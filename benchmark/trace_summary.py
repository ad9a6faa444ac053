"""Summarise a ``torch.profiler`` Chrome trace: device time by kernel, the
device's busy time and idle share, and the longest idle gaps with what the
host was doing in them.

A frozen copy of the program's ``tools/trace_summary.py::summarize``
rule: the device is busy while a kernel, a copy or a memset runs on it;
busy time is the union of those intervals, so kernels that overlap on two
streams count once. The window is the span of every timed event in the
trace, host events included.
"""

from __future__ import annotations

import collections
import json

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver",
                   "user_annotation", "python_function")


def _union(intervals: list) -> list:
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(trace: dict, top: int = 10) -> dict:
    """Seconds: ``window_s``, ``busy_s``; ``kernels`` {name: [seconds,
    calls]}; ``device_ops``, the ``top`` device operations by time, and
    ``idle_gaps``, the ``top`` longest gaps between device work, each named
    by the innermost host event that spans the gap's middle."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError("the trace has no timed events")
    start = min(float(e["ts"]) for e in events)
    end = max(float(e["ts"]) + float(e["dur"]) for e in events)
    device = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events
              if str(e.get("cat", "")).lower() in DEVICE_CATEGORIES]
    busy = _union(device)
    by_name: dict = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        if str(e.get("cat", "")).lower() in DEVICE_CATEGORIES:
            by_name[e["name"]][0] += float(e["dur"]) * 1e-6
            by_name[e["name"]][1] += 1
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events
            if str(e.get("cat", "")).lower() in HOST_CATEGORIES]
    gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])]
    gaps.sort(reverse=True)
    idle = []
    for length, s, e in gaps[:top]:
        mid = 0.5 * (s + e)
        spans = [(he - hs, name) for hs, he, name in host if hs <= mid <= he]
        idle.append([min(spans)[1] if spans else "(no host event)",
                     length * 1e-6])
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"window_s": (end - start) * 1e-6,
            "busy_s": sum(e - s for s, e in busy) * 1e-6,
            "kernels": dict(by_name),
            "device_ops": [[n[:160], t] for n, (t, _) in ranked[:top]],
            "idle_gaps": idle}


def summarize_file(path: str, top: int = 10) -> dict:
    with open(path) as f:
        return summarize(json.load(f), top)
