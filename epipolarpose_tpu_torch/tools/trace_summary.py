"""Summarize a ``torch.profiler`` Chrome trace: device time by kernel and
the device's idle share.

    python -m epipolarpose_tpu_torch.tools.trace_summary TRACE.json [--top 15]

The device is busy while a kernel, a copy or a memset runs on it; busy time
is the union of those intervals, so kernels that overlap on two streams
count once. The window is the span of every timed event in the trace, host
events included; the idle share is ``1 - busy / window``. Each kernel's
time is its summed duration; names are cut to their first 120
characters.
"""

from __future__ import annotations

import argparse
import collections
import json

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def summarize(path: str, top: int = 15) -> dict:
    """Read a Chrome trace; return the window, the busy time and idle share
    (ms, fraction) and the ``top`` kernels by summed time."""
    with open(path) as f:
        trace = json.load(f)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{path}: no timed events")
    start = min(float(e["ts"]) for e in events)
    end = max(float(e["ts"]) + float(e["dur"]) for e in events)
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in events
                    if str(e.get("cat", "")).lower() in DEVICE_CATEGORIES)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in device:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        if str(e.get("cat", "")).lower() == "kernel":
            by_name[e["name"]][0] += float(e["dur"])
            by_name[e["name"]][1] += 1
    window = end - start
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / window if window > 0 else 0.0,
            "device_events": len(device),
            "top_kernels": [{"name": n[:120], "ms": t / 1e3, "calls": c,
                             "share_of_busy": t / busy if busy else 0.0}
                            for n, (t, c) in ranked]}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trace")
    p.add_argument("--top", type=int, default=15)
    args = p.parse_args(argv)
    print(json.dumps(summarize(args.trace, args.top), indent=1))


if __name__ == "__main__":
    main()
