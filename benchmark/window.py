"""The measured window and the profiled stretch after it.

The window calls the program for ``seconds`` on the host's clock and ends
in a ``synchronize``. Around each call it keeps a host span (the
benchmark's own: the program has none yet) and records a CUDA event after
it, read only once the window has closed, so no wait is added. With a
trace, a short stretch of further calls then runs under
``torch.profiler``; its Chrome trace goes to ``TMPDIR``, is summarised and
deleted.
"""

from __future__ import annotations

import math
import os
import tempfile
import time

import torch

from benchmark import trace_summary

PROFILED_CALLS = 6
PROFILER_WARMUP = 2


def _event(device):
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def p95(values: list) -> float:
    """Nearest-rank 95th percentile."""
    ranked = sorted(values)
    return ranked[max(math.ceil(0.95 * len(ranked)) - 1, 0)]


def run(call, seconds: float, device, after=None) -> dict:
    """``call(i)`` until ``seconds`` have passed, then a synchronize.
    ``after(i, out)`` runs after each call (the loop's own host work).
    Returns the calls made, the window's seconds, the host spans and the
    device's intervals between consecutive calls' ends (ms; None on the
    CPU), each call's start-to-end interval where ``after`` waits."""
    sync(device)
    first = _event(device)
    ends, starts, host = [], [], []
    t0 = time.perf_counter()
    i = 0
    while True:
        starts.append(_event(device))
        h0 = time.perf_counter()
        with torch.profiler.record_function("bench.call"):
            out = call(i)
            if after is not None:
                after(i, out)
        host.append(time.perf_counter() - h0)
        ends.append(_event(device))
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    window_s = time.perf_counter() - t0
    gaps = spans = None
    if device.type == "cuda":
        marks = [first] + ends
        gaps = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        spans = [a.elapsed_time(b) for a, b in zip(starts, ends)]
    return {"calls": i, "window_s": window_s, "host_s": host,
            "end_gaps_ms": gaps, "call_ms": spans}


def profiled(call, first: int, device, after=None) -> dict | None:
    """``PROFILED_CALLS`` calls under ``torch.profiler`` after
    ``PROFILER_WARMUP`` unrecorded ones, each followed by ``after`` as in
    the window; the trace's summary
    (:func:`trace_summary.summarize`) with ``calls``, or None on the
    CPU."""
    if device.type != "cuda":
        return None
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=PROFILER_WARMUP,
                                    active=PROFILED_CALLS, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for k in range(PROFILER_WARMUP + PROFILED_CALLS):
            with torch.profiler.record_function("bench.call"):
                out = call(first + k)
                if after is not None:
                    after(first + k, out)
            if k == PROFILER_WARMUP + PROFILED_CALLS - 1:
                sync(device)
            prof.step()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        summary = trace_summary.summarize_file(path)
    finally:
        os.remove(path)
    summary["calls"] = PROFILED_CALLS
    return summary
