"""The port's own instruments: spans at the layer boundaries of its steps
and loops, and the kernels' launch counters.

Spans
-----
``with telemetry.span("train.forward"): ...`` marks a phase of a step.
It records only while a ``torch.profiler`` session records
(``torch.autograd.profiler._is_profiler_enabled``, the flag PyTorch keeps
for fast checks: true from a profile's start of recording to its stop,
false in a schedule's wait and warm-up). With no one recording, entering
a span costs that one test and hands back a shared null context: nothing
is launched, allocated or waited for. So ``scripts/train.py --profile``
and the benchmark's traced stretch turn spans on, and every other run
sees them off.

A recording span

- opens ``torch.profiler.record_function(name)``, so its range lies in the
  profiler's Chrome trace on the kernels' clock (a ``user_annotation``);
- keeps its name, its parent (the span open around it on this thread),
  its step (an id shared by every span of one top-level span) and its
  host start and end (``perf_counter_ns``);
- once CUDA is initialised, records two timing events from a reused pool
  on the current stream at its start and end. ``device_ms`` is the time
  from one to the other on that stream: the work enqueued inside the span,
  and the stream's waits for work enqueued before it. The events are read
  by :func:`snapshot`, never on the hot path. While the current stream
  captures a CUDA graph, or under a fake mode (``torch.export`` tracing),
  a span keeps its host record alone.

:func:`snapshot` aggregates the last stretch in which spans recorded. A
stretch ends where a span is entered with no profiler recording, or where
a snapshot is taken; the next span that records starts a fresh aggregate.
Occurrences wait for their events in a bounded queue; past
:data:`PENDING_CAP` the oldest whose events have completed are folded
into the aggregate without waiting.

Counters
--------
A kernel wrapper declares its counters with :func:`counter` (attributes of
the wrapper, read by name: ``softmax_integral.launches``) and adds to them
with :func:`count`: outside a CUDA-graph capture at once; inside one to
the capture's tally (:func:`capture_tally`), which the graph adds at each
replay (:func:`add_tally`), when the kernels really run. :func:`reset`
zeroes every declared counter and the span aggregate.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch
from torch._guards import detect_fake_mode
from torch.autograd import profiler as _profiler

# occurrences waiting for their events before the oldest completed ones
# are folded into the aggregate
PENDING_CAP = 4096


class _Occurrence:
    """One recording span, from its entry to its fold into the
    aggregate."""

    __slots__ = ("name", "parent", "step", "t0", "t1", "events", "rf",
                 "child_host_ns", "child_device_ms")

    def __init__(self, name: str):
        self.name = name
        self.child_host_ns = 0
        self.child_device_ms = 0.0

    def __enter__(self):
        _recorder.enter(self)
        return self

    def __exit__(self, *exc):
        _recorder.exit(self, exc)
        return False


class _Null:
    """The span of no one recording. Entering it ends the recorded
    stretch, so the next recording span starts a fresh aggregate."""

    __slots__ = ()

    def __enter__(self):
        _recorder.stretch_over = True
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def span(name: str):
    """A context manager that marks a phase named ``name`` (module
    docstring); the shared null context while no profiler records."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Occurrence(name)


def _stat() -> dict:
    return {"calls": 0, "steps": 0, "last_step": None, "parents": set(),
            "host_ns": 0, "self_host_ns": 0, "device_ms": None,
            "self_device_ms": None}


class _Recorder:
    """The spans' state: per-thread stacks of open spans, the occurrences
    waiting for their events, the aggregate of the stretch and the event
    pool."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.step_ids = itertools.count(1)
        self.free_events: list = []
        self.stretch_over = True
        self.pending: collections.deque = collections.deque()
        self.agg: dict = {}
        self.top_level = 0

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def clear(self) -> None:
        with self.lock:
            for occ in self.pending:
                if occ.events is not None:
                    self.free_events.append(occ.events)
            self.pending.clear()
            self.agg = {}
            self.top_level = 0

    def enter(self, occ: _Occurrence) -> None:
        if self.stretch_over:
            self.stretch_over = False
            self.clear()
        stack = self.stack()
        occ.parent = stack[-1] if stack else None
        occ.step = (occ.parent.step if occ.parent is not None
                    else next(self.step_ids))
        occ.rf = torch.profiler.record_function(occ.name)
        occ.rf.__enter__()
        occ.events = self.start_events()
        stack.append(occ)
        occ.t0 = time.perf_counter_ns()

    def exit(self, occ: _Occurrence, exc) -> None:
        occ.t1 = time.perf_counter_ns()
        if occ.events is not None:
            if torch.cuda.is_current_stream_capturing():
                with self.lock:
                    self.free_events.append(occ.events)
                occ.events = None
            else:
                occ.events[1].record()
        stack = self.stack()
        if stack and stack[-1] is occ:
            stack.pop()
        occ.rf.__exit__(*exc)
        occ.rf = None
        if occ.parent is not None:
            occ.parent.child_host_ns += occ.t1 - occ.t0
        with self.lock:
            self.pending.append(occ)
            if len(self.pending) > PENDING_CAP:
                self.fold(wait=False)

    def start_events(self):
        """A (start, end) pair of timing events with start recorded on the
        current stream, or None where a span keeps its host record
        alone."""
        if _host_only():
            return None
        with self.lock:
            pair = self.free_events.pop() if self.free_events else None
        if pair is None:
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
        pair[0].record()
        return pair

    def fold(self, wait: bool) -> None:
        """Fold pending occurrences, oldest first, into the aggregate;
        without ``wait``, stop at the first whose end event has not
        completed. A child ends, and so folds, before its parent. Called
        under the lock."""
        while self.pending:
            occ = self.pending[0]
            device_ms = None
            if occ.events is not None:
                start, end = occ.events
                if wait:
                    end.synchronize()
                elif not end.query():
                    return
                device_ms = start.elapsed_time(end)
                self.free_events.append(occ.events)
                occ.events = None
            self.pending.popleft()
            st = self.agg.get(occ.name)
            if st is None:
                st = self.agg[occ.name] = _stat()
            host_ns = occ.t1 - occ.t0
            st["calls"] += 1
            if st["last_step"] != occ.step:
                st["steps"] += 1
                st["last_step"] = occ.step
            st["host_ns"] += host_ns
            st["self_host_ns"] += host_ns - occ.child_host_ns
            if occ.parent is None:
                self.top_level += 1
            else:
                st["parents"].add(occ.parent.name)
            if device_ms is not None:
                st["device_ms"] = (st["device_ms"] or 0.0) + device_ms
                st["self_device_ms"] = ((st["self_device_ms"] or 0.0)
                                        + device_ms - occ.child_device_ms)
                if occ.parent is not None:
                    occ.parent.child_device_ms += device_ms
            occ.parent = None


def _host_only() -> bool:
    """No timing events: CUDA unused, a capture under way on the current
    stream, or a fake mode's tracing."""
    return (not torch.cuda.is_initialized()
            or torch.cuda.is_current_stream_capturing()
            or detect_fake_mode() is not None)


_recorder = _Recorder()

# ------------------------------------------------------------ counters
# declared counters: (function, attribute name)
_counters: list[tuple] = []
# launches recorded by the capture under way (graphs.StepGraph), or None
_tally: collections.Counter | None = None


def counter(fn, *names: str) -> None:
    """Declare the counters ``fn.<name>``, each starting at 0."""
    for name in names:
        setattr(fn, name, 0)
        if (fn, name) not in _counters:
            _counters.append((fn, name))


def count(fn, *names: str) -> None:
    """Add one to each counter ``fn.<name>``, or, while a
    :func:`capture_tally` is open and the current stream captures, to the
    tally that each replay of the graph adds."""
    if (_tally is not None and torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing()):
        for name in names:
            _tally[(fn, name)] += 1
        return
    for name in names:
        setattr(fn, name, getattr(fn, name) + 1)


@contextlib.contextmanager
def capture_tally():
    """Collect the :func:`count` calls of a capture into a Counter of
    ``(fn, name) -> launches``; :func:`add_tally` adds it at a replay."""
    global _tally
    if _tally is not None:
        raise RuntimeError("a capture's launch tally is already open")
    _tally = tally = collections.Counter()
    try:
        yield tally
    finally:
        _tally = None


def add_tally(tally: collections.Counter) -> None:
    """Add a captured graph's launches to the counters (one replay)."""
    for (fn, name), n in tally.items():
        setattr(fn, name, getattr(fn, name) + n)


def counters() -> dict[str, int]:
    """Every declared counter by ``<function>.<name>``."""
    return {f"{fn.__name__}.{name}": getattr(fn, name)
            for fn, name in _counters}


# ------------------------------------------------------------ read-out
def snapshot() -> dict:
    """The last recorded stretch, waiting for its spans' events:

    - ``spans``: per name ``calls``, ``steps`` (the top-level spans it
      occurred under), ``parents`` (names), ``host_ms``, ``self_host_ms``
      (less its children's host time), ``device_ms`` and
      ``self_device_ms`` (None where no occurrence had events);
    - ``steps``: the top-level spans recorded;
    - ``counters``: :func:`counters`.

    The stretch ends here: the next span that records starts anew.
    """
    with _recorder.lock:
        _recorder.stretch_over = True
        _recorder.fold(wait=True)
        spans = {name: {"calls": st["calls"], "steps": st["steps"],
                        "parents": sorted(st["parents"]),
                        "host_ms": st["host_ns"] / 1e6,
                        "self_host_ms": st["self_host_ns"] / 1e6,
                        "device_ms": st["device_ms"],
                        "self_device_ms": st["self_device_ms"]}
                 for name, st in _recorder.agg.items()}
        steps = _recorder.top_level
    return {"spans": spans, "steps": steps, "counters": counters()}


def reset() -> None:
    """Zero every declared counter and drop the span aggregate."""
    for fn, name in _counters:
        setattr(fn, name, 0)
    _recorder.clear()


def table(snap: dict) -> str:
    """A snapshot's spans as a table of ms a call, widest host time
    first."""
    rows = ["span  calls  host_ms/call  self_host  device_ms/call  "
            "self_device"]

    def per(v, n):
        return "-" if v is None else f"{v / n:.3f}"
    for name, s in sorted(snap["spans"].items(),
                          key=lambda kv: -kv[1]["host_ms"]):
        n = s["calls"]
        rows.append(f"{name}  {n}  {per(s['host_ms'], n)}  "
                    f"{per(s['self_host_ms'], n)}  "
                    f"{per(s['device_ms'], n)}  "
                    f"{per(s['self_device_ms'], n)}")
    return "\n".join(rows)
