"""CUDA graphs for whole steps: capture once, replay per batch.

The counterpart of the JAX package's ``lax.scan`` over a super-batch
(its ``core/steps.py::compile_step(fused_steps=K)``): one host dispatch
runs K steps (``core/steps.py::FusedSteps`` here). :class:`StepGraph` captures a callable on a side stream into a
private memory pool, following PyTorch's whole-network recipe, and replays
it on the current stream.

A capture here also runs the work once: each graph segment is replayed as
soon as it is captured, so the call that captures gives the same results
as one that replays. Most steps are one segment. An op that cannot be
captured, because it reads a result back to the host (cuSOLVER's
``eigh`` and ``svd`` check their status that way), goes through
:func:`host_op`: inside a capture it ends the segment, runs the op
eagerly between two segments, and opens the next one; at each replay it
runs again at the same point, writing into the same output tensors. No
other op runs eagerly: anything else that synchronises, or copies from
pageable host memory, fails the capture, and :class:`CaptureError` names
the line of the step that did it.

Kernel launch counters (``telemetry.count``) add a segment's launches at
each of its replays. Each run of a host op, eager, at a capture or at a
replay, is a ``graphs.host_op`` span: the op waits for the card.
"""

from __future__ import annotations

import os
import threading
import traceback

import numpy as np
import torch
from torch._guards import detect_fake_mode

from epipolarpose_tpu_torch import telemetry

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_active = threading.local()
_constants: dict = {}


class CaptureError(RuntimeError):
    """A step failed to capture into a CUDA graph, or to replay."""


def host_op(fn, *args):
    """``fn(*args)``, which returns a tensor or a tuple of tensors; inside
    a :class:`StepGraph` capture it runs eagerly between two graph
    segments (module docstring), and at every replay again."""
    graph = getattr(_active, "graph", None)
    if graph is None:
        with telemetry.span("graphs.host_op"):
            return fn(*args)
    return graph._split(fn, args)


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A small constant tensor (index lists, matrices, per-channel
    statistics) on ``device``, copied from the host once and kept: a later
    call, inside a capture too, copies nothing. Callers must not write
    into it.

    While a fake mode is active (``torch.export`` or ``torch.compile``
    tracing), the tensor made here is a fake one with no data: it is made
    anew and not cached, and the cache is not read, so the traced program
    holds the values as a constant of its own and a later eager call still
    gets real data."""
    a = np.asarray(values)
    if detect_fake_mode() is not None:
        return torch.as_tensor(a, dtype=dtype, device=device)
    key = (a.shape, a.dtype.str, a.tobytes(), dtype, torch.device(device))
    t = _constants.get(key)
    if t is None:
        t = _constants[key] = torch.as_tensor(a, dtype=dtype, device=device)
    return t


def _where(exc: BaseException) -> str:
    """The innermost frame of ``exc``'s traceback outside PyTorch and this
    module: ``file:line in function: source``."""
    frames = traceback.extract_tb(exc.__traceback__)
    own = os.path.abspath(__file__)
    mine = [f for f in frames if os.path.abspath(f.filename) != own
            and f"{os.sep}torch{os.sep}" not in f.filename]
    if not mine:
        return "an op inside PyTorch"
    f = mine[-1]
    path = os.path.relpath(f.filename, os.path.dirname(PKG_DIR)) \
        if f.filename.startswith(os.path.dirname(PKG_DIR)) else f.filename
    return f"{path}:{f.lineno} in {f.name}: {(f.line or '').strip()}"


def _copy_into(dst, src) -> None:
    """Copy a tensor, or a tuple of them, into ``dst`` in place."""
    if torch.is_tensor(dst):
        dst.copy_(src)
        return
    for d, s in zip(dst, src, strict=True):
        _copy_into(d, s)


class StepGraph:
    """One captured step: graph segments and the host ops between them.

    ``pool``: the memory pool shared with other graphs of the same step
    (``torch.cuda.graph_pool_handle()``); they must replay in an order in
    which no graph reads a tensor another graph's temporaries overwrote,
    which holds where each graph's outputs are copied out before the next
    replay.
    """

    def __init__(self, pool=None):
        self.pool = pool if pool is not None else \
            torch.cuda.graph_pool_handle()
        self.segments: list[tuple] = []
        self._graph = None
        self._tally = None

    @property
    def host_ops(self) -> int:
        """The number of ops run eagerly between segments at each
        replay."""
        return sum(1 for s in self.segments if s[0] == "host")

    def _begin(self) -> None:
        self._tally_ctx = telemetry.capture_tally()
        self._tally = self._tally_ctx.__enter__()
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self.pool,
                                  capture_error_mode="thread_local")

    def _end(self) -> None:
        graph, tally = self._graph, self._tally
        self._graph = None
        try:
            graph.capture_end()
        finally:
            self._tally_ctx.__exit__(None, None, None)
        self.segments.append(("graph", graph, dict(tally)))
        graph.replay()
        telemetry.add_tally(tally)

    def _split(self, fn, args):
        self._end()
        with telemetry.span("graphs.host_op"):
            out = fn(*args)
        self.segments.append(("host", fn, args, out))
        self._begin()
        return out

    def capture(self, run, stream: torch.cuda.Stream | None = None):
        """Capture ``run()`` (no arguments; it reads and writes tensors
        that outlive the graph) on ``stream`` (a new side stream by
        default) and run it once. Returns what ``run`` returned: tensors
        that every replay rewrites in place."""
        if self.segments:
            raise RuntimeError("this graph is already captured")
        current = torch.cuda.current_stream()
        torch.cuda.synchronize()
        stream = stream or torch.cuda.Stream()
        with torch.cuda.stream(stream):
            _active.graph = self
            try:
                self._begin()
                out = run()
                self._end()
            except BaseException as exc:
                self._abort()
                raise CaptureError(
                    f"CUDA-graph capture of the step failed at "
                    f"{_where(exc)}: {type(exc).__name__}: {exc}") from exc
            finally:
                _active.graph = None
        current.wait_stream(stream)
        return out

    def _abort(self) -> None:
        if self._graph is None:
            return
        try:
            self._graph.capture_end()
        except Exception:       # the capture was invalidated: expected
            pass
        finally:
            self._graph = None
            self._tally_ctx.__exit__(None, None, None)

    def replay(self) -> None:
        """Run every segment and host op in order on the current stream."""
        for seg in self.segments:
            try:
                if seg[0] == "graph":
                    seg[1].replay()
                    telemetry.add_tally(seg[2])
                else:
                    _, fn, args, out = seg
                    with telemetry.span("graphs.host_op"):
                        _copy_into(out, fn(*args))
            except Exception as exc:
                what = ("a graph segment" if seg[0] == "graph"
                        else f"host op {getattr(seg[1], '__name__', seg[1])}")
                raise CaptureError(f"replay of the step failed in {what}: "
                                   f"{type(exc).__name__}: {exc}") from exc
