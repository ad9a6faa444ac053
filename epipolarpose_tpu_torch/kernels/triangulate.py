"""Batched DLT triangulation: the CUDA kernel ``csrc/triangulate.cu`` and
its plain twin.

The kernel does all of
``geometry/triangulation.py::triangulate(..., method="fast")`` in one
launch, in registers: float32 rows, as in the plain version, and AᵀA and
the Rayleigh step in float64, where float32 amplifies rounding into
millimetres (the source says why). It is the port's kernel for an op that
XLA fuses on the TPU (``epipolarpose_tpu/geometry/triangulation.py:125-160``),
not for a ``pl.pallas_call``.

Two layouts of one kernel, chosen by :func:`route` from the number of
points alone: ``thread`` (``epk_triangulate``, one thread a point) for
large batches, ``split`` (``epk_triangulate_split``, four lanes a point,
the views split over the lanes) for small ones, where a thread's serial
chain and the launch set the time.

:func:`triangulate_fast` is the entry point: a CPU tensor takes the plain
version (:func:`triangulate_fast_plain`), a CUDA tensor launches the kernel
on the current stream, or raises. ``triangulate_fast.launches`` counts the
launches of either layout; ``launches_thread`` and ``launches_split``
count each.
"""

from __future__ import annotations

import functools

import torch

from epipolarpose_tpu_torch.geometry.triangulation import triangulate
from epipolarpose_tpu_torch.kernels import _build

MIN_VIEWS, MAX_VIEWS = 2, 8
# the kernel numbers threads in 32 bits (more points than an H100 holds)
MAX_POINTS = 2 ** 32 - 129
# the split layout up to this many points, one thread a point beyond: on
# an H100 the split layout is the faster at 544, 4,352 and 8,704 points
# (512 frames x 17 joints), the thread layout at 17,408 and more
# (tools/bench_triangulate.py --layouts)
SPLIT_MAX_POINTS = 8704


def route(points: int) -> str:
    """``"split"`` (four lanes a point) up to :data:`SPLIT_MAX_POINTS`
    points, else ``"thread"`` (one thread a point)."""
    return "split" if points <= SPLIT_MAX_POINTS else "thread"


def triangulate_fast_plain(points2d: torch.Tensor, P: torch.Tensor,
                           weights: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``triangulate(..., method="fast")``."""
    return triangulate(points2d, P, weights, method="fast")


def check_kernel_args(points2d: torch.Tensor, P: torch.Tensor,
                      weights: torch.Tensor | None) -> bool:
    """Raise on what ``epk_triangulate`` does not take (no silent copies);
    return whether P is per frame."""
    if points2d.ndim != 4 or points2d.shape[-1] != 2:
        raise ValueError(f"points2d must be (N, V, J, 2), got "
                         f"{tuple(points2d.shape)}")
    n, v, j, _ = points2d.shape
    if not MIN_VIEWS <= v <= MAX_VIEWS:
        raise ValueError(f"epk_triangulate takes {MIN_VIEWS} to {MAX_VIEWS} "
                         f"views, got V = {v}")
    if n * j > MAX_POINTS:
        raise ValueError(f"epk_triangulate takes at most {MAX_POINTS} "
                         f"points, got {n} x {j}")
    p_shape = P.shape
    if p_shape == (v, 3, 4):
        per_frame = False
    elif p_shape == (n, v, 3, 4):
        per_frame = True
    else:
        raise ValueError(f"P must be ({v}, 3, 4) or ({n}, {v}, 3, 4), got "
                         f"{tuple(p_shape)}")
    if weights is not None and weights.shape != (n, v, j):
        raise ValueError(f"weights must be ({n}, {v}, {j}), got "
                         f"{tuple(weights.shape)}")
    device = points2d.device
    for name, t in (("points2d", points2d), ("P", P), ("weights", weights)):
        if t is None:
            continue
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"epk_triangulate: {name} must be contiguous "
                             f"float32, got {t.dtype}"
                             f"{'' if t.is_contiguous() else ' strided'}")
        if t.device != device:
            raise ValueError(f"epk_triangulate: {name} on {t.device}, "
                             f"points2d on {device}")
    if points2d.data_ptr() % 8:
        raise ValueError("epk_triangulate: points2d must be 8-byte aligned")
    return per_frame


@functools.lru_cache(maxsize=None)
def _kernels() -> tuple:
    """The library and each layout's launch function, looked up once."""
    lib = _build.library()
    return lib, {"thread": lib.epk_triangulate,
                 "split": lib.epk_triangulate_split}


def triangulate_fast(points2d: torch.Tensor, P: torch.Tensor,
                     weights: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Triangulate (N, J) joints by the ``fast`` solver.

    points2d (N, V, J, 2) undistorted pixels; P (V, 3, 4) or
    (N, V, 3, 4); weights (N, V, J) or None. Returns (X (N, J, 3),
    residual (N, J)) float32. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel in the layout :func:`route` picks
    (2 <= V <= 8), or raises.
    """
    device = points2d.device
    if device.type == "cpu":
        return triangulate_fast_plain(points2d, P, weights)
    if device.type != "cuda":
        raise ValueError(f"no triangulation kernel for {device}")
    per_frame = check_kernel_args(points2d, P, weights)
    n, v, j, _ = points2d.shape
    x = torch.empty((n, j, 3), dtype=torch.float32, device=device)
    res = torch.empty((n, j), dtype=torch.float32, device=device)
    if n * j == 0:
        return x, res
    layout = route(n * j)
    index = device.index
    lib, kernels = _kernels()
    code = kernels[layout](
        points2d.data_ptr(), P.data_ptr(), per_frame,
        None if weights is None else weights.data_ptr(), x.data_ptr(),
        res.data_ptr(), n, v, j, index, _build.current_stream(index))
    _build.check(lib, code, "epk_triangulate")
    triangulate_fast.launches += 1
    if layout == "split":
        triangulate_fast.launches_split += 1
    else:
        triangulate_fast.launches_thread += 1
    return x, res


# launches of the CUDA kernel, all and per layout; the CPU path does not
# count
triangulate_fast.launches = 0
triangulate_fast.launches_thread = 0
triangulate_fast.launches_split = 0
