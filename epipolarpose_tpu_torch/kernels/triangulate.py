"""Batched DLT triangulation: the CUDA kernel ``csrc/triangulate.cu`` and
its plain twin.

The kernel ``epk_triangulate`` does all of
``geometry/triangulation.py::triangulate(..., method="fast")`` in one
launch, one thread per (frame, joint) point, in float32 registers. It is
the port's kernel for an op that XLA fuses on the TPU
(``epipolarpose_tpu/geometry/triangulation.py:125-160``), not for a
``pl.pallas_call``.

:func:`triangulate_fast` is the entry point: a CPU tensor takes the plain
version (:func:`triangulate_fast_plain`), a CUDA tensor launches the kernel
on the current stream, or raises.
"""

from __future__ import annotations

import torch

from epipolarpose_tpu_torch.geometry.triangulation import triangulate
from epipolarpose_tpu_torch.kernels import _build

MIN_VIEWS, MAX_VIEWS = 2, 8


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
    if tuple(P.shape) == (v, 3, 4):
        per_frame = False
    elif tuple(P.shape) == (n, v, 3, 4):
        per_frame = True
    else:
        raise ValueError(f"P must be ({v}, 3, 4) or ({n}, {v}, 3, 4), got "
                         f"{tuple(P.shape)}")
    if weights is not None and tuple(weights.shape) != (n, v, j):
        raise ValueError(f"weights must be ({n}, {v}, {j}), got "
                         f"{tuple(weights.shape)}")
    for name, t in (("points2d", points2d), ("P", P), ("weights", weights)):
        if t is None:
            continue
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"epk_triangulate: {name} must be contiguous "
                             f"float32, got {t.dtype}"
                             f"{'' if t.is_contiguous() else ' strided'}")
        if t.device != points2d.device:
            raise ValueError(f"epk_triangulate: {name} on {t.device}, "
                             f"points2d on {points2d.device}")
    if points2d.data_ptr() % 8:
        raise ValueError("epk_triangulate: points2d must be 8-byte aligned")
    return per_frame


def triangulate_fast(points2d: torch.Tensor, P: torch.Tensor,
                     weights: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Triangulate (N, J) joints by the ``fast`` solver.

    points2d (N, V, J, 2) undistorted pixels; P (V, 3, 4) or
    (N, V, 3, 4); weights (N, V, J) or None. Returns (X (N, J, 3),
    residual (N, J)) float32. A CPU tensor takes the plain version; a CUDA
    tensor launches ``epk_triangulate`` (2 <= V <= 8), or raises.
    """
    if points2d.device.type == "cpu":
        return triangulate_fast_plain(points2d, P, weights)
    if points2d.device.type != "cuda":
        raise ValueError(f"no triangulation kernel for {points2d.device}")
    per_frame = check_kernel_args(points2d, P, weights)
    n, v, j, _ = points2d.shape
    kw = dict(dtype=torch.float32, device=points2d.device)
    x = torch.empty((n, j, 3), **kw)
    res = torch.empty((n, j), **kw)
    if n * j == 0:
        return x, res
    lib = _build.library()
    code = lib.epk_triangulate(
        points2d.data_ptr(), P.data_ptr(), int(per_frame),
        None if weights is None else weights.data_ptr(), x.data_ptr(),
        res.data_ptr(), n, v, j, *_build.launch_args(points2d.device))
    _build.check(lib, code, "epk_triangulate")
    triangulate_fast.launches += 1
    return x, res


# launches of the CUDA kernel; the CPU path does not count
triangulate_fast.launches = 0
