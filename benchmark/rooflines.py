"""The work each hand-written kernel's job needs, from the cell's shapes,
and the card's published peaks: the yardstick of the ``*_roofline``
metrics. The counts do not depend on how a kernel is written: each input
byte is read once, each output byte written once, and the operations are
those of the plain algorithm.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit. A
share is stated against them, with the card's power limit beside it.
"""

from __future__ import annotations

BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(n_bytes: float, flops: float = 0.0,
            peak_flops: float = F32_FLOPS) -> float:
    """Least time the card needs: the larger of the bytes' and the
    operations' times."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / peak_flops)


def softargmax_fwd_bytes(n: int, joints: int, depth: int, h: int, w: int,
                         dtype: str) -> int:
    """Soft-argmax forward: the (N, J*D, H, W) volume read, the (N, J, 3)
    float32 coordinates written."""
    return n * joints * depth * h * w * DTYPE_BYTES[dtype] + n * joints * 12


def softargmax_bwd_bytes(n: int, joints: int, depth: int, h: int, w: int,
                         dtype: str) -> int:
    """Its gradient: the volume and the (N, J, 3) coordinates and their
    gradient read, the volume's gradient written."""
    vol = n * joints * depth * h * w * DTYPE_BYTES[dtype]
    return 2 * vol + 2 * n * joints * 12


def tri_flops(views: int) -> int:
    """float32 operations a point of the confidence-weighted DLT with the
    closed-form solver: rows, norms and weights 50V, AᵀA 64V, residual
    16V; two adjugates of 16 3x3 minors (14 each) 448; column norms,
    argmax, normalisation, the Rayleigh step, sign and dehomogenisation
    about 140."""
    return 130 * views + 590


def triangulate_work(groups: int, views: int, joints: int
                     ) -> tuple[int, int]:
    """(bytes, operations) of one triangulation of G x J points over V
    views with a projection matrix a frame and view: the (G, V, J, 2)
    points and (G, V, J) weights and the (G, V, 3, 4) matrices read, the
    (G, J, 3) points and (G, J) residuals written."""
    points = groups * joints
    n_bytes = (points * views * 12 + groups * views * 48 + points * 16)
    return n_bytes, points * tri_flops(views)
