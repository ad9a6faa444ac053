"""Procrustes (similarity) alignment for PA-MPJPE, in torch.

Counterpart of the JAX package's ``geometry/procrustes.py``: the scale s,
rotation R and translation t minimizing ||s X R + t - Y||^2 over joint
sets X, Y (..., J, 3), by the SVD of the 3x3 cross-covariance. The
products are elementwise float32 sums (no matmul, so no TF32); the SVD
runs in float32.
"""

from __future__ import annotations

import torch


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n, k) @ (..., k, m) as an elementwise product and sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def compute_similarity_transform(X: torch.Tensor, Y: torch.Tensor):
    """The similarity transform aligning X to Y, X and Y (..., J, 3).

    Returns (s (...,), R (..., 3, 3), t (..., 3)) with the aligned points
    ``s[..., None, None] * X @ R + t[..., None, :]``; R is a proper
    rotation (a reflection is refused by flipping the last axis).
    """
    muX = X.mean(dim=-2, keepdim=True)
    muY = Y.mean(dim=-2, keepdim=True)
    X0, Y0 = X - muX, Y - muY
    normX2 = (X0 * X0).sum(dim=(-1, -2))
    H = _mm(X0.transpose(-1, -2), Y0)                    # (..., 3, 3)
    U, S, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    det = torch.linalg.det(_mm(V, Ut))
    sign = torch.stack([torch.ones_like(det), torch.ones_like(det), det],
                       dim=-1)
    R = _mm(V * sign[..., None, :], Ut)
    # R acts on column vectors; on row vectors X0 @ R^T
    R_row = R.transpose(-1, -2)
    trace = (S * sign).sum(dim=-1)
    s = trace / torch.where(normX2 < 1e-12, torch.full_like(normX2, 1e-12),
                            normX2)
    t = (muY - s[..., None, None] * _mm(muX, R_row))[..., 0, :]
    return s, R_row, t


def procrustes_align(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """X aligned onto Y by the optimal similarity transform."""
    s, R, t = compute_similarity_transform(X, Y)
    return s[..., None, None] * _mm(X, R) + t[..., None, :]
