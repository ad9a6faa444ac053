"""Batched multi-view DLT triangulation in float32 torch.

Counterpart of the JAX package's ``geometry/triangulation.py``. Per 3D
point each view gives two rows, ``x P[2] - P[0]`` and ``y P[2] - P[1]``;
the rows are scaled to unit length, then weighted by the view's
confidence, and the point is the right null vector of the (2V, 4) system.

Three solvers, as in the JAX package:

- ``svd``:  ``torch.linalg.svd`` of A;
- ``eigh``: ``torch.linalg.eigh`` of AᵀA (4x4);
- ``fast``: the closed-form adjugate of AᵀA, its largest column, then one
  Rayleigh-shifted adjugate refinement. Pure elementwise arithmetic.

This module's ``fast`` path is the plain version of the CUDA kernel
``epk_triangulate`` (``kernels/triangulate.py``); ``svd`` and ``eigh`` are
its oracles. Every product is elementwise float32 (no matmul), so no TF32
setting can reach it. :func:`svd` and :func:`eigh` are cuSOLVER's on a
card, which reads its status back to the host: they run through
:func:`graphs.host_op`, between the segments of a CUDA graph.
"""

from __future__ import annotations

import torch

from epipolarpose_tpu_torch.graphs import host_op


def eigh(m: torch.Tensor):
    """``torch.linalg.eigh(m)``; eagerly between two graph segments inside
    a capture (:func:`graphs.host_op`)."""
    return host_op(torch.linalg.eigh, m)


def svd(a: torch.Tensor, full_matrices: bool = True):
    """``torch.linalg.svd(a, full_matrices)``; eagerly between two graph
    segments inside a capture (:func:`graphs.host_op`)."""
    if full_matrices:
        return host_op(torch.linalg.svd, a)
    return host_op(_svd_reduced, a)


def _svd_reduced(a: torch.Tensor):
    return torch.linalg.svd(a, full_matrices=False)


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., R, C) @ (..., C) elementwise."""
    return (m * v[..., None, :]).sum(-1)


def build_dlt_system(points2d: torch.Tensor, P: torch.Tensor,
                     weights: torch.Tensor | None = None) -> torch.Tensor:
    """DLT rows. points2d (..., V, 2); P (..., V, 3, 4), broadcast;
    weights (..., V) or None. Returns A (..., 2V, 4): the V ``x`` rows,
    then the V ``y`` rows."""
    x = points2d[..., 0:1]
    y = points2d[..., 1:2]
    r0 = x * P[..., 2, :] - P[..., 0, :]
    r1 = y * P[..., 2, :] - P[..., 1, :]
    a = torch.cat([r0, r1], dim=-2)
    a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-12)
    if weights is not None:
        a = a * torch.cat([weights, weights], dim=-1)[..., None]
    return a


def adjugate4(m: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate (cofactor transpose) of (..., 4, 4) matrices."""
    def det3(r, c):
        rows = [i for i in range(4) if i != r]
        cols = [j for j in range(4) if j != c]
        a = m[..., rows[0], :][..., cols]
        b = m[..., rows[1], :][..., cols]
        d = m[..., rows[2], :][..., cols]
        return (a[..., 0] * (b[..., 1] * d[..., 2] - b[..., 2] * d[..., 1])
                - a[..., 1] * (b[..., 0] * d[..., 2] - b[..., 2] * d[..., 0])
                + a[..., 2] * (b[..., 0] * d[..., 1] - b[..., 1] * d[..., 0]))

    cof = torch.stack([torch.stack([((-1.0) ** (r + c)) * det3(r, c)
                                    for c in range(4)], dim=-1)
                       for r in range(4)], dim=-2)
    return cof.transpose(-1, -2)


def _max_norm_column(b: torch.Tensor) -> torch.Tensor:
    """The column of (..., 4, 4) ``b`` with the largest norm (the first of
    equal ones), scaled to unit length."""
    best = torch.linalg.vector_norm(b, dim=-2).argmax(dim=-1)
    idx = best[..., None, None].expand(b.shape[:-1] + (1,))
    v = torch.gather(b, -1, idx)[..., 0]
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-30)


def _smallest_eigvec_fast(m: torch.Tensor,
                          refine: bool = True) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of symmetric PSD (..., 4, 4)
    ``m``: the largest column of adj(m), then one Rayleigh-shifted
    adjugate step, kept only where its result is not vanishing."""
    v = _max_norm_column(adjugate4(m))
    if refine:
        lam = (v * _mv(m, v)).sum(-1)
        eye = torch.eye(4, dtype=m.dtype, device=m.device)
        shifted = m - (lam[..., None, None] - 1e-7) * eye
        w = _mv(adjugate4(shifted), v)
        nw = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
        v = torch.where(nw > 1e-12, w / (nw + 1e-30), v)
    return v


def normal_matrix(a: torch.Tensor) -> torch.Tensor:
    """AᵀA of (..., 2V, 4) ``a``, elementwise."""
    return (a[..., :, :, None] * a[..., :, None, :]).sum(-3)


def _null_vector(a: torch.Tensor, method: str) -> torch.Tensor:
    """Right null vector of (..., 2V, 4) ``a`` by the named solver."""
    if method == "svd":
        return svd(a, full_matrices=False)[2][..., -1, :]
    m = normal_matrix(a)
    if method == "eigh":
        return eigh(m)[1][..., :, 0]
    if method == "fast":
        return _smallest_eigvec_fast(m)
    raise ValueError(f"unknown triangulation method: {method}")


def triangulate_points(points2d: torch.Tensor, P: torch.Tensor,
                       weights: torch.Tensor | None = None,
                       method: str = "fast"
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """One 3D point per batch element.

    points2d (..., V, 2); P (..., V, 3, 4), broadcast; weights (..., V) or
    None. Returns (X (..., 3), residual ``|A v|`` (...,)).
    """
    a = build_dlt_system(points2d, P, weights)
    v = _null_vector(a, method)
    w = v[..., 3:4]
    # sign-stabilize (w >= 0), then dehomogenize
    v = v * torch.sign(torch.where(w == 0, torch.ones_like(w), w))
    w = v[..., 3:4]
    x = v[..., :3] / torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12),
                                 w)
    return x, torch.linalg.vector_norm(_mv(a, v), dim=-1)


def triangulate(points2d: torch.Tensor, P: torch.Tensor,
                weights: torch.Tensor | None = None,
                method: str = "fast") -> tuple[torch.Tensor, torch.Tensor]:
    """(N, J) batches of joints.

    points2d (N, V, J, 2); P (V, 3, 4) or (N, V, 3, 4); weights (N, V, J)
    or None. Returns (X (N, J, 3), residual (N, J)).
    """
    pts = points2d.transpose(-3, -2)                 # (N, J, V, 2)
    pb = P[None, None] if P.ndim == 3 else P[:, None]
    w = None if weights is None else weights.transpose(-2, -1)
    return triangulate_points(pts, pb, w, method=method)


triangulate_dlt = triangulate


def reprojection_error(x: torch.Tensor, points2d: torch.Tensor,
                       P: torch.Tensor) -> torch.Tensor:
    """Mean pixel reprojection error. x (..., 3); points2d (..., V, 2);
    P (..., V, 3, 4)."""
    xh = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
    proj = _mv(P, xh[..., None, :])
    proj = proj[..., :2] / proj[..., 2:3]
    return torch.linalg.vector_norm(proj - points2d, dim=-1).mean(-1)
