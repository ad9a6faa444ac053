"""Epipolar geometry in batched float32 torch: the 8-point fundamental and
essential matrices, pose recovery and a vectorized RANSAC.

Counterpart of the JAX package's ``geometry/epipolar.py``: the
calibration-free route recovers the relative pose of two cameras, up to
scale, from 2D joint correspondences. Everything runs on the tensors'
device with static shapes: RANSAC scores a fixed number of hypotheses at
once and picks the best by ``argmax`` on the device.

The JAX code runs its contractions at ``Precision.HIGHEST``. Here every
product of 3x3 and N x 9 matrices is written as elementwise multiplies and
sums, never a matmul, so ``torch.backends.cuda.matmul.allow_tf32`` cannot
change a bit. The solvers are ``torch.linalg.eigh`` (the 9x9 normal
matrix, and the two-view DLT inside :func:`recover_pose`) and
``torch.linalg.svd`` (3x3); on a card each call goes through cuSOLVER,
which waits for the host to read its status.
"""

from __future__ import annotations

import math

import torch

from epipolarpose_tpu_torch.geometry.triangulation import triangulate_points


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over the last two dims, elementwise (no TF32)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., R, C) matrices times (..., N, C) points -> (..., N, R)."""
    return (m[..., None, :, :] * v[..., :, None, :]).sum(-1)


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) matrices in closed form."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def _usv(u: torch.Tensor, s: torch.Tensor, vt: torch.Tensor) -> torch.Tensor:
    """``u @ diag(s) @ vt``."""
    return _mm(u * s[..., None, :], vt)


def _hartley_normalize(x: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Similarity-normalize (..., N, 2) points to centroid 0 and mean
    distance sqrt(2). Returns (x_norm, T (..., 3, 3)) with
    ``x_h_norm = T @ x_h``."""
    mu = x.mean(dim=-2, keepdim=True)
    d = torch.linalg.vector_norm(x - mu, dim=-1).mean(dim=-1)
    s = math.sqrt(2.0) / torch.where(d < 1e-12, torch.full_like(d, 1e-12), d)
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    t = torch.stack([
        torch.stack([s, z, -s * mu[..., 0, 0]], dim=-1),
        torch.stack([z, s, -s * mu[..., 0, 1]], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)
    return (x - mu) * s[..., None, None], t


def _nine_point_nullvec(a: torch.Tensor) -> torch.Tensor:
    """Smallest right-singular vector of (..., N, 9) ``a``, by ``eigh`` of
    AᵀA."""
    m = (a[..., :, :, None] * a[..., :, None, :]).sum(-3)
    return torch.linalg.eigh(m)[1][..., :, 0]


def estimate_fundamental(x1: torch.Tensor, x2: torch.Tensor,
                         weights: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Normalized 8-point fundamental matrix, batched.

    x1, x2 (..., N, 2) correspondences (``x2ᵀ F x1 = 0``); weights (..., N)
    or None. Returns F (..., 3, 3): rank 2, denormalized, unit Frobenius
    norm.
    """
    x1n, t1 = _hartley_normalize(x1)
    x2n, t2 = _hartley_normalize(x2)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    a = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], dim=-1)          # (..., N, 9)
    if weights is not None:
        a = a * weights[..., None]
    f = _nine_point_nullvec(a)
    f = f.reshape(f.shape[:-1] + (3, 3))
    # rank 2
    u, s, vt = torch.linalg.svd(f)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    f = _usv(u, s, vt)
    # x2ᵀ F x1 with x = T x_orig: F_orig = T2ᵀ F T1
    f = _mm(_mm(t2.transpose(-1, -2), f), t1)
    norm = torch.linalg.vector_norm(f.reshape(f.shape[:-2] + (9,)), dim=-1)
    return f / (norm[..., None, None] + 1e-30)


def _project_to_essential(e: torch.Tensor) -> torch.Tensor:
    """The nearest essential matrix: σ1 and σ2 equalized, σ3 zeroed."""
    u, s, vt = torch.linalg.svd(e)
    m = (s[..., 0] + s[..., 1]) / 2.0
    return _usv(u, torch.stack([m, m, torch.zeros_like(m)], dim=-1), vt)


def essential_from_fundamental(f: torch.Tensor, k1: torch.Tensor,
                               k2: torch.Tensor) -> torch.Tensor:
    """``E = K2ᵀ F K1``, projected to the essential manifold."""
    return _project_to_essential(_mm(_mm(k2.transpose(-1, -2), f), k1))


def estimate_essential(x1n: torch.Tensor, x2n: torch.Tensor,
                       weights: torch.Tensor | None = None) -> torch.Tensor:
    """The 8-point solve on normalized (K⁻¹) coordinates, projected to the
    essential manifold."""
    return _project_to_essential(estimate_fundamental(x1n, x2n, weights))


def _w_matrix(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                        dtype=like.dtype, device=like.device)


def decompose_essential(e: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """E -> (R1, R2, t), the candidate decompositions (as OpenCV's
    ``decomposeEssentialMat``): proper rotations and a unit translation,
    up to sign."""
    u, _, vt = torch.linalg.svd(e)
    u = u * torch.sign(_det3(u))[..., None, None]
    vt = vt * torch.sign(_det3(vt))[..., None, None]
    w = _w_matrix(e)
    r1 = _mm(_mm(u, w), vt)
    r2 = _mm(_mm(u, w.T), vt)
    return r1, r2, u[..., :, 2]


def _triangulate_two_view(x1: torch.Tensor, x2: torch.Tensor,
                          r: torch.Tensor, t: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Two-view DLT (``eigh``) with P1 = [I | 0], P2 = [R | t].

    x1, x2 (..., N, 2) normalized coordinates. Returns X (..., N, 3) in
    camera 1's frame and the depth in each camera.
    """
    eye = torch.cat([torch.eye(3, dtype=x1.dtype, device=x1.device),
                     torch.zeros((3, 1), dtype=x1.dtype, device=x1.device)],
                    dim=-1).expand(r.shape[:-2] + (3, 4))
    p2 = torch.cat([r, t[..., None]], dim=-1)
    p = torch.stack([eye, p2], dim=-3)                   # (..., 2, 3, 4)
    pts = torch.stack([x1, x2], dim=-2)                  # (..., N, 2, 2)
    x, _ = triangulate_points(pts, p[..., None, :, :, :], method="eigh")
    z1 = x[..., 2]
    z2 = (r[..., None, 2, :] * x).sum(-1) + t[..., None, 2]
    return x, z1, z2


def recover_pose(e: torch.Tensor, x1n: torch.Tensor, x2n: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (R, t) of the four decompositions with the most points in front
    of both cameras (as OpenCV's ``recoverPose``).

    x1n, x2n (..., N, 2) normalized coordinates. Returns (R (..., 3, 3),
    t (..., 3), n_good (...,)). The four candidates are triangulated in one
    batched solve.
    """
    r1, r2, t = decompose_essential(e)
    rs = torch.stack([r1, r1, r2, r2], dim=-3)           # (..., 4, 3, 3)
    ts = torch.stack([t, -t, t, -t], dim=-2)             # (..., 4, 3)
    _, z1, z2 = _triangulate_two_view(x1n[..., None, :, :],
                                      x2n[..., None, :, :], rs, ts)
    score = ((z1 > 0) & (z2 > 0)).sum(dim=-1)            # (..., 4)
    best = score.argmax(dim=-1)
    r = torch.gather(rs, -3, best[..., None, None, None].expand(
        best.shape + (1, 3, 3)))[..., 0, :, :]
    tt = torch.gather(ts, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    n_good = torch.gather(score, -1, best[..., None])[..., 0]
    return r, tt, n_good


def sampson_distance(f: torch.Tensor, x1: torch.Tensor,
                     x2: torch.Tensor) -> torch.Tensor:
    """First-order epipolar distance of each correspondence (..., N)."""
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    x2h = torch.cat([x2, torch.ones_like(x2[..., :1])], dim=-1)
    fx1 = _mv(f, x1h)
    ftx2 = _mv(f.transpose(-1, -2), x2h)
    num = (x2h * fx1).sum(-1) ** 2
    den = fx1[..., 0] ** 2 + fx1[..., 1] ** 2 + ftx2[..., 0] ** 2 \
        + ftx2[..., 1] ** 2
    return num / (den + 1e-12)


def ransac_fundamental(x1: torch.Tensor, x2: torch.Tensor,
                       num_hypotheses: int = 64, sample_size: int = 8,
                       inlier_thresh: float = 1e-3,
                       generator: torch.Generator | None = None,
                       idx: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Vectorized RANSAC with a static hypothesis count.

    Draws ``num_hypotheses`` subsets of ``sample_size`` distinct points at
    once (a repeated row makes the 8-point system rank-deficient), solves
    every candidate F in one batched 8-point solve, scores each by its
    Sampson inliers, takes the best by ``argmax`` on the device and refits
    on its inliers. x1, x2 (N, 2). ``generator`` draws the subsets on the
    points' device; ``idx`` (H, ``sample_size``) gives them instead.
    Returns (F (3, 3), inlier mask (N,)).
    """
    n = x1.shape[-2]
    if idx is None:
        keys = torch.rand((num_hypotheses, n), generator=generator,
                          device=x1.device)
        idx = keys.argsort(dim=-1)[:, :sample_size]
    idx = idx.to(x1.device)
    fs = estimate_fundamental(x1[idx], x2[idx])          # (H, 3, 3)
    d = sampson_distance(fs, x1[None], x2[None])         # (H, N)
    inliers = d < inlier_thresh
    best = inliers.sum(dim=-1).argmax()
    w = inliers[best].to(x1.dtype)
    f = estimate_fundamental(x1, x2, weights=w)
    return f, sampson_distance(f, x1, x2) < inlier_thresh
