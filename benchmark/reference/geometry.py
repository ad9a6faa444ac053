"""Camera and crop geometry written out in plain PyTorch, for the
self-supervised step's reference and the traffic generator.

- Cameras (the Human3.6M release's model): ``X_cam = R (X_world - T)``;
  pixels ``f * distort(X_cam[:2] / X_cam[2]) + c`` with radial
  ``(k1, k2, k3)`` and Human3.6M's tangential ``(p1, p2)`` term.
- Crops: the three-point affine of a box (``center``, ``scale`` x 200 px,
  rotation) onto the crop, as the original EpipolarPose code builds it.
- Triangulation: per point, each view's two DLT rows ``x P3 - P1`` and
  ``y P3 - P2`` scaled to unit length and weighted by the view's
  confidence; the point is the right null vector of that system, taken
  here as the eigenvector of the smallest eigenvalue of AᵀA in float64.
  A point is judged by how far its algebraic residual lies above that
  least value (:func:`dlt_excess`): where the rays barely meet, points
  far apart fit almost equally well, and any rounding moves the solution
  along them.
"""

from __future__ import annotations

import math

import torch


def world_to_camera(x: torch.Tensor, R: torch.Tensor, T: torch.Tensor
                    ) -> torch.Tensor:
    """World points (..., N, 3), R (..., 3, 3), T (..., 3) -> camera frame."""
    return torch.einsum("...ij,...nj->...ni", R, x - T[..., None, :])


def distort(xx: torch.Tensor, k: torch.Tensor, p: torch.Tensor
            ) -> torch.Tensor:
    x, y = xx[..., 0], xx[..., 1]
    r2 = x * x + y * y
    radial = 1 + k[..., 0:1] * r2 + k[..., 1:2] * r2 ** 2 \
        + k[..., 2:3] * r2 ** 3
    tan = p[..., 0:1] * y + p[..., 1:2] * x
    return torch.stack([x * (radial + tan) + p[..., 1:2] * r2,
                        y * (radial + tan) + p[..., 0:1] * r2], -1)


def project(x_world: torch.Tensor, cam: dict) -> torch.Tensor:
    """World points (..., N, 3) -> distorted pixels (..., N, 2)."""
    xc = world_to_camera(x_world, cam["R"], cam["T"])
    xx = xc[..., :2] / xc[..., 2:3]
    return cam["f"][..., None, :] * distort(xx, cam["k"], cam["p"]) \
        + cam["c"][..., None, :]


def undistort(px: torch.Tensor, cam: dict, iters: int = 5) -> torch.Tensor:
    """Distorted pixels (..., N, 2) -> pinhole pixels: ``iters`` steps of
    the fixed point ``x = (obs - q r^2) / (radial + tan)``."""
    f, c = cam["f"][..., None, :], cam["c"][..., None, :]
    k, p = cam["k"], cam["p"]
    obs = (px - c) / f
    x = obs
    for _ in range(iters):
        r2 = (x * x).sum(-1)
        radial = 1 + k[..., 0:1] * r2 + k[..., 1:2] * r2 ** 2 \
            + k[..., 2:3] * r2 ** 3
        tan = p[..., 0:1] * x[..., 1] + p[..., 1:2] * x[..., 0]
        q = torch.stack([p[..., 1:2] * r2, p[..., 0:1] * r2], -1)
        x = (obs - q) / (radial + tan)[..., None]
    return x * f + c


def projection_matrix(cam: dict) -> torch.Tensor:
    """(..., 3, 4) pinhole ``K [R | -R T]``."""
    f, c = cam["f"], cam["c"]
    zero = torch.zeros_like(f[..., 0])
    K = torch.stack([torch.stack([f[..., 0], zero, c[..., 0]], -1),
                     torch.stack([zero, f[..., 1], c[..., 1]], -1),
                     torch.stack([zero, zero, torch.ones_like(zero)], -1)],
                    -2)
    t = -torch.einsum("...ij,...j->...i", cam["R"], cam["T"])
    return K @ torch.cat([cam["R"], t[..., None]], -1)


def dlt_normal(px: torch.Tensor, P: torch.Tensor, w: torch.Tensor,
               rnd=None) -> torch.Tensor:
    """AᵀA (G, J, 4, 4) of the weighted DLT system of pinhole pixels
    (G, V, J, 2), P (G, V, 3, 4) and weights (G, V, J): in float64, or
    with ``rnd`` in float32 with every input, row and product rounded by
    ``rnd`` (the control's lower precision)."""
    if rnd is not None:
        px, P, w = rnd(px.float()), rnd(P.float()), rnd(w.float())
        r0 = rnd(px[..., 0:1] * P[:, :, None, 2] - P[:, :, None, 0])
        r1 = rnd(px[..., 1:2] * P[:, :, None, 2] - P[:, :, None, 1])
        a = torch.cat([r0, r1], 1)
        a = rnd(a / (a.norm(dim=-1, keepdim=True) + 1e-12))
        a = rnd(a * torch.cat([w, w], 1)[..., None])
        return rnd(torch.einsum("gvji,gvjk->gjik", a, a))
    px, P, w = px.double(), P.double(), w.double()
    x, y = px[..., 0:1], px[..., 1:2]                     # (G, V, J, 1)
    r0 = x * P[:, :, None, 2] - P[:, :, None, 0]          # (G, V, J, 4)
    r1 = y * P[:, :, None, 2] - P[:, :, None, 1]
    a = torch.cat([r0, r1], 1)                            # (G, 2V, J, 4)
    a = a / (a.norm(dim=-1, keepdim=True) + 1e-12)
    a = a * torch.cat([w, w], 1)[..., None]
    return torch.einsum("gvji,gvjk->gjik", a, a)


def triangulate(ata: torch.Tensor) -> torch.Tensor:
    """The points (G, J, 3) of :func:`dlt_normal`'s systems: the
    eigenvector of AᵀA's smallest eigenvalue, dehomogenised."""
    v = torch.linalg.eigh(ata)[1][..., 0]
    return v[..., :3] / v[..., 3:4]


def dlt_excess(ata: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """How far points (G, J, 3) fall short of the least squares: the
    Rayleigh quotient of AᵀA at the homogeneous point over the unit
    sphere, less the smallest eigenvalue, over the mean eigenvalue. 0 at
    the solution, whatever its conditioning."""
    xh = torch.cat([x.double(), torch.ones_like(x[..., :1]).double()], -1)
    xh = xh / xh.norm(dim=-1, keepdim=True)
    f = torch.einsum("gji,gjik,gjk->gj", xh, ata, xh)
    lam = torch.linalg.eigvalsh(ata)[..., 0]
    return (f - lam) / (ata.diagonal(dim1=-2, dim2=-1).sum(-1) / 4)


def affine(center: torch.Tensor, scale: torch.Tensor, rot: torch.Tensor,
           size, inv: bool = False) -> torch.Tensor:
    """(..., 2, 3) affine taking the box to a ``size`` (w, h) crop (or
    back, ``inv``): its centre, the point half a box width above it
    (turned by ``rot`` degrees) and the third point of the right angle."""
    src_w = scale[..., 0] * 200.0
    rad = rot * math.pi / 180.0
    sn, cs = torch.sin(rad), torch.cos(rad)
    src_dir = torch.stack([-src_w * -0.5 * sn, src_w * -0.5 * cs], -1)
    ones = torch.ones_like(src_w)
    dst0 = torch.stack([size[0] * 0.5 * ones, size[1] * 0.5 * ones], -1)
    dst_dir = torch.stack([0 * ones, -size[0] * 0.5 * ones], -1)

    def third(a, b):
        d = a - b
        return b + torch.stack([-d[..., 1], d[..., 0]], -1)

    src = torch.stack([center, center + src_dir,
                       third(center, center + src_dir)], -2)
    dst = torch.stack([dst0, dst0 + dst_dir, third(dst0, dst0 + dst_dir)],
                      -2)
    if inv:
        src, dst = dst, src
    # solve [x y 1] M^T = dst for the three points
    a = torch.cat([src, torch.ones_like(src[..., :1])], -1).double()
    m = torch.linalg.solve(a, dst.double()).transpose(-1, -2)
    return m.to(center.dtype)


def apply_affine(pts: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Points (..., N, 2) through affines (..., 2, 3)."""
    return torch.einsum("...ij,...nj->...ni", m[..., :2], pts) \
        + m[..., None, :, 2]
