"""Affine image warps on the device, with ``cv2.warpAffine`` semantics.

The port's copy of the JAX package's ``ops/warp.py``: bilinear crops of
(N, Hs, Ws, C) float images, computed on the device that holds the images
(CPU or card). ``M`` maps SOURCE to DEST pixels, as OpenCV's does; each
destination pixel samples the source through the inverse map, with pixel
centres at integer coordinates and samples outside the image read as 0
(``BORDER_CONSTANT``).

No loader calls these yet: the port's loaders warp on the host
(``data/imgproc.py::warp_affine_u8``), as the JAX package's do.
"""

from __future__ import annotations

import torch

from epipolarpose_tpu_torch.geometry.affine import invert_affine


def _inverse(M, images: torch.Tensor) -> torch.Tensor:
    """The dest -> source maps of ``M`` ((N, 2, 3) or (2, 3)), float32
    (N, 2, 3) on the images' device: the 2x2 part inverted in float64 and
    rounded once, the translation ``-(A^-1 t)`` in float32 as the JAX
    package computes it (for a rotation-free ``M`` the same bits as its
    ``invert_affine``)."""
    M = (M if isinstance(M, torch.Tensor) else torch.tensor(M)).to(
        images.device, torch.float32)
    M = M.expand(images.shape[0], 2, 3) if M.dim() == 2 else M
    A = invert_affine(M.double())[..., :2].float()
    t = M[..., 2]                                            # (N, 2)
    t_inv = -(A[..., 0] * t[:, None, 0] + A[..., 1] * t[:, None, 1])
    return torch.cat([A, t_inv[..., None]], dim=-1)


def warp_affine(images: torch.Tensor, M, output_size) -> torch.Tensor:
    """Batched bilinear affine warp (a gather of four neighbours).

    images: (N, Hs, Ws, C) float; M: (N, 2, 3) or (2, 3) source -> dest;
    output_size: (Wd, Hd). Returns (N, Hd, Wd, C).
    """
    Wd, Hd = int(output_size[0]), int(output_size[1])
    N, Hs, Ws, C = images.shape
    Minv = _inverse(M, images)
    dev = images.device
    gy, gx = torch.meshgrid(torch.arange(Hd, dtype=torch.float32, device=dev),
                            torch.arange(Wd, dtype=torch.float32, device=dev),
                            indexing="ij")                  # (Hd, Wd)
    m = Minv[:, :, :, None, None]
    sx = m[:, 0, 0] * gx + m[:, 0, 1] * gy + m[:, 0, 2]      # (N, Hd, Wd)
    sy = m[:, 1, 0] * gx + m[:, 1, 1] * gy + m[:, 1, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx = (sx - x0)[..., None].to(images.dtype)
    fy = (sy - y0)[..., None].to(images.dtype)
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    n = torch.arange(N, device=dev)[:, None, None]

    def sample(yi, xi):
        ok = (xi >= 0) & (xi < Ws) & (yi >= 0) & (yi < Hs)
        vals = images[n, yi.clamp(0, Hs - 1), xi.clamp(0, Ws - 1)]
        return vals * ok[..., None].to(images.dtype)

    top = sample(y0i, x0i) * (1 - fx) + sample(y0i, x0i + 1) * fx
    bot = sample(y0i + 1, x0i) * (1 - fx) + sample(y0i + 1, x0i + 1) * fx
    return top * (1 - fy) + bot * fy


def _taps(scale: torch.Tensor, shift: torch.Tensor, n_dst: int, n_src: int):
    """The nonzero entries of the JAX package's interpolation matrix
    ``K[n, d, s] = max(0, 1 - |scale * d + shift - s|)``: at most two a
    row, at s = floor(pos) and floor(pos) + 1. Returns their source
    indices (clamped) and weights (0 outside the source), (N, n_dst, 2)
    each."""
    d = torch.arange(n_dst, dtype=torch.float32, device=scale.device)
    pos = scale[:, None] * d + shift[:, None]                # (N, n_dst)
    s = torch.floor(pos)[..., None] + torch.tensor(
        [0.0, 1.0], device=scale.device)
    w = torch.clamp(1.0 - torch.abs(pos[..., None] - s), min=0.0)
    w = w * ((s >= 0) & (s < n_src)).to(w.dtype)
    return s.clamp(0, n_src - 1).to(torch.int64), w


def warp_affine_separable(images: torch.Tensor, M,
                          output_size) -> torch.Tensor:
    """Axis-aligned affine warp (scale and translation, no rotation or
    shear): ``out = Ky @ img @ Kx^T`` with per-image linear-interpolation
    matrices, as the JAX package computes it for the eval crops, the SS
    teacher crop and the flip test.

    Each matrix row has at most two nonzero weights, so each product is
    applied as two weighted row (then column) gathers: the same sums in
    float32, with no matmul for TF32 to round (JAX asks for
    ``Precision.HIGHEST``), whatever ``torch.backends`` allows.

    images: (N, Hs, Ws, C); M: (N, 2, 3) or (2, 3) source -> dest with
    zero off-diagonal terms (not checked: a rotation gives wrong output).
    Returns (N, Hd, Wd, C), samples outside the source 0.
    """
    Wd, Hd = int(output_size[0]), int(output_size[1])
    N, Hs, Ws, C = images.shape
    Minv = _inverse(M, images)
    iy, wy = _taps(Minv[:, 1, 1], Minv[:, 1, 2], Hd, Hs)     # (N, Hd, 2)
    ix, wx = _taps(Minv[:, 0, 0], Minv[:, 0, 2], Wd, Ws)     # (N, Wd, 2)
    n = torch.arange(N, device=images.device)[:, None]
    wy, wx = wy.to(images.dtype), wx.to(images.dtype)
    rows = (images[n, iy[..., 0]] * wy[..., 0, None, None]
            + images[n, iy[..., 1]] * wy[..., 1, None, None])  # (N, Hd, Ws, C)
    return (rows[n, :, ix[..., 0]].transpose(1, 2) * wx[:, None, :, 0, None]
            + rows[n, :, ix[..., 1]].transpose(1, 2) * wx[:, None, :, 1, None])
