"""cv2-compatible crop affines and flip utilities, batched in float32 torch.

Counterpart of the JAX package's ``geometry/affine.py``, with the same
conventions:

- ``center``: (x, y) person center in source-image pixels.
- ``scale``:  (sx, sy) in "200-pixel units"; the crop box is ``scale*200``
  source pixels.
- ``rot``:    rotation in degrees.
- ``output_size``: (w, h) of the destination crop.
- ``get_affine_transform`` returns a (..., 2, 3) matrix mapping SOURCE
  pixels to DEST pixels, as ``cv2.getAffineTransform`` does (``inv=True``
  maps back).

Model outputs are NCHW here (the port's ``PoseResNet`` layout), so the
flip helpers act on the last axis for W and on the channel axis for joints.
Points are mapped with elementwise float32 arithmetic, never a matmul, so
no TF32 setting can lower their precision.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def get_dir(src_point: torch.Tensor, rot_rad: torch.Tensor) -> torch.Tensor:
    """Rotate 2D vectors (..., 2) by ``rot_rad`` radians."""
    sn, cs = torch.sin(rot_rad), torch.cos(rot_rad)
    x, y = src_point[..., 0], src_point[..., 1]
    return torch.stack([x * cs - y * sn, x * sn + y * cs], dim=-1)


def get_3rd_point(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Third triangle vertex: b + perp(a - b)."""
    d = a - b
    return b + torch.stack([-d[..., 1], d[..., 0]], dim=-1)


def _solve_affine(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Exact 2x3 affine M with dst_i = M @ [src_i; 1]; src/dst (..., 3, 2)."""
    ones = torch.ones(src.shape[:-1] + (1,), dtype=src.dtype,
                      device=src.device)
    a = torch.cat([src, ones], dim=-1)                  # (..., 3, 3)
    # solve_ex: no host sync on the info check (inputs are well posed)
    x = torch.linalg.solve_ex(a, dst).result            # (..., 3, 2)
    return x.transpose(-1, -2)


def get_affine_transform(center, scale, rot, output_size: Sequence[float],
                         shift=(0.0, 0.0), inv: bool = False) -> torch.Tensor:
    """The 3-point crop affine; args broadcast over leading batch dims.

    Returns (..., 2, 3) float32 on ``center``'s device.
    """
    center = _f32(center)
    dev = center.device
    scale = _f32(scale, dev)
    if scale.ndim == center.ndim - 1 or scale.ndim == 0:
        scale = scale[..., None] * torch.ones_like(center)
    shift = _f32(shift, dev)
    rot = _f32(rot, dev)

    scale_tmp = scale * 200.0
    src_w = scale_tmp[..., 0]
    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    ones = torch.ones_like(src_w)

    rot_rad = math.pi * rot / 180.0
    src_dir = get_dir(torch.stack([torch.zeros_like(src_w), src_w * -0.5],
                                  dim=-1), rot_rad)
    dst_dir = torch.stack([torch.zeros_like(src_w), (dst_w * -0.5) * ones],
                          dim=-1)

    src0 = center + scale_tmp * shift
    src1 = center + src_dir + scale_tmp * shift
    dst0 = torch.stack([dst_w * 0.5 * ones, dst_h * 0.5 * ones], dim=-1)
    dst1 = dst0 + dst_dir
    src = torch.stack([src0, src1, get_3rd_point(src0, src1)], dim=-2)
    dst = torch.stack([dst0, dst1, get_3rd_point(dst0, dst1)], dim=-2)
    if inv:
        src, dst = dst, src
    return _solve_affine(src, dst)


def affine_transform(pt: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Apply (..., 2, 3) affines to points (..., 2)."""
    x, y = pt[..., 0], pt[..., 1]
    return torch.stack([m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2],
                        m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2]],
                       dim=-1)


def transform_preds(coords: torch.Tensor, center, scale,
                    output_size: Sequence[float]) -> torch.Tensor:
    """Map crop-space predictions (..., J, 2) back to source pixels.

    ``center``/``scale``: (..., 2); ``output_size``: (w, h) of the crop.
    """
    m = get_affine_transform(center, scale, 0.0, output_size, inv=True)
    return affine_transform(coords, m[..., None, :, :])


def _pair_permutation(num_joints: int, matched_parts) -> list[int]:
    perm = list(range(num_joints))
    for a, b in matched_parts:
        perm[a], perm[b] = perm[b], perm[a]
    return perm


def flip_back(heatmaps: torch.Tensor, matched_parts) -> torch.Tensor:
    """Un-flip NCHW heatmaps from a flipped forward: flip W, swap pairs."""
    perm = _pair_permutation(heatmaps.shape[-3], matched_parts)
    return heatmaps.flip(-1)[..., perm, :, :]


def flip_back_volume(logits: torch.Tensor, matched_parts, num_joints: int,
                     depth_dim: int) -> torch.Tensor:
    """``flip_back`` for the integral head's (N, J*D, H, W) output.

    Channel ``j*D + d`` holds depth bin d of joint j, so left/right swaps
    move whole blocks of D channels; depth is unchanged by a mirror.
    """
    if depth_dim == 1:
        return flip_back(logits, matched_parts)
    n, _, h, w = logits.shape
    vol = logits.reshape(n, num_joints, depth_dim, h, w).flip(-1)
    vol = vol[:, _pair_permutation(num_joints, matched_parts)]
    return vol.reshape(n, num_joints * depth_dim, h, w)


def shift_right(heatmaps: torch.Tensor) -> torch.Tensor:
    """Shift maps one pixel right along W, keeping column 0 (SHIFT_HEATMAP)."""
    return torch.cat([heatmaps[..., :1], heatmaps[..., :-1]], dim=-1)
