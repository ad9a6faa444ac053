"""Integral pose regression: soft-argmax over per-joint volumes.

Counterpart of the JAX package's ``ops/integral.py``. The model's final
conv emits ``J*D`` channels, channel ``j*D + d``; softmax over each joint's
flattened (D, H, W) volume, then the expectation over the x/y/z index grids
gives sub-pixel coordinates normalized to [-0.5, 0.5). Here the volume is
NCHW (N, J*D, H, W). :func:`softmax_integral` takes the CUDA kernels for
a CUDA tensor and their plain twins for a CPU tensor
(``kernels/softargmax.py``), with a gradient on both.
"""

from __future__ import annotations

import torch

from epipolarpose_tpu_torch.kernels.softargmax import (  # noqa: F401
    softmax_integral,
)


def generate_integral_target(joints_img: torch.Tensor,
                             joints_vis: torch.Tensor, image_size,
                             depth_bound: float | None = None,
                             joints_depth: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized integral regression targets (..., J, 3) and per-joint
    weights (..., J) float32.

    joints_img: (..., J, 2+) crop-space pixels; joints_vis: (..., J) or
    (..., J, k), the first entry read; joints_depth: (..., J) root-relative
    depth in the units of ``depth_bound``, or None for 2D. A joint weighs
    ``vis`` when x, y lie in [-0.5, 0.5) and |z| <= 0.5, else 0.
    """
    if joints_vis.ndim == joints_img.ndim:
        joints_vis = joints_vis[..., 0]
    x = joints_img[..., 0] / image_size[0] - 0.5
    y = joints_img[..., 1] / image_size[1] - 0.5
    if joints_depth is None or depth_bound is None:
        z = torch.zeros_like(x)
        z_ok = torch.ones_like(x, dtype=torch.bool)
    else:
        z = joints_depth / (2.0 * depth_bound)     # [-bound, bound] -> +-0.5
        z_ok = z.abs() <= 0.5
    inside = (x >= -0.5) & (x < 0.5) & (y >= -0.5) & (y < 0.5) & z_ok
    weight = joints_vis.to(torch.float32) * inside.to(torch.float32)
    return torch.stack([x, y, z], dim=-1), weight


def integral_to_camera_depth(coords: torch.Tensor,
                             depth_bound: float) -> torch.Tensor:
    """Undo the z normalization: normalized z -> root-relative depth."""
    return coords[..., 2] * (2.0 * depth_bound)
