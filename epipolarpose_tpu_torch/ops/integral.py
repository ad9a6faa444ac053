"""Integral pose regression: soft-argmax over per-joint volumes.

Counterpart of the JAX package's ``ops/integral.py``. The model's final
conv emits ``J*D`` channels, channel ``j*D + d``; softmax over each joint's
flattened (D, H, W) volume, then the expectation over the x/y/z index grids
gives sub-pixel coordinates normalized to [-0.5, 0.5). Here the volume is
NCHW (N, J*D, H, W). :func:`softmax_integral` takes the plain PyTorch
version for a CPU tensor and the CUDA kernel for a CUDA tensor
(``kernels/softargmax.py``).
"""

from __future__ import annotations

import torch

from epipolarpose_tpu_torch.kernels.softargmax import (  # noqa: F401
    softmax_integral,
)


def integral_to_camera_depth(coords: torch.Tensor,
                             depth_bound: float) -> torch.Tensor:
    """Undo the z normalization: normalized z -> root-relative depth."""
    return coords[..., 2] * (2.0 * depth_bound)
