"""Tensor ops of the eval path: soft-argmax decode and MPJPE metrics."""

from epipolarpose_tpu_torch.ops.integral import (  # noqa: F401
    integral_to_camera_depth,
    softmax_integral,
)
from epipolarpose_tpu_torch.ops.metrics import mpjpe, nmpjpe  # noqa: F401
