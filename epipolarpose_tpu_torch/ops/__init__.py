"""Tensor ops: soft-argmax decode, integral targets, losses, MPJPE."""

from epipolarpose_tpu_torch.ops.integral import (  # noqa: F401
    generate_integral_target,
    integral_to_camera_depth,
    softmax_integral,
)
from epipolarpose_tpu_torch.ops.losses import (  # noqa: F401
    integral_l1_loss,
    make_loss,
)
from epipolarpose_tpu_torch.ops.metrics import mpjpe, nmpjpe  # noqa: F401
