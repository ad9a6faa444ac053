"""Eval step and validation loop of the port."""

from epipolarpose_tpu_torch.core.function import (  # noqa: F401
    AverageMeter,
    validate,
)
from epipolarpose_tpu_torch.core.steps import (  # noqa: F401
    make_eval_step,
    normalize_images,
)
