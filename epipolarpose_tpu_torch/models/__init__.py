"""Model registry: ``pose_resnet`` (2D) and ``pose3d_resnet`` (integral 3D)
are the same module with ``depth_dim`` 1 vs >1; and the refinement unit
``PoseRefiner``."""

from epipolarpose_tpu_torch.models.convert import (  # noqa: F401
    from_jax_variables,
    refiner_from_jax_variables,
)
from epipolarpose_tpu_torch.models.pose_resnet import (  # noqa: F401
    PoseResNet,
    get_pose_net,
    is_row_split,
    partition_rows,
)
from epipolarpose_tpu_torch.models.refiner import PoseRefiner  # noqa: F401

_REGISTRY = {
    "pose_resnet": get_pose_net,
    "pose3d_resnet": get_pose_net,
}


def get_model(cfg, is_train: bool = True, generator=None):
    """Build the model named by ``cfg.MODEL.NAME``."""
    name = cfg.MODEL.NAME
    if name not in _REGISTRY:
        raise ValueError(f"unknown MODEL.NAME: {name}")
    return _REGISTRY[name](cfg, is_train, generator)
