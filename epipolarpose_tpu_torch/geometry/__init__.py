"""Crop geometry in float32 torch: affines, ``transform_preds``, flip-back."""

from epipolarpose_tpu_torch.geometry.affine import (  # noqa: F401
    affine_transform,
    flip_back,
    flip_back_volume,
    get_affine_transform,
    shift_right,
    transform_preds,
)
