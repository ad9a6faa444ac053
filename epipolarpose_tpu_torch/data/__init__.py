"""Synthetic data: the multi-view camera rig and skeleton poses."""

from epipolarpose_tpu_torch.data.synthetic import (  # noqa: F401
    make_rig,
    skeleton_template,
    synth_skeleton_poses,
)
