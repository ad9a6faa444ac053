"""Geometry in float32 torch: crop affines, the H36M camera model,
batched DLT triangulation, Procrustes alignment, epipolar geometry and
the rig self-calibration (elementwise arithmetic, never TF32)."""

from epipolarpose_tpu_torch.geometry.affine import (  # noqa: F401
    affine_transform,
    flip_back,
    flip_back_volume,
    fliplr_joints,
    get_affine_transform,
    get_affine_transform_np,
    invert_affine,
    shift_right,
    transform_preds,
)
from epipolarpose_tpu_torch.geometry.camera import (  # noqa: F401
    Camera,
    camera_to_world_frame,
    normalized_camera_coords,
    pixel2cam,
    project_point_radial,
    undistort_points,
    world_to_camera_frame,
)
from epipolarpose_tpu_torch.geometry.epipolar import (  # noqa: F401
    decompose_essential,
    essential_from_fundamental,
    estimate_essential,
    estimate_fundamental,
    ransac_fundamental,
    recover_pose,
    sampson_distance,
)
from epipolarpose_tpu_torch.geometry.procrustes import (  # noqa: F401
    compute_similarity_transform,
    procrustes_align,
)
from epipolarpose_tpu_torch.geometry.triangulation import (  # noqa: F401
    build_dlt_system,
    reprojection_error,
    triangulate,
    triangulate_dlt,
    triangulate_points,
)
from epipolarpose_tpu_torch.geometry.rig import (  # noqa: F401
    estimate_rig,
    pseudo_gt_uncalibrated,
)
