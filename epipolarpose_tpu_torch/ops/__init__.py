"""Tensor ops: soft-argmax decode, integral targets, gaussian heatmap
targets and decode, losses, and the metrics (accuracy, PCK, PCKh, the
MPJPE family, PSS, 3DHP's PCK3D and AUC)."""

from epipolarpose_tpu_torch.ops.heatmap import (  # noqa: F401
    generate_target,
    get_final_preds,
    get_max_preds,
    post_process_preds,
)
from epipolarpose_tpu_torch.ops.integral import (  # noqa: F401
    generate_integral_target,
    integral_to_camera_depth,
    softmax_integral,
)
from epipolarpose_tpu_torch.ops.losses import (  # noqa: F401
    integral_l1_loss,
    joints_mse_loss,
    make_loss,
)
from epipolarpose_tpu_torch.ops.metrics import (  # noqa: F401
    auc3d,
    fit_pss_centers,
    heatmap_accuracy,
    kmeans,
    mpjpe,
    nmpjpe,
    pa_mpjpe,
    pck,
    pck3d,
    pckh,
    pss,
)
