"""Debug images (joint overlays, heatmap strips, the 3D skeleton) as PNG."""

from epipolarpose_tpu_torch.utils.vis import (  # noqa: F401
    plot_3d_skeleton,
    read_png,
    save_batch_heatmaps,
    save_batch_image_with_joints,
    save_debug_images,
    write_png,
)
