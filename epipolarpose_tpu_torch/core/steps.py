"""The eval step: normalize, forward (+ flipped forward), decode, un-crop.

Counterpart of the JAX package's ``core/steps.py::make_eval_step`` for
``TARGET_TYPE: integral``. A batch is what the JAX loaders ship: ``input``
uint8 crops (N, H, W, 3) NHWC, ``center`` and ``scale`` (N, 2); numpy
arrays or tensors, moved to the step's device. The model runs NCHW.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from epipolarpose_tpu_torch.geometry.affine import (flip_back_volume,
                                                    shift_right,
                                                    transform_preds)
from epipolarpose_tpu_torch.ops.integral import (integral_to_camera_depth,
                                                 softmax_integral)

# ImageNet mean/std (torchvision Normalize constants of the reference)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_images(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 in [0, 255] or float in [0, 1] -> normalized f32."""
    if not torch.is_floating_point(x):
        x = x.to(torch.float32) * (1.0 / 255.0)
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x.to(torch.float32) - mean) / std


def configure_backends(cfg) -> None:
    """Set PyTorch's process-wide GPU math flags for a config.

    ``CUDNN.*`` as the reference's scripts set them. TF32 is off for both
    cuDNN convolutions and cuBLAS matmuls: float32 configs are the ones
    held against the JAX package, and TF32 keeps about three digits.
    bfloat16 configs do not reach TF32 either way. The entry point calls
    this once, as the reference's scripts do; ``make_eval_step`` does not.
    """
    torch.backends.cudnn.benchmark = bool(cfg.CUDNN.BENCHMARK)
    torch.backends.cudnn.deterministic = bool(cfg.CUDNN.DETERMINISTIC)
    torch.backends.cudnn.enabled = bool(cfg.CUDNN.ENABLED)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def make_eval_step(cfg, model: torch.nn.Module, flip_pairs=(),
                   device: str | torch.device = "cuda",
                   decode: Callable = softmax_integral):
    """Build ``step(batch) -> {"preds": (N, J, 3) float32}``.

    preds hold (x, y) in source-image pixels and z in root-relative mm,
    as the JAX step returns them. ``model`` is moved to ``device`` and put
    in eval mode. ``decode`` is the soft-argmax; the default takes the CUDA
    kernel on the card (a caller may pass the plain version to compare).
    """
    if cfg.MODEL.EXTRA.TARGET_TYPE != "integral":
        raise NotImplementedError("gaussian eval needs the 2D decode ops, "
                                  "which are not ported yet")
    device = torch.device(device)
    image_size = tuple(float(v) for v in cfg.MODEL.IMAGE_SIZE)
    depth_dim = int(cfg.MODEL.EXTRA.DEPTH_DIM)
    depth_bound = float(cfg.MODEL.EXTRA.DEPTH_BOUND)
    num_joints = int(cfg.MODEL.NUM_JOINTS)
    flip_test = bool(cfg.TEST.FLIP_TEST)
    shift_heatmap = bool(cfg.TEST.SHIFT_HEATMAP)
    model = model.to(device).eval()
    size = torch.tensor(image_size, dtype=torch.float32, device=device)

    @torch.inference_mode()
    def step(batch) -> dict[str, torch.Tensor]:
        imgs = torch.as_tensor(batch["input"]).to(device, non_blocking=True)
        x = normalize_images(imgs).permute(0, 3, 1, 2).contiguous()
        out = model(x)
        if flip_test:
            out_f = flip_back_volume(model(x.flip(-1)), flip_pairs,
                                     num_joints, depth_dim)
            if shift_heatmap:
                out_f = shift_right(out_f)
            out = (out + out_f) * 0.5
        coords = decode(out, num_joints, depth_dim)
        # normalized -> crop pixels -> source pixels; z -> mm
        xy_crop = (coords[..., :2] + 0.5) * size
        center = torch.as_tensor(batch["center"]).to(device)
        scale = torch.as_tensor(batch["scale"]).to(device)
        xy_src = transform_preds(xy_crop, center, scale, image_size)
        z_mm = integral_to_camera_depth(coords, depth_bound)
        return {"preds": torch.cat([xy_src, z_mm[..., None]], dim=-1)}

    return step
