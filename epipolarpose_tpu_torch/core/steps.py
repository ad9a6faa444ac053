"""The train and eval steps, for ``TARGET_TYPE: integral`` and ``gaussian``.

Counterparts of the JAX package's ``core/steps.py::make_train_step`` and
``make_eval_step``. A batch is what the JAX loaders ship: ``input`` uint8
crops (N, H, W, 3) NHWC; for training ``joints`` (N, J, 2+) crop pixels,
``joints_vis`` (N, J) or (N, J, k) and, in 3D, ``joints_3d`` (N, J, 3)
in mm; for eval ``center`` and ``scale`` (N, 2). Numpy arrays or tensors,
moved to the step's device. The model runs NCHW: a gaussian model's
heatmaps are (N, J, H, W).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from epipolarpose_tpu_torch.geometry.affine import (flip_back,
                                                    flip_back_volume,
                                                    shift_right,
                                                    transform_preds)
from epipolarpose_tpu_torch.ops.heatmap import (generate_target,
                                                get_final_preds)
from epipolarpose_tpu_torch.ops.integral import (generate_integral_target,
                                                 integral_to_camera_depth,
                                                 softmax_integral)
from epipolarpose_tpu_torch.ops.losses import (integral_l1_loss,
                                               joints_mse_loss)
from epipolarpose_tpu_torch.ops.metrics import heatmap_accuracy

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


def _root_relative_depth(joints_3d: torch.Tensor, root_idx: int
                         ) -> torch.Tensor:
    z = joints_3d[..., 2]
    return z - z[..., root_idx:root_idx + 1]


def configure_backends(cfg) -> None:
    """Set PyTorch's process-wide GPU math flags for a config.

    ``CUDNN.*`` as the reference's scripts set them. TF32 is off for both
    cuDNN convolutions and cuBLAS matmuls: float32 configs are the ones
    held against the JAX package, and TF32 keeps about three digits.
    bfloat16 configs do not reach TF32 either way. The entry point calls
    this once, as the reference's scripts do; the step builders do not.
    """
    torch.backends.cudnn.benchmark = bool(cfg.CUDNN.BENCHMARK)
    torch.backends.cudnn.deterministic = bool(cfg.CUDNN.DETERMINISTIC)
    torch.backends.cudnn.enabled = bool(cfg.CUDNN.ENABLED)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _check_target_type(cfg) -> str:
    target_type = str(cfg.MODEL.EXTRA.TARGET_TYPE)
    if target_type not in ("integral", "gaussian"):
        raise ValueError(f"unknown TARGET_TYPE: {target_type}")
    return target_type


def optimizer_step(state, loss: torch.Tensor) -> None:
    """Backward of ``loss``, then one step of ``state``'s optimizer and
    schedule."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1


def integral_update(state, model: torch.nn.Module, x: torch.Tensor,
                    target: torch.Tensor, tw: torch.Tensor | None,
                    num_joints: int, depth_dim: int,
                    decode: Callable = softmax_integral) -> torch.Tensor:
    """One optimizer step of the integral model on NCHW images ``x``: the
    forward in train mode, ``decode``, the L1 loss, the backward and the
    update. Returns the loss, detached."""
    model.train()
    coords = decode(model(x), num_joints, depth_dim)
    loss = integral_l1_loss(coords, target, tw)
    optimizer_step(state, loss)
    return loss.detach()


def make_train_step(cfg, model: torch.nn.Module,
                    device: str | torch.device = "cuda",
                    decode: Callable = softmax_integral):
    """Build ``step(state, batch) -> (state, metrics)``.

    One optimizer step of ``state``, a ``TrainState`` whose ``model`` is
    ``model`` itself (its optimizer holds that model's parameters; any
    other model, a copy included, raises): the forward in train mode (BN
    on batch statistics, which it updates), the loss, the backward,
    ``optimizer.step()`` and ``scheduler.step()``.

    - ``integral``: the soft-argmax (``decode``: the CUDA kernels on the
      card, with their backward) and the integral L1 loss; metrics
      ``{"loss"}``.
    - ``gaussian``: Gaussian heatmap targets and the heatmap MSE; metrics
      ``{"loss", "acc"}``, ``acc`` the heatmap accuracy of this step's
      forward.

    The metrics stay on the device: nothing waits for the card. ``model``
    is moved to ``device``.
    """
    target_type = _check_target_type(cfg)
    device = torch.device(device)
    image_size = tuple(float(v) for v in cfg.MODEL.IMAGE_SIZE)
    heatmap_size = tuple(int(v) for v in cfg.MODEL.EXTRA.HEATMAP_SIZE)
    sigma = float(cfg.MODEL.EXTRA.SIGMA)
    depth_dim = int(cfg.MODEL.EXTRA.DEPTH_DIM)
    depth_bound = float(cfg.MODEL.EXTRA.get("DEPTH_BOUND", 1000.0))
    num_joints = int(cfg.MODEL.NUM_JOINTS)
    use_tw = bool(cfg.LOSS.USE_TARGET_WEIGHT)
    root_idx = 0
    model = model.to(device)

    def to_device(a) -> torch.Tensor:
        return torch.as_tensor(a).to(device, non_blocking=True)

    def step(state, batch):
        if state.model is not model:
            raise ValueError("the train state holds another model than the "
                             "one this step was built for")
        x = normalize_images(to_device(batch["input"]))
        x = x.permute(0, 3, 1, 2).contiguous()
        joints = to_device(batch["joints"]).float()
        vis = to_device(batch["joints_vis"])
        if target_type == "gaussian":
            target, tw = generate_target(joints, vis, heatmap_size, sigma,
                                         image_size)
            model.train()
            out = model(x)
            loss = joints_mse_loss(out, target, tw if use_tw else None)
            optimizer_step(state, loss)
            with torch.no_grad():
                acc = heatmap_accuracy(out.detach(), target)[1]
            return state, {"loss": loss.detach(), "acc": acc}
        depth = None
        if "joints_3d" in batch:
            depth = _root_relative_depth(
                to_device(batch["joints_3d"]).float(), root_idx)
        target, tw = generate_integral_target(
            joints, vis, image_size, depth_bound=depth_bound,
            joints_depth=depth)
        loss = integral_update(state, model, x, target,
                               tw if use_tw else None, num_joints, depth_dim,
                               decode)
        return state, {"loss": loss}

    return step


def make_eval_step(cfg, model: torch.nn.Module, flip_pairs=(),
                   device: str | torch.device = "cuda",
                   decode: Callable = softmax_integral):
    """Build ``step(batch) -> dict`` of predictions in source-image pixels.

    - ``integral``: ``{"preds": (N, J, 3) float32}``, (x, y) in pixels and
      z in root-relative mm; ``decode`` is the soft-argmax (the default
      takes the CUDA kernel on the card; a caller may pass the plain
      version to compare).
    - ``gaussian``: ``{"preds": (N, J, 2) float32, "maxvals": (N, J)}``
      from the argmax decode (with the quarter offset when
      ``TEST.POST_PROCESS``).

    With ``TEST.FLIP_TEST`` the flipped forward is flipped back (and
    shifted one pixel right with ``TEST.SHIFT_HEATMAP``) and averaged in.
    ``model`` is moved to ``device``. Each call puts it in eval mode, as
    the JAX step passes ``train=False`` on each call: BN runs on its
    running statistics and writes no buffer, so a train step built on the
    same model may run before and after it.
    """
    target_type = _check_target_type(cfg)
    device = torch.device(device)
    image_size = tuple(float(v) for v in cfg.MODEL.IMAGE_SIZE)
    depth_dim = int(cfg.MODEL.EXTRA.DEPTH_DIM)
    depth_bound = float(cfg.MODEL.EXTRA.get("DEPTH_BOUND", 1000.0))
    num_joints = int(cfg.MODEL.NUM_JOINTS)
    flip_test = bool(cfg.TEST.FLIP_TEST)
    shift_heatmap = bool(cfg.TEST.SHIFT_HEATMAP)
    post_process = bool(cfg.TEST.POST_PROCESS)
    model = model.to(device)
    size = torch.tensor(image_size, dtype=torch.float32, device=device)

    @torch.inference_mode()
    def step(batch) -> dict[str, torch.Tensor]:
        model.eval()
        imgs = torch.as_tensor(batch["input"]).to(device, non_blocking=True)
        x = normalize_images(imgs).permute(0, 3, 1, 2).contiguous()
        out = model(x)
        if flip_test:
            out_f = model(x.flip(-1))
            if target_type == "gaussian":
                out_f = flip_back(out_f, flip_pairs)
            else:
                out_f = flip_back_volume(out_f, flip_pairs, num_joints,
                                         depth_dim)
            if shift_heatmap:
                out_f = shift_right(out_f)
            out = (out + out_f) * 0.5
        center = torch.as_tensor(batch["center"]).to(device)
        scale = torch.as_tensor(batch["scale"]).to(device)
        if target_type == "gaussian":
            preds, maxvals = get_final_preds(out, center, scale,
                                             post_process)
            return {"preds": preds, "maxvals": maxvals}
        coords = decode(out, num_joints, depth_dim)
        # normalized -> crop pixels -> source pixels; z -> mm
        xy_crop = (coords[..., :2] + 0.5) * size
        xy_src = transform_preds(xy_crop, center, scale, image_size)
        z_mm = integral_to_camera_depth(coords, depth_bound)
        return {"preds": torch.cat([xy_src, z_mm[..., None]], dim=-1)}

    return step
