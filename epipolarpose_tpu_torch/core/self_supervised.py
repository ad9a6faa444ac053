"""The self-supervised 3D train step: 2D teacher -> triangulate -> student.

Counterpart of the JAX package's ``core/self_supervised.py``. One step of
a multi-view batch of G groups of V views:

    frozen 2D teacher on the G*V clean crops (no_grad, eval mode)
      -> argmax + quarter-offset decode -> source pixels
      -> ``TPU.SS_CAMERAS: given``: undistortion -> confidence-weighted
         batched DLT (``fast``: the CUDA kernel ``epk_triangulate`` on the
         card) with the batch's cameras;
         ``estimated``: the rig recovered from the detections
         (``geometry/rig.py``: essential matrices, pose recovery, V - 1
         two-view triangulations, then one V-view triangulation, all
         ``fast``), no extrinsics read
      -> reprojection into each view -> integral targets (dual-crop remap
         with its left/right swap when the batch carries ``input_aug``)
      -> the student's train step (soft-argmax kernels, L1, Adam).

A batch holds ``input`` uint8 (G, V, H, W, 3), ``center`` and ``scale``
(G, V, 2), ``camera`` (a :class:`Camera` with (G, V, ...) fields) and
optionally ``joints_vis`` (G, V, J); ``det_src`` (G, V, J, 2) source
pixels with ``det_conf`` (G, V, J) in place of the teacher; ``input_aug``
(G, V, H, W, 3), ``aug_M`` (G, V, 2, 3) and ``aug_flip`` (G, V) for the
dual crop. Numpy arrays or tensors, moved to the step's device.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from epipolarpose_tpu_torch.core.checkpoint import (load_model_variables,
                                                    read_state_dict)
from epipolarpose_tpu_torch.core.refine import make_refiner_apply
from epipolarpose_tpu_torch.core.steps import (integral_update,
                                               normalize_images)
from epipolarpose_tpu_torch.geometry.affine import (affine_transform,
                                                    get_affine_transform,
                                                    transform_preds)
from epipolarpose_tpu_torch.geometry.camera import (Camera,
                                                    project_point_radial,
                                                    undistort_points,
                                                    world_to_camera_frame)
from epipolarpose_tpu_torch.geometry.rig import pseudo_gt_uncalibrated
from epipolarpose_tpu_torch.geometry.triangulation import triangulate
from epipolarpose_tpu_torch.kernels.triangulate import triangulate_fast
from epipolarpose_tpu_torch.models.pose_resnet import PoseResNet
from epipolarpose_tpu_torch.models.refiner import PoseRefiner
from epipolarpose_tpu_torch.ops.heatmap import (get_max_preds,
                                                post_process_preds)
from epipolarpose_tpu_torch.ops.integral import (generate_integral_target,
                                                 softmax_integral)


class Teacher(nn.Module):
    """The frozen 2D heatmap network: a ``depth_dim=1`` PoseResNet whose
    parameters need no gradient. Every call puts it in eval mode and runs
    it under ``no_grad``: its BN uses the running statistics and never
    writes them, whatever mode a caller left it in."""

    def __init__(self, model: PoseResNet):
        super().__init__()
        self.model = model.requires_grad_(False).eval()

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        """Normalized NCHW crops -> (B, J, h, w) heatmaps."""
        self.model.eval()
        with torch.no_grad():
            return self.model(imgs)


def teacher_net(cfg) -> PoseResNet:
    """The teacher's network for ``cfg``: the student's backbone and head
    with one depth bin (the JAX package's ``load_teacher`` model)."""
    extra = cfg.MODEL.EXTRA
    return PoseResNet(
        num_layers=int(extra.NUM_LAYERS),
        num_joints=int(cfg.MODEL.NUM_JOINTS), depth_dim=1,
        num_deconv_filters=tuple(extra.NUM_DECONV_FILTERS),
        num_deconv_kernels=tuple(extra.NUM_DECONV_KERNELS),
        final_conv_kernel=int(extra.FINAL_CONV_KERNEL),
        dtype=(torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
               else torch.float32))


def load_teacher(cfg, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None) -> Teacher:
    """The frozen teacher named by ``cfg.MODEL.PRETRAINED``.

    ``''``: random weights drawn from ``generator`` (the pipeline runs, the
    pseudo-GT is noise). Otherwise any checkpoint path
    ``core/checkpoint.py::resolve_checkpoint_path`` takes (a reference
    ``.pth`` / ``.pth.tar``, or the port's ``checkpoints`` directories),
    loaded with ``strict=True``. An orbax directory raises: the port does
    not import JAX; export it to ``.pth`` with the JAX package's
    ``models/torch_convert.py`` first.
    """
    model = teacher_net(cfg)
    path = str(cfg.MODEL.PRETRAINED)
    if path:
        load_model_variables(model, path)
    else:
        model.init_weights(generator)
    return Teacher(model).to(device)


def load_refiner(cfg, path: str, device: str | torch.device = "cuda"
                 ) -> Callable:
    """A trained refinement unit (a ``.pth`` that
    ``scripts/train_refiner.py`` wrote) as a callable for the SS step's
    ``refiner``: root-relative (N, ``NUM_JOINTS``, 3) poses in mm ->
    refined ones, in eval mode with no gradient. Its width and depth are
    read from the file's shapes."""
    sd = read_state_dict(path)
    hidden = int(sd["stem.linear.weight"].shape[0])
    blocks = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    model = PoseRefiner(int(cfg.MODEL.NUM_JOINTS), hidden, blocks)
    model.load_state_dict(sd, strict=True)
    model = model.to(device).eval()
    apply = make_refiner_apply(model)

    def refine(poses):
        return apply(None, torch.as_tensor(poses, dtype=torch.float32,
                                           device=device))
    return refine


def teacher_detect(cfg, teacher: Teacher, imgs: torch.Tensor,
                   centers: torch.Tensor, scales: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher heatmaps -> source-image 2D joints and confidences.

    imgs (B, 3, H, W) normalized crops; centers, scales (B, 2). Returns
    (joints_src (B, J, 2), conf (B, J)), both float32. The heatmap size is
    read from the teacher's output, not the config, so a teacher may run
    on smaller crops.
    """
    hm = teacher(imgs)
    hm_h, hm_w = hm.shape[-2:]
    preds, maxvals = get_max_preds(hm)
    preds = post_process_preds(hm, preds)
    joints_src = transform_preds(preds, centers, scales, (hm_w, hm_h))
    teacher_detect.calls += 1
    return joints_src.float(), maxvals.float()


# calls of the teacher's forward and decode (no hand-written kernel)
teacher_detect.calls = 0


def triangulate_for(method: str) -> Callable:
    """The solver of ``TPU.TRIANGULATION.METHOD``: ``fast`` is
    :func:`triangulate_fast` (the kernel on the card, its plain twin on
    the CPU); ``svd`` and ``eigh`` go through ``torch.linalg``."""
    if method == "fast":
        return triangulate_fast
    if method in ("svd", "eigh"):
        return lambda pts, P, w: triangulate(pts, P, w, method=method)
    raise ValueError(f"unknown triangulation method: {method}")


def generate_pseudo_gt(cfg, detections: torch.Tensor, conf: torch.Tensor,
                       cameras: Camera, solve: Callable | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-view detections -> world-frame pseudo-GT.

    detections (G, V, J, 2) source pixels; conf (G, V, J); cameras with
    (G, V) leading dims. Undistorts, then triangulates with the solver of
    ``TPU.TRIANGULATION.METHOD`` (``solve`` overrides it, with the same
    ``(points2d, P, weights)`` signature), weighted by ``conf`` when
    ``TPU.TRIANGULATION.CONF_WEIGHT``. Returns (X (G, J, 3), residual
    (G, J)).
    """
    und = undistort_points(detections, cameras).contiguous()
    solve = solve or triangulate_for(str(cfg.TPU.TRIANGULATION.METHOD))
    weights = (conf.float().contiguous()
               if bool(cfg.TPU.TRIANGULATION.CONF_WEIGHT) else None)
    return solve(und, cameras.P.contiguous(), weights)


def _h36m_bones(num_joints: int) -> list[tuple[int, int]]:
    """Limb pairs for bone-length scale fixing (H36M 17-joint order)."""
    pairs = ((1, 2), (2, 3), (4, 5), (5, 6), (11, 12), (12, 13),
             (14, 15), (15, 16))
    return [p for p in pairs if p[0] < num_joints and p[1] < num_joints]


def make_gt_teacher(joints_src, conf=None) -> Callable:
    """A perfect teacher: ``detect(imgs, centers, scales)`` that ignores
    its arguments and returns fixed detections (B, J, 2) and confidences
    (B, J; 1 when not given), B the batch's G*V. Moved to the images'
    device on each call."""
    joints_src = torch.as_tensor(joints_src, dtype=torch.float32)
    c = (torch.as_tensor(conf, dtype=torch.float32) if conf is not None
         else torch.ones(joints_src.shape[:-1]))

    def detect(imgs, centers, scales):
        del centers, scales
        return joints_src.to(imgs.device), c.to(imgs.device)
    return detect


def make_ss_train_step(cfg, model: nn.Module, teacher: Teacher | None,
                       device: str | torch.device = "cuda",
                       detect_fn: Callable | None = None, flip_pairs=(),
                       refiner: Callable | None = None,
                       decode: Callable = softmax_integral,
                       solve: Callable | None = None):
    """Build ``step(state, batch) -> (state, metrics)`` for multi-view
    batches (module docstring), with metrics ``{"loss", "tri_residual",
    "teacher_conf"}`` on the device.

    The 2D detections come from the batch's ``det_src``/``det_conf`` when
    it has them, else from ``detect_fn(imgs, centers, scales)`` (NCHW
    normalized crops), else from ``teacher``. Targets are kept only where
    the smallest confidence over the views exceeds ``TPU.SS_CONF_MIN``
    and the target is finite. ``refiner`` maps root-relative (N, J, 3)
    poses to refined ones, under ``no_grad``. ``decode`` and ``solve``
    default to the kernels on the card; a caller may pass the plain
    versions to compare. ``state.model`` must be ``model`` (moved to
    ``device``).
    """
    cameras = str(cfg.TPU.SS_CAMERAS)
    if cameras not in ("given", "estimated"):
        raise ValueError(f"unknown TPU.SS_CAMERAS: {cameras}")
    device = torch.device(device)
    image_size = tuple(int(v) for v in cfg.MODEL.IMAGE_SIZE)
    depth_dim = int(cfg.MODEL.EXTRA.DEPTH_DIM)
    depth_bound = float(cfg.MODEL.EXTRA.get("DEPTH_BOUND", 1000.0))
    num_joints = int(cfg.MODEL.NUM_JOINTS)
    root_idx = 0
    conf_min = float(cfg.TPU.get("SS_CONF_MIN", 0.05))
    bone_mm = float(cfg.TPU.get("SS_BONE_LENGTH_MM", 0.0))
    bones = _h36m_bones(num_joints) if bone_mm > 0 else None
    perm = list(range(num_joints))
    for a, b in flip_pairs:
        if a < num_joints and b < num_joints:
            perm[a], perm[b] = perm[b], perm[a]
    model = model.to(device)

    def to_device(a) -> torch.Tensor:
        return torch.as_tensor(a).to(device, non_blocking=True)

    def step(state, batch):
        if state.model is not model:
            raise ValueError("the train state holds another model than the "
                             "one this step was built for")
        G, V = batch["input"].shape[:2]

        def flat(a) -> torch.Tensor:
            a = to_device(a)
            return a.reshape((G * V,) + tuple(a.shape[2:]))

        def crops(key) -> torch.Tensor:
            return normalize_images(flat(batch[key])).permute(
                0, 3, 1, 2).contiguous()

        imgs = crops("input")
        centers = flat(batch["center"]).float()
        scales = flat(batch["scale"]).float()
        cam = batch["camera"].to(device)

        with torch.no_grad():
            # 1) 2D detections in source pixels
            if "det_src" in batch:
                joints_src = flat(batch["det_src"]).float()
                conf = (flat(batch["det_conf"]).float()
                        if "det_conf" in batch
                        else torch.ones(joints_src.shape[:-1],
                                        device=device))
            elif detect_fn is not None:
                joints_src, conf = detect_fn(imgs, centers, scales)
            else:
                joints_src, conf = teacher_detect(cfg, teacher, imgs,
                                                  centers, scales)
            # 2) triangulate; 3) project into each view
            det = joints_src.reshape(G, V, num_joints, 2)
            conf_gv = conf.reshape(G, V, -1)
            if cameras == "estimated":
                # the rig from the detections; every group shares it, the
                # intrinsics are group 0's; X in camera 0's frame
                intr = cam.map(lambda t: t[0])
                x0, p_est, res = pseudo_gt_uncalibrated(
                    det, intr, conf=conf_gv.contiguous(), bone_pairs=bones,
                    bone_length_mm=bone_mm if bone_mm > 0 else None,
                    solve=solve)
                if refiner is not None:
                    root = x0[:, root_idx:root_idx + 1]
                    x0 = root + refiner(x0 - root)
                # each view's frame through the estimated [R | t], then
                # pinhole pixels (no distortion)
                xh = torch.cat([x0, torch.ones_like(x0[..., :1])], dim=-1)
                x_cam = (p_est[None, :, None] * xh[:, None, :, None]).sum(-1)
                z = x_cam[..., 2:3]
                z = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
                px = (x_cam[..., :2] / z * intr.f[None, :, None]
                      + intr.c[None, :, None])
            else:
                x_w, res = generate_pseudo_gt(cfg, det, conf_gv, cam, solve)
                if refiner is not None:
                    root = x_w[:, root_idx:root_idx + 1]
                    x_w = root + refiner(x_w - root)
                x_cam = world_to_camera_frame(x_w[:, None], cam)
                px, _ = project_point_radial(x_w[:, None], cam)
            px = px.reshape(G * V, num_joints, 2)
            m = get_affine_transform(centers, scales, 0.0, image_size)
            xy_crop = affine_transform(px, m[:, None])
            z_rel = x_cam[..., 2].reshape(G * V, num_joints)
            z_rel = z_rel - z_rel[..., root_idx:root_idx + 1]
            vis = (flat(batch["joints_vis"]).float()
                   if "joints_vis" in batch else torch.ones_like(z_rel))
            # a joint supervises only where every view was confident;
            # flat index g*V + v, so the gate repeats group by group
            conf_ok = conf_gv.amin(dim=1) > conf_min
            vis = vis * conf_ok.to(vis.dtype).repeat_interleave(V, dim=0)
            # dual crop: the student trains on the augmented crop, targets
            # remapped through its affine; a flip swaps left and right
            if "input_aug" in batch:
                imgs = crops("input_aug")
                m_aug = flat(batch["aug_M"]).float()
                xy_crop = affine_transform(px, m_aug[:, None])
                flip = flat(batch["aug_flip"])[:, None] > 0.5
                xy_crop = torch.where(flip[..., None], xy_crop[:, perm],
                                      xy_crop)
                z_rel = torch.where(flip, z_rel[:, perm], z_rel)
                vis = torch.where(flip, vis[:, perm], vis)
            target, tw = generate_integral_target(
                xy_crop, vis, image_size, depth_bound=depth_bound,
                joints_depth=z_rel)
            # a degenerate triangulation can give nan/inf targets: zero
            # their weight and sanitize them
            tw = tw * torch.isfinite(target).all(dim=-1).to(tw.dtype)
            target = torch.nan_to_num(target)

        # 4) the student's update
        loss = integral_update(state, model, imgs, target, tw, num_joints,
                               depth_dim, decode)
        return state, {"loss": loss, "tri_residual": res.mean(),
                       "teacher_conf": conf.mean()}

    return step
