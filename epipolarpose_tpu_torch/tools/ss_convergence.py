"""SS convergence experiment: teacher pretrain -> frozen-teacher SS loop,
the student's MPJPE curve against the pseudo-GT floor.

    python -m epipolarpose_tpu_torch.tools.ss_convergence                 # chip scale
    python -m epipolarpose_tpu_torch.tools.ss_convergence --preset ci     # CI scale

Counterpart of the JAX package's ``tools/ss_convergence.py``, with the
same presets, phases and flags (plus ``--device``):

1. train a 2D gaussian-head teacher on the synthetic multi-view rig's
   clean crops (GT 2D supervision, the MPII-pretrain stand-in);
2. freeze it; measure the pseudo-GT floor (teacher -> decode -> undistort
   -> weighted DLT against the GT world poses);
3. run the SS loop (``make_ss_train_step``) on multi-view batches and
   evaluate the student's MPJPE every few steps.

Prints a markdown curve table. Batches are decoded once and kept on the
device: the experiment shows optimization behaviour, not input-fed
throughput.
"""

from __future__ import annotations

import argparse
import copy
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", default="experiments/h36m/"
                   "train_ss_r50_256_integral.yaml")
    p.add_argument("--preset", choices=["chip", "ci"], default="chip")
    p.add_argument("--frames", type=int, default=None,
                   help="train time instants (x4 views each)")
    p.add_argument("--val-frames", type=int, default=None)
    p.add_argument("--groups", type=int, default=None,
                   help="multi-view groups per SS batch")
    p.add_argument("--teacher-steps", type=int, default=None)
    p.add_argument("--ss-steps", type=int, default=None)
    p.add_argument("--eval-every", type=int, default=None)
    p.add_argument("--pose-mode", choices=["uniform", "skeleton"],
                   default=None, help="synthetic pose bank (default: "
                   "preset; chip uses skeleton, ci uniform)")
    p.add_argument("--eval-on", choices=["val", "train", "both"],
                   default=None,
                   help="eval set: held-out frames, the training poses "
                   "(clean crops), or both curves")
    p.add_argument("--depth-cue", type=float, default=0.0,
                   help="perspective size-cue exponent for the synthetic "
                   "renderer (0 = constant blob size)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs a card) or cpu")
    return p.parse_args(argv)


_PRESETS = {
    # r50 @ 256^2, depth 64: the SS config's architecture
    "chip": dict(frames=64, val_frames=16, groups=16, teacher_steps=3000,
                 ss_steps=240, eval_every=30, pose_mode="skeleton",
                 eval_on="both"),
    # r18 @ 64^2, depth 4
    "ci": dict(frames=12, val_frames=6, groups=4, teacher_steps=150,
               ss_steps=48, eval_every=8, pose_mode="uniform",
               eval_on="train"),
}


def make_teacher_cfg(cfg):
    """2D gaussian-head view of the same geometry (the MPII-pretrain
    twin)."""
    t = copy.deepcopy(cfg)
    t.MODEL.NAME = "pose_resnet"
    t.MODEL.EXTRA.TARGET_TYPE = "gaussian"
    t.MODEL.EXTRA.DEPTH_DIM = 1
    t.LOSS.TYPE = "JointsMSELoss"
    t.TRAIN.LR = 0.003
    if int(t.MODEL.EXTRA.HEATMAP_SIZE[0]) <= 16:
        t.MODEL.EXTRA.SIGMA = 1.0        # tight blob on tiny heatmaps
    return t


def pseudo_gt_floor(cfg, det, conf, camera, gt_world) -> float:
    """Mean distance (mm) of the triangulated detections (G, V, J, 2) with
    confidences (G, V, J) from the GT world poses (G, J, 3)."""
    from epipolarpose_tpu_torch.core.self_supervised import generate_pseudo_gt
    x_w, _ = generate_pseudo_gt(cfg, det, conf, camera)
    gt = torch.as_tensor(np.asarray(gt_world), dtype=torch.float32)
    return float((x_w.cpu() - gt).norm(dim=-1).mean())


def axis_breakdown(preds: np.ndarray, dset) -> tuple[float, float]:
    """Eval-step predictions of ``dset``'s first records -> the mean
    image-plane (xy) and depth (|z|) error in root-relative camera mm: the
    split of the residual gap to the pseudo-GT floor."""
    recs = dset.records[:len(preds)]
    ri = dset.root_idx
    gts = np.stack([r.joints_3d - r.joints_3d[ri:ri + 1] for r in recs])
    pc = dset._preds_to_camera_mm(preds, recs)
    pc = pc - pc[:, ri:ri + 1]
    d = pc - gts
    return (float(np.linalg.norm(d[..., :2], axis=-1).mean()),
            float(np.abs(d[..., 2]).mean()))


def _to_device(batch: dict, device) -> dict:
    return {k: (v.to(device) if k == "camera" else
                torch.as_tensor(v).to(device)) for k, v in batch.items()}


def run(cfg, frames, val_frames, groups, teacher_steps, ss_steps,
        eval_every, log=print, detector="teacher", noise_px=2.0,
        merge_backbone=True, eval_on="val", pose_mode="uniform",
        depth_cue=0.0, device="cuda"):
    """The experiment; returns (curve [(step, MPJPE)], floor, losses
    [(step, loss)]).

    ``detector='teacher'``: pretrain a 2D teacher, freeze it, and run the
    SS loop through it. ``'gt_noise'``: no teacher; GT detections with
    ``noise_px`` pixels of noise ride in the batch (``det_src``).
    ``merge_backbone=False`` starts the student from random weights, not
    from the teacher's backbone. ``eval_on``: the curve on held-out frames
    (``val``), on the training poses' clean crops (``train``), or both.
    """
    from epipolarpose_tpu_torch.core import (create_train_state,
                                             make_eval_step, make_train_step,
                                             validate)
    from epipolarpose_tpu_torch.core.checkpoint import merge_matching
    from epipolarpose_tpu_torch.core.self_supervised import (
        Teacher, make_ss_train_step, teacher_detect)
    from epipolarpose_tpu_torch.core.steps import normalize_images
    from epipolarpose_tpu_torch.data import SyntheticMultiviewDataset
    from epipolarpose_tpu_torch.models import get_model

    device = torch.device(device)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    image_shape = tuple(int(v) for v in cfg.MODEL.IMAGE_SIZE)
    ds = SyntheticMultiviewDataset(cfg, num_frames=frames, is_train=True,
                                   image_shape=image_shape, seed=0,
                                   pose_mode=pose_mode, depth_cue=depth_cue)
    ds_val = SyntheticMultiviewDataset(
        cfg, num_frames=frames if eval_on == "train" else val_frames,
        is_train=False, image_shape=image_shape,
        seed=0 if eval_on == "train" else 1, pose_mode=pose_mode,
        depth_cue=depth_cue)
    # eval_on='both': a second eval set over the training poses (clean
    # crops): train-pose gap = optimization, (val - train) gap =
    # generalization. At most 64 frames.
    ds_tr = None
    if eval_on == "both":
        ds_tr = SyntheticMultiviewDataset(
            cfg, num_frames=min(frames, 64), is_train=False,
            image_shape=image_shape, seed=0, pose_mode=pose_mode,
            depth_cue=depth_cue)
    J = int(cfg.MODEL.NUM_JOINTS)
    rng = np.random.default_rng(11)

    def noisy_det(indices):
        """Source-space GT 2D plus pixel noise for a flat index array."""
        det = np.stack([ds.records[i].joints[:, :2] for i in indices])
        det = det + rng.normal(0.0, noise_px, det.shape)
        return det.astype(np.float32)

    teacher = tmodel = None
    if detector == "teacher":
        # ---- phase 1: teacher pretrain on clean single-view crops (GT 2D)
        tcfg = make_teacher_cfg(cfg)
        tmodel = get_model(tcfg, True, torch.Generator().manual_seed(2))
        tstate = create_train_state(tcfg, tmodel, 100, device)
        tstep = make_train_step(tcfg, tmodel, device=device)
        tbatches = [_to_device(b, device) for b in
                    ds.batches(16, seed=0, shuffle=True, drop_last=True)]
        t0 = time.time()
        tm = None
        for s in range(teacher_steps):
            tstate, tm = tstep(tstate, tbatches[s % len(tbatches)])
            if (s + 1) % 500 == 0:
                log(f"  teacher step {s + 1}: acc {float(tm['acc']):.3f}")
        acc = float(tm["acc"]) if tm is not None else float("nan")
        log(f"teacher: {teacher_steps} steps, final train acc {acc:.3f} "
            f"({time.time() - t0:.0f}s)")
        teacher = Teacher(tmodel).to(device)

    # ---- phase 2: pseudo-GT floor (detections -> DLT vs GT world)
    n_floor = min(len(ds.view_groups), 16)
    batch0 = next(ds.view_batches(n_floor, shuffle=False))
    G, V = batch0["input"].shape[:2]

    def flat(x):
        return x.reshape((G * V,) + x.shape[2:])
    if detector == "teacher":
        imgs = normalize_images(torch.as_tensor(flat(batch0["input"])).to(
            device)).permute(0, 3, 1, 2).contiguous()
        j_src, conf = teacher_detect(
            cfg, teacher, imgs,
            torch.as_tensor(flat(batch0["center"])).to(device),
            torch.as_tensor(flat(batch0["scale"])).to(device))
        det = j_src.reshape(G, V, J, 2)
        conf = conf.reshape(G, V, J)
    else:
        det = torch.from_numpy(noisy_det(flat(batch0["index"])).reshape(
            G, V, J, 2)).to(device)
        conf = torch.ones((G, V, J), device=device)
    gt_w = np.stack([ds.records[ds.view_groups[t][0]].meta["pose_world"]
                     for t in range(G)])
    floor = pseudo_gt_floor(cfg, det, conf, batch0["camera"].to(device),
                            gt_w)
    log(f"pseudo-GT floor ({detector}->DLT vs GT): {floor:.1f} mm "
        f"(conf {float(conf.mean()):.2f})")

    # ---- phase 3: SS loop, MPJPE curve
    model = get_model(cfg, True, torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model,
                               max(len(ds.view_groups) // groups, 1), device)
    if merge_backbone and tmodel is not None:
        # the student starts from the teacher's backbone (2D -> 3D merge)
        merge_matching(model, tmodel.state_dict())

    sstep = make_ss_train_step(cfg, model, teacher, device=device)
    estep = make_eval_step(cfg, model, ds_val.flip_pairs, device=device)
    ss_batches = []
    for b in ds.view_batches(groups, seed=3, shuffle=True):
        b.pop("joints_3d", None)
        if detector == "gt_noise":
            g, v = b["index"].shape[:2]
            b["det_src"] = noisy_det(b["index"].reshape(-1)).reshape(
                g, v, J, 2)
        ss_batches.append(_to_device(b, device))
    val_batches = [_to_device(b, device) for b in
                   ds_val.batches(8, seed=0, shuffle=False)]
    tr_batches = ([_to_device(b, device) for b in
                   ds_tr.batches(8, seed=0, shuffle=False)]
                  if ds_tr is not None else None)

    def eval_mpjpe(batches, dset):
        _, perf = validate(cfg, iter(batches), dset, estep)
        return float(perf)

    def eval_point():
        v = eval_mpjpe(val_batches, ds_val)
        t = (eval_mpjpe(tr_batches, ds_tr) if tr_batches is not None
             else None)
        return v, t

    def fmt(v, t):
        return (f"held-out MPJPE {v:.1f} mm" if t is None else
                f"held-out MPJPE {v:.1f} mm / train-pose {t:.1f} mm")

    v0, t0_mpjpe = eval_point()
    curve, curve_tr = [(0, v0)], [(0, t0_mpjpe)]
    losses = []
    log(f"step 0: student {fmt(v0, t0_mpjpe)}")
    t0 = time.time()
    for s in range(1, ss_steps + 1):
        state, m = sstep(state, ss_batches[(s - 1) % len(ss_batches)])
        if s % eval_every == 0 or s == ss_steps:
            v, t = eval_point()
            curve.append((s, v))
            curve_tr.append((s, t))
            losses.append((s, float(m["loss"])))
            log(f"step {s}: student {fmt(v, t)} "
                f"(loss {losses[-1][1]:.3f})")
    sync()
    log(f"SS: {ss_steps} steps in {time.time() - t0:.0f}s")
    if eval_on != "train":
        preds = np.concatenate([estep(b)["preds"].cpu().numpy()
                                for b in val_batches])[:len(ds_val)]
        xy, z = axis_breakdown(preds, ds_val)
        log(f"final held-out error split: xy {xy:.1f} mm, |z| {z:.1f} mm")

    log("")
    if tr_batches is not None:
        log("| SS step | held-out MPJPE (mm) | train-pose MPJPE (mm) |")
        log("|---|---|---|")
        for (s, v), (_, t) in zip(curve, curve_tr):
            log(f"| {s} | {v:.1f} | {t:.1f} |")
        log(f"| pseudo-GT floor | {floor:.1f} | {floor:.1f} |")
    else:
        log("| SS step | student MPJPE (mm) |")
        log("|---|---|")
        for s, v in curve:
            log(f"| {s} | {v:.1f} |")
        log(f"| pseudo-GT floor | {floor:.1f} |")
    return curve, floor, losses


def main(argv=None):
    args = parse_args(argv)
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.core.steps import configure_backends
    from epipolarpose_tpu_torch.scripts.common import resolve_device
    cfg = load_config(args.cfg)
    preset = dict(_PRESETS[args.preset])
    for k in preset:
        v = getattr(args, k)
        if v is not None:
            preset[k] = v
    preset["depth_cue"] = args.depth_cue
    if args.preset == "ci":
        cfg.MODEL.EXTRA.NUM_LAYERS = 18
        cfg.MODEL.IMAGE_SIZE = [64, 64]
        cfg.MODEL.EXTRA.HEATMAP_SIZE = [16, 16]
        cfg.MODEL.EXTRA.NUM_DECONV_FILTERS = [32, 32, 32]
        cfg.MODEL.EXTRA.DEPTH_DIM = 4
        cfg.TPU.COMPUTE_DTYPE = "float32"
    device = resolve_device(args.device)
    configure_backends(cfg)
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                 if device.type == "cuda" else ""))
    return run(cfg, device=device, **preset)


if __name__ == "__main__":
    main()
