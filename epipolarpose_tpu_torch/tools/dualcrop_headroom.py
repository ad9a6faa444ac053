"""Dual-crop SS headroom: the half-res teacher crop, measured.

    python -m epipolarpose_tpu_torch.tools.dualcrop_headroom                  # chip scale (r50@256)
    python -m epipolarpose_tpu_torch.tools.dualcrop_headroom --preset ci      # r18@64
        [--device cuda|cpu] [--cfg <ss yaml>]

Counterpart of the JAX package's ``tools/dualcrop_headroom.py``, with the
same presets, parts and table (plus ``--device``). The SS input path
decodes each frame once and warps it twice (the clean teacher crop and
the augmented student crop). The teacher only feeds a heatmap argmax, so
its crop can shrink: ``TPU.SS_TEACHER_SCALE: 0.5`` quarters the teacher
crop's pixels and bytes, and the frozen teacher's forward. Three sides of
the trade:

A. the host loader's img/s (student images counted) and bytes shipped an
   image at teacher scales 1.0 and 0.5, through ``H36MDataset`` over a
   tree of 4-view frames. The route it takes is named: the native
   loader's one decode (the port's own decoder, ``native/jpegdec.cpp``,
   DCT-scaled where the crops allow) and two warps wherever ``g++``
   builds it, the card's machine included, else the same decoder and the
   numpy warps on the thread pool. Every frame of
   the tree is one JPEG, the repo's 1000 x 1000 H36M-sized fixture
   (:data:`FRAME_JPEG`), since the port writes no JPEG without OpenCV;
   the labels come from the synthetic rig and do not match it, which the
   loader's cost does not depend on;
B. the pseudo-GT floor: a 2D teacher (the gaussian train step) trained on
   full-res clean crops, its detections triangulated (the ``fast``
   solver) against the ground truth, on full-res and half-res crops (the
   same weights), then after a fine-tune on half-res crops;
C. the SS step's img/s (``make_ss_train_step``, ``TPU.FUSED_STEPS``
   honoured) at both scales, each with its teacher: both soft-argmax
   kernels and the triangulation kernel run on the card.
"""

from __future__ import annotations

import argparse
import copy
import os
import pathlib
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
FRAME_JPEG = ROOT / "tests" / "data" / "jpeg" / "h36m_1000x1000.jpg"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cfg", default="experiments/h36m/"
                   "train_ss_r50_256_integral.yaml")
    p.add_argument("--preset", choices=["chip", "ci"], default="chip")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs a card) or cpu")
    return p.parse_args(argv)


_PRESETS = {
    # the JAX tool's: a 3000-step teacher (a 600-step one puts the floor at
    # hundreds of mm of teacher error, which swamps the few-mm effect of
    # the half-res crop)
    "chip": dict(frames=48, loader_frames=32, groups=8,
                 teacher_steps=3000, finetune_steps=600, dev_iters=6),
    "ci": dict(frames=12, loader_frames=12, groups=4,
               teacher_steps=150, finetune_steps=60, dev_iters=2),
}
SCALES = (1.0, 0.5)


def ci_config(cfg) -> None:
    """The ``ci`` preset's cut of the SS config: ResNet-18 at 64x64,
    32-wide deconvs, D = 4, float32."""
    cfg.MODEL.EXTRA.NUM_LAYERS = 18
    cfg.MODEL.IMAGE_SIZE = [64, 64]
    cfg.MODEL.EXTRA.HEATMAP_SIZE = [16, 16]
    cfg.MODEL.EXTRA.NUM_DECONV_FILTERS = [32, 32, 32]
    cfg.MODEL.EXTRA.DEPTH_DIM = 4
    cfg.TPU.COMPUTE_DTYPE = "float32"


def kernel_launches() -> dict[str, int]:
    """Every kernel wrapper's launch counter (the triangulation's also by
    layout), and the teacher's decodes, which launch no hand-written
    kernel."""
    from epipolarpose_tpu_torch.core.self_supervised import teacher_detect
    from epipolarpose_tpu_torch.kernels import softargmax as ksa
    from epipolarpose_tpu_torch.kernels.matmul_stats import matmul_stats
    from epipolarpose_tpu_torch.kernels.triangulate import triangulate_fast
    return {"softargmax_fwd": ksa.softmax_integral.launches,
            "softargmax_bwd": ksa.softmax_integral_bwd.launches,
            "matmul_stats": matmul_stats.launches,
            "triangulate": triangulate_fast.launches,
            "triangulate_split": triangulate_fast.launches_split,
            "teacher_decode": teacher_detect.calls}


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in kernel_launches().items()}


def _to_device(batch: dict, device) -> dict:
    return {k: (v.to(device) if k == "camera" else
                torch.as_tensor(v).to(device)) for k, v in batch.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def loader_route() -> str:
    """Which route decodes and warps part A's JPEG records."""
    from epipolarpose_tpu_torch.data import fastloader, jpeg
    if fastloader.available():
        return ("native loader: one decode by the port's decoder + two "
                "warps")
    decoder = ("built" if jpeg.available()
               else f"not built: {jpeg.build_error()}")
    return (f"the port's JPEG decoder ({decoder}) + numpy warps on the "
            f"thread pool; native loader not built "
            f"({fastloader.build_error()})")


def bench_loader(cfg, td: str, n_frames: int, groups: int, log) -> dict:
    """A: host dual-crop loader img/s (student images counted) and bytes
    shipped an image, both scales through the same dataset and tree.
    Returns ``{scale: {"img_s", "bytes_per_img"}, "route": str,
    "decodes": the port decoder's decodes through both libraries}``."""
    import epipolarpose_tpu_torch.data.h36m as h36m_mod
    from epipolarpose_tpu_torch.data import fastloader, jpeg
    from epipolarpose_tpu_torch.data.synthetic import write_synthetic_h36m

    frame = FRAME_JPEG.read_bytes()
    sub = cfg.DATASET.SUBSAMPLE
    cfg.DATASET.SUBSAMPLE = 1
    root = os.path.join(td, "tree")
    write_synthetic_h36m(root, cfg, num_frames=n_frames, jpeg=frame)
    orig = h36m_mod.CAMERA_IDS
    h36m_mod.CAMERA_IDS = ("0", "1", "2", "3")
    out: dict = {}
    decodes = jpeg.decode_count() + sum(
        fastloader.decode_counts()["scale"].values())
    try:
        cfg.TPU.NATIVE_LOADER = fastloader.available()
        ds = h36m_mod.H36MDataset(cfg, root, "train", is_train=True)
        out["route"] = loader_route()
        log(f"A loader route: {out['route']}")
        for scale in SCALES:
            cfg.TPU.SS_TEACHER_SCALE = scale
            # warm: decoder caches, page cache
            for _ in ds.view_batches(groups, seed=0, shuffle=False,
                                     augment=True):
                pass
            n_img = n_bytes = 0
            t0 = time.perf_counter()
            for rep in range(3):
                for b in ds.view_batches(groups, seed=rep, shuffle=True,
                                         augment=True):
                    n_img += b["input_aug"].shape[0] * b["input_aug"].shape[1]
                    n_bytes += b["input"].nbytes + b["input_aug"].nbytes
            dt = time.perf_counter() - t0
            out[scale] = dict(img_s=round(n_img / dt, 1),
                              bytes_per_img=round(n_bytes / n_img))
            log(f"A loader scale={scale}: {out[scale]['img_s']} img/s, "
                f"{out[scale]['bytes_per_img']} B/img shipped")
    finally:
        h36m_mod.CAMERA_IDS = orig
        cfg.TPU.NATIVE_LOADER = "auto"
        cfg.TPU.SS_TEACHER_SCALE = 1.0
        cfg.DATASET.SUBSAMPLE = sub
    out["decodes"] = jpeg.decode_count() + sum(
        fastloader.decode_counts()["scale"].values()) - decodes
    return out


def train_teacher(tcfg, tmodel, batches: list, steps: int, device,
                  state=None):
    """``steps`` gaussian train steps of ``tmodel`` over ``batches`` (on
    ``device``, cycled); continues ``state`` when given. Returns (state,
    the last step's accuracy)."""
    from epipolarpose_tpu_torch.core import (create_train_state,
                                             make_train_step)
    state = state or create_train_state(tcfg, tmodel, 100, device)
    step = make_train_step(tcfg, tmodel, device=device)
    metrics = None
    for s in range(steps):
        state, metrics = step(state, batches[s % len(batches)])
    acc = float(metrics["acc"]) if metrics is not None else float("nan")
    return state, acc


def floor_from_detections(cfg, ds, det: torch.Tensor, conf: torch.Tensor,
                          camera, log=print) -> float:
    """The pseudo-GT MPJPE (mm) of detections (G, V, J, 2) with
    confidences (G, V, J) of ``ds``'s first G view groups: triangulated
    (``TPU.TRIANGULATION``) against the GT world poses, over the finite
    joints (a degenerate triangulation comes back nan, and the SS step
    gives it no weight; their share is logged)."""
    from epipolarpose_tpu_torch.core.self_supervised import generate_pseudo_gt
    x_w, _ = generate_pseudo_gt(cfg, det, conf, camera)
    gt_w = np.stack([ds.records[ds.view_groups[t][0]].meta["pose_world"]
                     for t in range(det.shape[0])])
    err = np.linalg.norm(x_w.cpu().numpy() - gt_w, axis=-1)
    finite = np.isfinite(err)
    if not finite.any():
        return float("nan")
    if finite.mean() < 1.0:
        log(f"   ({(1 - finite.mean()) * 100:.0f}% joints degenerate/nan "
            f"at this operating point)")
    return float(err[finite].mean())


def pseudo_gt_floor_at(cfg, ds, teacher, scale: float, device, log=print):
    """The pseudo-GT floor with clean crops at ``scale`` through the
    dataset's dual crop (``TPU.SS_TEACHER_SCALE``) -> the teacher ->
    :func:`floor_from_detections`. Returns (floor, detections (G, V, J,
    2), confidences (G, V, J))."""
    from epipolarpose_tpu_torch.core.self_supervised import teacher_detect
    from epipolarpose_tpu_torch.core.steps import normalize_images
    num_joints = int(cfg.MODEL.NUM_JOINTS)
    cfg.TPU.SS_TEACHER_SCALE = scale
    try:
        n_floor = min(len(ds.view_groups), 16)
        batch0 = next(ds.view_batches(n_floor, shuffle=False,
                                      augment=(scale != 1.0)))
    finally:
        cfg.TPU.SS_TEACHER_SCALE = 1.0
    g, v = batch0["input"].shape[:2]

    def flat(x):
        return torch.as_tensor(x.reshape((g * v,) + x.shape[2:])).to(device)
    imgs = normalize_images(flat(batch0["input"])).permute(
        0, 3, 1, 2).contiguous()
    j_src, conf = teacher_detect(cfg, teacher, imgs, flat(batch0["center"]),
                                 flat(batch0["scale"]))
    det = j_src.reshape(g, v, num_joints, 2)
    conf = conf.reshape(g, v, num_joints)
    floor = floor_from_detections(cfg, ds, det, conf,
                                  batch0["camera"].to(device), log)
    return floor, det, conf


def ss_step_rate(cfg, ds, state, teacher, scale: float, groups: int,
                 iters: int, device, log=print) -> dict:
    """C: the SS step (``make_ss_train_step`` with ``TPU.FUSED_STEPS``) on
    one dual-crop batch at ``scale``: a first call (warm-up, its loss
    kept), then ``iters`` timed calls. Returns ``{"img_s", "loss"}``: the
    student images a second and the first step's loss."""
    from epipolarpose_tpu_torch.core.self_supervised import make_ss_train_step
    from epipolarpose_tpu_torch.data.pipeline import stack_batches
    device = torch.device(device)
    k = int(cfg.TPU.FUSED_STEPS)
    cfg.TPU.SS_TEACHER_SCALE = scale
    try:
        batch = next(ds.view_batches(groups, seed=1, shuffle=True,
                                     augment=True))
        batch.pop("joints_3d", None)
        batch = _to_device(batch, device)
        if k > 1:
            batch = next(stack_batches(iter([batch] * k), k))
        step = make_ss_train_step(cfg, state.model, teacher, device=device,
                                  flip_pairs=ds.flip_pairs, fused_steps=k)
        state, m = step(state, batch)
        loss = float(m["loss"].reshape(-1)[0])
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            state, m = step(state, batch)
        _sync(device)
        n = iters * k * batch["input_aug"].shape[-5] * \
            batch["input_aug"].shape[-4]
        rate = round(n / (time.perf_counter() - t0), 1)
    finally:
        cfg.TPU.SS_TEACHER_SCALE = 1.0
    log(f"C device SS step scale={scale}: {rate} img/s")
    return dict(img_s=rate, loss=loss)


def bench_quality_and_device(cfg, frames: int, groups: int,
                             teacher_steps: int, finetune_steps: int,
                             dev_iters: int, device, log=print) -> dict:
    """B and C; returns the floors, the SS step's rates and first losses,
    and each part's kernel launches."""
    from epipolarpose_tpu_torch.core import create_train_state
    from epipolarpose_tpu_torch.core.self_supervised import Teacher
    from epipolarpose_tpu_torch.data import SyntheticMultiviewDataset
    from epipolarpose_tpu_torch.models import get_model
    from epipolarpose_tpu_torch.tools.ss_convergence import make_teacher_cfg

    image_shape = tuple(int(v) for v in cfg.MODEL.IMAGE_SIZE)
    ds = SyntheticMultiviewDataset(cfg, num_frames=frames, is_train=True,
                                   image_shape=image_shape, seed=0)
    before = kernel_launches()
    # the teacher, trained on full-res clean crops (the MPII-pretrain twin)
    tcfg = make_teacher_cfg(cfg)
    tmodel = get_model(tcfg, True, torch.Generator().manual_seed(2))
    tbatches = [_to_device(b, device) for b in
                ds.batches(16, seed=0, shuffle=True, drop_last=True)]
    tstate, acc = train_teacher(tcfg, tmodel, tbatches, teacher_steps,
                                device)
    log(f"B teacher: {teacher_steps} steps, train acc {acc:.3f}")
    teacher = Teacher(copy.deepcopy(tmodel)).to(device)
    f_full = pseudo_gt_floor_at(cfg, ds, teacher, 1.0, device, log)[0]
    f_half = pseudo_gt_floor_at(cfg, ds, teacher, 0.5, device, log)[0]
    log(f"B pseudo-GT floor: full-res {f_full:.1f} mm, half-res "
        f"{f_half:.1f} mm (same weights)")

    # fine-tune the teacher on half-res crops (the scale shift): the same
    # full-res source images, crops and gaussian targets at half the size
    tcfg_h = make_teacher_cfg(cfg)
    tcfg_h.MODEL.IMAGE_SIZE = [image_shape[0] // 2, image_shape[1] // 2]
    tcfg_h.MODEL.EXTRA.HEATMAP_SIZE = [
        int(v) // 2 for v in tcfg_h.MODEL.EXTRA.HEATMAP_SIZE]
    ds_ft = SyntheticMultiviewDataset(tcfg_h, num_frames=frames,
                                      is_train=True, image_shape=image_shape,
                                      seed=0)
    ftb = [_to_device(b, device) for b in
           ds_ft.batches(16, seed=7, shuffle=True, drop_last=True)]
    train_teacher(tcfg_h, tmodel, ftb, finetune_steps, device, tstate)
    teacher_ft = Teacher(tmodel).to(device)
    f_half_ft = pseudo_gt_floor_at(cfg, ds, teacher_ft, 0.5, device, log)[0]
    log(f"B pseudo-GT floor: half-res after {finetune_steps}-step "
        f"fine-tune {f_half_ft:.1f} mm")
    launches_b = _since(before)

    # C: the SS step at both scales, each scale with its teacher
    before = kernel_launches()
    model = get_model(cfg, True, torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model, 100, device)
    steps = {s: ss_step_rate(cfg, ds, state, teacher if s == 1.0
                             else teacher_ft, s, groups, dev_iters, device,
                             log) for s in SCALES}
    return dict(floor_full=f_full, floor_half=f_half,
                floor_half_ft=f_half_ft, teacher_acc=acc,
                device={s: v["img_s"] for s, v in steps.items()},
                loss={s: v["loss"] for s, v in steps.items()},
                launches={"B": launches_b, "C": _since(before)})


def table(A: dict, B: dict) -> str:
    """The JAX tool's markdown table."""
    return "\n".join([
        "| measure | scale 1.0 | scale 0.5 |",
        "|---|---|---|",
        f"| host loader (img/s) | {A[1.0]['img_s']} | {A[0.5]['img_s']} |",
        f"| shipped bytes/img | {A[1.0]['bytes_per_img']} | "
        f"{A[0.5]['bytes_per_img']} |",
        f"| pseudo-GT floor (mm) | {B['floor_full']:.1f} | "
        f"{B['floor_half']:.1f} (same weights) / "
        f"{B['floor_half_ft']:.1f} (fine-tuned) |",
        f"| device SS step (img/s) | {B['device'][1.0]} | "
        f"{B['device'][0.5]} |"])


def main(argv=None) -> dict:
    """Run parts A, B and C and print the table; returns ``{"A", "B",
    "table"}``."""
    args = parse_args(argv)
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.core.steps import configure_backends
    from epipolarpose_tpu_torch.scripts.common import resolve_device
    cfg = load_config(args.cfg)
    preset = dict(_PRESETS[args.preset])
    if args.preset == "ci":
        ci_config(cfg)
    device = resolve_device(args.device)
    configure_backends(cfg)
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                 if device.type == "cuda" else ""))
    with tempfile.TemporaryDirectory() as td:
        A = bench_loader(cfg, td, preset["loader_frames"], preset["groups"],
                         print)
    B = bench_quality_and_device(
        cfg, preset["frames"], preset["groups"], preset["teacher_steps"],
        preset["finetune_steps"], preset["dev_iters"], device, print)
    text = table(A, B)
    print()
    print(text)
    return dict(A=A, B=B, table=text)


if __name__ == "__main__":
    main()
