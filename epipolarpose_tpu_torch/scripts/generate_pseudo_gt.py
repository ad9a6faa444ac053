"""Offline pseudo-GT generation: the JAX package's
``scripts/generate_pseudo_gt.py`` on the card.

    python -m epipolarpose_tpu_torch.scripts.generate_pseudo_gt --cfg experiments/h36m/train_ss_r50_256_integral.yaml \
        [--synthetic] [--out pseudo_gt.json] [--gt-detections] \
        [--merge-into annot/train.json] [--refiner refiner.pth]

The reference's own self-supervised workflow: the frozen 2D teacher
(``MODEL.PRETRAINED``; random weights without one) runs over every
multi-view group of the train split, its detections are triangulated with
the dataset's cameras (undistortion, then the confidence-weighted DLT of
``TPU.TRIANGULATION``; ``fast`` is the CUDA kernel ``epk_triangulate`` on
the card), and each record's joints go to a json as absolute camera-frame
3D joints in mm: ``{record index: {"joints_3d", "conf", "residual"}}``.
Absolute, because the evaluation's ``pixel2cam`` keys on the root depth;
the reported error is root-relative. As in the JAX script, the cameras are
the dataset's whatever ``TPU.SS_CAMERAS`` says.

``--gt-detections`` triangulates the dataset's 2D labels in place of the
teacher's (the geometry alone); ``--merge-into`` folds the json into an
annot json (``data/pseudo_gt.py``); ``--refiner`` denoises each pose with
a refinement unit first (the paper's offline "SS + R").
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.scripts.common import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Generate pseudo-GT (GPU)")
    p.add_argument("--cfg", required=True)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--samples", type=int, default=32)
    p.add_argument("--groups-per-batch", type=int, default=8)
    p.add_argument("--out", default="pseudo_gt.json")
    p.add_argument("--gt-detections", action="store_true",
                   help="bypass the teacher and triangulate the dataset's "
                        "GT 2D joints (isolates geometry quality)")
    p.add_argument("--merge-into", default=None,
                   help="annot json to fold the pseudo-GT into (the "
                        "reference's stage-2 input)")
    p.add_argument("--merge-out", default=None,
                   help="output path for the merged annot json "
                        "(default: <merge-into>.pseudo.json)")
    p.add_argument("--merge-conf-min", type=float, default=0.0,
                   help="skip records whose min teacher confidence is "
                        "below this when merging")
    p.add_argument("--refiner", default=None,
                   help="refinement-unit checkpoint: denoise the "
                        "triangulated poses before writing (the paper's "
                        "offline 'SS + R' rows)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs a card) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; returns ``{"records", "mpjpe" (mm, or None without
    dataset 3D), "merged" (or None), "out", "loop_s"}``: ``loop_s`` is the
    seconds of the batch loop (loader, teacher, triangulation, copies to
    the host), without the set-up before it and the json after it."""
    args = parse_args(argv)
    cfg = load_config(args.cfg)
    if args.synthetic:
        cfg.DATASET.DATASET = "synthetic_multiview"
    device = resolve_device(args.device)

    from epipolarpose_tpu_torch.core.self_supervised import (
        generate_pseudo_gt, load_refiner, load_teacher, teacher_detect)
    from epipolarpose_tpu_torch.core.steps import (configure_backends,
                                                   normalize_images)
    from epipolarpose_tpu_torch.data import epoch_loader, get_dataset
    from epipolarpose_tpu_torch.geometry.camera import world_to_camera_frame

    configure_backends(cfg)
    kwargs = ({"num_frames": max(args.samples // 4, 2)}
              if cfg.DATASET.DATASET == "synthetic_multiview" else {})
    ds = get_dataset(cfg, cfg.DATASET.TRAIN_SET, False, **kwargs)
    num_joints = int(cfg.MODEL.NUM_JOINTS)
    gt_src = None
    teacher = None
    if args.gt_detections:
        gt_src = torch.tensor(np.stack([r.joints for r in ds.records]),
                              dtype=torch.float32, device=device)
    else:
        teacher = load_teacher(cfg, device, torch.Generator().manual_seed(1))
    refiner = None
    if args.refiner:
        refiner = load_refiner(cfg, args.refiner, device)
        print(f"refining pseudo-GT with {args.refiner}")

    @torch.no_grad()
    def process(batch):
        G, V = batch["input"].shape[:2]
        if gt_src is not None:
            det = gt_src[batch["index"].reshape(-1)]
            conf = torch.ones(det.shape[:-1], device=device)
        else:
            imgs = normalize_images(batch["input"].reshape(
                (G * V,) + tuple(batch["input"].shape[2:]))).permute(
                    0, 3, 1, 2).contiguous()
            det, conf = teacher_detect(cfg, teacher, imgs,
                                       batch["center"].reshape(G * V, 2),
                                       batch["scale"].reshape(G * V, 2))
        det = det.reshape(G, V, num_joints, 2)
        conf = conf.reshape(G, V, num_joints)
        cam = batch["camera"]
        x_w, res = generate_pseudo_gt(cfg, det, conf, cam)
        if refiner is not None:
            root = x_w[:, :1]
            x_w = root + refiner(x_w - root)
        x_cam = world_to_camera_frame(x_w[:, None], cam)
        return x_cam, conf.amin(dim=1), res

    results = {}
    errs = []
    root = 0
    # at least one batch from a small dataset (view_batches drops the
    # remainder, as the reference's drop_last loader does)
    gpb = max(min(args.groups_per_batch, len(ds.view_groups)), 1)
    t_loop = time.perf_counter()
    for batch in epoch_loader(ds, gpb, 0, is_train=False, device=device,
                              multiview=True):
        gt3 = batch.pop("joints_3d", None)
        x_cam, conf, res = process(batch)
        idx = batch["index"].cpu().numpy()                 # (G, V)
        x_cam = x_cam.cpu().numpy()
        conf = conf.cpu().numpy()
        res = res.cpu().numpy()
        gt3 = None if gt3 is None else gt3.cpu().numpy()
        for g in range(idx.shape[0]):
            for v in range(idx.shape[1]):
                rel = x_cam[g, v] - x_cam[g, v, root:root + 1]
                results[int(idx[g, v])] = {
                    "joints_3d": x_cam[g, v].tolist(),
                    "conf": conf[g].tolist(),
                    "residual": float(res[g].mean()),
                }
                if gt3 is not None:
                    gt_rel = gt3[g, v] - gt3[g, v, root:root + 1]
                    errs.append(np.linalg.norm(rel - gt_rel, axis=-1).mean())
    loop_s = time.perf_counter() - t_loop
    with open(args.out, "w") as f:
        json.dump(results, f)
    print(f"wrote {args.out}: {len(results)} records")
    mpjpe = float(np.mean(errs)) if errs else None
    if errs:
        print(f"pseudo-GT MPJPE vs dataset GT: {mpjpe:.2f} mm")
    merged = None
    if args.merge_into:
        from epipolarpose_tpu_torch.data.pseudo_gt import (
            merge_pseudo_gt_into_annot)
        out = args.merge_out or f"{args.merge_into}.pseudo.json"
        merged = merge_pseudo_gt_into_annot(args.merge_into, args.out, out,
                                            conf_min=args.merge_conf_min)
        print(f"merged pseudo-GT into {merged} records -> {out}")
    return {"records": len(results), "mpjpe": mpjpe, "merged": merged,
            "out": args.out, "loop_s": loop_s}


if __name__ == "__main__":
    main()
