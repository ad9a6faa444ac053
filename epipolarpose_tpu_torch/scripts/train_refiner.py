"""Train the pose refinement unit: the JAX package's
``scripts/train_refiner.py`` on the card.

    python -m epipolarpose_tpu_torch.scripts.train_refiner --cfg experiments/h36m/train_fs_r50_256_integral.yaml \
        [--synthetic] [--steps 1000] [--out output/refiner]

Pairs (the refiner denoises triangulated poses):

- ``--synthetic``: kinematic-tree skeletons (constant bones) are projected
  through the 4-camera rig, the 2D detections corrupted (Gaussian pixel
  noise and outlier detections), undistorted and triangulated (``fast``:
  the triangulation kernel on the card); the triangulation is the input,
  the skeleton the target, root-relative in each camera's frame.
- a real dataset: GT poses corrupted by ``core.refine.synth_noise``.

Reports the MPJPE before and after on a held-out tenth of the poses and
writes ``<out>/refiner.pth``, which ``load_refiner`` (``TPU.SS_REFINER``,
``demo --refiner-file``) reads.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.scripts.common import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train the refinement unit")
    p.add_argument("--cfg", required=True)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--poses", type=int, default=2048,
                   help="synthetic pose-bank size (before x4 camera frames)")
    p.add_argument("--noise-mm", type=float, default=25.0,
                   help="real-dataset path: synth_noise sigma")
    p.add_argument("--px-sigma", type=float, default=2.5,
                   help="synthetic path: 2D detection noise (px)")
    p.add_argument("--outlier-prob", type=float, default=0.07,
                   help="synthetic path: per-(view, joint) outlier rate")
    p.add_argument("--hidden", type=int, default=1024,
                   help="refiner width")
    p.add_argument("--blocks", type=int, default=2)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--out", default="output/refiner")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs a card) or cpu")
    return p.parse_args(argv)


def _triangulated_pairs(rng: np.random.Generator, n_poses: int, J: int,
                        px_sigma: float, outlier_prob: float,
                        device: torch.device):
    """(noisy, gt) root-relative camera-frame pairs from the synthetic rig,
    each (4 * n_poses, J, 3) float32 numpy, pose-major (the 4 views of a
    pose are adjacent, so a split of the last rows splits poses)."""
    from epipolarpose_tpu_torch.data.synthetic import (make_rig,
                                                       synth_skeleton_poses)
    from epipolarpose_tpu_torch.geometry.camera import (Camera,
                                                        project_point_radial,
                                                        undistort_points,
                                                        world_to_camera_frame)
    from epipolarpose_tpu_torch.kernels.triangulate import triangulate_fast

    gt_world = synth_skeleton_poses(rng, n_poses, J)
    gt_world = gt_world + rng.uniform(
        -300, 300, (n_poses, 1, 3)).astype(np.float32)
    gt_world[..., 2] += 900.0           # the rig looks at z ~ 900

    rig = make_rig(4)
    V = len(rig)
    cam = Camera.stack(rig)
    gt_t = torch.from_numpy(gt_world)
    det = np.zeros((n_poses, V, J, 2), np.float32)
    for v, c in enumerate(rig):
        det[:, v] = project_point_radial(gt_t, c)[0].numpy()
    det += rng.normal(0, px_sigma, det.shape).astype(np.float32)
    is_out = rng.random((n_poses, V, J, 1)) < outlier_prob
    det += np.where(is_out,
                    rng.uniform(-60, 60, det.shape), 0).astype(np.float32)

    und = undistort_points(torch.from_numpy(det), cam)
    x_w, _ = triangulate_fast(und.to(device).contiguous(),
                              cam.P.to(device).contiguous())
    x_w = x_w.cpu()
    noisy = torch.stack([world_to_camera_frame(x_w, c) for c in rig], 1)
    gt = torch.stack([world_to_camera_frame(gt_t, c) for c in rig], 1)
    return (noisy.reshape(n_poses * V, J, 3).numpy().astype(np.float32),
            gt.reshape(n_poses * V, J, 3).numpy().astype(np.float32))


def main(argv=None) -> dict:
    """Run the CLI; returns the MPJPE before and after and the file."""
    args = parse_args(argv)
    cfg = load_config(args.cfg)
    if args.synthetic:
        cfg.DATASET.DATASET = "synthetic_multiview"
    device = resolve_device(args.device)

    from epipolarpose_tpu_torch.core.checkpoint import atomic_save
    from epipolarpose_tpu_torch.core.refine import (create_refiner_state,
                                                    make_refiner_apply,
                                                    make_refiner_train_step,
                                                    synth_noise)
    from epipolarpose_tpu_torch.ops.metrics import mpjpe

    J = int(cfg.MODEL.NUM_JOINTS)
    rng = np.random.default_rng(0)
    if str(cfg.DATASET.DATASET).startswith("synthetic"):
        noisy, gt = _triangulated_pairs(rng, args.poses, J, args.px_sigma,
                                        args.outlier_prob, device)
    else:
        from epipolarpose_tpu_torch.data import get_dataset
        ds = get_dataset(cfg, cfg.DATASET.TRAIN_SET, False)
        gt = np.stack([r.joints_3d for r in ds.records
                       if r.joints_3d is not None]).astype(np.float32)
        noisy = synth_noise(torch.from_numpy(gt), sigma_mm=args.noise_mm,
                            generator=torch.Generator().manual_seed(2)
                            ).numpy()
    # root-relative: the frame the refiner is applied in everywhere
    noisy = torch.from_numpy(noisy - noisy[:, :1]).to(device)
    gt = torch.from_numpy(gt - gt[:, :1]).to(device)
    n_val = max(len(gt) // 10, 1)
    train_n, val_n = noisy[:-n_val], noisy[-n_val:]
    train_g, val_g = gt[:-n_val], gt[-n_val:]

    model, state = create_refiner_state(
        J, torch.Generator().manual_seed(0), hidden=args.hidden,
        blocks=args.blocks, dropout=args.dropout, device=device)
    step = make_refiner_train_step(model)
    apply = make_refiner_apply(model)
    gen = torch.Generator(device=device).manual_seed(1)
    for i in range(args.steps):
        idx = torch.from_numpy(rng.integers(0, len(train_n), args.batch)
                               ).to(device)
        state, loss = step(state, train_n[idx], train_g[idx], gen)
        if i % 100 == 0:
            print(f"step {i}: loss {float(loss):.3f}")

    before = float(mpjpe(val_n, val_g))
    after = float(mpjpe(apply(state, val_n), val_g))
    print(f"MPJPE noisy->GT: {before:.2f} mm ; refined->GT: {after:.2f} mm")

    os.makedirs(args.out, exist_ok=True)
    path = os.path.abspath(os.path.join(args.out, "refiner.pth"))
    atomic_save({"state_dict": model.state_dict()}, path)
    print(f"saved {path}")
    return {"before_mm": before, "after_mm": after, "path": path,
            "loss": float(loss) if args.steps else None}


if __name__ == "__main__":
    main()
