"""Single-image 3D pose demo: the JAX package's ``scripts/demo.py`` on the
card.

    python -m epipolarpose_tpu_torch.scripts.demo --cfg experiments/h36m/valid_r50_256_integral.yaml \
        [--image person.jpg] [--model-file <ckpt>] [--refiner-file refiner.pth] [--out demo_out]

Read the image (without ``--image``: a synthetic sample, no files needed)
-> centre and scale box -> affine crop to ``IMAGE_SIZE`` -> the eval step
(soft-argmax decode) -> root-relative 3D joints lifted to camera mm by a
nominal pinhole (``--focal``, ``--root-depth``) -> the optional refiner
-> ``pose_2d.png`` (joints on the crop) and ``pose_3d.png`` (the
skeleton). ``--image`` is decoded by ``data/zipreader.py::imread``: a
JPEG by the native loader where it is built, else by the port's own
decoder (no libjpeg, no OpenCV); other formats by OpenCV.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.scripts.common import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="3D pose demo (GPU)")
    p.add_argument("--cfg", required=True)
    p.add_argument("--image", default=None)
    p.add_argument("--model-file", default=None)
    p.add_argument("--out", default="demo_out")
    p.add_argument("--refiner-file", default=None,
                   help="a trained refinement unit (.pth from "
                        "train_refiner), applied to the predicted 3D pose")
    p.add_argument("--focal", type=float, default=1150.0,
                   help="nominal focal length (px) for lifting (x, y) "
                        "pixels to camera-frame mm (H36M cameras ~1150)")
    p.add_argument("--root-depth", type=float, default=4500.0,
                   help="assumed absolute root depth (mm) for the lift")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs a card) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the demo; returns the predictions and the files written."""
    args = parse_args(argv)
    cfg = load_config(args.cfg)
    if args.model_file:
        cfg.TEST.MODEL_FILE = args.model_file
    device = resolve_device(args.device)

    from epipolarpose_tpu_torch.core.checkpoint import load_model_variables
    from epipolarpose_tpu_torch.core.steps import (configure_backends,
                                                   make_eval_step)
    from epipolarpose_tpu_torch.data.imgproc import warp_affine_f32
    from epipolarpose_tpu_torch.geometry.affine import get_affine_transform_np
    from epipolarpose_tpu_torch.models import get_model
    from epipolarpose_tpu_torch.utils.vis import (plot_3d_skeleton,
                                                  save_batch_image_with_joints)

    configure_backends(cfg)
    os.makedirs(args.out, exist_ok=True)
    model = get_model(cfg, False, torch.Generator().manual_seed(0))
    if cfg.TEST.MODEL_FILE:
        load_model_variables(model, cfg.TEST.MODEL_FILE)
        print(f"loaded {cfg.TEST.MODEL_FILE}")

    W, H = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
    if args.image:
        from epipolarpose_tpu_torch.data.zipreader import imread
        img = imread(args.image, rgb=True).astype(np.float32) / 255.0
        h, w = img.shape[:2]
        center = np.array([w / 2, h / 2], np.float32)
        scale = np.array([max(w, h) / 200.0] * 2, np.float32)
    else:
        from epipolarpose_tpu_torch.data import SyntheticPoseDataset
        ds = SyntheticPoseDataset(cfg, num_samples=1, is_train=False)
        rec = ds.records[0]
        img = ds._read_image(rec.image).astype(np.float32) / 255.0
        center, scale = rec.center, rec.scale
        print("no --image given: using a synthetic sample")

    # crop as the dataset does (eval: no rotation)
    M = get_affine_transform_np(center, scale, 0.0, (W, H))
    crop = warp_affine_f32(img, M, (W, H))
    batch = {"input": crop[None], "center": center[None],
             "scale": scale[None]}
    preds = make_eval_step(cfg, model, device=device)(batch)["preds"]
    preds = preds.cpu().numpy()[0]

    overlay = os.path.join(args.out, "pose_2d.png")
    save_batch_image_with_joints(batch["input"], _to_crop(preds, M)[None],
                                 np.ones((1, preds.shape[0], 1)), overlay)
    print(f"wrote {overlay}")
    out = {"preds": preds, "files": [overlay]}

    if preds.shape[-1] == 3:
        # lift (x px, y px, z rel-mm) to camera-frame mm with a nominal
        # pinhole: the units of the 3D plot and of the refiner, which is
        # trained on root-relative camera-frame mm poses
        h_src, w_src = img.shape[:2]
        z_abs = args.root_depth + preds[:, 2]
        x_mm = (preds[:, 0] - w_src / 2) / args.focal * z_abs
        y_mm = (preds[:, 1] - h_src / 2) / args.focal * z_abs
        pose3d = np.stack([x_mm, y_mm, z_abs], axis=-1)
        pose3d = (pose3d - pose3d[:1]).astype(np.float32)
        if args.refiner_file:
            from epipolarpose_tpu_torch.core.self_supervised import \
                load_refiner
            refine = load_refiner(cfg, args.refiner_file, device)
            pose3d = refine(pose3d[None]).cpu().numpy()[0]
            print(f"applied refiner {args.refiner_file}")
        plot = os.path.join(args.out, "pose_3d.png")
        plot_3d_skeleton(pose3d, plot, title="predicted 3D pose (mm)")
        print(f"wrote {plot}")
        out.update(pose3d=pose3d, files=[overlay, plot])
    return out


def _to_crop(preds, M):
    """Source-image (x, y) -> crop pixels, for the overlay."""
    return preds[:, :2] @ M[:, :2].T + M[:, 2]


if __name__ == "__main__":
    main()
