"""Evaluation CLI: the JAX package's ``scripts/valid.py`` on the card.

    python -m epipolarpose_tpu_torch.scripts.valid --cfg experiments/h36m/valid_r50_256_integral.yaml \
        --model-file output/.../checkpoints/final_state.pth.tar
    python -m epipolarpose_tpu_torch.scripts.valid --cfg ... --synthetic   # data-free

Loads ``TEST.MODEL_FILE`` (a ``.pth`` / ``.pth.tar`` file or a
``checkpoints`` directory), runs ``validate`` on the test split, logs the
metric table and ``perf: <value>``: MPJPE (mm, lower is better) on H36M,
PCK3D@150 (percent, higher is better) on MPI-INF-3DHP, where
``experiments/h36m/valid_3dhp_transfer.yaml`` scores an H36M model on the
3DHP test set (``DATASET.ROOT`` or ``--dataDir`` points at the tree; its
JPEG frames need no OpenCV).
"""

from __future__ import annotations

import argparse

import torch

from epipolarpose_tpu_torch.config import load_config, update_dir
from epipolarpose_tpu_torch.scripts.common import (dataset_kwargs,
                                                   refuse_unported,
                                                   resolve_device,
                                                   use_synthetic)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Validate a pose network (GPU)")
    p.add_argument("--cfg", required=True)
    p.add_argument("--model-file", default=None,
                   help="override TEST.MODEL_FILE")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--samples", type=int, default=64)
    p.add_argument("--modelDir", type=str, default=None)
    p.add_argument("--logDir", type=str, default=None)
    p.add_argument("--dataDir", type=str, default=None)
    p.add_argument("--distributed", action="store_true",
                   help="multi-GPU evaluation (not ported: refused)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs a card) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> float:
    """Run the CLI; returns the perf."""
    args = parse_args(argv)
    cfg = load_config(args.cfg)
    update_dir(cfg, args.modelDir, args.logDir, args.dataDir)
    if args.model_file:
        cfg.TEST.MODEL_FILE = args.model_file
    if args.synthetic:
        use_synthetic(cfg, train=False)
    refuse_unported(cfg, args.distributed)
    device = resolve_device(args.device)

    from epipolarpose_tpu_torch.core import make_eval_step, validate
    from epipolarpose_tpu_torch.core.checkpoint import load_model_variables
    from epipolarpose_tpu_torch.core.logger import create_logger
    from epipolarpose_tpu_torch.core.steps import configure_backends
    from epipolarpose_tpu_torch.data import epoch_loader, get_dataset
    from epipolarpose_tpu_torch.models import get_model

    configure_backends(cfg)
    logger, output_dir, _ = create_logger(cfg, args.cfg, "valid")
    model = get_model(cfg, False, torch.Generator().manual_seed(0))
    if cfg.TEST.MODEL_FILE:
        load_model_variables(model, cfg.TEST.MODEL_FILE)
        logger.info(f"loaded {cfg.TEST.MODEL_FILE}")
    ds = get_dataset(cfg, cfg.DATASET.TEST_SET, False,
                     **dataset_kwargs(cfg, args.samples))
    estep = make_eval_step(cfg, model, getattr(ds, "flip_pairs", ()),
                           device=device)
    loader = epoch_loader(ds, int(cfg.TEST.BATCH_SIZE), 0, is_train=False,
                          device=device)
    _, perf = validate(cfg, loader, ds, estep, output_dir=output_dir)
    logger.info(f"perf: {perf:.6f}")
    return perf


if __name__ == "__main__":
    main()
