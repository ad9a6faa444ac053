"""Evaluation CLI: the JAX package's ``scripts/valid.py`` on the card.

    python -m epipolarpose_tpu_torch.scripts.valid --cfg experiments/h36m/valid_r50_256_integral.yaml \
        --model-file output/.../checkpoints/final_state.pth.tar
    python -m epipolarpose_tpu_torch.scripts.valid --cfg ... --synthetic   # data-free
    python -m torch.distributed.run --nproc-per-node 8 \
        -m epipolarpose_tpu_torch.scripts.valid --cfg ... --distributed   # 8 cards

Loads ``TEST.MODEL_FILE`` (a ``.pth`` / ``.pth.tar`` file or a
``checkpoints`` directory), runs ``validate`` on the test split, logs the
metric table and ``perf: <value>``: MPJPE (mm, lower is better) on H36M,
PCK3D@150 (percent, higher is better) on MPI-INF-3DHP, where
``experiments/h36m/valid_3dhp_transfer.yaml`` scores an H36M model on the
3DHP test set (``DATASET.ROOT`` or ``--dataDir`` points at the tree; its
JPEG frames need no OpenCV). ``--distributed``: one process per card on
a ``(data, model)`` mesh (``TPU.MESH``), the global batch
``TEST.BATCH_SIZE`` times the data axis, each data group's slice of
every batch gathered back before ``evaluate``; with ``TPU.MESH.MODEL >
1`` each process of a data group runs the network on its rows of the
crops.
``TPU.FUSED_STEPS: K``: K batches a call of the eval step (one CUDA-graph
replay on the card).
"""

from __future__ import annotations

import argparse

import torch

from epipolarpose_tpu_torch.config import load_config, update_dir
from epipolarpose_tpu_torch.scripts.common import (dataset_kwargs,
                                                   log_processes,
                                                   refuse_unported,
                                                   resolve_device,
                                                   setup_processes,
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
                   help="one process per card under torch.distributed.run "
                        "(nccl; gloo with --device cpu)")
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
    refuse_unported(cfg)
    device, mesh = setup_processes(cfg, resolve_device(args.device),
                                   args.distributed)
    data = mesh[0]

    from epipolarpose_tpu_torch.core import make_eval_step, validate
    from epipolarpose_tpu_torch.core.checkpoint import load_model_variables
    from epipolarpose_tpu_torch.core.logger import create_logger
    from epipolarpose_tpu_torch.core.steps import configure_backends
    from epipolarpose_tpu_torch.data import epoch_loader, get_dataset
    from epipolarpose_tpu_torch.models import get_model, partition_rows
    from epipolarpose_tpu_torch.parallel import data_index, model_count

    configure_backends(cfg)
    logger, output_dir, _ = create_logger(cfg, args.cfg, "valid")
    log_processes(logger, device, mesh, args.distributed)
    model = get_model(cfg, False, torch.Generator().manual_seed(0))
    if cfg.TEST.MODEL_FILE:
        load_model_variables(model, cfg.TEST.MODEL_FILE)
        logger.info(f"loaded {cfg.TEST.MODEL_FILE}")
    ds = get_dataset(cfg, cfg.DATASET.TEST_SET, False,
                     **dataset_kwargs(cfg, args.samples))
    if model_count() > 1:
        partition_rows(model)          # each process runs its image rows
    fused = int(cfg.TPU.FUSED_STEPS)
    estep = make_eval_step(cfg, model, getattr(ds, "flip_pairs", ()),
                           device=device, fused_steps=fused)
    loader = epoch_loader(ds, int(cfg.TEST.BATCH_SIZE) * data, 0,
                          is_train=False, device=device,
                          process_index=data_index(), process_count=data,
                          fused_steps=fused)
    _, perf = validate(cfg, loader, ds, estep, output_dir=output_dir)
    logger.info(f"perf: {perf:.6f}")
    if args.distributed:
        torch.distributed.destroy_process_group()
    return perf


if __name__ == "__main__":
    main()
