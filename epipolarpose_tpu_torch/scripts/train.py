"""Training CLI: the JAX package's ``scripts/train.py`` on the card.

    python -m epipolarpose_tpu_torch.scripts.train --cfg experiments/h36m/train_fs_r50_256_integral.yaml
    python -m epipolarpose_tpu_torch.scripts.train --cfg ... --synthetic --epochs 2   # data-free
    python -m epipolarpose_tpu_torch.scripts.train --cfg ... --device cpu             # the CPU
    python -m torch.distributed.run --nproc-per-node 8 \
        -m epipolarpose_tpu_torch.scripts.train --cfg ... --distributed       # 8 cards

The flow: config -> logger and metric writer -> model -> datasets ->
optimizer and schedule (its boundaries in optimizer steps: view groups for
the SS route) -> the ``MODEL.PRETRAINED`` merge -> ``CheckpointManager``
in the dataset's metric direction -> ``TRAIN.RESUME`` -> the SS step
(teacher from ``MODEL.PRETRAINED``, refiner from ``TPU.SS_REFINER``) or
the fully supervised / 2D step -> each epoch ``epoch_loader`` ->
``train`` -> ``validate`` -> a checkpoint -> the final weights. With
``TPU.FUSED_STEPS: K`` the loaders stack K batches a super-batch and the
train and eval steps run K steps a call (one CUDA-graph replay on the
card).

``--distributed`` runs one process per card under
``torch.distributed.run``, as the JAX script runs one per host, on a
``(data, model)`` mesh (``TPU.MESH``): the global batch is
``TRAIN.BATCH_SIZE`` (and ``TEST.BATCH_SIZE``) times the data axis, the
schedule counts global batches, each data group decodes its slice of
every batch, with ``TPU.MESH.MODEL > 1`` each process of a data group
runs the network on its rows of the crops (``models.partition_rows``:
halo exchanges; the teacher's too), the model trains through
``parallel.wrap_model`` (batch norm over the global batch, DDP), and the
first process writes the logs and checkpoints.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from epipolarpose_tpu_torch.config import load_config, update_dir
from epipolarpose_tpu_torch.scripts.common import (dataset_kwargs,
                                                   log_processes,
                                                   refuse_unported,
                                                   resolve_device,
                                                   setup_processes,
                                                   use_synthetic)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a pose network (GPU)")
    p.add_argument("--cfg", required=True, help="experiment yaml")
    p.add_argument("--workers", type=int, default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic dataset (no files needed)")
    p.add_argument("--samples", type=int, default=256,
                   help="synthetic dataset size")
    p.add_argument("--epochs", type=int, default=None,
                   help="override TRAIN.END_EPOCH")
    p.add_argument("--modelDir", type=str, default=None)
    p.add_argument("--logDir", type=str, default=None)
    p.add_argument("--dataDir", type=str, default=None)
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler Chrome trace of the first "
                        "epoch, from its third step, into the log "
                        "directory (the first process's)")
    p.add_argument("--distributed", action="store_true",
                   help="one process per card under torch.distributed.run "
                        "(nccl; gloo with --device cpu)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs a card) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; returns ``{"state", "loss", "perf", "best_perf",
    "output_dir", "final"}`` (the last epoch's average logged loss and
    perf) for callers in Python."""
    args = parse_args(argv)
    cfg = load_config(args.cfg)
    update_dir(cfg, args.modelDir, args.logDir, args.dataDir)
    if args.workers is not None:
        cfg.WORKERS = args.workers
    if args.epochs is not None:
        cfg.TRAIN.END_EPOCH = args.epochs
    if args.synthetic:
        use_synthetic(cfg, train=True)
    refuse_unported(cfg)
    device, mesh = setup_processes(cfg, resolve_device(args.device),
                                   args.distributed)
    data = mesh[0]

    from epipolarpose_tpu_torch.core import (create_train_state,
                                             make_eval_step, make_train_step,
                                             train, validate)
    from epipolarpose_tpu_torch.core.checkpoint import (CheckpointManager,
                                                        merge_matching,
                                                        read_state_dict)
    from epipolarpose_tpu_torch.core.logger import (create_logger,
                                                    create_metric_writer)
    from epipolarpose_tpu_torch.core.steps import configure_backends
    from epipolarpose_tpu_torch.data import epoch_loader, get_dataset
    from epipolarpose_tpu_torch.models import get_model, partition_rows
    from epipolarpose_tpu_torch.parallel import (data_index, model_count,
                                                 process_index, wrap_model)

    configure_backends(cfg)
    logger, output_dir, tb_dir = create_logger(cfg, args.cfg, "train")
    log_processes(logger, device, mesh, args.distributed)
    writer = create_metric_writer(tb_dir)

    model = get_model(cfg, True,
                      torch.Generator().manual_seed(int(cfg.TPU.SEED)))
    kw = dataset_kwargs(cfg, args.samples)
    train_ds = get_dataset(cfg, cfg.DATASET.TRAIN_SET, True, **kw)
    valid_ds = get_dataset(cfg, cfg.DATASET.TEST_SET, False, **kw)

    # global batches: the JAX script's BATCH_SIZE x the mesh's data axis
    batch_size = int(cfg.TRAIN.BATCH_SIZE) * data
    self_supervised = cfg.DATASET.LABEL_SOURCE == "triangulated"
    # the schedule counts optimizer steps: one a view group batch for SS
    epoch_units = (len(train_ds.view_groups) if self_supervised
                   else len(train_ds))
    steps_per_epoch = max(epoch_units // batch_size, 1)
    state = create_train_state(cfg, model, steps_per_epoch, device)

    if cfg.MODEL.PRETRAINED:
        logger.info(f"loading pretrained {cfg.MODEL.PRETRAINED}")
        merge_matching(model, read_state_dict(cfg.MODEL.PRETRAINED))

    higher_better = bool(getattr(valid_ds, "perf_higher_is_better", True))
    ckpt = CheckpointManager(os.path.join(output_dir, "checkpoints"),
                             best_mode="max" if higher_better else "min")
    begin_epoch = int(cfg.TRAIN.BEGIN_EPOCH)
    if cfg.TRAIN.RESUME:
        state, begin_epoch = ckpt.restore(state)
        logger.info(f"resumed at epoch {begin_epoch}, step {state.step}")

    flip_pairs = getattr(train_ds, "flip_pairs", ())
    if model_count() > 1:
        partition_rows(model)          # each process runs its image rows
    net = wrap_model(model) if args.distributed else model
    # K optimizer steps a call, one CUDA-graph replay on the card
    fused = int(cfg.TPU.FUSED_STEPS)
    if self_supervised:
        from epipolarpose_tpu_torch.core.self_supervised import (
            load_refiner, load_teacher, make_ss_train_step)
        teacher = load_teacher(cfg, device)
        if model_count() > 1:
            partition_rows(teacher.model)
        refiner = None
        if cfg.TPU.SS_REFINER:
            refiner = load_refiner(cfg, cfg.TPU.SS_REFINER, device)
            logger.info(f"refining pseudo-GT with {cfg.TPU.SS_REFINER}")
        tstep = make_ss_train_step(cfg, net, teacher, device=device,
                                   flip_pairs=flip_pairs, refiner=refiner,
                                   fused_steps=fused)
    else:
        tstep = make_train_step(cfg, net, device=device, fused_steps=fused)
    estep = make_eval_step(cfg, model, flip_pairs, device=device,
                           fused_steps=fused)

    best_perf = -np.inf if higher_better else np.inf
    perf = avg_loss = None
    # each data group decodes its slice of every batch
    shard = dict(process_index=data_index(), process_count=data)
    for epoch in range(begin_epoch, int(cfg.TRAIN.END_EPOCH)):
        loader = epoch_loader(train_ds, batch_size, epoch,
                              multiview=self_supervised,
                              prefetch=int(cfg.TPU.PREFETCH), device=device,
                              fused_steps=fused, **shard)
        if args.profile and epoch == begin_epoch and process_index() == 0:
            state, avg_loss = _profiled(cfg, loader, state, tstep, epoch,
                                        writer, output_dir, tb_dir, device,
                                        logger)
        else:
            state, avg_loss = train(cfg, loader, state, tstep, epoch, writer,
                                    output_dir)
        vloader = epoch_loader(valid_ds, int(cfg.TEST.BATCH_SIZE) * data,
                               epoch, is_train=False, device=device,
                               fused_steps=fused, **shard)
        _, perf = validate(cfg, vloader, valid_ds, estep, output_dir, writer,
                           state.step)
        best_perf = (max if higher_better else min)(best_perf, perf)
        ckpt.save(int(state.step), state, epoch, float(perf))
        logger.info(f"epoch {epoch}: loss {avg_loss:.5f} perf {perf:.3f} "
                    f"best {best_perf:.3f}")

    final = ckpt.save_final(state)
    ckpt.wait()
    ckpt.close()
    if writer is not None:
        writer.close()
    if args.distributed:
        torch.distributed.destroy_process_group()
    logger.info("done")
    return {"state": state, "loss": avg_loss, "perf": perf,
            "best_perf": best_perf,
            "output_dir": output_dir, "final": final}


def _profiled(cfg, loader, state, tstep, epoch, writer, output_dir, tb_dir,
              device, logger: logging.Logger):
    """``train`` for one epoch under ``torch.profiler``, recording from its
    third step on (the first carries cuDNN's autotuning, the second warms
    the profiler); writes the Chrome trace into ``tb_dir`` and logs its
    summary and the program's spans over the recorded steps
    (``telemetry.snapshot``)."""
    from epipolarpose_tpu_torch import telemetry
    from epipolarpose_tpu_torch.core import train
    from epipolarpose_tpu_torch.tools.trace_summary import summarize
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    steps = []
    with torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=1, warmup=1,
                                             active=1 << 30)) as prof:
        def stepped(st, batch):
            out = tstep(st, batch)
            steps.append(1)
            prof.step()
            return out
        out = train(cfg, loader, state, stepped, epoch, writer, output_dir)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    if len(steps) < 3:
        logger.info(f"--profile: {len(steps)} steps, none recorded (the "
                    "trace starts at the third)")
        return out
    path = os.path.join(tb_dir, f"trace_epoch{epoch}.json")
    prof.export_chrome_trace(path)
    logger.info(f"profiler trace of steps 3-{len(steps)} written to {path}: "
                f"{summarize(path, 10)}")
    logger.info("spans of the recorded steps, ms a call:\n"
                + telemetry.table(telemetry.snapshot()))
    return out


if __name__ == "__main__":
    main()
