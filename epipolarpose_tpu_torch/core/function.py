"""Epoch loops: the reference ``train`` and ``validate`` shapes.

Counterpart of the JAX package's ``core/function.py`` (``AverageMeter``,
``train``, ``validate``). A loader yields batches, or with
``TPU.FUSED_STEPS = K > 1`` K-stacked super-batches for a fused step,
whose metrics and predictions carry a leading (K,) axis. ``train`` waits
for the card only when it logs; ``validate`` gathers predictions on the
host (from every data group under data parallelism: the processes of a
model group hold the same predictions) and hands them to
``dataset.evaluate``. A ``writer`` is anything with tensorboard's
``add_scalar(tag, value, step)``. Under data parallelism every process
runs the loops and only the first writes files and scalars.

Spans (``telemetry``): ``loop.data_wait`` around each ``next`` of the
loader, ``loop.log`` around ``train``'s read of the loss and
``loop.to_host`` around ``validate``'s copy of the predictions, the two
points where a loop waits for the card.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from epipolarpose_tpu_torch import telemetry
from epipolarpose_tpu_torch.parallel.mesh import (data_count, data_group,
                                                  process_allgather,
                                                  process_index)

logger = logging.getLogger(__name__)


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _mean(a) -> float:
    """A metric's value: a fused step's (K,) metrics averaged."""
    return float(np.mean(_host(a)))


def _waited(loader):
    """``loader``'s batches, each ``next`` inside a ``loop.data_wait``
    span."""
    batches = iter(loader)
    end = object()
    while True:
        with telemetry.span("loop.data_wait"):
            batch = next(batches, end)
        if batch is end:
            return
        yield batch


def train(cfg, loader, state, train_step, epoch: int, writer=None,
          output_dir=None):
    """One training epoch of ``train_step`` over ``loader`` (any iterable
    of batches). Every ``PRINT_FREQ`` batches it logs the loss (and the
    accuracy, when the step gives one), writes them to ``writer``
    (``add_scalar`` at the optimizer step), and with ``DEBUG.DEBUG`` dumps
    the batch's images for a single-view batch into ``output_dir``: the
    only points where it waits for the card. The loss is the step's, a
    mean over the processes; samples/s counts the global batches since
    the previous log over the wall time since it.

    A fused step is told by the rank of its metrics, not their size: a
    tail super-batch of one stacked batch has (1,) metrics and still
    counts its ``input.shape[1]`` samples. Its logged loss is the mean
    over the K steps, weighted by K_tail x B samples; the DEBUG dump takes
    its first inner batch. Returns (state, average of the logged losses).
    """
    if process_index() != 0:
        writer = output_dir = None
    batch_time, data_time = AverageMeter(), AverageMeter()
    losses, accs = AverageMeter(), AverageMeter()
    end = last_log = time.time()
    since_log = 0
    metrics = None
    for i, batch in enumerate(_waited(loader)):
        data_time.update(time.time() - end)
        state, metrics = train_step(state, batch)
        fused = np.ndim(metrics["loss"]) >= 1
        n = int(batch["input"].shape[0]) * data_count()
        if fused:
            n *= int(batch["input"].shape[1])
        since_log += n
        if i % int(cfg.PRINT_FREQ) == 0:
            first = {k: batch[k][0] if fused else batch[k]
                     for k in ("input", "joints", "joints_vis")
                     if k in batch}
            if (cfg.DEBUG.DEBUG and output_dir is not None
                    and first["input"].ndim == 4):
                from epipolarpose_tpu_torch.utils.vis import save_debug_images
                dbg = {k: _host(v) for k, v in first.items()}
                save_debug_images(cfg, dbg, None, None, None,
                                  f"{output_dir}/train_{epoch}_{i}")
            with telemetry.span("loop.log"):
                loss_v = _mean(metrics["loss"])      # waits for the card
                acc_v = _mean(metrics["acc"]) if "acc" in metrics else None
            losses.update(loss_v, n)
            if acc_v is not None:
                accs.update(acc_v, n)
            now = time.time()
            batch_time.update(now - end)
            speed = since_log / max(now - last_log, 1e-9)
            since_log, last_log = 0, now
            msg = (f"Epoch: [{epoch}][{i}]\t"
                   f"Time {batch_time.val:.3f}s ({speed:.1f} samples/s)\t"
                   f"Data {data_time.val:.3f}s\t"
                   f"Loss {losses.val:.5f} ({losses.avg:.5f})")
            if acc_v is not None:
                msg += f"\tAccuracy {accs.val:.3f} ({accs.avg:.3f})"
            logger.info(msg)
            if writer is not None:
                writer.add_scalar("train/loss", loss_v, int(state.step))
                if acc_v is not None:
                    writer.add_scalar("train/acc", acc_v, int(state.step))
        end = time.time()
    if metrics is not None and losses.count == 0:
        losses.update(_mean(metrics["loss"]))
    return state, losses.avg


def validate(cfg, loader, dataset, eval_step, output_dir=None, writer=None,
             step: int = 0):
    """Run ``eval_step`` over ``loader`` and score with ``dataset.evaluate``.

    ``loader`` is any iterable of batches; ``dataset`` has ``__len__`` and
    ``evaluate(cfg, preds, output_dir)``. The perf goes to ``writer`` at
    ``step``. Under data parallelism each data group's loader holds its
    slice of every global batch: the predictions and boxes of every data
    group are gathered back into the global order (over the data group:
    the processes of a model group hold the same ones), and every process
    evaluates them (the first alone with ``output_dir`` and ``writer``). A fused
    eval step's (K, B, J, C) predictions and their (K, B, 2) centres and
    scales are flattened to K x B rows. Returns (name_values, perf).
    """
    if process_index() != 0:
        writer = output_dir = None
    all_preds, all_boxes = [], []
    n_seen = n_batches = 0
    t0 = time.perf_counter()
    for batch in _waited(loader):
        out = eval_step(batch)
        with telemetry.span("loop.to_host"):
            preds = out["preds"].cpu().numpy()       # waits for the card
        c, s = _host(batch["center"]), _host(batch["scale"])
        if preds.ndim == 4:      # a fused super-batch: (K, B, J, C)
            n_batches += preds.shape[0]
            preds = preds.reshape((-1,) + preds.shape[2:])
            c, s = c.reshape(-1, c.shape[-1]), s.reshape(-1, s.shape[-1])
        else:
            n_batches += 1
        all_preds.append(preds)
        all_boxes.append(np.concatenate(
            [c, s, np.prod(s * 200, axis=-1, keepdims=True)], axis=-1))
        n_seen += preds.shape[0]
    total = time.perf_counter() - t0
    preds = _gather_batches(np.concatenate(all_preds), n_batches)
    boxes = _gather_batches(np.concatenate(all_boxes), n_batches)
    n_seen *= data_count()
    preds, boxes = preds[:len(dataset)], boxes[:len(dataset)]
    logger.info(f"validate: {n_seen} samples in {total:.3f}s "
                f"({n_seen / max(total, 1e-9):.1f} samples/s)")
    if output_dir:
        np.savez(os.path.join(output_dir, "pred.npz"), preds=preds,
                 boxes=boxes)
    name_values, perf = dataset.evaluate(cfg, preds, output_dir)
    if isinstance(name_values, dict):
        _print_name_value(name_values, cfg.MODEL.NAME)
    if writer is not None:
        writer.add_scalar("valid/perf", float(perf), int(step))
    return name_values, perf


def _gather_batches(local: np.ndarray, n_batches: int) -> np.ndarray:
    """Rows of ``n_batches`` batches, each data group holding its
    contiguous slice of every global batch, -> the global batches' rows
    in order."""
    rows = process_allgather(local, data_group())
    if data_count() == 1:
        return rows
    rows = rows.reshape((data_count(), n_batches, -1) + local.shape[1:])
    return rows.swapaxes(0, 1).reshape((-1,) + local.shape[1:])


def _print_name_value(name_value: dict, full_arch_name: str):
    """Markdown metric table, as the reference logs it."""
    names = list(name_value.keys())
    values = list(name_value.values())
    logger.info("| Arch " + " ".join(f"| {n}" for n in names) + " |")
    logger.info("|---" * (len(names) + 1) + "|")
    logger.info(f"| {full_arch_name} "
                + " ".join(f"| {v:.3f}" for v in values) + " |")
