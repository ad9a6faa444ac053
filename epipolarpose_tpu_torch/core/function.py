"""Epoch loops: the reference ``train`` and ``validate`` shapes.

Counterpart of the JAX package's ``core/function.py`` (``AverageMeter``,
``train``, ``validate``) for one process and one batch per step
(``TPU.FUSED_STEPS`` has no counterpart here). ``train`` waits for the
card only when it logs; ``validate`` gathers predictions on the host and
hands them to ``dataset.evaluate``.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

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


def train(cfg, loader, state, train_step, epoch: int):
    """One training epoch of ``train_step`` over ``loader`` (any iterable
    of batches). Logs every ``PRINT_FREQ`` batches, the only points where
    it waits for the card. Returns (state, average of the logged losses).
    """
    if cfg.DEBUG.DEBUG:
        raise NotImplementedError("DEBUG.DEBUG image dumps need utils/vis, "
                                  "which is not ported yet")
    batch_time, data_time, losses = (AverageMeter(), AverageMeter(),
                                     AverageMeter())
    end = time.time()
    metrics = None
    for i, batch in enumerate(loader):
        data_time.update(time.time() - end)
        state, metrics = train_step(state, batch)
        n = int(batch["input"].shape[0])
        if i % int(cfg.PRINT_FREQ) == 0:
            losses.update(float(metrics["loss"]), n)   # waits for the card
            batch_time.update(time.time() - end)
            speed = n / max(batch_time.val, 1e-9)
            logger.info(f"Epoch: [{epoch}][{i}]\t"
                        f"Time {batch_time.val:.3f}s ({speed:.1f} "
                        f"samples/s)\tData {data_time.val:.3f}s\t"
                        f"Loss {losses.val:.5f} ({losses.avg:.5f})")
        end = time.time()
    if metrics is not None and losses.count == 0:
        losses.update(float(metrics["loss"]))
    return state, losses.avg


def validate(cfg, loader, dataset, eval_step, output_dir=None):
    """Run ``eval_step`` over ``loader`` and score with ``dataset.evaluate``.

    ``loader`` is any iterable of batches; ``dataset`` has ``__len__`` and
    ``evaluate(cfg, preds, output_dir)``. Returns (name_values, perf).
    """
    all_preds, all_boxes = [], []
    n_seen = 0
    t0 = time.perf_counter()
    for batch in loader:
        preds = eval_step(batch)["preds"].cpu().numpy()  # waits for the card
        c, s = _host(batch["center"]), _host(batch["scale"])
        all_preds.append(preds)
        all_boxes.append(np.concatenate(
            [c, s, np.prod(s * 200, axis=-1, keepdims=True)], axis=-1))
        n_seen += preds.shape[0]
    total = time.perf_counter() - t0
    preds = np.concatenate(all_preds)[:len(dataset)]
    logger.info(f"validate: {n_seen} samples in {total:.3f}s "
                f"({n_seen / max(total, 1e-9):.1f} samples/s)")
    if output_dir:
        np.savez(os.path.join(output_dir, "pred.npz"), preds=preds,
                 boxes=np.concatenate(all_boxes)[:len(dataset)])
    name_values, perf = dataset.evaluate(cfg, preds, output_dir)
    if isinstance(name_values, dict):
        _print_name_value(name_values, cfg.MODEL.NAME)
    return name_values, perf


def _print_name_value(name_value: dict, full_arch_name: str):
    """Markdown metric table, as the reference logs it."""
    names = list(name_value.keys())
    values = list(name_value.values())
    logger.info("| Arch " + " ".join(f"| {n}" for n in names) + " |")
    logger.info("|---" * (len(names) + 1) + "|")
    logger.info(f"| {full_arch_name} "
                + " ".join(f"| {v:.3f}" for v in values) + " |")
