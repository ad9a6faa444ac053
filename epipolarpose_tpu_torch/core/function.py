"""Validation loop: the reference ``validate`` shape, driving the eval step.

Counterpart of the JAX package's ``core/function.py`` (``AverageMeter``,
``validate``) for one process: predictions are gathered on the host and
handed to ``dataset.evaluate``.
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
