"""Training state, optimizer and learning-rate schedule.

Counterpart of the JAX package's ``core/train_state.py``: Adam or SGD from
``TRAIN.OPTIMIZER`` and the MultiStep schedule (``LR`` times ``LR_FACTOR``
at each epoch of ``LR_STEP``), as ``torch.optim`` objects. The schedule's
boundaries are in optimizer steps (``LR_STEP[i] * steps_per_epoch``), as
the JAX schedule counts them: the train step calls ``scheduler.step()``
after every ``optimizer.step()``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN statistics), its optimizer, the
    schedule, and the number of optimizer steps taken."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def make_optimizer(cfg, params) -> torch.optim.Optimizer:
    """``adam``: Adam with eps 1e-8 and no weight decay (``optax.adam``).
    ``sgd``: SGD with ``MOMENTUM``, ``NESTEROV`` and ``WD``; torch adds the
    decay to the gradient before the momentum, as the JAX package's
    ``add_decayed_weights -> sgd`` chain does."""
    lr = float(cfg.TRAIN.LR)
    name = str(cfg.TRAIN.OPTIMIZER).lower()
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr,
                               momentum=float(cfg.TRAIN.MOMENTUM),
                               nesterov=bool(cfg.TRAIN.NESTEROV),
                               weight_decay=float(cfg.TRAIN.WD))
    raise ValueError(f"unknown TRAIN.OPTIMIZER: {cfg.TRAIN.OPTIMIZER}")


def make_lr_schedule(cfg, optimizer: torch.optim.Optimizer,
                     steps_per_epoch: int
                     ) -> torch.optim.lr_scheduler.MultiStepLR:
    """MultiStep: the rate is multiplied by ``LR_FACTOR`` once the step
    count reaches each ``LR_STEP[i] * steps_per_epoch``."""
    milestones = sorted({int(e) * steps_per_epoch for e in cfg.TRAIN.LR_STEP})
    return torch.optim.lr_scheduler.MultiStepLR(
        optimizer, milestones, gamma=float(cfg.TRAIN.LR_FACTOR))


def create_train_state(cfg, model: torch.nn.Module,
                       steps_per_epoch: int = 1000,
                       device: str | torch.device = "cuda") -> TrainState:
    """Move ``model`` (already initialized) to ``device`` and build its
    optimizer and schedule."""
    model = model.to(device)
    optimizer = make_optimizer(cfg, model.parameters())
    return TrainState(model, optimizer,
                      make_lr_schedule(cfg, optimizer, steps_per_epoch))
