"""Training state, optimizer and learning-rate schedule.

Counterpart of the JAX package's ``core/train_state.py``: Adam or SGD from
``TRAIN.OPTIMIZER`` and the MultiStep schedule (``LR`` times ``LR_FACTOR``
at each epoch of ``LR_STEP``), as ``torch.optim`` objects. The schedule's
boundaries are in optimizer steps (``LR_STEP[i] * steps_per_epoch``), as
the JAX schedule counts them: the train step calls ``scheduler.step()``
after every ``optimizer.step()``.

On the card the update is capturable into a CUDA graph: the rate is a
float32 tensor on the card, Adam runs with ``capturable=True`` (its step
count on the card too) and SGD with ``fused=True`` (the update that takes
a tensor rate without reading it back), and :class:`MultiStepSchedule`
sets the rate from a step count on the card. So a milestone that falls
inside a fused super-batch changes the rate at the same inner step as
optax's schedule inside the JAX package's scan. On the CPU the rate is a
Python float, as ``torch.optim.lr_scheduler.MultiStepLR`` keeps it.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN statistics), its optimizer, the
    schedule (None for the refinement unit's constant rate), and the
    number of optimizer steps taken."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: "MultiStepSchedule | None"
    step: int = 0


def make_optimizer(cfg, params, device: str | torch.device = "cpu"
                   ) -> torch.optim.Optimizer:
    """``adam``: Adam with eps 1e-8 and no weight decay (``optax.adam``).
    ``sgd``: SGD with ``MOMENTUM``, ``NESTEROV`` and ``WD``; torch adds the
    decay to the gradient before the momentum, as the JAX package's
    ``add_decayed_weights -> sgd`` chain does. On a CUDA ``device`` (where
    the parameters are) the rate is a tensor there and the update is
    capturable (module docstring)."""
    on_card = torch.device(device).type == "cuda"
    lr = float(cfg.TRAIN.LR)
    if on_card:
        lr = torch.tensor(lr, dtype=torch.float32, device=device)
    name = str(cfg.TRAIN.OPTIMIZER).lower()
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                capturable=on_card)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr,
                               momentum=float(cfg.TRAIN.MOMENTUM),
                               nesterov=bool(cfg.TRAIN.NESTEROV),
                               weight_decay=float(cfg.TRAIN.WD),
                               fused=on_card or None)
    raise ValueError(f"unknown TRAIN.OPTIMIZER: {cfg.TRAIN.OPTIMIZER}")


class MultiStepSchedule:
    """The rate of every param group times ``gamma`` once the step count
    reaches each milestone: ``torch.optim.lr_scheduler.MultiStepLR``'s
    rates and its ``step``, ``last_epoch``, ``milestones``,
    ``get_last_lr``, ``state_dict`` and ``load_state_dict``.

    A group whose rate is a tensor (the card) gets it from a step count
    on the card, in place, so :meth:`step` is graph-safe; a graph replay
    does not run it in Python, and the fused step adds its steps to
    ``last_epoch`` (``core/steps.py::fuse_steps``). A group whose rate is
    a float gets the float.
    """

    def __init__(self, optimizer: torch.optim.Optimizer, milestones,
                 gamma: float):
        self.optimizer = optimizer
        self.milestones = collections.Counter(int(m) for m in milestones)
        self.gamma = float(gamma)
        self.last_epoch = 0
        self._bounds = sorted(self.milestones)
        self.base_lrs, self._rates = [], []
        for group in optimizer.param_groups:
            # each milestone multiplies the last rate, as MultiStepLR does
            rates = [float(group["lr"])]
            for m in self._bounds:
                rates.append(rates[-1] * self.gamma ** self.milestones[m])
            self.base_lrs.append(rates[0])
            self._rates.append(rates)
        lr = optimizer.param_groups[0]["lr"]
        self._count = None
        if torch.is_tensor(lr):
            kw = dict(device=lr.device)
            self._count = torch.zeros((), dtype=torch.int64, **kw)
            self._bounds_t = torch.tensor(self._bounds, dtype=torch.int64,
                                          **kw)
            self._rates_t = [torch.tensor(r, dtype=torch.float32, **kw)
                             for r in self._rates]
            self._lrs = [g["lr"] for g in optimizer.param_groups]

    def _set_rates(self) -> None:
        if self._count is None:
            i = bisect.bisect_right(self._bounds, self.last_epoch)
            for group, rates in zip(self.optimizer.param_groups,
                                    self._rates):
                group["lr"] = rates[i]
            return
        i = (self._bounds_t <= self._count).sum().reshape(1)
        for lr, rates in zip(self._lrs, self._rates_t):
            lr.copy_(rates.index_select(0, i).reshape(()))

    def step(self) -> None:
        """One optimizer step taken: advance the count, set the rates."""
        self.last_epoch += 1
        if self._count is not None:
            self._count.add_(1)
        self._set_rates()

    def get_last_lr(self) -> list[float]:
        """The current rate of each group (read back from the card)."""
        return [float(g["lr"]) for g in self.optimizer.param_groups]

    def state_dict(self) -> dict:
        return {"milestones": collections.Counter(self.milestones),
                "gamma": self.gamma, "base_lrs": list(self.base_lrs),
                "last_epoch": self.last_epoch,
                "_last_lr": self.get_last_lr()}

    def load_state_dict(self, state: dict) -> None:
        """Restore the step count and set the rates for it. Call it after
        the optimizer's ``load_state_dict``, which replaces a tensor rate
        with the saved one: the group gets its tensor on the card back."""
        self.last_epoch = int(state["last_epoch"])
        if self._count is not None:
            for group, lr in zip(self.optimizer.param_groups, self._lrs):
                group["lr"] = lr
            self._count.fill_(self.last_epoch)
        self._set_rates()


def make_lr_schedule(cfg, optimizer: torch.optim.Optimizer,
                     steps_per_epoch: int) -> MultiStepSchedule:
    """MultiStep: the rate is multiplied by ``LR_FACTOR`` once the step
    count reaches each ``LR_STEP[i] * steps_per_epoch``."""
    milestones = sorted({int(e) * steps_per_epoch for e in cfg.TRAIN.LR_STEP})
    return MultiStepSchedule(optimizer, milestones,
                             gamma=float(cfg.TRAIN.LR_FACTOR))


def create_train_state(cfg, model: torch.nn.Module,
                       steps_per_epoch: int = 1000,
                       device: str | torch.device = "cuda") -> TrainState:
    """Move ``model`` (already initialized) to ``device`` and build its
    optimizer and schedule."""
    model = model.to(device)
    optimizer = make_optimizer(cfg, model.parameters(), device)
    return TrainState(model, optimizer,
                      make_lr_schedule(cfg, optimizer, steps_per_epoch))
