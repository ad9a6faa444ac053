"""What the entries share: the program's model built on the benchmark's
weights, and the program's first steps read for the check."""

from __future__ import annotations

import math

import torch

ADAM_BETA1 = 0.9


def load_weights(model: torch.nn.Module, weights: dict, device
                 ) -> torch.nn.Module:
    """A model built on the meta device, given storage on ``device`` and
    the benchmark's weights under the reference state-dict names
    (``strict``: every name matches, or it raises)."""
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model


def first_moment(optimizer, param) -> torch.Tensor:
    """Adam's first moment of ``param``; zeros where it never stepped."""
    state = optimizer.state.get(param)
    return state["exp_avg"] if state else torch.zeros_like(param)


def checked_steps(step, state, batches: list, names: list,
                  start: dict) -> dict:
    """The program's first steps, one a batch, through the window's own
    call: each step's loss; after the first, each leaf's gradient as Adam
    got it (its first moment over ``1 - beta1``); after the last, the norm
    of each leaf's change from ``start``. Read by name, in ``names``'
    order; all stays on the device."""
    params = dict(state.model.named_parameters())
    losses, grad1 = [], None
    for k, batch in enumerate(batches):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].detach().float().reshape(()))
        if k == 0:
            grad1 = torch.stack([first_moment(state.optimizer, params[n])
                                 .float().norm()
                                 for n in names]) / (1 - ADAM_BETA1)
    change = torch.stack([(params[n].detach() - start[n]).float().norm()
                          for n in names])
    return {"loss": torch.stack(losses), "grad1": grad1, "change": change}


class TrainLoop:
    """A training entry's window call, as ``core/function.py::train``
    makes it: one step a batch of the pool, the loss read on the host
    every ``PRINT_FREQ`` steps (``print_freq``; ``read``, the losses
    read)."""

    def call(self, i: int):
        self.state, metrics = self.step(self.state,
                                        self.pool[i % len(self.pool)])
        return metrics

    def after(self, i: int, metrics) -> None:
        if i % self.print_freq == 0:
            self.read.append(float(metrics["loss"]))   # waits for the card

    def failed(self) -> int:
        return sum(not math.isfinite(v) for v in self.read)


def reference_mode(device) -> None:
    """Before the reference runs: the program's memory handed back, cuDNN
    on its default algorithms (no autotuning at the reference's shapes)
    and TF32 off, so float32 is float32."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
