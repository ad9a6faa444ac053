"""Fully supervised 3D training through the program's
``core/steps.py::make_train_step``, driven as ``core/function.py::train``
drives it: one call a batch, the loss read on the host only every
``PRINT_FREQ`` steps.

Set-up builds the train state on the benchmark's weights and takes the
first ``check_steps`` steps on distinct batches through the same step;
those steps are what the reference follows once the window has closed.
"""

from __future__ import annotations

import torch

from benchmark import weights
from benchmark.entries import common
from benchmark.reference import model as ref_model
from benchmark.reference import steps as ref_steps

KIND = "train"


def flops_per_sample(ctx) -> float:
    from benchmark import flops
    return 3.0 * flops.forward_flops(ctx.arch)


class Job(common.TrainLoop):
    def __init__(self, ctx):
        from epipolarpose_tpu_torch.core import (create_train_state,
                                                 make_train_step)
        from epipolarpose_tpu_torch.core.steps import configure_backends
        from epipolarpose_tpu_torch.models import get_model
        self.ctx = ctx
        dev = ctx.device
        configure_backends(ctx.cfg)
        w = weights.make(ctx.arch, ctx.seed, weights.WEIGHTS, dev)
        with torch.device("meta"):
            model = get_model(ctx.cfg, True)
        model = common.load_weights(model, w, dev)
        self.state = create_train_state(ctx.cfg, model, device=dev)
        self.step = make_train_step(ctx.cfg, model, dev)
        self.names = ref_model.trainable(ctx.arch)
        n_check = int(ctx.cell["check"]["steps"])
        self.pool = ctx.pool
        self.prog = common.checked_steps(self.step, self.state,
                                         self.pool[:n_check], self.names, w)
        del w
        for i in range(int(ctx.cell["warmup_calls"])):
            self.call(i)
        self.print_freq = int(ctx.cfg.PRINT_FREQ)
        self.read = []

    def check(self) -> tuple[dict, dict]:
        ctx = self.ctx
        prog = {k: v.detach() for k, v in self.prog.items()}
        del self.state, self.step
        common.reference_mode(ctx.device)
        n_check = int(ctx.cell["check"]["steps"])
        w = weights.make(ctx.arch, ctx.seed, weights.WEIGHTS, ctx.device)
        ref = ref_steps.train_steps(w, ctx.arch, self.pool[:n_check],
                                    float(ctx.cfg.TRAIN.LR))
        from benchmark import checks
        return checks.train_readings(prog, ref, self.names)


FAULTS = ("half",)


def stand_in(ctx, quant=None, fault: str | None = None
             ) -> tuple[dict, dict]:
    """The readings of the reference put in the program's place, in a
    lower precision (``quant``) or with a planted fault (``half``: half of
    each batch left out, the mean taken over the rest), against the
    reference: for setting the limits."""
    half = fault == "half"
    n_check = int(ctx.cell["check"]["steps"])
    lr = float(ctx.cfg.TRAIN.LR)
    w = weights.make(ctx.arch, ctx.seed, weights.WEIGHTS, ctx.device)
    names = ref_model.trainable(ctx.arch)
    prog = ref_steps.train_steps(w, ctx.arch, ctx.pool[:n_check], lr,
                                 quant=quant, half=half)
    common.reference_mode(ctx.device)
    ref = ref_steps.train_steps(w, ctx.arch, ctx.pool[:n_check], lr)
    from benchmark import checks
    return checks.train_readings(prog, ref, names)
