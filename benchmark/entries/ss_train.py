"""Self-supervised training through the program's
``core/self_supervised.py::make_ss_train_step`` with the frozen teacher:
teacher forward, argmax decode, ``fast`` confidence-weighted
triangulation with the batch's cameras, reprojection, dual-crop targets,
the student's update. Driven as ``core/function.py::train`` drives it.

With random weights a teacher's argmax is not well posed: its maps have
near-ties that any rounding flips. Nor is the meeting point of the rays
of random detections: a float32 and a float64 solution lie some mm apart
at the median and metres apart where the rays barely meet. So the
reference follows the program from its teacher maps (a forward hook on
the teacher it is handed) and its pseudo-GT, both read during the
checked steps, and checks each stage by itself: the teacher's forward
(``hm_gap``), the decode and the triangulation by how well the program's
pseudo-GT solves the reference's system for the program's detections
(``pgt_gap``), and the student's update by the training readings, on
targets from the program's pseudo-GT.
"""

from __future__ import annotations

import math

import torch

from benchmark import checks, weights
from benchmark.entries import common
from benchmark.reference import model as ref_model
from benchmark.reference import steps as ref_steps

KIND = "train"


def teacher_arch(arch: dict) -> dict:
    return dict(arch, depth_dim=1)


def flops_per_sample(ctx) -> float:
    from benchmark import flops
    return (3.0 * flops.forward_flops(ctx.arch)
            + flops.forward_flops(teacher_arch(ctx.arch)))


def teacher_weights(ctx, device) -> dict:
    tarch = teacher_arch(ctx.arch)
    tw = weights.make(tarch, ctx.seed, weights.TEACHER, device)
    g = weights.generator(ctx.seed, weights.CALIBRATION, device)
    w, h = ctx.arch["image_size"]
    crops = torch.randint(0, 256, (ctx.samples, h, w, 3), generator=g,
                          device=device, dtype=torch.uint8)
    weights.calibrate_running_stats(tw, tarch, crops)
    return tw


def ss_settings(ctx) -> dict:
    return {"conf_min": float(ctx.cfg.TPU.SS_CONF_MIN),
            "flip_pairs": [tuple(p) for p in ctx.mix["flip_pairs"]]}


def port_batch(batch: dict) -> dict:
    from epipolarpose_tpu_torch.geometry.camera import Camera
    return dict(batch, camera=Camera(**batch["camera"]))


class PseudoGT:
    """Keeps the pseudo-GT of the checked steps. The step returns none, so
    for those steps alone this wraps the program's ``generate_pseudo_gt``;
    the window runs it unwrapped."""

    def __init__(self, tss):
        self.tss, self.x = tss, []
        self.orig = tss.generate_pseudo_gt

    def __enter__(self):
        def pseudo_gt(*args, **kwargs):
            x, res = self.orig(*args, **kwargs)
            self.x.append(x.detach().clone())
            return x, res
        self.tss.generate_pseudo_gt = pseudo_gt
        return self

    def __exit__(self, *exc):
        self.tss.generate_pseudo_gt = self.orig


class Job(common.TrainLoop):
    def __init__(self, ctx):
        from epipolarpose_tpu_torch.core import create_train_state
        from epipolarpose_tpu_torch.core import self_supervised as tss
        from epipolarpose_tpu_torch.core.steps import configure_backends
        from epipolarpose_tpu_torch.models import get_model
        self.ctx = ctx
        dev = ctx.device
        configure_backends(ctx.cfg)
        w = weights.make(ctx.arch, ctx.seed, weights.WEIGHTS, dev)
        with torch.device("meta"):
            model = get_model(ctx.cfg, True)
            tnet = tss.teacher_net(ctx.cfg)
        model = common.load_weights(model, w, dev)
        teacher = tss.Teacher(common.load_weights(
            tnet, teacher_weights(ctx, dev), dev))
        self.state = create_train_state(ctx.cfg, model, device=dev)
        self.step = tss.make_ss_train_step(
            ctx.cfg, model, teacher, device=dev,
            flip_pairs=ss_settings(ctx)["flip_pairs"])
        self.names = ref_model.trainable(ctx.arch)
        self.pool = [port_batch(b) for b in ctx.pool]
        n_check = int(ctx.cell["check"]["steps"])
        # the teacher's maps from its own forward, by a hook on the module
        # handed to the step
        maps = []
        hook = teacher.register_forward_hook(
            lambda module, args, out: maps.append(out.detach().clone()))
        try:
            with PseudoGT(tss) as pgt:
                self.prog = common.checked_steps(
                    self.step, self.state, self.pool[:n_check], self.names,
                    w)
        finally:
            hook.remove()
        self.prog["hm"], self.prog["X"] = maps, pgt.x
        del w
        for i in range(int(ctx.cell["warmup_calls"])):
            self.call(i)
        self.print_freq = int(ctx.cfg.PRINT_FREQ)
        self.read = []

    def check(self) -> tuple[dict, dict]:
        ctx = self.ctx
        prog = self.prog
        del self.state, self.step
        common.reference_mode(ctx.device)
        n_check = int(ctx.cell["check"]["steps"])
        dev = ctx.device
        w = weights.make(ctx.arch, ctx.seed, weights.WEIGHTS, dev)
        tw = teacher_weights(ctx, dev)
        ref = ref_steps.ss_steps(w, tw, ctx.arch, teacher_arch(ctx.arch),
                                 ctx.pool[:n_check], float(ctx.cfg.TRAIN.LR),
                                 ss_settings(ctx), follow=prog)
        readings, notes = checks.train_readings(prog, ref, self.names)
        readings.update(ss_readings(prog, ref))
        return readings, notes


def ss_readings(prog: dict, ref: dict) -> dict:
    """``hm_gap``: the largest gap between the program's and the
    reference's teacher maps, over the reference map's standard deviation
    across its pixels; ``pgt_gap``: the largest excess of the program's
    pseudo-GT points over the least squares of the reference's
    triangulation of the program's detections
    (``reference/geometry.py::dlt_excess``)."""
    hm = max(float(((p.float() - r).abs().amax((-2, -1))
                    / r.std((-2, -1))).max())
             for p, r in zip(prog["hm"], ref["hm"]))
    pgt = max(float(e.max()) for e in ref["excess"])
    return {"hm_gap": hm if math.isfinite(hm) else math.inf,
            "pgt_gap": pgt if math.isfinite(pgt) else math.inf}


FAULTS = ("half", "moved")


def stand_in(ctx, quant=None, fault: str | None = None,
             tri_round=None) -> tuple[dict, dict]:
    """The readings of the reference put in the program's place, in a
    lower precision (``quant``, ``tri_round``) or with a planted fault
    (``half``: half of each batch left out; ``moved``: the pseudo-GT moved
    30 mm where it is produced), against the reference following it: for
    setting the limits."""
    n_check = int(ctx.cell["check"]["steps"])
    dev, lr = ctx.device, float(ctx.cfg.TRAIN.LR)
    w = weights.make(ctx.arch, ctx.seed, weights.WEIGHTS, dev)
    tw = teacher_weights(ctx, dev)
    args = (w, tw, ctx.arch, teacher_arch(ctx.arch), ctx.pool[:n_check], lr,
            ss_settings(ctx))
    prog = ref_steps.ss_steps(*args, quant=quant, half=fault == "half",
                              shift_mm=30.0 if fault == "moved" else 0.0,
                              tri_round=tri_round)
    common.reference_mode(dev)
    ref = ref_steps.ss_steps(*args, follow=prog)
    readings, notes = checks.train_readings(prog, ref,
                                            ref_model.trainable(ctx.arch))
    readings.update(ss_readings(prog, ref))
    return readings, notes
