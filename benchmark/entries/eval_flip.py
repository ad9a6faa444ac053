"""Evaluation through the program's ``core/steps.py::make_eval_step``
with the flip test, driven as ``core/function.py::validate`` drives it:
each batch's predictions are copied to the host before the next batch is
handed over.

The model's batch-norm running statistics are the batch statistics of one
train-mode pass of the reference over crops of the seed's calibration
stream, so that an eval-mode network with random weights is normalised.
The final convolution is drawn at the cell's ``final_std``, wide enough
that a crop's joints land tens of pixels apart: then a flip-back that
swaps or shifts wrongly moves them, and the check sees it.
Once the window has closed, the reference predicts a sample of the
batches whose predictions reached the host, drawn from the seed, and each
sampled answer is compared with it.
"""

from __future__ import annotations

import math

import torch

from benchmark import weights
from benchmark.entries import common
from benchmark.reference import steps as ref_steps

KIND = "eval"


def flops_per_sample(ctx) -> float:
    from benchmark import flops
    return 2.0 * flops.forward_flops(ctx.arch)


def eval_weights(ctx, device) -> dict:
    """The configuration's weights, the final convolution at the cell's
    ``final_std``, and batch norm's running statistics calibrated."""
    w = weights.make(ctx.arch, ctx.seed, weights.WEIGHTS, device,
                     final_std=float(ctx.cell.get("final_std",
                                                  weights.FINAL_STD)))
    g = weights.generator(ctx.seed, weights.CALIBRATION, device)
    width, height = ctx.arch["image_size"]
    crops = torch.randint(0, 256, (ctx.samples, height, width, 3),
                          generator=g, device=device, dtype=torch.uint8)
    weights.calibrate_running_stats(w, ctx.arch, crops)
    return w


class Job:
    def __init__(self, ctx):
        from epipolarpose_tpu_torch.core.steps import (configure_backends,
                                                       make_eval_step)
        from epipolarpose_tpu_torch.models import get_model
        self.ctx = ctx
        dev = ctx.device
        configure_backends(ctx.cfg)
        with torch.device("meta"):
            model = get_model(ctx.cfg, False)
        model = common.load_weights(model, eval_weights(ctx, dev), dev)
        self.pairs = [tuple(p) for p in ctx.mix["flip_pairs"]]
        self.step = make_eval_step(ctx.cfg, model, self.pairs, dev)
        self.pool = ctx.pool
        self.answers: list = []
        for i in range(int(ctx.cell["warmup_calls"])):
            self.step(self.pool[i % len(self.pool)])["preds"].cpu()

    def call(self, i: int):
        return self.step(self.pool[i % len(self.pool)])

    def after(self, i: int, out) -> None:
        self.answers.append(out["preds"].cpu())        # waits for the card

    def failed(self) -> int:
        return sum(not bool(torch.isfinite(a).all()) for a in self.answers)

    def check(self) -> tuple[dict, dict]:
        ctx = self.ctx
        del self.step
        common.reference_mode(ctx.device)
        w = eval_weights(ctx, ctx.device)
        n = len(self.answers)
        g = torch.Generator().manual_seed(int(ctx.seed) % (2 ** 63))
        take = min(int(ctx.cell["check"]["batches"]), n)
        picked = sorted(torch.randperm(n, generator=g)[:take].tolist())
        ref_of: dict = {}
        found = []
        for i in picked:
            k = i % len(self.pool)
            if k not in ref_of:
                ref_of[k] = ref_steps.eval_preds(
                    w, ctx.arch, self.pool[k], self.pairs).cpu()
            found.append(gaps(self.answers[i], ref_of[k]))
        readings = combine(found)
        worst = max(range(len(found)), key=lambda n: found[n]["xy_gap_px"])
        spread = torch.stack([joint_spread(r) for r in ref_of.values()])
        return readings, {"xy_gap_px": f"batch {picked[worst]}",
                          "checked_batches": len(picked),
                          "joint_spread_px_mm": spread.mean(0).tolist()}


def gaps(got: torch.Tensor, want: torch.Tensor) -> dict:
    """One batch's widest gaps of x, y (px) and of z (mm), and its mean
    gap of x and y; inf where an answer is not finite."""
    gap = (got.float() - want.float()).abs()
    out = {"xy_gap_px": float(gap[..., :2].max()),
           "xy_mean_gap_px": float(gap[..., :2].mean()),
           "z_gap_mm": float(gap[..., 2].max())}
    if not all(math.isfinite(v) for v in out.values()):
        return dict.fromkeys(out, math.inf)
    return out


def combine(found: list) -> dict:
    """Batches' gaps -> the check's: the widest, and the mean over the
    batches (all of one size) of the mean gap."""
    return {"xy_gap_px": max(f["xy_gap_px"] for f in found),
            "xy_mean_gap_px": (sum(f["xy_mean_gap_px"] for f in found)
                               / len(found)),
            "z_gap_mm": max(f["z_gap_mm"] for f in found)}


def joint_spread(preds: torch.Tensor) -> torch.Tensor:
    """The mean over crops of each coordinate's range over the joints:
    where the joints all land at one place any decode agrees, and the
    comparison tests nothing."""
    return (preds.amax(1) - preds.amin(1)).mean(0)


FAULTS = ("no_shift", "no_swap")


def stand_in(ctx, quant=None, fault: str | None = None
             ) -> tuple[dict, dict]:
    """The readings of the reference put in the program's place in a lower
    precision (``quant``) or with a planted fault in the flip test
    (``no_shift``: the flipped output not shifted one pixel; ``no_swap``:
    its left and right joints not swapped), against the reference, over
    the check's number of batches: for setting the limits."""
    w = eval_weights(ctx, ctx.device)
    pairs = [tuple(p) for p in ctx.mix["flip_pairs"]]
    found = []
    for k in range(min(int(ctx.cell["check"]["batches"]), len(ctx.pool))):
        want = ref_steps.eval_preds(w, ctx.arch, ctx.pool[k], pairs)
        found.append(gaps(ref_steps.eval_preds(w, ctx.arch, ctx.pool[k],
                                                pairs, quant, fault), want))
    return combine(found), {"joint_spread_px_mm":
                            joint_spread(want).tolist()}
