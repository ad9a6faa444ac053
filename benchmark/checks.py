"""The numbers that decide ``correct``, each against its limit in the
cell's file.

Training (three readings, each taken by the worst leaf):

- ``loss_gap``: the largest relative gap between the program's and the
  reference's loss over the checked steps; ``loss1_gap`` the first
  step's alone (a forward pass from the same weights);
- ``grad_gap``: the first step's gradient norm, leaf by leaf (the
  program's from Adam's first moment after one step, ``m / (1 - beta1)``):
  the largest gap between the two norms, over the larger of the
  reference's norm of that leaf and the median leaf's;
  ``grad_median_gap``: the median over the leaves of the gap over the
  leaf's own reference norm;
- ``change_gap``: the same as ``grad_gap`` for the norm of each leaf's
  change after the last checked step, leaving out the leaves whose
  reference gradient is under a thousandth of the median leaf's (they
  move by round-off alone); ``change_median_gap`` as
  ``grad_median_gap``.

A cell's file names the numbers it holds to a limit; the others are
printed beside them.
"""

from __future__ import annotations

import math

import torch


def relative_worst(prog: torch.Tensor, ref: torch.Tensor,
                   keep: torch.Tensor | None = None) -> tuple[float, int]:
    """max |prog - ref| / max(ref, median(ref)) over the kept entries;
    (value, index)."""
    prog, ref = prog.double().cpu(), ref.double().cpu()
    if keep is not None:
        idx = torch.nonzero(keep.cpu()).flatten()
        prog, ref = prog[idx], ref[idx]
    else:
        idx = torch.arange(len(ref))
    floor = torch.maximum(ref.abs(), ref.abs().median())
    gaps = (prog - ref).abs() / floor
    gaps = torch.where(torch.isfinite(gaps), gaps,
                       torch.full_like(gaps, math.inf))
    worst = int(gaps.argmax())
    return float(gaps[worst]), int(idx[worst])


def median_gap(prog: torch.Tensor, ref: torch.Tensor,
               keep: torch.Tensor) -> float:
    """The median over the kept leaves of |prog - ref| / ref."""
    prog, ref = prog.double().cpu(), ref.double().cpu()
    k = keep.cpu()
    gaps = (prog[k] - ref[k]).abs() / ref[k].abs()
    value = float(gaps.median())
    return value if math.isfinite(value) else math.inf


def train_readings(prog: dict, ref: dict, names: list) -> tuple[dict, dict]:
    """(readings, notes): the three training numbers, and which step or
    leaf gave each."""
    lp, lr = prog["loss"].double().cpu(), ref["loss"].double().cpu()
    loss = ((lp - lr).abs() / lr.abs())
    loss = torch.where(torch.isfinite(loss), loss,
                       torch.full_like(loss, math.inf))
    grad, g_at = relative_worst(prog["grad1"], ref["grad1"])
    g_ref = ref["grad1"].cpu()
    keep = g_ref >= 1e-3 * g_ref.median()
    change, c_at = relative_worst(prog["change"], ref["change"], keep)
    readings = {"loss_gap": float(loss.max()), "loss1_gap": float(loss[0]),
                "grad_gap": grad,
                "grad_median_gap": median_gap(prog["grad1"], ref["grad1"],
                                              keep),
                "change_gap": change,
                "change_median_gap": median_gap(prog["change"],
                                                ref["change"], keep)}
    notes = {"loss_gap": f"step {int(loss.argmax()) + 1}",
             "grad_gap": names[g_at], "change_gap": names[c_at],
             "left_out": [n for n, k in zip(names, keep.tolist()) if not k]}
    return readings, notes


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and the ``checks`` block: every limited number present,
    finite and at or under its limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
