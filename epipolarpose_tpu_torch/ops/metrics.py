"""MPJPE metrics (counterparts of the JAX package's ``ops/metrics.py``)."""

from __future__ import annotations

import torch


def mpjpe(pred: torch.Tensor, gt: torch.Tensor,
          joints_vis: torch.Tensor | None = None) -> torch.Tensor:
    """Mean per-joint position error. pred/gt: (N, J, 3)."""
    d = torch.linalg.vector_norm(pred - gt, dim=-1)
    if joints_vis is not None:
        w = (joints_vis > 0).to(d.dtype)
        return (d * w).sum() / w.sum().clamp(min=1)
    return d.mean()


def nmpjpe(pred: torch.Tensor, gt: torch.Tensor,
           joints_vis: torch.Tensor | None = None) -> torch.Tensor:
    """Scale-normalized MPJPE: optimal per-sample scale before MPJPE."""
    num = (pred * gt).sum(dim=(-1, -2), keepdim=True)
    den = (pred * pred).sum(dim=(-1, -2), keepdim=True)
    s = num / torch.where(den < 1e-12, torch.full_like(den, 1e-12), den)
    return mpjpe(s * pred, gt, joints_vis)
