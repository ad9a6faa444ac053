"""Metrics (counterparts of the JAX package's ``ops/metrics.py``): the
train-time heatmap accuracy and the MPJPE family."""

from __future__ import annotations

import torch

from epipolarpose_tpu_torch.ops.heatmap import get_max_preds


def _calc_dists(preds: torch.Tensor, target: torch.Tensor,
                normalize: torch.Tensor) -> torch.Tensor:
    """Normalized distances (N, J); -1 where the target is not valid
    (x <= 1 or y <= 1). preds/target (N, J, 2); normalize (N,) or (N, 2)."""
    if normalize.ndim == 1:
        normalize = normalize[:, None]
    valid = (target[..., 0] > 1) & (target[..., 1] > 1)
    d = torch.linalg.vector_norm((preds - target) / normalize[:, None, :],
                                 dim=-1)
    return torch.where(valid, d, torch.full_like(d, -1.0))


def _dist_acc(dists: torch.Tensor, thr: float = 0.5) -> torch.Tensor:
    """Per joint, the share of valid distances below ``thr``; -1 where
    no distance is valid."""
    valid = dists != -1
    n = valid.sum(dim=0)
    hit = ((dists < thr) & valid).sum(dim=0)
    acc = hit / n.clamp(min=1)
    return torch.where(n > 0, acc, torch.full_like(acc, -1.0))


def heatmap_accuracy(output: torch.Tensor, target: torch.Tensor,
                     thr: float = 0.5):
    """Train-time PCK on the heatmap grid. output/target (N, J, H, W); the
    normalizer is the heatmap size / 10, built in the output's dtype as the
    JAX function builds it (x divided by h/10, as the reference does).

    Returns (per-joint accuracy (J,), average (), valid joints (), pred).
    """
    h, w = output.shape[-2:]
    pred, _ = get_max_preds(output)
    gt, _ = get_max_preds(target)
    norm = (torch.ones((output.shape[0], 2), dtype=output.dtype,
                       device=output.device)
            * torch.tensor([h, w], dtype=output.dtype,
                           device=output.device) / 10.0)
    acc = _dist_acc(_calc_dists(pred, gt, norm), thr)
    valid_joint = acc >= 0
    avg = (torch.where(valid_joint, acc, torch.zeros_like(acc)).sum()
           / valid_joint.sum().clamp(min=1))
    return acc, avg, valid_joint.sum(), pred


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
