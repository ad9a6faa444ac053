"""Training losses (counterparts of the JAX package's ``ops/losses.py``):
the heatmap MSE (``JointsMSELoss``) and the integral L1 loss."""

from __future__ import annotations

import torch


def joints_mse_loss(output: torch.Tensor, target: torch.Tensor,
                    target_weight: torch.Tensor | None = None,
                    use_target_weight: bool = True) -> torch.Tensor:
    """Heatmap MSE. output/target (N, J, H, W); target_weight (N, J).

    Per joint ``0.5 * mean((w*pred - w*gt)^2)`` over the batch and the map,
    then the mean over joints, in float32.
    """
    n, j = output.shape[:2]
    pred = output.float().reshape(n, j, -1)
    gt = target.float().reshape(n, j, -1)
    if use_target_weight and target_weight is not None:
        tw = target_weight.float()[..., None]
        pred = pred * tw
        gt = gt * tw
    return (0.5 * (pred - gt).pow(2).mean(dim=(0, 2))).mean()


def integral_l1_loss(pred_coords: torch.Tensor, target_coords: torch.Tensor,
                     target_weight: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """L1 loss on normalized (x, y, z): ``sum(|err| * w) / N``.

    pred/target: (N, J, 3); target_weight: (N, J) or (N, J, 3). Divides by
    the batch size, not the weighted count, as the JAX loss does. Masks
    with ``where`` so that a nan target under zero weight stays out.
    """
    err = (pred_coords - target_coords).abs()
    n = max(err.shape[0], 1)
    if target_weight is not None:
        if target_weight.ndim == err.ndim - 1:
            target_weight = target_weight[..., None]
        err = torch.where(target_weight > 0, err * target_weight,
                          torch.zeros((), dtype=err.dtype, device=err.device))
    return err.sum() / n


def make_loss(cfg):
    """``criterion(output, target, target_weight)`` for ``LOSS.TYPE``."""
    use_tw = bool(cfg.LOSS.USE_TARGET_WEIGHT)
    if cfg.LOSS.TYPE == "JointsMSELoss":
        def criterion(output, target, target_weight):
            return joints_mse_loss(output, target, target_weight, use_tw)
        return criterion
    if cfg.LOSS.TYPE == "IntegralL1Loss":
        def criterion(output, target, target_weight):
            return integral_l1_loss(output, target,
                                    target_weight if use_tw else None)
        return criterion
    raise ValueError(f"unknown LOSS.TYPE: {cfg.LOSS.TYPE}")
