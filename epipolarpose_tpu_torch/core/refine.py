"""Training the refinement unit on (noisy triangulated pose, GT pose) pairs.

Counterpart of the JAX package's ``core/refine.py``: the structured noise
model over GT poses (per-joint Gaussian plus occasional outlier joints,
like triangulation failures), the refiner's state (model and Adam), its
L1 or L2 train step on root-relative poses, and its eval-mode apply. Every
random draw (noise, dropout) comes from an explicit ``torch.Generator``;
the values cannot match ``jax.random``'s, their statistics do.
"""

from __future__ import annotations

import torch

from epipolarpose_tpu_torch.core.train_state import TrainState
from epipolarpose_tpu_torch.models.refiner import PoseRefiner


def synth_noise(poses: torch.Tensor, sigma_mm: float = 25.0,
                outlier_prob: float = 0.05, outlier_mm: float = 150.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Triangulation-like corruption of (N, J, 3) poses in mm: each joint
    moves by N(0, sigma_mm), or with ``outlier_prob`` by N(0,
    outlier_mm)."""
    dev = poses.device
    noise = torch.randn(poses.shape, generator=generator, device=dev) \
        * sigma_mm
    outliers = torch.randn(poses.shape, generator=generator, device=dev) \
        * outlier_mm
    is_out = torch.rand(poses.shape[:-1] + (1,), generator=generator,
                        device=dev) < outlier_prob
    return poses + torch.where(is_out, outliers, noise)


def create_refiner_state(num_joints: int,
                         generator: torch.Generator | None = None,
                         lr: float = 1e-3, hidden: int = 1024,
                         blocks: int = 2, dropout: float = 0.5,
                         device: str | torch.device = "cuda"):
    """A :class:`PoseRefiner` initialized from ``generator`` on ``device``
    and its state (Adam at ``lr``, no schedule). Returns (model, state)."""
    model = PoseRefiner(num_joints, hidden, blocks, dropout).init_weights(
        generator).to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    return model, TrainState(model, optimizer, scheduler=None)


def make_refiner_train_step(model: PoseRefiner, loss_type: str = "l1"):
    """``step(state, noisy (N, J, 3), gt (N, J, 3), generator) -> (state,
    loss)``: the forward in train mode (batch statistics, dropout drawn
    from ``generator``), the mean absolute (``l1``) or squared (``l2``)
    error, and one Adam step."""
    if loss_type not in ("l1", "l2"):
        raise ValueError(f"unknown refiner loss: {loss_type}")

    def step(state, noisy, gt, generator=None):
        model.train()
        err = model(noisy, generator) - gt
        loss = err.abs().mean() if loss_type == "l1" else (err ** 2).mean()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return step


def make_refiner_apply(model: PoseRefiner):
    """``apply(state, poses) -> refined poses``, in eval mode with no
    gradient."""

    @torch.no_grad()
    def apply(state, poses):
        del state
        model.eval()
        return model(poses)

    return apply
