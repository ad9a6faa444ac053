"""Integral regression written out in plain PyTorch, float32: input
normalisation, the soft-argmax over each joint's (D, H, W) volume, the
integral targets, the L1 loss and Adam (Sun et al., arXiv:1711.08229;
Kingma and Ba, arXiv:1412.6980)."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def normalize(crops: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, 3, H, W) float32, ImageNet-normalised."""
    x = crops.to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()


def soft_argmax(vol: torch.Tensor, joints: int, depth: int) -> torch.Tensor:
    """(N, J*D, H, W) logits -> (N, J, 3) expected (x, y, z) over a softmax
    of each joint's whole volume, each over its axis length, minus 0.5."""
    n, _, h, w = vol.shape
    p = torch.softmax(vol.float().reshape(n, joints, -1), dim=-1)
    p = p.reshape(n, joints, depth, h, w)
    dev = vol.device
    ex = (p.sum((2, 3)) * torch.arange(w, device=dev)).sum(-1) / w
    ey = (p.sum((2, 4)) * torch.arange(h, device=dev)).sum(-1) / h
    if depth > 1:
        ez = (p.sum((3, 4)) * torch.arange(depth, device=dev)).sum(-1) / depth
    else:
        ez = torch.full_like(ex, 0.5)
    return torch.stack([ex, ey, ez], -1) - 0.5


def targets(joints_xy: torch.Tensor, vis: torch.Tensor, image_size,
            depth_bound: float, z_rel: torch.Tensor | None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Crop pixels (N, J, 2), visibility (N, J), root-relative depth (N, J)
    in mm -> normalised targets (N, J, 3) and weights (N, J): a joint
    counts where x, y lie in [-0.5, 0.5) and |z| <= 0.5."""
    x = joints_xy[..., 0] / image_size[0] - 0.5
    y = joints_xy[..., 1] / image_size[1] - 0.5
    if z_rel is None:
        z = torch.zeros_like(x)
    else:
        z = z_rel / (2.0 * depth_bound)
    inside = (x >= -0.5) & (x < 0.5) & (y >= -0.5) & (y < 0.5) \
        & (z.abs() <= 0.5)
    return torch.stack([x, y, z], -1), vis.float() * inside.float()


def l1_loss(pred: torch.Tensor, target: torch.Tensor,
            weight: torch.Tensor) -> torch.Tensor:
    """Sum of the weighted absolute errors over the batch size."""
    err = (pred - target).abs() * weight[..., None]
    err = torch.where(weight[..., None] > 0, err, torch.zeros_like(err))
    return err.sum() / pred.shape[0]


class Adam:
    """Adam on a list of float32 leaves, written out."""

    def __init__(self, leaves: list, lr: float):
        self.leaves, self.lr, self.t = leaves, lr, 0
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]

    @torch.no_grad()
    def step(self, grads: list) -> None:
        b1, b2 = ADAM_BETAS
        self.t += 1
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = m / (1 - b1 ** self.t)
            v_hat = v / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + ADAM_EPS))
