"""The refinement unit: a residual MLP that denoises root-relative 3D poses.

Counterpart of the JAX package's ``models/refiner.py``: a Linear ->
BatchNorm1d -> ReLU -> Dropout stem of width ``hidden_size``,
``num_blocks`` residual blocks of two such layers, and a linear head back
to the flattened pose, added to the input pose (the unit learns a delta).
BatchNorm follows flax (momentum 0.9, i.e. torch's 0.1, and the biased
running variance, :class:`FlaxRunningVar`). Weights are drawn as flax's
``Dense`` draws them (LeCun truncated normal, zero bias), and the dropout
masks as flax's ``Dropout`` does, each from a ``torch.Generator``: the
values cannot match ``jax.random``'s.

State-dict names: ``stem.{linear,bn}``, ``blocks.{i}.{a,b}.{linear,bn}``,
``head``; ``models/convert.py::refiner_from_jax_variables`` maps the JAX
package's variables onto them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from epipolarpose_tpu_torch.models.pose_resnet import (_TRUNC_STD,
                                                       FlaxRunningVar,
                                                       _trunc_normal_)

_BN_EPS = 1e-5


class BatchNorm1d(FlaxRunningVar, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` with flax's running variance."""


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """flax's ``Dropout``: in training, keep each entry with probability
    ``1 - rate`` (drawn from ``generator``) and scale it by ``1 / (1 -
    rate)``; the identity otherwise."""
    if not training or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class LinearBlock(nn.Module):
    """Linear -> BatchNorm1d -> ReLU -> Dropout."""

    def __init__(self, in_features: int, size: int, rate: float):
        super().__init__()
        self.linear = nn.Linear(in_features, size)
        self.bn = BatchNorm1d(size, eps=_BN_EPS, momentum=0.1)
        self.rate = float(rate)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return dropout(torch.relu(self.bn(self.linear(x))), self.rate,
                       self.training, generator)


class ResidualBlock(nn.Module):
    """x + b(a(x)), ``a`` and ``b`` linear blocks of one width."""

    def __init__(self, size: int, rate: float):
        super().__init__()
        self.a = LinearBlock(size, size, rate)
        self.b = LinearBlock(size, size, rate)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return x + self.b(self.a(x, generator), generator)


class PoseRefiner(nn.Module):
    """(N, J, 3) root-relative poses -> refined poses, flattened inside."""

    def __init__(self, num_joints: int = 17, hidden_size: int = 1024,
                 num_blocks: int = 2, dropout: float = 0.5):
        super().__init__()
        self.num_joints = int(num_joints)
        self.stem = LinearBlock(num_joints * 3, hidden_size, dropout)
        self.blocks = nn.ModuleList(ResidualBlock(hidden_size, dropout)
                                    for _ in range(num_blocks))
        self.head = nn.Linear(hidden_size, num_joints * 3)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator | None = None
                     ) -> "PoseRefiner":
        """flax ``Dense`` init: kernel LeCun truncated normal over fan-in,
        bias 0; BN scale 1, shift 0, running mean 0 and variance 1."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                std = math.sqrt(1.0 / mod.in_features) / _TRUNC_STD
                _trunc_normal_(mod.weight, std, generator)
                mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm1d):
                mod.reset_parameters()
        return self

    def forward(self, pose: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` draws the dropout masks in train mode."""
        n = pose.shape[0]
        x = self.stem(pose.reshape(n, -1).float(), generator)
        for block in self.blocks:
            x = block(x, generator)
        out = self.head(x)
        return pose + out.reshape(n, self.num_joints, 3).to(pose.dtype)
