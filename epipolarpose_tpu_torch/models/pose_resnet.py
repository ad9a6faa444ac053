"""PoseResNet: ResNet backbone + deconv head + final conv, as an nn.Module.

Counterpart of the JAX package's ``models/pose_resnet.py`` (Flax, NHWC),
in PyTorch's NCHW layout. Module names are the reference PyTorch
state-dict keys (``conv1``, ``layer{i}.{b}.conv{k}``, ``.downsample.{0,1}``,
``deconv_layers.{3m,3m+1}``, ``final_layer``), so the weight bridge in
``models/convert.py`` loads with ``strict=True``.

BatchNorm follows flax's convention in train mode (:class:`BatchNorm2d`):
it normalizes with the biased batch variance, as ``nn.BatchNorm2d`` does,
and also keeps the biased variance in ``running_var``, where
``nn.BatchNorm2d`` keeps the unbiased one; momentum 0.1 here is flax's 0.9.

Compute dtype: parameters and BatchNorm statistics stay float32. With
``dtype=torch.bfloat16`` (``TPU.COMPUTE_DTYPE: bfloat16``, the flagship)
the forward runs under ``torch.autocast``: convolutions and deconvolutions
take bf16 inputs and weights on cuDNN; BatchNorm runs on the bf16
activations with its float32 scale, shift and running statistics, and
emits bf16, as the JAX model's bf16 BatchNorm does. The output keeps the
compute dtype: the (N, J*D, H, W) volume is 0.57 GB in bf16 at batch 64 of
the flagship head, and the soft-argmax kernel reads it as it is.

Weight init follows the JAX package: backbone convs truncated-normal
He init over fan-out, deconvs and the final conv normal(std=0.001), BN
scale 1 and shift 0, running mean 0 and variance 1. It draws from a
``torch.Generator``, so it is reproducible but does not give the JAX
package's numbers.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
from torch import nn

# layers per stage for each depth
RESNET_SPEC = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}

_BN_EPS = 1e-5
_HEAD_STD = 0.001
# std of a unit normal truncated to [-2, 2] (jax.nn.initializers constant)
_TRUNC_STD = 0.87962566103423978


def _trunc_normal_(t: torch.Tensor, std: float,
                   generator: torch.Generator | None) -> torch.Tensor:
    """Fill ``t`` with N(0, 1) truncated to [-2, 2], times ``std``
    (inverse-CDF sampling, as ``nn.init.trunc_normal_`` does)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    t.uniform_(2 * lo - 1, 1 - 2 * lo, generator=generator)
    t.erfinv_().mul_(std * math.sqrt(2.0))
    return t.clamp_(-2 * std, 2 * std)


class FlaxRunningVar:
    """Mixin for torch's batch norms whose train-mode update keeps flax's
    biased running variance.

    torch adds ``m * var * n/(n-1)`` to ``(1-m) * running_var``; flax adds
    ``m * var``. With the old buffer ``old`` and torch's result ``new``,
    flax's value is ``new * (n-1)/n + (1-m) * old / n``, that is
    ``lerp(new, (1-m) * old, 1/n)``: a per-channel fix of two small
    kernels that reads no activation again. It replaces the buffer rather
    than writing into it, since autograd saved the buffer for the backward.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        old = self.running_var * (1.0 - self.momentum)
        y = super().forward(x)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var = torch.lerp(self.running_var, old, 1.0 / n)
        return y


class BatchNorm2d(FlaxRunningVar, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running variance
    (:class:`FlaxRunningVar`)."""


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=_BN_EPS, momentum=0.1)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _bn(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                _bn(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = _bn(out)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, out, 1, stride, bias=False), _bn(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + residual)


class SameDeconv2d(nn.ConvTranspose2d):
    """Stride-2 ``ConvTranspose2d`` that equals flax's
    ``ConvTranspose(..., padding="SAME")``: exact 2x upsampling with
    flax's alignment. k4 is torch padding 1; k2 padding 0; k3 padding 0
    with the last row and column of the (2H + 1)-sized output dropped
    (the original PyTorch EpipolarPose's k3, padding 1 with output padding
    1, is the same grid shifted by one pixel). A subclass, so the weight
    keeps its reference name ``deconv_layers.N.weight``."""

    _PADDING = {4: (1, 0), 3: (0, 1), 2: (0, 0)}

    def __init__(self, inplanes: int, planes: int, kernel: int,
                 bias: bool = False):
        if kernel not in self._PADDING:
            raise ValueError(f"unsupported deconv kernel {kernel}")
        pad, crop = self._PADDING[kernel]
        super().__init__(inplanes, planes, kernel, 2, pad, 0, bias=bias)
        self.crop = crop

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        return y[..., :-self.crop, :-self.crop] if self.crop else y


class PoseResNet(nn.Module):
    """Backbone + deconv head + final conv. Input (N, 3, H, W) float;
    output (N, NUM_JOINTS * DEPTH_DIM, H/4, W/4) in ``dtype``."""

    def __init__(self, num_layers: int = 50, num_joints: int = 16,
                 depth_dim: int = 1, num_deconv_layers: int = 3,
                 num_deconv_filters: Sequence[int] = (256, 256, 256),
                 num_deconv_kernels: Sequence[int] = (4, 4, 4),
                 final_conv_kernel: int = 1, deconv_with_bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        block_name, stages = RESNET_SPEC[num_layers]
        block = BasicBlock if block_name == "basic" else Bottleneck
        self.num_joints = num_joints
        self.depth_dim = depth_dim
        self.dtype = dtype

        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for i, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512),
                                                   stages)):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (i > 0 and b == 0) else 1
                blocks.append(block(inplanes, planes, stride))
                inplanes = planes * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

        layers = []
        for i in range(num_deconv_layers):
            k, planes = num_deconv_kernels[i], num_deconv_filters[i]
            layers += [SameDeconv2d(inplanes, planes, k,
                                    bias=deconv_with_bias),
                       _bn(planes), nn.ReLU(inplace=True)]
            inplanes = planes
        self.deconv_layers = nn.Sequential(*layers)
        k = final_conv_kernel
        self.final_layer = nn.Conv2d(inplanes, num_joints * depth_dim, k, 1,
                                     1 if k == 3 else 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cast = (torch.autocast(x.device.type, dtype=self.dtype)
                if self.dtype != torch.float32 else contextlib.nullcontext())
        with cast:
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
            x = self.final_layer(self.deconv_layers(x))
        return x.to(self.dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator | None = None
                     ) -> "PoseResNet":
        """Re-draw every parameter as the JAX package initializes it."""
        for name, mod in self.named_modules():
            if isinstance(mod, nn.ConvTranspose2d) or name == "final_layer":
                mod.weight.normal_(0.0, _HEAD_STD, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Conv2d):
                o, _, kh, kw = mod.weight.shape
                std = math.sqrt(2.0 / (o * kh * kw)) / _TRUNC_STD
                _trunc_normal_(mod.weight, std, generator)
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
        return self


def get_pose_net(cfg, is_train: bool = True,
                 generator: torch.Generator | None = None) -> PoseResNet:
    """Build the model a config names, initialized from ``generator``.

    ``is_train`` is kept for the reference signature; train/eval is the
    module's ``train()``/``eval()`` mode. The model is built on the CPU;
    move it with ``.to(device)``.
    """
    if cfg.TPU.REMAT:
        raise NotImplementedError("TPU.REMAT (activation checkpointing) is "
                                  "not ported yet")
    extra = cfg.MODEL.EXTRA
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    model = PoseResNet(
        num_layers=int(extra.NUM_LAYERS),
        num_joints=int(cfg.MODEL.NUM_JOINTS),
        depth_dim=int(extra.get("DEPTH_DIM", 1)),
        num_deconv_layers=int(extra.NUM_DECONV_LAYERS),
        num_deconv_filters=tuple(extra.NUM_DECONV_FILTERS),
        num_deconv_kernels=tuple(extra.NUM_DECONV_KERNELS),
        final_conv_kernel=int(extra.FINAL_CONV_KERNEL),
        deconv_with_bias=bool(extra.DECONV_WITH_BIAS),
        dtype=dtypes[cfg.TPU.COMPUTE_DTYPE],
    )
    return model.init_weights(generator)
