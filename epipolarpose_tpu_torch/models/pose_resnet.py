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

``TPU.REMAT`` (``remat=True``) is the JAX package's ``nn.remat`` over
each backbone block: the block's forward runs under
``torch.utils.checkpoint`` and is run again in the backward instead of
keeping its activations. The stem, the deconv head and ``final_layer``
are not wrapped. The second forward updates no batch-norm buffer (JAX
drops the recomputed ``batch_stats``), so the buffers after a step are
the same with and without it.

Under data parallelism the train step's model has
:class:`GlobalBatchNorm2d` in place of :class:`BatchNorm2d`
(``parallel.wrap_model``): statistics over the global batch, as flax's
BatchNorm gives a batch sharded over a mesh (flax computes the variance
as E[x^2] - E[x]^2; the port combines centred sums, which do not
cancel).

Under a model axis (``TPU.MESH.MODEL > 1``) each process runs the network
on its own rows of the crops: :func:`partition_rows` switches every layer
that reads rows beyond its output's (the stem, the max pool, the 3x3
convolutions, the k3 and k4 deconvolutions, a k3 final layer) to a halo
exchange (``parallel/spatial.py``) followed by the layer with no padding
along H. With one process it is the same layer.

Weight init follows the JAX package: backbone convs truncated-normal
He init over fan-out, deconvs and the final conv normal(std=0.001), BN
scale 1 and shift 0, running mean 0 and variance 1. It draws from a
``torch.Generator``, so it is reproducible but does not give the JAX
package's numbers.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from epipolarpose_tpu_torch.parallel.mesh import (all_reduce_sum,
                                                  process_allgather,
                                                  process_count)
from epipolarpose_tpu_torch.parallel.spatial import halo_exchange

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
    kernels that reads no activation again. It writes the buffer in place,
    so a CUDA graph's replays update the buffer the graph captured, and
    through ``.data``: autograd saved the buffer for the backward, which in
    train mode does not read it, and would refuse a bumped version.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        old = self.running_var * (1.0 - self.momentum)
        y = super().forward(x)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.data.copy_(
                torch.lerp(self.running_var, old, 1.0 / n))
        return y


class BatchNorm2d(FlaxRunningVar, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running variance
    (:class:`FlaxRunningVar`)."""


class _GlobalBatchNormFn(torch.autograd.Function):
    """Train-mode batch norm over the batches of every process. Forward:
    each process's per-channel count, mean and centred sum of squares
    (two passes over its slice), gathered in one collective and combined
    by Chan et al.'s pairwise rule, so the global variance does not cancel
    in float32 as E[x^2] - E[x]^2 does where a channel's mean is large
    against its spread; every process combines the same numbers in the
    same order, so all hold the same statistics. Under a model axis a
    process's count is its crops x its rows x W, and the global count
    covers each crop's rows once. Backward: one all-reduce of (sum dy, sum
    dy * xhat); the gradient of ``x`` is that of the sum of the losses
    whose gradients the processes hold. Without a model axis that is
    every process's loss, so DDP's mean of the parameter gradients is the
    gradient of the global mean loss. Under a model axis each process of
    a model group holds its rows' part of their one loss, so the sum
    counts each data group's loss once and DDP's mean over ``D * M``
    processes is ``1/M`` of that gradient: the train step scales its loss
    by ``M`` (``core/steps.py::optimizer_step``). Returns (y, mean, biased
    variance)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        shape = [1, c] + [1] * (x.dim() - 2)
        xf = x.float()
        n_local = xf.numel() // c
        mean_local = xf.mean(dims)
        m2_local = (xf - mean_local.view(shape)).square().sum(dims)
        parts = process_allgather(torch.cat([
            mean_local, m2_local,
            torch.full((1,), n_local, dtype=torch.float32,
                       device=x.device)])[None])
        means, m2s, counts = parts[:, :c], parts[:, c:2 * c], parts[:, -1:]
        n = counts.sum()
        mean = (means * counts).sum(0) / n
        m2 = (m2s + counts * (means - mean).square()).sum(0)
        var = m2 / n
        invstd = torch.rsqrt(var + eps)
        scale = (weight * invstd).view(shape)
        y = (xf - mean.view(shape)) * scale + bias.view(shape)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        shape = [1, c] + [1] * (x.dim() - 2)
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        dyf = dy.float()
        sum_dy, sum_dy_xhat = dyf.sum(dims), (dyf * xhat).sum(dims)
        g = all_reduce_sum(torch.cat([sum_dy, sum_dy_xhat])) / n
        dx = (dyf - g[:c].view(shape) - xhat * g[c:].view(shape)) \
            * (weight * invstd).view(shape)
        return dx.to(x.dtype), sum_dy_xhat, sum_dy, None


class GlobalBatchNorm2d(BatchNorm2d):
    """:class:`BatchNorm2d` whose train-mode statistics cover the global
    batch of every process (:class:`_GlobalBatchNormFn`); the running
    buffers get flax's update, biased variance and the global count,
    written in place, so they agree on every process. With one process,
    or in eval mode, it is :class:`BatchNorm2d`. Same state-dict names."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or process_count() == 1:
            return super().forward(x)
        y, mean, var = _GlobalBatchNormFn.apply(x, self.weight, self.bias,
                                                self.eps)
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
        return y


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


def _check_stride(x: torch.Tensor, stride: int) -> None:
    if x.shape[2] % stride:
        raise ValueError(f"{x.shape[2]} rows a process under a stride "
                         f"{stride}: the row split is not aligned "
                         "(parallel.check_row_split)")


class RowSplitConv2d(nn.Conv2d):
    """``nn.Conv2d`` on this process's rows: the ``p`` rows above and the
    ``k - s - p`` below that its outputs read come from the neighbours
    (zeros at the image's edges), then the convolution without padding
    along H gives exactly this process's output rows, given that its
    first row is a multiple of the stride."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (k, _), (s, _), (p, pw) = (self.kernel_size, self.stride,
                                   self.padding)
        _check_stride(x, s)
        x = halo_exchange(x, p, max(k - s - p, 0), 0.0)
        return F.conv2d(x, self.weight, self.bias, self.stride, (0, pw),
                        self.dilation, self.groups)


class RowSplitMaxPool2d(nn.MaxPool2d):
    """``nn.MaxPool2d`` on this process's rows, as
    :class:`RowSplitConv2d`; the image's edges are ``-inf``, the pool's
    own padding."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s, p = self.kernel_size, self.stride, self.padding
        _check_stride(x, s)
        x = halo_exchange(x, p, max(k - s - p, 0), float("-inf"))
        return F.max_pool2d(x, k, s, (0, p), self.dilation, self.ceil_mode,
                            self.return_indices)


class RowSplitDeconv2d(SameDeconv2d):
    """:class:`SameDeconv2d` on this process's rows: its output rows
    ``[s*r0, s*(r0 + R))`` read input rows ``r0 - floor((k-1-p)/s)`` to
    ``r0 + R - 1 + floor((p-1)/s) + 1``; with those halos (zeros at the
    edges) the transposed convolution's H padding ``s*top + p`` and an
    output padding give exactly them. The k3 head's crop of the last row
    falls to the last process alone; every process crops its column."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (k, _), (s, _), (p, pw) = (self.kernel_size, self.stride,
                                   self.padding)
        r = x.shape[2]
        top, bottom = (k - 1 - p) // s, (p - 1) // s + 1
        pad = s * top + p
        extra = s * r - ((r + top + bottom - 1) * s + k - 2 * pad)
        y = F.conv_transpose2d(halo_exchange(x, top, bottom, 0.0),
                               self.weight, self.bias, self.stride,
                               (pad, pw), (extra, 0), self.groups,
                               self.dilation)
        return y[..., :-self.crop] if self.crop else y


# the layers that read rows beyond their output's, and their row-split
# forms (same attributes and state-dict names)
_ROW_SPLIT = {nn.Conv2d: RowSplitConv2d, nn.MaxPool2d: RowSplitMaxPool2d,
              SameDeconv2d: RowSplitDeconv2d}


def _reads_halo(mod: nn.Module) -> bool:
    if isinstance(mod, SameDeconv2d):
        return mod.kernel_size[0] > 2
    k = mod.kernel_size if isinstance(mod, nn.MaxPool2d) \
        else mod.kernel_size[0]
    return k > 1


def partition_rows(model: nn.Module) -> nn.Module:
    """Switch every row-sensitive layer of ``model`` to its row-split form
    (a class swap, as ``parallel.wrap_model`` swaps batch norms: the
    state-dict names stay, so ``strict=True`` loads and the weight bridge
    are unchanged). 1x1 convolutions (those of stride 2 read the even
    local rows, aligned since each process's first row is even) and the
    k2 deconvolution read no halo and stay. Returns ``model``; a second
    call changes nothing."""
    for mod in model.modules():
        cls = _ROW_SPLIT.get(type(mod))
        if cls is not None and _reads_halo(mod):
            mod.__class__ = cls
    return model


def is_row_split(model: nn.Module) -> bool:
    """Whether :func:`partition_rows` has switched ``model``'s layers."""
    return any(type(m) in _ROW_SPLIT.values() for m in model.modules())


@contextlib.contextmanager
def _buffers_kept(block: nn.Module):
    """The recomputing forward of a checkpointed block: its batch norms run
    as in the forward (the same saved tensors) with momentum 0, so each
    running buffer keeps its value, and the step count is put back."""
    kept = [(m, m.momentum, m.num_batches_tracked.clone())
            for m in block.modules()
            if isinstance(m, nn.BatchNorm2d) and m.track_running_stats]
    for m, _, _ in kept:
        m.momentum = 0.0
    try:
        yield
    finally:
        for m, momentum, count in kept:
            m.momentum = momentum
            m.num_batches_tracked.copy_(count)


def _remat_contexts(block: nn.Module):
    return contextlib.nullcontext(), _buffers_kept(block)


class PoseResNet(nn.Module):
    """Backbone + deconv head + final conv. Input (N, 3, H, W) float;
    output (N, NUM_JOINTS * DEPTH_DIM, H/4, W/4) in ``dtype``. With
    ``remat`` each backbone block is recomputed in the backward (module
    docstring)."""

    def __init__(self, num_layers: int = 50, num_joints: int = 16,
                 depth_dim: int = 1, num_deconv_layers: int = 3,
                 num_deconv_filters: Sequence[int] = (256, 256, 256),
                 num_deconv_kernels: Sequence[int] = (4, 4, 4),
                 final_conv_kernel: int = 1, deconv_with_bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16, remat: bool = False):
        super().__init__()
        block_name, stages = RESNET_SPEC[num_layers]
        block = BasicBlock if block_name == "basic" else Bottleneck
        self.num_joints = num_joints
        self.depth_dim = depth_dim
        self.dtype = dtype
        self.remat = remat

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
        # no cast cache: a CUDA graph must not keep casts made at capture
        # (each weight is cast once a forward either way)
        cast = (torch.autocast(x.device.type, dtype=self.dtype,
                               cache_enabled=False)
                if self.dtype != torch.float32 else contextlib.nullcontext())
        with cast:
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            for layer in (self.layer1, self.layer2, self.layer3,
                          self.layer4):
                x = self._stage(layer, x)
            x = self.final_layer(self.deconv_layers(x))
        return x.to(self.dtype)

    def _stage(self, layer: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return layer(x)
        for block in layer:
            # non-reentrant: DDP's gradient hooks and autocast hold; no RNG
            # in a block, so its state is not saved
            x = checkpoint(block, x, use_reentrant=False,
                           preserve_rng_state=False,
                           context_fn=functools.partial(_remat_contexts,
                                                        block))
        return x

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
        remat=bool(cfg.TPU.REMAT),
    )
    return model.init_weights(generator)
