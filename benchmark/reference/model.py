"""PoseResNet written out in plain PyTorch, float32, from the published
architecture: a ResNet backbone (He et al., arXiv:1512.03385; the
bottleneck's stride on its 3x3 convolution), three stride-2 4x4
deconvolutions of 256 filters each followed by batch norm and ReLU
(Xiao et al., arXiv:1804.06208), and a 1x1 convolution to
``num_joints * depth_dim`` channels (Sun et al., arXiv:1711.08229).

Parameters live in a flat dict keyed by the reference state-dict names
(``conv1.weight``, ``layer1.0.conv2.weight``, ``deconv_layers.1.weight``,
``final_layer.bias``, ...), so one set of weights can be loaded into the
program under test and read here. Batch norm in train mode normalises with
the biased batch variance and keeps the biased variance in its running
buffer (flax's convention, which the program states); momentum 0.1.

``quant`` (a :class:`quant.Precision`) rounds every weight as it enters a
convolution and every activation, with its gradient, to a lower
precision: the control of the correctness check.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

STAGES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
EXPANSION = 4
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def arch_of(port: dict) -> dict:
    """The architecture's sizes from a configuration file's ``port`` block
    (the program's YAML schema, read as plain data)."""
    model = port["MODEL"]
    extra = model["EXTRA"]
    return {"num_layers": int(extra["NUM_LAYERS"]),
            "num_joints": int(model["NUM_JOINTS"]),
            "depth_dim": int(extra.get("DEPTH_DIM", 1)),
            "image_size": [int(v) for v in model["IMAGE_SIZE"]],
            "heatmap_size": [int(v) for v in extra["HEATMAP_SIZE"]],
            "deconv_filters": [int(v) for v in extra["NUM_DECONV_FILTERS"]],
            "deconv_kernels": [int(v) for v in extra["NUM_DECONV_KERNELS"]],
            "final_kernel": int(extra["FINAL_CONV_KERNEL"]),
            "depth_bound": float(extra.get("DEPTH_BOUND", 1000.0))}


def layout(arch: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the network, in state-dict
    order. Kinds: ``conv`` (He normal over fan-out), ``head`` (the
    deconvolutions), ``final`` (the final convolution), ``residual`` (the
    scale of each residual branch's last batch norm), ``one``, ``zero``
    and ``count`` (batch norm's step count)."""
    d = arch["depth_dim"]
    out: list[tuple[str, tuple, str]] = []

    def bn(prefix: str, c: int, scale: str = "one") -> None:
        out.extend([(f"{prefix}.weight", (c,), scale),
                    (f"{prefix}.bias", (c,), "zero"),
                    (f"{prefix}.running_mean", (c,), "zero"),
                    (f"{prefix}.running_var", (c,), "one"),
                    (f"{prefix}.num_batches_tracked", (), "count")])

    out.append(("conv1.weight", (64, 3, 7, 7), "conv"))
    bn("bn1", 64)
    inplanes = 64
    for i, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                             STAGES[arch["num_layers"]])):
        for b in range(blocks):
            p = f"layer{i + 1}.{b}"
            width = planes * EXPANSION
            out.append((f"{p}.conv1.weight", (planes, inplanes, 1, 1),
                        "conv"))
            bn(f"{p}.bn1", planes)
            out.append((f"{p}.conv2.weight", (planes, planes, 3, 3), "conv"))
            bn(f"{p}.bn2", planes)
            out.append((f"{p}.conv3.weight", (width, planes, 1, 1), "conv"))
            bn(f"{p}.bn3", width, "residual")
            if b == 0:
                out.append((f"{p}.downsample.0.weight",
                            (width, inplanes, 1, 1), "conv"))
                bn(f"{p}.downsample.1", width)
            inplanes = width
    for i, (planes, k) in enumerate(zip(arch["deconv_filters"],
                                        arch["deconv_kernels"])):
        out.append((f"deconv_layers.{3 * i}.weight", (inplanes, planes, k, k),
                    "head"))
        bn(f"deconv_layers.{3 * i + 1}", planes)
        inplanes = planes
    k = arch["final_kernel"]
    out.append(("final_layer.weight", (arch["num_joints"] * d, inplanes, k, k),
                "final"))
    out.append(("final_layer.bias", (arch["num_joints"] * d,), "zero"))
    return out


def _bn(x, p, name, train, stats):
    if train:
        mean = x.mean((0, 2, 3))
        var = x.var((0, 2, 3), unbiased=False)
        if stats is not None:
            stats[name] = (mean.detach(), var.detach())
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    scale = p[f"{name}.weight"] * torch.rsqrt(var + BN_EPS)
    y = (x - mean[None, :, None, None]) * scale[None, :, None, None]
    return y + p[f"{name}.bias"][None, :, None, None]


def final(p: dict, x: torch.Tensor, arch: dict, quant=None
          ) -> torch.Tensor:
    """The final convolution: deconvolution features -> (N, J*D, h, w)."""
    w = p["final_layer.weight"]
    if quant:
        w = quant.operand(w)
    k = arch["final_kernel"]
    y = F.conv2d(x, w, p.get("final_layer.bias"), 1, 1 if k == 3 else 0)
    return quant.act(y) if quant else y


def forward(p: dict, x: torch.Tensor, arch: dict, train: bool,
            stats: dict | None = None, quant=None,
            head: bool = True) -> torch.Tensor:
    """Normalised NCHW float32 crops -> (N, J*D, H/4, W/4) float32, or
    without ``head`` the deconvolutions' features that :func:`final`
    takes.

    ``train``: batch norm on batch statistics, written to ``stats`` by
    name when given (:func:`update_running`); else on the running ones.
    Where a gradient is taken, each residual block's activations are
    computed again in the backward pass instead of kept, so that a
    float32 step at a training cell's batch fits beside nothing else on
    the card.
    """
    def same(t):
        return t
    w_q = quant.operand if quant else same
    act = quant.act if quant else same

    def conv(x, name, stride=1, padding=0):
        bias = p.get(f"{name}.bias")
        return act(F.conv2d(x, w_q(p[f"{name}.weight"]), bias, stride,
                            padding))

    def bn(x, name):
        return act(_bn(x, p, name, train, stats))

    x = act(x)
    x = F.relu(bn(conv(x, "conv1", 2, 3), "bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    def block(x, pre, stride, first):
        res = x
        if first:
            res = bn(conv(x, f"{pre}.downsample.0", stride),
                     f"{pre}.downsample.1")
        y = F.relu(bn(conv(x, f"{pre}.conv1"), f"{pre}.bn1"))
        y = F.relu(bn(conv(y, f"{pre}.conv2", stride, 1), f"{pre}.bn2"))
        y = bn(conv(y, f"{pre}.conv3"), f"{pre}.bn3")
        return act(F.relu(y + res))

    again = torch.is_grad_enabled()
    for i, blocks in enumerate(STAGES[arch["num_layers"]]):
        for b in range(blocks):
            args = (x, f"layer{i + 1}.{b}", 2 if (i > 0 and b == 0) else 1,
                    b == 0)
            x = (checkpoint(block, *args, use_reentrant=False) if again
                 else block(*args))
    for i, k in enumerate(arch["deconv_kernels"]):
        if k != 4:
            raise ValueError("the reference writes out 4x4 deconvolutions")
        w = w_q(p[f"deconv_layers.{3 * i}.weight"])
        x = act(F.conv_transpose2d(x, w, None, 2, 1))
        x = F.relu(bn(x, f"deconv_layers.{3 * i + 1}"))
    return final(p, x, arch, quant) if head else x


@torch.no_grad()
def update_running(p: dict, stats: dict) -> None:
    """The running buffers after a train-mode forward: flax's update,
    ``(1 - m) * running + m * batch`` with the biased variance."""
    for name, (mean, var) in stats.items():
        p[f"{name}.running_mean"].lerp_(mean, BN_MOMENTUM)
        p[f"{name}.running_var"].lerp_(var, BN_MOMENTUM)
        p[f"{name}.num_batches_tracked"].add_(1)


def trainable(arch: dict) -> list:
    """Names of the parameters (not buffers), in state-dict order."""
    return [n for n, _, kind in layout(arch)
            if kind != "count" and not n.endswith(("running_mean",
                                                   "running_var"))]
