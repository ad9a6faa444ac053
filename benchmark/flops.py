"""Analytic multiply-add counts of the published PoseResNet
architectures, from the configuration's sizes alone: every convolution,
the three 4x4 stride-2 deconvolutions and the final convolution. Batch
norm, ReLU, pooling, the residual adds and the soft-argmax are left out
(a few percent of the operations, none on the tensor cores). An
operation is one multiply or one add: FLOPs = 2 x MACs.
"""

from __future__ import annotations

STAGES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
EXPANSION = 4


def _conv(cin: int, cout: int, k: int, h_out: int, w_out: int) -> int:
    return cin * cout * k * k * h_out * w_out


def forward_macs(arch: dict, depth_dim: int | None = None) -> int:
    """Multiply-adds of one crop's forward pass."""
    w, h = arch["image_size"]
    d = arch["depth_dim"] if depth_dim is None else depth_dim
    h, w = h // 2, w // 2
    macs = _conv(3, 64, 7, h, w)
    h, w = h // 2, w // 2                              # max pool
    inplanes = 64
    for i, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                             STAGES[arch["num_layers"]])):
        for b in range(blocks):
            stride = 2 if (i > 0 and b == 0) else 1
            width = planes * EXPANSION
            macs += _conv(inplanes, planes, 1, h, w)
            h2, w2 = h // stride, w // stride
            macs += _conv(planes, planes, 3, h2, w2)
            macs += _conv(planes, width, 1, h2, w2)
            if b == 0:
                macs += _conv(inplanes, width, 1, h2, w2)
            h, w, inplanes = h2, w2, width
    for planes, k in zip(arch["deconv_filters"], arch["deconv_kernels"]):
        # each input pixel scatters a k x k x planes patch
        macs += inplanes * planes * k * k * h * w
        h, w, inplanes = 2 * h, 2 * w, planes
    k = arch["final_kernel"]
    macs += _conv(inplanes, arch["num_joints"] * d, k, h, w)
    return macs


def forward_flops(arch: dict, depth_dim: int | None = None) -> int:
    return 2 * forward_macs(arch, depth_dim)
