"""The yardstick's counts against hand sums at small shapes, and the
frozen trace summary on a hand-made trace."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark import flops, rooflines, trace_summary
from benchmark.reference import model as ref_model

ARCH = dict(num_layers=50, num_joints=3, depth_dim=2, image_size=[64, 64],
            heatmap_size=[16, 16], deconv_filters=[8, 8, 8],
            deconv_kernels=[4, 4, 4], final_kernel=1, depth_bound=1000.0)


def test_flops_match_the_shapes_a_forward_pass_meets(monkeypatch):
    macs = []
    conv, deconv = F.conv2d, F.conv_transpose2d

    def count_conv(x, w, *a, **k):
        y = conv(x, w, *a, **k)
        macs.append(w.shape[1] * w.shape[2] * w.shape[3] * y[0].numel())
        return y

    def count_deconv(x, w, *a, **k):
        macs.append(x[0].numel() * w.shape[1] * w.shape[2] * w.shape[3])
        return deconv(x, w, *a, **k)
    monkeypatch.setattr(F, "conv2d", count_conv)
    monkeypatch.setattr(F, "conv_transpose2d", count_deconv)
    p = {n: (torch.zeros(s, dtype=torch.int64) if k == "count"
             else torch.randn(s) * 0.1)
         for n, s, k in ref_model.layout(ARCH)}
    ref_model.forward(p, torch.randn(1, 3, 64, 64), ARCH, train=True)
    assert flops.forward_macs(ARCH) == sum(macs)
    assert flops.forward_flops(ARCH) == 2 * sum(macs)


def test_flops_of_the_published_configurations():
    r50 = dict(ARCH, num_joints=17, depth_dim=64, image_size=[256, 256],
               deconv_filters=[256] * 3)
    # the deconvolution head alone: 2048 -> 256 at 8x8, 256 -> 256 at
    # 16x16 and 32x32 (k4), then 256 -> 17 x 64 at 64x64
    head = (2048 * 256 * 16 * 64 + 256 * 256 * 16 * 256
            + 256 * 256 * 16 * 1024 + 256 * 1088 * 4096)
    # ResNet-50's convolutions at 224x224: 4,087,136,256 multiply-adds
    # (the 4.09 GMAC usually cited, less the 2,048,000 of the classifier);
    # every feature map here is (8/7)^2 as large
    backbone = 4_087_136_256 * 64 * 64 // (56 * 56)
    assert flops.forward_macs(r50) == backbone + head == 8_358_199_296


def test_kernel_bytes_and_operations_by_hand():
    assert rooflines.softargmax_fwd_bytes(2, 3, 4, 5, 6, "bfloat16") \
        == 2 * 3 * 4 * 5 * 6 * 2 + 2 * 3 * 12
    assert rooflines.softargmax_bwd_bytes(2, 3, 4, 5, 6, "float32") \
        == 2 * (2 * 3 * 4 * 5 * 6 * 4) + 2 * 2 * 3 * 12
    n_bytes, ops = rooflines.triangulate_work(2, 4, 3)
    assert n_bytes == 6 * 4 * 12 + 2 * 4 * 48 + 6 * 16
    assert ops == 6 * (130 * 4 + 590)
    assert rooflines.bound_s(3.35e12) == 1.0
    assert rooflines.bound_s(0, 67e12) == 1.0


def test_trace_summary_on_a_hand_made_trace():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.call",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 60, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 20, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 80,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 95, "dur": 5},
        {"ph": "i", "cat": "kernel", "name": "ignored", "ts": 0},
    ]
    s = trace_summary.summarize({"traceEvents": ev})
    assert math.isclose(s["window_s"], 100e-6)
    # a and b overlap on [10, 40); the copy [80, 90); a again [95, 100)
    assert abs(s["busy_s"] - 45e-6) < 1e-12
    assert math.isclose(s["kernels"]["a"][0], 25e-6)
    assert s["kernels"]["a"][1] == 2
    assert s["device_ops"][0][0] == "a"
    # the longest gap [40, 80) is in the synchronize (the innermost host
    # event at its middle), the next [90, 95) only in the call
    assert [g[0] for g in s["idle_gaps"]] == ["cudaStreamSynchronize",
                                              "bench.call"]
    assert math.isclose(s["idle_gaps"][0][1], 40e-6)
    assert math.isclose(s["idle_gaps"][1][1], 5e-6)
