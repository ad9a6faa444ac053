"""The port's CUDA kernels against their plain versions, on the card.

Imports torch and numpy only, so it runs on the card's machine without
JAX (``--noconftest`` skips the suite's JAX setup there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py

Without a CUDA card every test here skips. Tolerances: soft-argmax 1e-5
in normalized coordinates (float32 sums in other orders); matmul y within
one bf16 spacing (both round an f32 sum of the same products; entries
below 1/256 of y's rms are measured at that floor), stats 1e-3 of the
largest stat (atomics add block partials in any order).
"""

import numpy as np
import pytest
import torch

from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.core.steps import (configure_backends,
                                               make_eval_step)
from epipolarpose_tpu_torch.kernels import matmul_stats as kms
from epipolarpose_tpu_torch.kernels import softargmax as ksa
from epipolarpose_tpu_torch.models import get_pose_net

H36M_FLIP_PAIRS = ((1, 4), (2, 5), (3, 6), (11, 14), (12, 15), (13, 16))

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _max_bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| in bf16 spacings at max(|a|, |b|, rms(b) / 256).

    The floor: an entry near zero by cancellation carries the f32 rounding
    of its K-term sum, which depends on the summation order and can exceed
    its own bf16 spacing in any two implementations."""
    floor = b.pow(2).mean().sqrt() / 256
    mag = torch.maximum(torch.maximum(a.abs(), b.abs()), floor)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((a - b).abs() / ulp).max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 1, 16, 16), (2, 17, 8, 16, 24),
                                   (3, 5, 4, 7, 32)])
def test_softargmax_kernel_matches_plain(cuda, dtype, shape):
    n, j, d, h, w = shape
    g = torch.Generator(cuda).manual_seed(0)
    x = (3 * torch.randn((n, j * d, h, w), generator=g, device=cuda)).to(dtype)
    before = ksa.softmax_integral.launches
    got = ksa.softmax_integral(x, j, d)
    assert ksa.softmax_integral.launches == before + 1
    want = ksa.softmax_integral_plain(x, j, d)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    if d == 1:
        assert torch.all(got[..., 2] == 0)


def test_softargmax_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros((2, 6, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ksa.softmax_integral(x.transpose(2, 3), 3, 2)
    with pytest.raises(TypeError):
        ksa.softmax_integral(x.half(), 3, 2)


@pytest.mark.parametrize("shape", [(256, 64, 64), (300, 72, 200),
                                   (131, 13, 70), (8192, 512, 256)])
def test_matmul_stats_kernel_matches_plain(cuda, shape):
    m, k, n = shape
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn((m, k), generator=g, device=cuda, dtype=torch.bfloat16)
    w = torch.randn((k, n), generator=g, device=cuda, dtype=torch.bfloat16)
    before = kms.matmul_stats.launches
    y, s = kms.matmul_stats(x, w)
    assert kms.matmul_stats.launches == before + 1
    y_ref, s_ref = kms.matmul_stats_plain(x, w)
    assert _max_bf16_ulps(y.float(), y_ref.float()) <= 1.0
    scale = s_ref.abs().amax(dim=1, keepdim=True)
    assert torch.all((s - s_ref).abs() <= 1e-3 * scale)


def test_eval_step_on_card_matches_cpu(cuda):
    """Debug config in float32 with flip test: the card (TF32 off, the
    soft-argmax kernel) against the CPU (plain decode), same weights."""
    cfg = load_config("experiments/debug/synth_smoke_3d.yaml")
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TEST.FLIP_TEST = cfg.TEST.SHIFT_HEATMAP = True
    configure_backends(cfg)
    gen = torch.Generator().manual_seed(0)
    model = get_pose_net(cfg, generator=gen)
    with torch.no_grad():
        for mod in (*model.deconv_layers, model.final_layer):
            w = getattr(mod, "weight", None)
            if w is not None and w.ndim == 4:
                w.normal_(0.0, 0.05, generator=gen)
    rng = np.random.default_rng(0)
    batch = {"input": rng.integers(0, 256, (4, 64, 64, 3), np.uint8),
             "center": rng.uniform(80, 400, (4, 2)).astype(np.float32),
             "scale": rng.uniform(0.2, 0.6, (4, 2)).astype(np.float32)}
    want = make_eval_step(cfg, model, H36M_FLIP_PAIRS, device="cpu")(batch)
    before = ksa.softmax_integral.launches
    got = make_eval_step(cfg, model, H36M_FLIP_PAIRS, device=cuda)(batch)
    assert ksa.softmax_integral.launches == before + 1
    got, want = got["preds"].cpu(), want["preds"]
    torch.testing.assert_close(got[..., :2], want[..., :2], rtol=0, atol=1e-3)
    torch.testing.assert_close(got[..., 2], want[..., 2], rtol=0, atol=1e-2)
