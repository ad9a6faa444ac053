"""Soft-argmax decode and metrics: the port vs the JAX package.

The JAX function takes NHWC (N, H, W, J*D); the port takes NCHW
(N, J*D, H, W); the test feeds both the same numbers. Tolerance 1e-5 in
normalized coordinates: both accumulate exp-weighted sums of 10^3-10^4
float32 terms in different orders.
"""

import numpy as np
import pytest
import torch

from epipolarpose_tpu.ops import integral as jint
from epipolarpose_tpu.ops import metrics as jmet
from epipolarpose_tpu_torch.kernels import softargmax as ksa
from epipolarpose_tpu_torch.ops import integral as tint
from epipolarpose_tpu_torch.ops import metrics as tmet



def _volume(rng, n, j, d, h, w, scale=3.0):
    return (scale * rng.standard_normal((n, h, w, j * d))).astype(np.float32)


@pytest.mark.parametrize("depth_dim", [1, 8])
def test_plain_softargmax_matches_jax(rng, depth_dim):
    j, h, w = 5, 12, 16
    nhwc = _volume(rng, 3, j, depth_dim, h, w)
    want = np.asarray(jint.softmax_integral(nhwc, j, depth_dim))
    nchw = torch.from_numpy(nhwc).permute(0, 3, 1, 2).contiguous()
    got = ksa.softmax_integral_plain(nchw, j, depth_dim).numpy()
    assert got.shape == (3, j, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if depth_dim == 1:
        assert np.all(got[..., 2] == 0)


def test_ops_entry_takes_plain_version_on_cpu(rng):
    nchw = torch.from_numpy(_volume(rng, 2, 3, 4, 8, 8)).permute(0, 3, 1, 2)
    before = ksa.softmax_integral.launches
    got = tint.softmax_integral(nchw, 3, 4)
    np.testing.assert_array_equal(
        got.numpy(), ksa.softmax_integral_plain(nchw, 3, 4).numpy())
    assert ksa.softmax_integral.launches == before   # CPU does not count


def test_plain_softargmax_bf16_accumulates_in_f32(rng):
    nchw = torch.from_numpy(_volume(rng, 2, 3, 4, 8, 8)).permute(0, 3, 1, 2)
    lo = nchw.to(torch.bfloat16)
    got = ksa.softmax_integral_plain(lo, 3, 4)
    assert got.dtype == torch.float32
    want = ksa.softmax_integral_plain(lo.float(), 3, 4)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_kernel_argument_checks():
    ok = torch.zeros((2, 3 * 4, 8, 16), dtype=torch.bfloat16)
    ksa.check_kernel_args(ok, 3, 4)
    with pytest.raises(TypeError):
        ksa.check_kernel_args(ok.half(), 3, 4)
    with pytest.raises(ValueError, match="expected"):
        ksa.check_kernel_args(ok, 5, 4)
    with pytest.raises(ValueError, match="contiguous"):
        ksa.check_kernel_args(ok.transpose(2, 3), 3, 4)
    with pytest.raises(ValueError, match="W %"):
        ksa.check_kernel_args(torch.zeros((2, 12, 8, 12),
                                          dtype=torch.bfloat16), 3, 4)
    with pytest.raises(ValueError, match="channels"):
        ksa.softmax_integral_plain(ok, 5, 4)


def test_integral_to_camera_depth():
    c = torch.tensor([[0.1, -0.2, 0.25]])
    assert tint.integral_to_camera_depth(c, 1000.0).item() == 500.0
    np.testing.assert_allclose(
        np.asarray(jint.integral_to_camera_depth(c.numpy(), 1000.0)), 500.0)


@pytest.mark.parametrize("fn", ["mpjpe", "nmpjpe"])
@pytest.mark.parametrize("with_vis", [False, True])
def test_metrics_match_jax(rng, fn, with_vis):
    pred = rng.standard_normal((6, 17, 3)).astype(np.float32) * 100
    gt = rng.standard_normal((6, 17, 3)).astype(np.float32) * 100
    vis = (rng.uniform(size=(6, 17)) > 0.3).astype(np.float32)
    args = (vis,) if with_vis else ()
    want = float(getattr(jmet, fn)(pred, gt, *args))
    got = float(getattr(tmet, fn)(torch.from_numpy(pred),
                                  torch.from_numpy(gt),
                                  *map(torch.from_numpy, args)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
