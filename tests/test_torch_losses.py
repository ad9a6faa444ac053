"""Integral targets, the L1 loss and the soft-argmax gradient: the port vs
the JAX package.

Targets and weights are elementwise float32 and must agree to 1e-6. The
loss sums at most a few hundred float32 terms: relative 1e-6. The
soft-argmax gradients are float32 sums over 10^3-10^4 exp-weighted terms
in another order: 1e-5 of the largest gradient entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epipolarpose_tpu.ops import integral as jint
from epipolarpose_tpu.ops import losses as jloss
from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.kernels import softargmax as ksa
from epipolarpose_tpu_torch.ops import integral as tint
from epipolarpose_tpu_torch.ops import losses as tloss

IMAGE_SIZE = (64, 48)        # (w, h), unequal so that x and y cannot swap


def _joints(rng, n=5, j=17):
    """Crop-pixel joints, some outside the crop, with vis 0 for some and
    depths (mm) some beyond the +-1000 mm bound of the tests."""
    w, h = IMAGE_SIZE
    xy = np.stack([rng.uniform(-8, w + 8, (n, j)),
                   rng.uniform(-8, h + 8, (n, j))], -1).astype(np.float32)
    xy[0, 0] = (w, h / 2)            # on the right edge: outside ([-.5, .5))
    xy[0, 1] = (0, 0)                # on the top-left corner: inside
    vis = (rng.uniform(size=(n, j)) > 0.2).astype(np.float32)
    depth = rng.uniform(-1300, 1300, (n, j)).astype(np.float32)
    xy[0, 2] = (w / 2, h / 2)
    depth[0, 2] = 1000.0             # |z| exactly 0.5: inside
    return xy, vis, depth


@pytest.mark.parametrize("mode", ["2d", "3d"])
@pytest.mark.parametrize("vis_shape", ["nj", "nj3"])
def test_generate_integral_target_matches_jax(rng, mode, vis_shape):
    xy, vis, depth = _joints(rng)
    if vis_shape == "nj3":
        vis = np.repeat(vis[..., None], 3, -1)
    kw = dict(depth_bound=1000.0, joints_depth=depth) if mode == "3d" else {}
    want_t, want_w = jint.generate_integral_target(xy, vis, IMAGE_SIZE, **kw)
    tkw = ({k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()})
    got_t, got_w = tint.generate_integral_target(
        torch.from_numpy(xy), torch.from_numpy(vis), IMAGE_SIZE, **tkw)
    assert got_t.shape == (5, 17, 3) and got_w.shape == (5, 17)
    assert got_w.dtype == torch.float32
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    # the cases the inputs were built to hit
    w = got_w.numpy()
    assert w[0, 0] == 0 and w[0, 1] == vis.reshape(5, 17, -1)[0, 1, 0]
    assert 0 < w.sum() < w.size
    if mode == "3d":
        assert w[0, 2] == vis.reshape(5, 17, -1)[0, 2, 0]
        z_out = np.abs(depth) > 1000.0
        assert np.all(w[z_out] == 0) and z_out.any()


@pytest.mark.parametrize("weight", ["none", "nj", "nj3"])
def test_integral_l1_loss_matches_jax(rng, weight):
    pred = rng.uniform(-0.5, 0.5, (6, 17, 3)).astype(np.float32)
    target = rng.uniform(-0.6, 0.6, (6, 17, 3)).astype(np.float32)
    w = {"none": None,
         "nj": (rng.uniform(size=(6, 17)) > 0.3).astype(np.float32),
         "nj3": rng.uniform(0, 2, (6, 17, 3)).astype(np.float32)}[weight]
    want = float(jloss.integral_l1_loss(pred, target, w))
    got = tloss.integral_l1_loss(
        torch.from_numpy(pred), torch.from_numpy(target),
        None if w is None else torch.from_numpy(w))
    assert got.ndim == 0
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


def test_integral_l1_loss_masks_nan_target_under_zero_weight(rng):
    pred = rng.uniform(-0.5, 0.5, (3, 4, 3)).astype(np.float32)
    target = rng.uniform(-0.5, 0.5, (3, 4, 3)).astype(np.float32)
    w = np.ones((3, 4), np.float32)
    target[1, 2] = np.nan
    w[1, 2] = 0.0
    want = float(jloss.integral_l1_loss(pred, target, w))
    got = tloss.integral_l1_loss(torch.from_numpy(pred),
                                 torch.from_numpy(target),
                                 torch.from_numpy(w)).item()
    assert np.isfinite(got) and np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # divided by the batch size, not by the weighted count
    err = np.abs(pred - np.nan_to_num(target)).sum(-1) * w
    np.testing.assert_allclose(got, err.sum() / 3, rtol=1e-6)


def test_make_loss():
    cfg = load_config("experiments/debug/synth_smoke_3d.yaml")
    a = torch.zeros((2, 3, 3))
    b = torch.full((2, 3, 3), 0.25)
    w = torch.tensor([[1.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    crit = tloss.make_loss(cfg)
    assert crit(a, b, w).item() == pytest.approx(3 * 3 * 0.25 / 2)
    cfg.LOSS.USE_TARGET_WEIGHT = False
    assert tloss.make_loss(cfg)(a, b, w).item() == pytest.approx(
        9 * 2 * 0.25 / 2)
    cfg.LOSS.TYPE = "JointsMSELoss"          # the heatmap MSE, ported now
    maps = torch.ones((2, 3, 4, 4))
    # USE_TARGET_WEIGHT is off: 0.5 * mean(1) for every joint
    assert tloss.make_loss(cfg)(maps, torch.zeros_like(maps), w).item() \
        == pytest.approx(0.5)
    cfg.LOSS.USE_TARGET_WEIGHT = True        # joints weigh 1/2, 0, 2/2
    assert tloss.make_loss(cfg)(maps, torch.zeros_like(maps), w).item() \
        == pytest.approx((0.25 + 0.0 + 0.5) / 3)
    cfg.LOSS.TYPE = "nope"
    with pytest.raises(ValueError):
        tloss.make_loss(cfg)


# ------------------------------------------------ soft-argmax gradient
J, H, W = 5, 12, 16


def _jax_grad(nhwc, g, depth_dim):
    """d(sum(softmax_integral * g))/d logits, NHWC, by jax.grad."""
    def f(x):
        return jnp.sum(jint.softmax_integral(x, J, depth_dim) * g)
    return np.asarray(jax.grad(f)(nhwc))


def _case(rng, depth_dim):
    nhwc = (3.0 * rng.standard_normal((3, H, W, J * depth_dim))
            ).astype(np.float32)
    g = rng.standard_normal((3, J, 3)).astype(np.float32)
    return nhwc, g, torch.from_numpy(nhwc).permute(0, 3, 1, 2).contiguous()


def _to_nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("depth_dim", [1, 8])
@pytest.mark.parametrize("route", ["softmax_integral", "Function", "plain"])
def test_softargmax_gradient_matches_jax(rng, depth_dim, route):
    """The entry point and the autograd Function it goes through (on the
    CPU with the kernels' plain twins), and ordinary autograd of the plain
    reference."""
    nhwc, g, nchw = _case(rng, depth_dim)
    want = _jax_grad(nhwc, g, depth_dim)
    x = nchw.clone().requires_grad_(True)
    if route == "softmax_integral":
        coords = ksa.softmax_integral(x, J, depth_dim)
        assert coords.grad_fn.name() == "SoftmaxIntegralBackward"
    elif route == "Function":
        coords = ksa.SoftmaxIntegral.apply(x, J, depth_dim)
    else:
        coords = ksa.softmax_integral_plain(x, J, depth_dim)
    assert coords.grad_fn is not None
    (coords * torch.from_numpy(g)).sum().backward()
    got = _to_nhwc(x.grad)
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("depth_dim", [1, 8])
def test_bwd_plain_matches_jax(rng, depth_dim):
    nhwc, g, nchw = _case(rng, depth_dim)
    want = _jax_grad(nhwc, g, depth_dim)
    stats = ksa.softmax_integral_stats_plain(nchw, J, depth_dim)
    got = ksa.softmax_integral_bwd_plain(nchw, stats, torch.from_numpy(g))
    assert got.shape == nchw.shape and got.dtype == nchw.dtype
    np.testing.assert_allclose(_to_nhwc(got), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_bwd_plain_keeps_the_logits_dtype(rng):
    _, g, nchw = _case(rng, 4)
    lo = nchw.to(torch.bfloat16)
    stats = ksa.softmax_integral_stats_plain(lo, J, 4)
    got = ksa.softmax_integral_bwd_plain(lo, stats, torch.from_numpy(g))
    assert got.dtype == torch.bfloat16
    want = ksa.softmax_integral_bwd_plain(lo.float(), stats,
                                          torch.from_numpy(g))
    torch.testing.assert_close(got.float(), want.to(torch.bfloat16).float(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("depth_dim", [1, 8])
def test_plain_stats(rng, depth_dim):
    """lse is the log-sum-exp of each joint's volume; (Ex, Ey, Ez) are the
    coordinates in index units."""
    nhwc, _, nchw = _case(rng, depth_dim)
    stats = ksa.softmax_integral_stats_plain(nchw, J, depth_dim)
    assert stats.shape == (3, J, 4) and stats.dtype == torch.float32
    lse = torch.logsumexp(nchw.reshape(3, J, -1).double(), -1)
    torch.testing.assert_close(stats[..., 0].double(), lse, rtol=0,
                               atol=1e-5)
    coords = np.asarray(jint.softmax_integral(nhwc, J, depth_dim))
    np.testing.assert_allclose(stats[..., 1].numpy(),
                               (coords[..., 0] + 0.5) * W, rtol=0, atol=1e-4)
    np.testing.assert_allclose(stats[..., 2].numpy(),
                               (coords[..., 1] + 0.5) * H, rtol=0, atol=1e-4)
    if depth_dim > 1:
        np.testing.assert_allclose(stats[..., 3].numpy(),
                                   (coords[..., 2] + 0.5) * depth_dim,
                                   rtol=0, atol=1e-4)
    else:
        assert torch.all(stats[..., 3] == 0)


def test_plain_version_detaches_its_max(rng):
    """Softmax is invariant to the subtracted constant: the gradient
    through the detached max equals the gradient of the exact softmax."""
    _, g, nchw = _case(rng, 2)
    x = nchw.double().requires_grad_(True)
    (ksa.softmax_integral_plain(x, J, 2)
     * torch.from_numpy(g)).sum().backward()
    y = nchw.double().requires_grad_(True)
    p = torch.softmax(y.reshape(3, J, -1), -1).reshape(3, J, 2, H, W)
    xs = torch.arange(W, dtype=torch.float64)
    ys = torch.arange(H, dtype=torch.float64)[:, None]
    zs = torch.arange(2, dtype=torch.float64)[:, None, None]
    coords = torch.stack([(p * xs).sum((2, 3, 4)) / W - 0.5,
                          (p * ys).sum((2, 3, 4)) / H - 0.5,
                          (p * zs).sum((2, 3, 4)) / 2 - 0.5], -1)
    (coords * torch.from_numpy(g).double()).sum().backward()
    torch.testing.assert_close(x.grad, y.grad, rtol=0, atol=1e-6)


def test_kernel_wrappers_refuse_other_devices():
    """Only a CPU tensor takes the plain versions; a tensor elsewhere than
    on the CPU or a CUDA card raises."""
    x = torch.zeros((2, 6, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no softargmax kernel"):
        ksa.softmax_integral_bwd(x, torch.zeros((2, 3, 4), device="meta"),
                                 torch.zeros((2, 3, 3), device="meta"))
    with pytest.raises(ValueError, match="no softargmax kernel"):
        ksa.softmax_integral_fwd(x, 3, 2)
