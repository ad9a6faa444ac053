"""PoseResNet port vs the JAX package's Flax model, through the weight bridge.

Both run float32 in eval mode on the same weights: the JAX init, with BN
statistics and head weights redrawn from a numpy rng so that every layer
matters. Tolerance: relative 1e-4 of the output's largest magnitude, for
float32 convolutions summed in different orders through ~50 layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epipolarpose_tpu.config import load_config as jax_load_config
from epipolarpose_tpu.models import PoseResNet as JaxPoseResNet
from epipolarpose_tpu.models import export_state_dict, init_pose_net
from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.models import (PoseResNet, from_jax_variables,
                                           get_model, get_pose_net)

DEBUG_3D = "experiments/debug/synth_smoke_3d.yaml"


def _perturbed_variables(model, rng, size=64):
    params, stats = init_pose_net(model, jax.random.PRNGKey(0), (size, size))
    params = jax.tree.map(np.asarray, params)
    stats = jax.tree.map(np.asarray, stats)

    def redraw(tree, path=""):
        for k, v in tree.items():
            here = f"{path}/{k}"
            if isinstance(v, dict):
                redraw(v, here)
            elif k == "mean":
                tree[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("scale", "bias"):
                base = 1.0 if k == "scale" else 0.0
                tree[k] = (base + rng.normal(0, 0.1, v.shape)
                           ).astype(np.float32)
            elif k == "kernel" and ("deconv" in here or "final" in here):
                tree[k] = rng.normal(0, 0.05, v.shape).astype(np.float32)
    redraw(params)
    redraw(stats)
    return {"params": params, "batch_stats": stats}


def _port_model(num_layers, variables, **kw):
    model = PoseResNet(num_layers=num_layers, dtype=torch.float32, **kw)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model.eval()


@pytest.mark.parametrize("num_layers,depth_dim", [(18, 8), (50, 4),
                                                   (101, 4)])
def test_eval_forward_matches_jax(rng, num_layers, depth_dim):
    kw = dict(num_joints=5, depth_dim=depth_dim,
              num_deconv_filters=(32, 32, 32))
    jmodel = JaxPoseResNet(num_layers=num_layers, dtype=jnp.float32, **kw)
    variables = _perturbed_variables(jmodel, rng)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, x, train=False))
    model = _port_model(num_layers, variables, **kw)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 16, 16, 5 * depth_dim)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_bridge_matches_jax_export(rng):
    jmodel = JaxPoseResNet(num_layers=18, num_joints=3, depth_dim=2,
                           num_deconv_filters=(16, 16, 16), dtype=jnp.float32)
    variables = _perturbed_variables(jmodel, rng, size=32)
    want = export_state_dict(variables)
    got = from_jax_variables(variables)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_bridge_rejects_unknown_groups():
    with pytest.raises(KeyError):
        from_jax_variables({"params": {"mystery": {}}, "batch_stats": {}})


def test_get_pose_net_from_flagship_config():
    cfg = load_config("experiments/h36m/valid_r50_256_integral.yaml")
    model = get_model(cfg, False, torch.Generator().manual_seed(0))
    assert model.dtype == torch.bfloat16 and model.depth_dim == 64
    w = model.layer1[0].conv2.weight            # 3x3, 64 -> 64
    fan_out = 64 * 9
    # truncated normal: std sqrt(2/fan_out), support +-2/0.8796 of it
    std = float(np.sqrt(2.0 / fan_out))
    assert abs(w.std().item() / std - 1) < 0.05
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(model.final_layer.weight.std().item() / 1e-3 - 1) < 0.05
    assert torch.all(model.final_layer.bias == 0)
    assert model.final_layer.out_channels == 17 * 64
    again = get_model(cfg, False, torch.Generator().manual_seed(0))
    torch.testing.assert_close(again.conv1.weight, model.conv1.weight)


def test_port_keys_are_the_jax_export_keys():
    cfg = jax_load_config(DEBUG_3D)
    from epipolarpose_tpu.models import get_model as jax_get_model
    jmodel = jax_get_model(cfg)
    params, stats = init_pose_net(jmodel, jax.random.PRNGKey(1), (64, 64))
    want = export_state_dict({"params": params, "batch_stats": stats})
    model = get_pose_net(load_config(DEBUG_3D))
    assert sorted(model.state_dict()) == sorted(want)


def test_remat_and_unknown_model_raise():
    """``TPU.REMAT`` builds the remat model (the name is historical: the
    port used to refuse it) with the same state-dict names and, in eval
    mode, the same output; an unknown ``MODEL.NAME`` raises."""
    cfg = load_config(DEBUG_3D)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    plain = get_pose_net(cfg, generator=torch.Generator().manual_seed(0))
    cfg.TPU.REMAT = True
    remat = get_pose_net(cfg, generator=torch.Generator().manual_seed(0))
    assert remat.remat and not plain.remat
    assert list(remat.state_dict()) == list(plain.state_dict())
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    assert torch.equal(remat.eval()(x), plain.eval()(x))
    cfg.TPU.REMAT = False
    cfg.MODEL.NAME = "nope"
    with pytest.raises(ValueError):
        get_model(cfg)


def test_bf16_forward_keeps_bf16_output():
    model = PoseResNet(num_layers=18, num_joints=2, depth_dim=2,
                       num_deconv_filters=(8, 8, 8)).init_weights(
                           torch.Generator().manual_seed(0)).eval()
    assert model.conv1.weight.dtype == torch.float32
    with torch.no_grad():
        out = model(torch.zeros((1, 3, 32, 32)))
    assert out.dtype == torch.bfloat16 and out.shape == (1, 4, 8, 8)


@pytest.mark.parametrize("kernel", [2, 3, 4])
def test_deconv_head_matches_flax_at_each_kernel(rng, kernel):
    """The deconv head at kernel 2, 3 and 4 against flax's ConvTranspose
    (``padding="SAME"``), weights through the bridge and loaded with
    ``strict=True``. Same tolerance as the forward test above."""
    kw = dict(num_joints=3, depth_dim=2, num_deconv_filters=(16, 16, 16),
              num_deconv_kernels=(kernel,) * 3)
    jmodel = JaxPoseResNet(num_layers=18, dtype=jnp.float32, **kw)
    variables = _perturbed_variables(jmodel, rng, size=32)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, x, train=False))
    model = _port_model(18, variables, **kw)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 8, 8, 6)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_k3_head_state_dict_round_trips_strict():
    """A kernel-3 head keeps the reference state-dict names: its own
    state_dict loads into a fresh model with ``strict=True``."""
    kw = dict(num_layers=18, num_joints=2, depth_dim=2,
              num_deconv_filters=(8, 8, 8), num_deconv_kernels=(3, 3, 3),
              dtype=torch.float32)
    src = PoseResNet(**kw).init_weights(torch.Generator().manual_seed(0))
    dst = PoseResNet(**kw)
    dst.load_state_dict(src.state_dict(), strict=True)
    assert "deconv_layers.0.weight" in dst.state_dict()
    x = torch.randn((1, 3, 32, 32), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(dst.eval()(x), src.eval()(x), rtol=0,
                                   atol=0)
