"""The refinement unit (``models/refiner.py``, ``core/refine.py``,
``load_refiner``) against the JAX package.

- ``PoseRefiner`` in eval mode, with the JAX variables (running statistics
  redrawn) through ``refiner_from_jax_variables``: the refined poses'
  delta within 1e-5 of JAX's, relative to its largest entry (poses of
  some 200 mm give deltas of hundreds of mm, where float32 spacing is
  3e-5).
- One ``l1`` and one ``l2`` train step at dropout 0 against JAX
  ``make_refiner_train_step``: the loss within 1e-5 relative, the running
  statistics within 1e-5, and the parameters within 1e-5 wherever JAX's
  gradient is at least 1e-6, but the linear biases that feed a batch norm.
  (Adam's first update is about ``lr * sign(g)``: where the gradient is
  float32 noise, and a bias that batch norm cancels has an exact gradient
  of 0, the two packages step either way.)
- ``synth_noise``: the outlier share and both standard deviations of the
  port's torch draws and of JAX's ``jax.random`` draws agree with the
  model's to within sampling error (the values cannot match).
- Dropout keeps ``1 - rate`` of the entries, scaled by ``1 / (1 - rate)``.
- ``load_refiner`` reads what ``train_refiner`` writes: width and depth
  from the file's shapes, eval mode, no gradient.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epipolarpose_tpu.core import refine as jrefine
from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.core import refine as trefine
from epipolarpose_tpu_torch.core.self_supervised import load_refiner
from epipolarpose_tpu_torch.models import (PoseRefiner,
                                           refiner_from_jax_variables)
from epipolarpose_tpu_torch.models.refiner import dropout

ROOT = pathlib.Path(__file__).resolve().parents[1]
J, HIDDEN, BLOCKS = 17, 64, 2


def _jax_state(rate, seed=0):
    model, state = jrefine.create_refiner_state(
        J, jax.random.PRNGKey(seed), hidden=HIDDEN, blocks=BLOCKS,
        dropout=rate)
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
        state.batch_stats)
    return model, state.replace(batch_stats=stats)


def _port(state, rate):
    model = PoseRefiner(J, HIDDEN, BLOCKS, rate)
    model.load_state_dict(refiner_from_jax_variables(
        {"params": jax.tree.map(np.asarray, state.params),
         "batch_stats": jax.tree.map(np.asarray, state.batch_stats)}),
        strict=True)
    return model


def _poses(seed, n=8):
    return np.random.default_rng(seed).normal(0, 200, (n, J, 3)).astype(
        np.float32)


def test_eval_matches_jax():
    jmodel, jstate = _jax_state(0.5)
    model = _port(jstate, 0.5)
    poses = _poses(1)
    want = np.asarray(jrefine.make_refiner_apply(jmodel)(jstate, poses))
    got = trefine.make_refiner_apply(model)(None, torch.from_numpy(poses))
    assert not model.training
    delta = want - poses
    np.testing.assert_allclose(got.numpy() - poses, delta, rtol=0,
                               atol=1e-5 * np.abs(delta).max())
    assert np.abs(delta).max() > 1e-2


def _jax_grads(jmodel, jstate, noisy, gt, loss_type):
    def loss_fn(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": jstate.batch_stats}, noisy,
            train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        err = out - gt
        return (jnp.mean(jnp.abs(err)) if loss_type == "l1"
                else jnp.mean(err ** 2))
    return jax.grad(loss_fn)(jstate.params)


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_train_step_matches_jax(loss_type):
    jmodel, jstate = _jax_state(0.0, seed=2)
    model = _port(jstate, 0.0)
    _, state = trefine.create_refiner_state(J, hidden=HIDDEN, blocks=BLOCKS,
                                            dropout=0.0, device="cpu")
    state.model = model
    state.optimizer = torch.optim.Adam(model.parameters(), lr=1e-3,
                                       betas=(0.9, 0.999), eps=1e-8)
    noisy, gt = _poses(3, n=32), _poses(4, n=32) * 0.5
    jnew, jloss = jrefine.make_refiner_train_step(jmodel, loss_type)(
        jstate, jnp.asarray(noisy), jnp.asarray(gt), jax.random.PRNGKey(5))
    step = trefine.make_refiner_train_step(model, loss_type)
    state, loss = step(state, torch.from_numpy(noisy), torch.from_numpy(gt),
                       torch.Generator().manual_seed(5))
    assert state.step == 1
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    grads = refiner_from_jax_variables(
        {"params": jax.tree.map(np.asarray, _jax_grads(
            jmodel, jstate, noisy, gt, loss_type))})
    want = refiner_from_jax_variables(
        {"params": jax.tree.map(np.asarray, jnew.params),
         "batch_stats": jax.tree.map(np.asarray, jnew.batch_stats)})
    got = model.state_dict()
    checked = 0
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
            continue
        if k.endswith("linear.bias"):        # feeds a batch norm
            continue
        mask = grads[k].abs() >= 1e-6
        checked += int(mask.sum())
        np.testing.assert_allclose(got[k][mask].numpy(), v[mask].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
    assert checked > 0.5 * sum(p.numel() for p in model.parameters())


def test_synth_noise_moments_match_jax():
    poses = torch.zeros((4000, J, 3))
    sigma, p, outlier = 25.0, 0.05, 150.0
    got = trefine.synth_noise(poses, sigma, p, outlier,
                              torch.Generator().manual_seed(0)).numpy()
    want = np.asarray(jrefine.synth_noise(jax.random.PRNGKey(0),
                                          jnp.zeros(poses.shape), sigma, p,
                                          outlier))
    moments = []
    for d in (got, want):
        big = np.abs(d).max(-1) > 5 * sigma       # outlier joints, mostly
        # an outlier joint has some |N(0, 150)| of three above 125 with
        # probability 1 - (1 - 0.405)^3 = 0.789
        assert big.mean() == pytest.approx(p * 0.789, abs=0.004)
        moments.append((d[~big].std(), d[big].std()))
        assert np.abs(d.mean()) < 1.0
    (s_got, o_got), (s_want, o_want) = moments
    assert s_got == pytest.approx(s_want, rel=0.02)
    assert s_got == pytest.approx(sigma, rel=0.1)
    assert o_got == pytest.approx(o_want, rel=0.05)
    assert trefine.synth_noise(poses, generator=torch.Generator(
        ).manual_seed(0)).equal(torch.from_numpy(got))


def test_dropout_keeps_and_scales():
    x = torch.ones(200000)
    y = dropout(x, 0.5, True, torch.Generator().manual_seed(0))
    kept = y != 0
    assert kept.float().mean().item() == pytest.approx(0.5, abs=0.01)
    assert torch.all(y[kept] == 2.0)
    assert dropout(x, 0.5, False) is x


def test_load_refiner_round_trip(tmp_path):
    model, state = trefine.create_refiner_state(
        J, torch.Generator().manual_seed(1), hidden=48, blocks=3,
        device="cpu")
    step = trefine.make_refiner_train_step(model, "l2")
    poses = torch.from_numpy(_poses(6, n=16))
    step(state, poses, poses * 0.9, torch.Generator().manual_seed(2))
    path = tmp_path / "refiner.pth"
    torch.save({"state_dict": model.state_dict()}, path)
    cfg = load_config(ROOT / "experiments/h36m/"
                      "train_ss_r50_256_integral.yaml")
    refine = load_refiner(cfg, str(path), device="cpu")
    out = refine(poses.numpy())
    assert not out.requires_grad
    want = trefine.make_refiner_apply(model)(state, poses)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    cfg.MODEL.NUM_JOINTS = 16
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_refiner(cfg, str(path), device="cpu")
