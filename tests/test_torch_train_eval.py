"""Train, eval, train on one model: the eval step leaves no trace.

``experiments/debug/synth_smoke_3d.yaml`` (ResNet-18 at 64x64, 17 joints,
D=8) in float32 on the CPU. One PoseResNet carries ``make_train_step`` and
``make_eval_step``; the run is train step, eval step, train step, as a
train-then-validate loop runs them. Checks:

- the eval preds equal those of a fresh eval-mode model with the same
  weights, within 1e-5 (the same float32 arithmetic on the same CPU);
- no buffer of the model (BN running statistics, batch counters) moves
  during the eval step;
- the second train step runs, and its loss equals that of the same two
  train steps without the eval step between them; both losses match the
  JAX package's two steps from the same weights on the same batches,
  relative 1e-5 (the loss tolerance of ``test_torch_train_step.py``, on
  its first two batches).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from epipolarpose_tpu.core.steps import make_train_step as jax_make_train_step
from epipolarpose_tpu.core.train_state import (
    create_train_state as jax_create_train_state)
from epipolarpose_tpu.models import get_model as jax_get_model
from epipolarpose_tpu_torch.core import create_train_state, make_train_step
from epipolarpose_tpu_torch.core.steps import make_eval_step
from epipolarpose_tpu_torch.models import from_jax_variables, get_pose_net
from test_torch_train_step import _batch, _configs, _numpy

H36M_FLIP_PAIRS = ((1, 4), (2, 5), (3, 6), (11, 14), (12, 15), (13, 16))


def _eval_batch(seed, n=4, size=64):
    r = np.random.default_rng(seed)
    return {"input": r.integers(0, 256, (n, size, size, 3), np.uint8),
            "center": r.uniform(80, 400, (n, 2)).astype(np.float32),
            "scale": r.uniform(0.2, 0.6, (n, 2)).astype(np.float32)}


def _buffers(model):
    return {name: b.detach().clone() for name, b in model.named_buffers()}


@pytest.fixture(scope="module")
def train_eval_train():
    """JAX: two train steps. Port: train step, eval step, train step on
    one model, from the same weights (the JAX init with the head redrawn
    at std 0.05) and the same two train batches."""
    jcfg, tcfg = _configs("adam")
    tcfg.TEST.FLIP_TEST = tcfg.TEST.SHIFT_HEATMAP = True
    rng = np.random.default_rng(5)
    jmodel = jax_get_model(jcfg)
    state = jax_create_train_state(jcfg, jmodel, jax.random.PRNGKey(1),
                                   steps_per_epoch=1, image_size=(64, 64))
    params = _numpy(state.params)
    for name in ("deconv1", "deconv2", "deconv3", "final_layer"):
        k = params[name]["kernel"]
        params[name]["kernel"] = rng.normal(0, 0.05, k.shape).astype(
            np.float32)
    state = state.replace(params=params, opt_state=state.tx.init(params))
    batch_stats = _numpy(state.batch_stats)
    jstep = jax_make_train_step(jcfg, jmodel, donate=False)
    jax_losses = []
    for k in range(2):
        state, metrics = jstep(state, _batch(k))
        jax_losses.append(float(metrics["loss"]))

    weights = from_jax_variables({"params": params,
                                  "batch_stats": batch_stats})
    twin = get_pose_net(tcfg)
    twin.load_state_dict(weights)
    twin_state = create_train_state(tcfg, twin, steps_per_epoch=1,
                                    device="cpu")
    twin_step = make_train_step(tcfg, twin, device="cpu")
    twin_losses = [float(twin_step(twin_state, _batch(k))[1]["loss"])
                   for k in range(2)]

    model = get_pose_net(tcfg)
    model.load_state_dict(weights)
    tstate = create_train_state(tcfg, model, steps_per_epoch=1, device="cpu")
    tstep = make_train_step(tcfg, model, device="cpu")
    estep = make_eval_step(tcfg, model, H36M_FLIP_PAIRS, device="cpu")
    batch = _eval_batch(0)

    out = {"jax_losses": jax_losses, "twin_losses": twin_losses,
           "losses": []}
    tstate, metrics = tstep(tstate, _batch(0))
    out["losses"].append(float(metrics["loss"]))
    out["training_before_eval"] = model.training
    before = _buffers(model)
    fresh = get_pose_net(tcfg)
    fresh.load_state_dict(copy.deepcopy(model.state_dict()))
    out["fresh_preds"] = make_eval_step(tcfg, fresh.eval(), H36M_FLIP_PAIRS,
                                        device="cpu")(batch)["preds"]
    out["preds"] = estep(batch)["preds"]
    out["buffers_before"], out["buffers_after"] = before, _buffers(model)
    tstate, metrics = tstep(tstate, _batch(1))
    out["losses"].append(float(metrics["loss"]))
    out["steps"] = tstate.step
    return out


def test_eval_after_train_matches_a_fresh_eval_model(train_eval_train):
    run = train_eval_train
    assert run["training_before_eval"]
    torch.testing.assert_close(run["preds"], run["fresh_preds"], rtol=0,
                               atol=1e-5)


def test_eval_step_writes_no_buffer(train_eval_train):
    before, after = (train_eval_train["buffers_before"],
                     train_eval_train["buffers_after"])
    assert sorted(before) == sorted(after)
    assert any("running_var" in name for name in before)
    for name, value in before.items():
        assert torch.equal(after[name], value), name
        assert not after[name].is_inference(), name


def test_train_after_eval_matches_jax(train_eval_train):
    """Both train steps run; their losses equal those of two train steps
    without the eval between them, and match the JAX steps."""
    run = train_eval_train
    assert run["steps"] == 2
    assert run["losses"] == run["twin_losses"]
    np.testing.assert_allclose(run["losses"], run["jax_losses"], rtol=1e-5)
