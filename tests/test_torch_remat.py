"""``TPU.REMAT`` in the port against the same model without it and against
the JAX package's ``nn.remat`` model, on the CPU in float32.

``experiments/debug/synth_smoke_3d.yaml`` (ResNet-18 at 64x64, 17 joints,
D 8, Adam), the JAX init with the head re-drawn at std 0.05, two steps of
``make_train_step`` on ``tests/test_torch_train_step.py``'s batches.

With REMAT each backbone block runs its forward a second time in the
backward, with momentum 0 in its batch norms: the same arithmetic on the
same inputs, so the loss, the gradients and every parameter and buffer
(``num_batches_tracked`` included) are the same bits as without it.
Against JAX with ``TPU.REMAT: True``: the train-step parity rules of
``tests/test_torch_train_step.py`` (loss relative 1e-5, step-1
gradients 1e-4 of each tensor's largest entry, parameters by the Adam
rule, BN buffers 1e-4 of each tensor's largest after step 1).
"""

import jax
import numpy as np
import pytest
import torch

from epipolarpose_tpu.config import load_config as jax_load_config
from epipolarpose_tpu.core.steps import make_train_step as jax_make_train_step
from epipolarpose_tpu.core.train_state import (
    create_train_state as jax_create_train_state)
from epipolarpose_tpu.models import get_model as jax_get_model
from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.core import create_train_state, make_train_step
from epipolarpose_tpu_torch.models import from_jax_variables, get_pose_net
from test_torch_train_step import _batch

DEBUG_3D = "experiments/debug/synth_smoke_3d.yaml"
N_STEPS = 2
LR = 1e-3


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _cfg(load, remat):
    cfg = load(DEBUG_3D)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.REMAT = remat
    return cfg


def _calls(block):
    """Count ``block``'s forward calls in ``block.calls``."""
    block.calls = 0

    def hook(mod, args):
        mod.calls += 1
    block.register_forward_pre_hook(hook)
    return block


@pytest.fixture(scope="module")
def runs():
    """Two steps of the port without and with REMAT and of JAX's remat
    model, from the same weights on the same batches."""
    jcfg = _cfg(jax_load_config, True)
    jmodel = jax_get_model(jcfg)
    jstate = jax_create_train_state(jcfg, jmodel, jax.random.PRNGKey(0),
                                    steps_per_epoch=10, image_size=(64, 64))
    rng = np.random.default_rng(4)
    params = _numpy(jstate.params)
    for name in ("deconv1", "deconv2", "deconv3", "final_layer"):
        k = params[name]["kernel"]
        params[name]["kernel"] = rng.normal(0, 0.05, k.shape).astype(
            np.float32)
    jstate = jstate.replace(params=params, opt_state=jstate.tx.init(params))
    weights = from_jax_variables({"params": params,
                                  "batch_stats": _numpy(jstate.batch_stats)})
    batches = [_batch(k) for k in range(N_STEPS)]
    out = {}
    for remat in (False, True):
        model = get_pose_net(_cfg(load_config, remat))
        model.load_state_dict(weights, strict=True)
        block = _calls(model.layer2[1])
        state = create_train_state(_cfg(load_config, remat), model,
                                   steps_per_epoch=10, device="cpu")
        step = make_train_step(_cfg(load_config, remat), model, "cpu")
        run = {"loss": [], "grads": [], "state_dict": [], "calls": []}
        for batch in batches:
            block.calls = 0
            state, metrics = step(state, batch)
            run["calls"].append(block.calls)
            run["loss"].append(float(metrics["loss"]))
            run["grads"].append({n: p.grad.clone()
                                 for n, p in model.named_parameters()})
            run["state_dict"].append({k: v.clone() for k, v in
                                      model.state_dict().items()})
        block.calls = 0
        with torch.no_grad():
            model(torch.zeros(1, 3, 64, 64))
        run["no_grad_calls"] = block.calls
        out[remat] = run
    jstep = jax_make_train_step(jcfg, jmodel, donate=False)
    jax_run = {"loss": [], "state_dict": []}
    for k, batch in enumerate(batches):
        jstate, metrics = jstep(jstate, batch)
        jax_run["loss"].append(float(metrics["loss"]))
        if k == 0:
            mu = from_jax_variables({"params": _numpy(jstate.opt_state[0].mu)})
            jax_run["grads"] = {n: mu[n] * 10.0
                                for n in out[True]["grads"][0]}
        jax_run["state_dict"].append(from_jax_variables(
            {"params": _numpy(jstate.params),
             "batch_stats": _numpy(jstate.batch_stats)}))
    out["jax"] = jax_run
    return out


def test_remat_recomputes_each_block(runs):
    """A block's forward runs twice a train step with REMAT (the forward
    and its recomputation in the backward), once without, and once
    under ``no_grad`` either way."""
    assert runs[False]["calls"] == [1] * N_STEPS
    assert runs[True]["calls"] == [2] * N_STEPS
    assert runs[False]["no_grad_calls"] == runs[True]["no_grad_calls"] == 1


@pytest.mark.parametrize("step", range(N_STEPS))
def test_remat_changes_no_bit(runs, step):
    """Loss, gradients, parameters and every BN buffer after each step,
    ``num_batches_tracked`` included, bit for bit."""
    off, on = runs[False], runs[True]
    assert on["loss"][step] == off["loss"][step]
    for key in ("grads", "state_dict"):
        assert sorted(on[key][step]) == sorted(off[key][step])
        for k, v in off[key][step].items():
            assert torch.equal(on[key][step][k], v), (key, k)
    counts = [v for k, v in on["state_dict"][step].items()
              if k.endswith("num_batches_tracked")]
    assert counts and all(int(c) == step + 1 for c in counts)


def test_remat_matches_jax_remat(runs):
    """Against JAX's train step with ``TPU.REMAT: True`` (module
    docstring's rules)."""
    got, want = runs[True], runs["jax"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for name, w in want["grads"].items():
        scale = w.abs().max().item()
        assert scale > 0, name
        torch.testing.assert_close(got["grads"][0][name], w, rtol=0,
                                   atol=1e-4 * scale, msg=name)
    for step in range(N_STEPS):
        sd, sw = got["state_dict"][step], want["state_dict"][step]
        for name, g in want["grads"].items():
            diff = (sd[name] - sw[name]).abs()
            assert diff.max().item() <= 2 * LR * (step + 1), name
            if step == 0:
                assert diff[g.abs() >= 1e-6].max().item() <= 1e-6, name
    sd, sw = got["state_dict"][0], want["state_dict"][0]
    for name, v in sw.items():
        if "running" in name:
            torch.testing.assert_close(sd[name], v, rtol=0,
                                       atol=1e-4 * v.abs().max().item(),
                                       msg=name)
