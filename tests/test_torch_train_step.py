"""The port's train slice vs the JAX package's, on the CPU in float32.

- PoseResNet in train mode (BN on batch statistics, flax's running-variance
  convention) against flax ``apply(..., mutable=["batch_stats"])``.
- ``make_train_step`` on ``experiments/debug/synth_smoke_3d.yaml``
  (ResNet-18 at 64x64, 17 joints, D=8), three steps from the same weights
  and batches, against JAX ``make_train_step``: Adam, and SGD with momentum,
  Nesterov and weight decay; ``steps_per_epoch=1`` and ``LR_STEP=[1, 2]``,
  so the schedule crosses two boundaries.

Tolerances, stated with each test: the forwards agree to float32 rounding
in other summation orders (loss relative 1e-5); step-1 gradients to 1e-4
of each tensor's largest entry. SGD parameters are held to 1e-6. Adam's
first update is ``lr * g / (|g| + 1e-8)``, about ``lr * sign(g)``, so an
entry whose gradient is near zero can move by anything up to ``lr``
either way on order-dependent noise: after step 1 every entry whose JAX
gradient is at least 1e-6 (100 times eps) agrees to 1e-6, and every entry
agrees within ``2 * lr`` summed over the steps taken.
"""

import copy
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epipolarpose_tpu.config import load_config as jax_load_config
from epipolarpose_tpu.core.steps import make_train_step as jax_make_train_step
from epipolarpose_tpu.core.train_state import (
    create_train_state as jax_create_train_state)
from epipolarpose_tpu.core.train_state import (
    make_lr_schedule as jax_make_lr_schedule)
from epipolarpose_tpu.models import PoseResNet as JaxPoseResNet
from epipolarpose_tpu.models import get_model as jax_get_model
from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.core import (create_train_state, function,
                                         make_train_step)
from epipolarpose_tpu_torch.models import (PoseResNet, from_jax_variables,
                                           get_pose_net)
from test_torch_models import _perturbed_variables

DEBUG_3D = "experiments/debug/synth_smoke_3d.yaml"
N_STEPS = 3


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------- BN in train mode
def _buffers(state_dict):
    return {k: v for k, v in state_dict.items() if "running" in k}


@pytest.mark.parametrize("num_layers,tol", [(18, 1e-5), (50, 1e-3)])
def test_train_forward_and_bn_buffers_match_flax(rng, num_layers, tol):
    """Output and each running mean and variance to ``tol`` of their
    largest magnitude. flax computes the batch variance as E[x^2] - E[x]^2,
    which cancels in float32: through ResNet-50 that puts the JAX output
    about 5e-4 of its largest magnitude away from a float64 evaluation of
    the same model, hence 1e-3 there; the port's float32 output is held to
    ``tol`` of that float64 evaluation too (ResNet-50: about 1.4e-4). The
    same model with torch's own ``nn.BatchNorm2d`` update (unbiased
    variance) misses the buffers by more than ``10 * tol``."""
    kw = dict(num_joints=5, depth_dim=4, num_deconv_filters=(32, 32, 32))
    jmodel = JaxPoseResNet(num_layers=num_layers, dtype=jnp.float32, **kw)
    variables = _perturbed_variables(jmodel, rng, 64)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    want, mutated = jmodel.apply(variables, x, train=True,
                                 mutable=["batch_stats"])
    want = torch.from_numpy(np.array(want))
    want_buf = _buffers(from_jax_variables(
        {"params": variables["params"],
         "batch_stats": _numpy(mutated["batch_stats"])}))

    def run(model, dtype=torch.float32):
        model.load_state_dict(from_jax_variables(variables), strict=True)
        model.to(dtype).train()
        with torch.no_grad():
            out = model(torch.from_numpy(x).permute(0, 3, 1, 2)
                        .contiguous().to(dtype))
        return out.permute(0, 2, 3, 1), _buffers(model.state_dict())

    def worst(a, b):
        """Largest gap over the tensors, each relative to its largest."""
        return max(((a[k] - v).abs().max() / v.abs().max()).item()
                   for k, v in b.items())

    got, got_buf = run(PoseResNet(num_layers=num_layers, dtype=torch.float32,
                                  **kw))
    assert worst({"out": got}, {"out": want}) <= tol
    # float32 parameters of a float32 module run in float64 when cast; the
    # output comes back as float32, well below these tolerances
    exact, _ = run(PoseResNet(num_layers=num_layers, dtype=torch.float32,
                              **kw), torch.float64)
    assert worst({"out": got}, {"out": exact.float()}) <= tol
    assert sorted(got_buf) == sorted(want_buf)
    assert worst(got_buf, want_buf) <= tol

    plain = PoseResNet(num_layers=num_layers, dtype=torch.float32, **kw)
    for mod in plain.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.__class__ = torch.nn.BatchNorm2d
    _, plain_buf = run(plain)
    assert worst(plain_buf, want_buf) > 10 * tol


# ------------------------------------------- the train step, 3 steps each
def _configs(optimizer):
    cfgs = []
    for load in (jax_load_config, load_config):
        cfg = load(DEBUG_3D)
        cfg.TPU.COMPUTE_DTYPE = "float32"
        cfg.TRAIN.OPTIMIZER = optimizer
        cfg.TRAIN.LR_STEP = [1, 2]
        if optimizer == "sgd":
            cfg.TRAIN.LR = 0.01
            cfg.TRAIN.MOMENTUM = 0.9
            cfg.TRAIN.WD = 0.01
            cfg.TRAIN.NESTEROV = True
        cfgs.append(cfg)
    return cfgs


def _batch(seed, n=4, size=64, joints=17, with_3d=True):
    """uint8 crops; joints partly outside the crop, some not visible, depths
    partly beyond the 1000 mm bound."""
    r = np.random.default_rng(seed)
    b = {"input": r.integers(0, 256, (n, size, size, 3), np.uint8),
         "joints": r.uniform(-4, size + 4, (n, joints, 2)).astype(np.float32),
         "joints_vis": (r.uniform(size=(n, joints)) > 0.1).astype(np.float32)}
    if with_3d:
        b["joints_3d"] = r.uniform(-700, 700, (n, joints, 3)).astype(
            np.float32)
    return b


def _first_moment_key(optimizer):
    return "exp_avg" if optimizer == "adam" else "momentum_buffer"


@pytest.fixture(scope="module", params=["adam", "sgd"])
def run3(request):
    """Three steps of the JAX step and of the port's, from the same weights
    (the JAX init with the head redrawn at std 0.05, so that gradients
    reach the backbone) on the same three batches."""
    opt = request.param
    jcfg, tcfg = _configs(opt)
    rng = np.random.default_rng(3)
    jmodel = jax_get_model(jcfg)
    state = jax_create_train_state(jcfg, jmodel, jax.random.PRNGKey(0),
                                   steps_per_epoch=1, image_size=(64, 64))
    params = _numpy(state.params)
    for name in ("deconv1", "deconv2", "deconv3", "final_layer"):
        k = params[name]["kernel"]
        params[name]["kernel"] = rng.normal(0, 0.05, k.shape).astype(
            np.float32)
    state = state.replace(params=params, opt_state=state.tx.init(params))
    model = get_pose_net(tcfg)
    model.load_state_dict(from_jax_variables(
        {"params": params, "batch_stats": _numpy(state.batch_stats)}))
    tstate = create_train_state(tcfg, model, steps_per_epoch=1, device="cpu")
    tstep = make_train_step(tcfg, model, device="cpu")
    jstep = jax_make_train_step(jcfg, jmodel, donate=False)
    sched = jax_make_lr_schedule(jcfg, 1)
    out = {"opt": opt, "lr": float(jcfg.TRAIN.LR), "loss": [], "rates": [],
           "jax": {}, "port": {}}
    for k in range(N_STEPS):
        batch = _batch(k)
        out["rates"].append((tstate.optimizer.param_groups[0]["lr"],
                             float(sched(k))))
        state, jmetrics = jstep(state, batch)
        tstate, tmetrics = tstep(tstate, batch)
        out["loss"].append((float(tmetrics["loss"]),
                            float(jmetrics["loss"])))
        if k == 0:
            # step-1 gradients: Adam's first moment is 0.1 * g; SGD's
            # momentum buffer is g + WD * p on both sides
            moment = (state.opt_state[0].mu if opt == "adam"
                      else state.opt_state[1][0].trace)
            out["jax_moment"] = from_jax_variables(
                {"params": _numpy(moment)})
            out["port_moment"] = {
                name: tstate.optimizer.state[p][_first_moment_key(opt)]
                .clone() for name, p in model.named_parameters()}
        if k + 1 in (1, N_STEPS):
            out["jax"][k + 1] = from_jax_variables(
                {"params": _numpy(state.params),
                 "batch_stats": _numpy(state.batch_stats)})
            out["port"][k + 1] = copy.deepcopy(model.state_dict())
    out["param_names"] = [name for name, _ in model.named_parameters()]
    out["port_steps"] = tstate.step
    return out


def test_train_step_loss_matches_jax(run3):
    """Loss of each step, relative 1e-5 (float32 forwards)."""
    assert run3["port_steps"] == N_STEPS
    for got, want in run3["loss"]:
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_lr_schedule_matches_jax(run3):
    """The rate of each step crosses LR_STEP=[1, 2] as optax's schedule
    does (relative 1e-6: optax keeps the rate in float32)."""
    got, want = zip(*run3["rates"])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] > got[1] > got[2]


def test_first_step_gradients_match_jax(run3):
    """Adam's first moment and SGD's momentum buffer after step 1 (both a
    fixed function of the gradient), to 1e-4 of each tensor's largest."""
    for name in run3["param_names"]:
        got, want = run3["port_moment"][name], run3["jax_moment"][name]
        scale = want.abs().max().item()
        assert scale > 0, name
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale,
                                   msg=name)


@pytest.mark.parametrize("after", [1, N_STEPS])
def test_params_match_jax(run3, after):
    """SGD: every entry to 1e-6. Adam: the rule in the module docstring."""
    got, want = run3["port"][after], run3["jax"][after]
    lr = run3["lr"]
    rates = [lr * 0.1 ** k for k in range(after)]
    moments = {n: run3["jax_moment"][n] * 10.0 for n in run3["param_names"]}
    for name in run3["param_names"]:
        diff = (got[name] - want[name]).abs()
        if run3["opt"] == "sgd":
            assert diff.max().item() <= 1e-6, name
            continue
        assert diff.max().item() <= 2 * sum(rates), name
        if after == 1:
            steady = moments[name].abs() >= 1e-6
            assert diff[steady].max().item() <= 1e-6, name


@pytest.mark.parametrize("after", [1, N_STEPS])
def test_batch_stats_match_jax(run3, after):
    """Running mean and variance: 1e-4 of each tensor's largest after
    step 1 (same weights); after step 3 under Adam the weights differ
    where the sign of a near-zero gradient flipped, so 1e-2 there."""
    got, want = run3["port"][after], run3["jax"][after]
    tol = 1e-2 if (run3["opt"] == "adam" and after > 1) else 1e-4
    for name, v in _buffers(want).items():
        scale = v.abs().max().item()
        torch.testing.assert_close(got[name], v, rtol=0, atol=tol * scale,
                                   msg=name)


# ----------------------------------------------- the port's own behaviour
def _small(**train):
    cfg = load_config(DEBUG_3D)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    for k, v in train.items():
        cfg.TRAIN[k] = v
    model = get_pose_net(cfg, generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model, steps_per_epoch=3, device="cpu")
    return cfg, model, state


def test_train_loop_runs_one_epoch(caplog):
    """``function.train`` over 3 batches with PRINT_FREQ 2: three steps,
    two log lines, and the average of the two logged losses."""
    cfg, model, state = _small()
    cfg.PRINT_FREQ = 2
    step = make_train_step(cfg, model, device="cpu")
    losses = []

    def recording(st, batch):
        st, metrics = step(st, batch)
        losses.append(metrics["loss"])
        return st, metrics

    batches = [_batch(seed, n=2) for seed in range(3)]
    with caplog.at_level(logging.INFO, logger=function.__name__):
        out, avg = function.train(cfg, batches, state, recording, epoch=4)
    assert out is state and state.step == 3
    assert all(t.ndim == 0 and not t.requires_grad for t in losses)
    assert avg == pytest.approx((losses[0].item() + losses[2].item()) / 2)
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 2 and lines[0].startswith("Epoch: [4][0]")
    assert lines[1].startswith("Epoch: [4][2]") and "samples/s" in lines[1]


def test_train_loop_refuses_debug_dumps():
    cfg, model, state = _small()
    cfg.DEBUG.DEBUG = True
    with pytest.raises(NotImplementedError):
        function.train(cfg, [], state, make_train_step(cfg, model, "cpu"), 0)


def test_loss_falls_on_a_repeated_batch():
    cfg, model, state = _small()
    step = make_train_step(cfg, model, device="cpu")
    batch = _batch(0, n=2)
    losses = [step(state, batch)[1]["loss"].item() for _ in range(5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_train_step_refuses_a_state_of_another_model():
    """The state and the step own one model: a step built on a copy of the
    state's model raises before it trains either of them."""
    cfg, model, state = _small()
    twin = copy.deepcopy(model)
    before = [p.detach().clone() for p in model.parameters()]
    with pytest.raises(ValueError, match="another model"):
        make_train_step(cfg, twin, device="cpu")(state, _batch(0, n=2))
    assert state.step == 0
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))
    assert all(p.grad is None for p in twin.parameters())


def test_train_step_2d_batches_and_target_weights():
    """Without ``joints_3d`` the z target is 0 (2D); with no visible joint
    the weighted loss is 0, and without ``USE_TARGET_WEIGHT`` it is not."""
    cfg, model, state = _small()
    step = make_train_step(cfg, model, device="cpu")
    batch = _batch(1, n=2, with_3d=False)
    assert np.isfinite(step(state, batch)[1]["loss"].item())
    batch["joints_vis"][:] = 0
    as_tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert step(state, as_tensors)[1]["loss"].item() == 0.0
    cfg.LOSS.USE_TARGET_WEIGHT = False
    step = make_train_step(cfg, model, device="cpu")
    assert step(state, batch)[1]["loss"].item() > 0.0
    assert state.step == 3


def test_optimizers_and_their_settings():
    _, _, adam = _small()
    assert isinstance(adam.optimizer, torch.optim.Adam)
    group = adam.optimizer.param_groups[0]
    assert group["eps"] == 1e-8 and group["weight_decay"] == 0
    _, _, sgd = _small(OPTIMIZER="sgd", MOMENTUM=0.8, WD=0.002,
                       NESTEROV=True, LR=0.05)
    group = sgd.optimizer.param_groups[0]
    assert isinstance(sgd.optimizer, torch.optim.SGD)
    assert (group["momentum"], group["weight_decay"], group["nesterov"],
            group["lr"]) == (0.8, 0.002, True, 0.05)
    assert sgd.scheduler.milestones == {8 * 3: 1}        # LR_STEP [8] x 3
    with pytest.raises(ValueError, match="OPTIMIZER"):
        _small(OPTIMIZER="rmsprop")


def test_gaussian_training_not_ported():
    """Gaussian training is ported now (held against JAX in
    tests/test_torch_heatmap.py): on the debug 2D config a step returns
    the loss and the heatmap accuracy; an unknown target type raises."""
    cfg = load_config("experiments/debug/synth_smoke.yaml")
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model = get_pose_net(cfg, generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model, steps_per_epoch=3, device="cpu")
    batch = _batch(0, n=2, joints=16, with_3d=False)
    _, metrics = make_train_step(cfg, model, device="cpu")(state, batch)
    assert sorted(metrics) == ["acc", "loss"] and state.step == 1
    assert np.isfinite(metrics["loss"].item())
    cfg.MODEL.EXTRA.TARGET_TYPE = "nope"
    with pytest.raises(ValueError, match="TARGET_TYPE"):
        make_train_step(cfg, model, device="cpu")


def test_bench_step_runs_small_on_cpu(capsys):
    """The ``--step`` bench end to end at the debug config's size on the
    CPU (plain versions; host-clock times, no card numbers)."""
    from epipolarpose_tpu_torch.tools import profile_step as tps
    res = tps.bench_step(DEBUG_3D, batch=2, device="cpu", iters=1)
    assert res["device"] == "cpu" and res["batch"] == 2
    for key in ("step_ms", "fwd_eval_bn_ms", "fwd_train_bn_ms",
                "softargmax_l1_fwd_kernel_ms",
                "softargmax_l1_fwd_bwd_plain_ms"):
        assert res[key] > 0, key
    # bf16 logits (2, 17*8, 16, 16): bound = bytes / 3.35 TB/s
    elems = 2 * 17 * 8 * 16 * 16 * 2
    assert res["softargmax_bwd_bound_ms"] == pytest.approx(
        (2 * elems + 2 * 17 * 28) / 3.35e12 * 1e3)
    assert "softargmax_l1_fwd_bwd_kernel_ms" in capsys.readouterr().out
