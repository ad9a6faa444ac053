"""The port's fused steps (``TPU.FUSED_STEPS``) against the JAX package's.

The port's counterparts of ``tests/test_fused_steps.py``: a step built
with ``fused_steps=K`` takes a K-stacked super-batch (``stack_batches``)
and runs K steps a call. On the CPU that is a Python loop of K unfused
steps; on the card one CUDA-graph replay (``tests/test_torch_graphs.py``,
whose ``cuda`` tests skip here). Each case below is held against the JAX
function on the
CPU, with inputs from a numpy seed and the weights through
``models/convert.py::from_jax_variables``, at the debug sizes
(``experiments/debug/synth_smoke_fused.yaml``: ResNet-18 at 64x64, here
with 4 joints and 32-wide deconvs as in the JAX tests, float32):

- the fused ``gaussian`` and ``integral`` train steps against JAX's
  ``make_train_step(fused_steps=3)``, with ``LR_STEP`` putting a milestone
  inside the super-batch (the third step's rate is a tenth);
- the SS step, ``given`` and ``estimated`` cameras, against JAX's
  ``make_ss_train_step(fused_steps=2)`` (detections in the batch);
- the fused eval step against JAX's ``make_eval_step(fused_steps=3)``,
  and ``validate`` over a fused loader against the unfused loop;
- ``stack_batches`` (the remainder, nested dicts, the camera's fields);
- ``train`` over a fused loader (the tail super-batch's samples);
- two ``gloo`` processes (``tests/torch_fused_worker.py``) against JAX's
  fused step sharded over two devices.

Tolerances are those of the unfused parity tests for the same step: FS
``integral`` losses relative 1e-5 (``tests/test_torch_train_step.py``),
``gaussian`` 1e-5 at the first step and 1e-4 after it, its accuracy equal
(``tests/test_torch_heatmap.py``; measured 9.8e-5 at the third); SS losses
relative 1e-5 at the first step and 1e-3 after it, the triangulation
residual 1e-4 absolute (``tests/test_torch_self_supervised.py``; Adam's
first update is about ``lr * sign(g)``, so entries with near-zero
gradients move apart on rounding noise); parameters within ``2 * lr`` a
step; the BN buffers, and the whole state, equal to the port's unfused
loop's bit for bit (:func:`_check_params` says why not to JAX's); eval
predictions 1e-3 px
and 1e-2 mm (``tests/test_torch_eval_step.py``); rates relative 1e-6
(optax keeps them in float32).
"""

import copy
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from epipolarpose_tpu.config import load_config as jax_load_config
from epipolarpose_tpu.core import self_supervised as jss
from epipolarpose_tpu.core.steps import make_eval_step as jax_make_eval_step
from epipolarpose_tpu.core.steps import make_train_step as jax_make_train_step
from epipolarpose_tpu.core.train_state import (
    create_train_state as jax_create_train_state)
from epipolarpose_tpu.core.train_state import (
    make_lr_schedule as jax_make_lr_schedule)
from epipolarpose_tpu.data.h36m import FLIP_PAIRS as H36M_FLIP_PAIRS
from epipolarpose_tpu.data.pipeline import stack_batches as jax_stack
from epipolarpose_tpu.models import get_model as jax_get_model
from epipolarpose_tpu.parallel import make_mesh as jax_make_mesh
from epipolarpose_tpu.parallel import shard_batch
from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.core import (create_train_state, function,
                                         make_eval_step, make_train_step,
                                         validate)
from epipolarpose_tpu_torch.core import self_supervised as tss
from epipolarpose_tpu_torch.core.steps import FusedSteps
from epipolarpose_tpu_torch.core.train_state import MultiStepSchedule
from epipolarpose_tpu_torch.data import epoch_loader, stack_batches
from epipolarpose_tpu_torch.data.synthetic import SyntheticPoseDataset
from epipolarpose_tpu_torch.geometry.camera import Camera
from epipolarpose_tpu_torch.models import from_jax_variables, get_pose_net
import test_torch_eval_step as tev
import test_torch_self_supervised as tsv
import torch_fused_worker as worker

ROOT = pathlib.Path(__file__).resolve().parents[1]
FUSED_YAML = ROOT / "experiments/debug/synth_smoke_fused.yaml"
K = 3
LR = 1e-3
JOIN_TIMEOUT_S = 240


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(target: str):
    """The fused debug config at the JAX fused tests' size, both
    packages; ``LR_STEP`` 2 with one step an epoch puts a milestone at
    the third step of a super-batch of 3."""
    cfgs = []
    for load in (jax_load_config, load_config):
        cfg = load(str(FUSED_YAML))
        cfg.MODEL.NUM_JOINTS = 4
        cfg.MODEL.EXTRA.NUM_DECONV_FILTERS = [32, 32, 32]
        cfg.TPU.COMPUTE_DTYPE = "float32"
        cfg.TRAIN.LR = LR
        cfg.TRAIN.LR_STEP = [2]
        if target == "integral":
            cfg.MODEL.NAME = "pose3d_resnet"
            cfg.MODEL.EXTRA.TARGET_TYPE = "integral"
            cfg.MODEL.EXTRA.DEPTH_DIM = 4
            cfg.LOSS.TYPE = "IntegralL1Loss"
        cfgs.append(cfg)
    return cfgs


def _batches(k: int, n: int = 4, size: int = 64, joints: int = 4,
             seed: int = 0, with_3d: bool = False) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        b = {"input": rng.integers(0, 256, (n, size, size, 3), np.uint8),
             "joints": rng.uniform(5, size - 5, (n, joints, 2)).astype(
                 np.float32),
             "joints_vis": np.ones((n, joints), np.float32)}
        if with_3d:
            b["joints_3d"] = rng.uniform(-700, 700, (n, joints, 3)).astype(
                np.float32)
        out.append(b)
    return out


def _pair(jcfg, tcfg, seed: int = 0):
    """JAX's train state (the head re-drawn at std 0.05, so that
    gradients reach the backbone) and the port's model and state on the
    same weights; one step an epoch."""
    rng = np.random.default_rng(seed)
    jmodel = jax_get_model(jcfg)
    jstate = jax_create_train_state(jcfg, jmodel, jax.random.PRNGKey(0),
                                    steps_per_epoch=1, image_size=(64, 64))
    params = _numpy(jstate.params)
    for name in ("deconv1", "deconv2", "deconv3", "final_layer"):
        k = params[name]["kernel"]
        params[name]["kernel"] = rng.normal(0, 0.05, k.shape).astype(
            np.float32)
    jstate = jstate.replace(params=params, opt_state=jstate.tx.init(params))
    model = get_pose_net(tcfg)
    model.load_state_dict(from_jax_variables(
        {"params": params, "batch_stats": _numpy(jstate.batch_stats)}))
    tstate = create_train_state(tcfg, model, steps_per_epoch=1, device="cpu")
    return jmodel, jstate, model, tstate


def _jax_weights(jstate) -> dict:
    return from_jax_variables({"params": _numpy(jstate.params),
                               "batch_stats": _numpy(jstate.batch_stats)})


def _check_params(got: dict, want: dict, steps: int, lr: float = LR):
    """Parameters against JAX within ``2 * lr`` a step. The BN buffers
    are not held to JAX after several steps: Adam's sign noise moves the
    weights apart, and layer4's running means with them (1.6e-2 of the
    tensor's largest entry after 3 gaussian steps, measured;
    ``tests/test_torch_self_supervised.py`` measured 7%); they are held
    to the port's unfused loop instead (:func:`_check_same_as_loop`)."""
    for name, v in want.items():
        if "running" not in name and "num_batches" not in name:
            diff = (got[name] - v).abs().max().item()
            assert diff <= 2 * lr * steps, (name, diff)


def _check_same_as_loop(fused_state, loop_state) -> None:
    """The fused step's weights, BN buffers and Adam moments equal those
    of K unfused steps bit for bit (the same ops on the CPU)."""
    sa = fused_state.model.state_dict()
    sb = loop_state.model.state_dict()
    for k in sb:
        assert torch.equal(sa[k], sb[k]), k
    oa = fused_state.optimizer.state_dict()["state"]
    ob = loop_state.optimizer.state_dict()["state"]
    for i, st in ob.items():
        for k, v in st.items():
            assert torch.equal(oa[i][k], v), (i, k)
    assert fused_state.step == loop_state.step


# ---------------------------------------------------- the FS train steps
@pytest.fixture(scope="module", params=["gaussian", "integral"])
def fs_run(request):
    """K steps of JAX's fused step and of the port's on one super-batch
    from the same weights; the port's rate at each inner step."""
    target = request.param
    jcfg, tcfg = _configs(target)
    batches = _batches(K, with_3d=target == "integral")
    jmodel, jstate, model, tstate = _pair(jcfg, tcfg)
    jstep = jax_make_train_step(jcfg, jmodel, donate=False, fused_steps=K)
    jstate, jm = jstep(jstate, next(jax_stack(iter(batches), K)))
    tstep = make_train_step(tcfg, model, device="cpu", fused_steps=K)
    rates = []
    sched_step = tstate.scheduler.step

    def recording():
        rates.append(tstate.optimizer.param_groups[0]["lr"])
        sched_step()

    tstate.scheduler.step = recording
    out_state, tm = tstep(tstate, next(stack_batches(iter(batches), K)))
    # the port's unfused loop from the same weights
    _, _, loop_model, loop_state = _pair(jcfg, tcfg)
    loop_step = make_train_step(tcfg, loop_model, device="cpu")
    for b in batches:
        loop_state, _ = loop_step(loop_state, b)
    return {"target": target, "loop": loop_state,
            "jax": {k: np.asarray(v) for k, v in jm.items()},
            "port": {k: v.numpy() for k, v in tm.items()},
            "state": out_state, "tstate": tstate,
            "rates": rates, "jax_rates": [float(jax_make_lr_schedule(
                jcfg, 1)(k)) for k in range(K)],
            "weights": (copy.deepcopy(model.state_dict()),
                        _jax_weights(jstate))}


def test_fused_train_step_matches_jax(fs_run):
    """Per-step losses (and the gaussian step's accuracy) of the K steps,
    ``state.step == K``, parameters after them; the state equal to the
    port's unfused loop's."""
    got, want = fs_run["port"], fs_run["jax"]
    assert fs_run["state"] is fs_run["tstate"] and fs_run["state"].step == K
    assert sorted(got) == sorted(want)
    assert got["loss"].shape == want["loss"].shape == (K,)
    assert np.isfinite(got["loss"]).all()
    np.testing.assert_allclose(got["loss"][0], want["loss"][0], rtol=1e-5)
    # integral: 1e-5 at every step, as test_torch_train_step holds it;
    # gaussian: 1e-4 after the first, as test_torch_heatmap holds it
    later = 1e-5 if fs_run["target"] == "integral" else 1e-4
    np.testing.assert_allclose(got["loss"][1:], want["loss"][1:],
                               rtol=later)
    if fs_run["target"] == "gaussian":
        np.testing.assert_array_equal(got["acc"], want["acc"])
    _check_params(*fs_run["weights"], steps=K)
    _check_same_as_loop(fs_run["state"], fs_run["loop"])


def test_milestone_inside_a_superbatch(fs_run):
    """``LR_STEP`` 2: the third inner step of the super-batch takes a
    tenth of the rate, at the same step as optax's schedule in the scan;
    the schedule's count advanced by K."""
    np.testing.assert_allclose(fs_run["rates"], fs_run["jax_rates"],
                               rtol=1e-6)
    assert fs_run["rates"][1] == pytest.approx(10 * fs_run["rates"][2])
    assert fs_run["tstate"].scheduler.last_epoch == K


def test_schedule_on_the_card_form_matches_multistep():
    """The form the card runs (a tensor rate, set from a step count held
    as a tensor, which a CUDA graph captures): the same rates as the
    float form and ``torch.optim.lr_scheduler.MultiStepLR`` at every
    step across two milestones, and a restore from its state dict."""
    lrs = {}
    for form in ("float", "tensor", "torch"):
        p = torch.nn.Parameter(torch.zeros(3))
        lr = torch.tensor(0.1) if form == "tensor" else 0.1
        opt = torch.optim.Adam([p], lr=lr, foreach=False)
        sched = (torch.optim.lr_scheduler.MultiStepLR(opt, [2, 5], 0.5)
                 if form == "torch" else MultiStepSchedule(opt, [2, 5], 0.5))
        seen = []
        for _ in range(7):
            seen.append(float(opt.param_groups[0]["lr"]))
            sched.step()
        lrs[form] = seen
        if form == "tensor":
            assert opt.param_groups[0]["lr"] is lr     # written in place
            fresh = torch.optim.Adam([p], lr=torch.tensor(0.1),
                                     foreach=False)
            twin = MultiStepSchedule(fresh, [2, 5], 0.5)
            twin.load_state_dict(sched.state_dict())
            assert twin.get_last_lr() == sched.get_last_lr()
            assert int(twin._count) == twin.last_epoch == 7
    np.testing.assert_array_equal(lrs["tensor"],
                                  np.float32(lrs["torch"]))
    assert lrs["float"] == lrs["torch"]


# ------------------------------------------------------------- SS steps
SS_K = 2


def _ss_batches(cameras: str) -> tuple[list, list]:
    """SS_K JAX multi-view batches (noise crops, detections in the batch)
    and the port's form of each."""
    jcfg, _ = tsv._configs()
    ds = tsv._dataset(jcfg)
    rng = np.random.default_rng(31)
    jax_batches = []
    for k in range(SS_K):
        if cameras == "estimated":
            b, det = tsv._estimated_batch(ds, 40 + k)
            det = det.reshape(tsv.G, tsv.V, tsv.J, 2)
        else:
            b = tsv._noise_crops(next(ds.view_batches(tsv.G, shuffle=False)),
                                 40 + k)
            b.pop("joints_3d")
            gt = tsv._gt_src(ds).reshape(tsv.G, tsv.V, tsv.J, 2)
            det = gt + rng.normal(0, 2.0, gt.shape)
        b["det_src"] = det.astype(np.float32)
        b["det_conf"] = rng.uniform(0.5, 1.0, det.shape[:-1]).astype(
            np.float32)
        jax_batches.append(b)
    return jax_batches, [tsv.port_batch(b) for b in jax_batches]


@pytest.mark.parametrize("cameras", ["given", "estimated"])
def test_fused_ss_step_matches_jax(cameras):
    """SS_K steps of JAX's fused SS step and of the port's on one
    super-batch (the cameras stacked field by field): per-step loss,
    residual and confidence, ``state.step``, parameters; the state equal
    to the port's unfused loop's.
    The port runs with oneDNN off, as the unfused estimated route's test
    does (its float32 convolution backward on this CPU)."""
    tpu = dict(SS_CAMERAS=cameras, SS_CONF_MIN=-1.0)
    if cameras == "estimated":
        tpu["SS_BONE_LENGTH_MM"] = tsv.BONE_MM
    jcfg, tcfg = tsv._configs(**tpu)
    jax_batches, port_batches = _ss_batches(cameras)
    jmodel, jstate, model, tstate = tsv._students(jcfg, tcfg, seed=5)
    jstep = jss.make_ss_train_step(jcfg, jmodel, None, donate=False,
                                   fused_steps=SS_K)
    jstate, jm = jstep(jstate, next(jax_stack(iter(jax_batches), SS_K)))
    tstep = tss.make_ss_train_step(tcfg, model, None, device="cpu",
                                   fused_steps=SS_K)
    superbatch = next(stack_batches(iter(port_batches), SS_K))
    assert isinstance(superbatch["camera"], Camera)
    assert superbatch["camera"].R.shape == (SS_K, tsv.G, tsv.V, 3, 3)
    with torch.backends.mkldnn.flags(enabled=False):
        tstate, tm = tstep(tstate, superbatch)
    assert tstate.step == SS_K
    for name in ("loss", "tri_residual", "teacher_conf"):
        assert tm[name].shape == (SS_K,), name
    got, want = tm["loss"].numpy(), np.asarray(jm["loss"])
    assert np.isfinite(got).all() and got[0] > 0
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-3)
    scale = 1.0
    if cameras == "estimated":
        # residuals of unit-row systems times the bone scale (the unit
        # baseline in mm), as in test_estimated_route_matches_jax
        scale = max(tsv._jax_estimated_targets(
            jcfg, b, b["det_src"], b["det_conf"], lambda p: p)[2]
            for b in jax_batches)
        assert 1e3 < scale < 1e5
    np.testing.assert_allclose(tm["tri_residual"].numpy(),
                               np.asarray(jm["tri_residual"]), rtol=0,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(tm["teacher_conf"].numpy(),
                               np.asarray(jm["teacher_conf"]), rtol=1e-6)
    _check_params(copy.deepcopy(model.state_dict()), _jax_weights(jstate),
                  steps=SS_K)
    _, _, loop_model, loop_state = tsv._students(jcfg, tcfg, seed=5)
    loop_step = tss.make_ss_train_step(tcfg, loop_model, None, device="cpu")
    with torch.backends.mkldnn.flags(enabled=False):
        for b in port_batches:
            loop_state, _ = loop_step(loop_state, b)
    _check_same_as_loop(tstate, loop_state)


# ------------------------------------------------------------ eval steps
def test_fused_eval_step_matches_jax():
    """JAX's fused eval step and the port's (integral, flip test) on one
    super-batch of 3: (K, N, J, 3) predictions."""
    jcfg, tcfg = tev._configs()
    rng = np.random.default_rng(7)
    jmodel = jax_get_model(jcfg)
    jstate = jax_create_train_state(jcfg, jmodel, jax.random.PRNGKey(0),
                                    steps_per_epoch=1, image_size=(64, 64))
    params = _numpy(jstate.params)
    for name in ("deconv1", "deconv2", "deconv3", "final_layer"):
        k = params[name]["kernel"]
        params[name]["kernel"] = rng.normal(0, 0.05, k.shape).astype(
            np.float32)
    stats = _numpy(jstate.batch_stats)
    model = get_pose_net(tcfg)
    model.load_state_dict(from_jax_variables(
        {"params": params, "batch_stats": stats}), strict=True)
    batches = [tev._batch(np.random.default_rng(s)) for s in range(K)]
    jstep = jax_make_eval_step(jcfg, jmodel, flip_pairs=H36M_FLIP_PAIRS,
                               fused_steps=K)
    want = np.asarray(jstep(tev._State(params, stats),
                            next(jax_stack(iter(batches), K)))["preds"])
    tstep = make_eval_step(tcfg, model, H36M_FLIP_PAIRS, device="cpu",
                           fused_steps=K)
    got = tstep(next(stack_batches(iter(batches), K)))["preds"]
    assert got.shape == want.shape == (K, 4, 17, 3)
    assert not got.requires_grad
    got = got.numpy()
    assert np.ptp(want[..., 0]) > 1.0, "joints should not all coincide"
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0, atol=1e-2)


def test_fused_validate_flattens_as_the_unfused_loop():
    """``validate`` over a loader of super-batches of 3 (4 batches: one
    of 3 and a ragged tail of 1) gives the unfused loop's perf and
    predictions (the same computation on the CPU)."""
    _, cfg = _configs("gaussian")
    cfg.DATASET.DATASET = "synthetic"
    model = get_pose_net(cfg, generator=torch.Generator().manual_seed(0))
    ds = SyntheticPoseDataset(cfg, num_samples=16, is_train=False,
                              image_shape=(64, 64))
    preds = {}

    def run(k):
        step = make_eval_step(cfg, model, device="cpu", fused_steps=k)
        seen = []

        def recording(batch):
            out = step(batch)
            seen.append(tuple(out["preds"].shape))
            return out
        loader = epoch_loader(ds, 4, 0, is_train=False, device="cpu",
                              fused_steps=k)
        _, perf = validate(cfg, loader, ds, recording)
        preds[k] = seen
        return perf

    perf1, perf3 = run(1), run(3)
    assert preds[1] == [(4, 4, 2)] * 4
    assert preds[3] == [(3, 4, 4, 2), (1, 4, 4, 2)]
    np.testing.assert_allclose(perf3, perf1, rtol=1e-6)


# ------------------------------------------------- loader and train loop
def test_stack_batches_remainder_and_nested_leaves():
    """A leading (k,) axis on every leaf, nested dicts and a ``Camera``'s
    fields too; the tail kept or dropped."""
    def batch(i):
        return {"a": np.full((4, 2), i, np.float32),
                "nested": {"b": np.full((4,), i, np.float32)},
                "t": torch.full((4, 3), float(i)),
                "camera": Camera.identity((4,))}
    stacked = list(stack_batches(iter([batch(i) for i in range(5)]), 2))
    assert [s["a"].shape[0] for s in stacked] == [2, 2, 1]
    np.testing.assert_array_equal(stacked[1]["nested"]["b"][:, 0], [2, 3])
    assert torch.is_tensor(stacked[0]["t"])
    assert stacked[0]["t"].shape == (2, 4, 3)
    assert stacked[2]["camera"].R.shape == (1, 4, 3, 3)
    assert len(list(stack_batches(iter([batch(i) for i in range(5)]), 2,
                                  drop_remainder=True))) == 2


def test_train_loop_with_fused_loader():
    """``epoch_loader(fused_steps=2)`` -> ``train``: 24 samples in batches
    of 8 are a super-batch of 2 and a tail of 1; 3 steps."""
    _, cfg = _configs("gaussian")
    cfg.DATASET.DATASET = "synthetic"
    model = get_pose_net(cfg, generator=torch.Generator().manual_seed(0))
    ds = SyntheticPoseDataset(cfg, num_samples=24, is_train=True,
                              image_shape=(64, 64))
    state = create_train_state(cfg, model, steps_per_epoch=3, device="cpu")
    step = make_train_step(cfg, model, device="cpu", fused_steps=2)
    shapes = []

    def recording(st, batch):
        st, metrics = step(st, batch)
        shapes.append(tuple(metrics["loss"].shape))
        return st, metrics
    loader = epoch_loader(ds, 8, 0, device="cpu", fused_steps=2)
    state, avg = function.train(cfg, loader, state, recording, epoch=0)
    assert shapes == [(2,), (1,)]
    assert state.step == 3 and state.scheduler.last_epoch == 3
    assert np.isfinite(avg)


def test_train_loop_tail_superbatch_sample_weighting():
    """A tail super-batch of one stacked batch ((1,) loss) weighs its
    true batch size: (16 * 1 + 8 * 4) / 24 = 2, not the scan axis's
    (16 + 4) / 17."""
    _, cfg = _configs("gaussian")
    cfg.PRINT_FREQ = 1

    class FakeState:
        step = 0

    batches = [{"input": np.zeros((2, 8, 4, 4, 3), np.float32)},
               {"input": np.zeros((1, 8, 4, 4, 3), np.float32)}]
    losses = iter([torch.tensor([1.0, 1.0]), torch.tensor([4.0])])

    def fake_step(state, batch):
        return state, {"loss": next(losses)}

    _, avg = function.train(cfg, iter(batches), FakeState(), fake_step, 0)
    np.testing.assert_allclose(avg, 2.0)


def test_fused_step_loops_over_any_k_and_refuses_k_below_one():
    """A fused step on the CPU loops over whatever K the super-batch has;
    ``fused_steps`` below 1 raises."""
    with pytest.raises(ValueError, match="fused_steps"):
        FusedSteps(lambda s, b: (s, {}), 0, "cpu")
    seen = []
    fused = FusedSteps(lambda s, b: (s, {"x": torch.tensor(
        float(b["v"][0]))}), 4, "cpu")
    _, out = fused(seen, {"v": np.arange(3.0)[:, None]})
    assert out["x"].tolist() == [0.0, 1.0, 2.0]


# ----------------------------------------------------- two gloo processes
@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """Two ``gloo`` processes of ``tests/torch_fused_worker.py`` (each its
    slice of every batch, the fused FS step through ``wrap_model``) and
    JAX's fused step on a two-device mesh with the super-batch sharded on
    its batch axis."""
    tmp = tmp_path_factory.mktemp("fused_gloo")
    jcfg = jax_load_config(str(worker.DEBUG_3D))
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jmodel = jax_get_model(jcfg)
    jstate = jax_create_train_state(jcfg, jmodel, jax.random.PRNGKey(0),
                                    steps_per_epoch=10, image_size=(64, 64))
    rng = np.random.default_rng(3)
    params = _numpy(jstate.params)
    for name in ("deconv1", "deconv2", "deconv3", "final_layer"):
        k = params[name]["kernel"]
        params[name]["kernel"] = rng.normal(0, 0.05, k.shape).astype(
            np.float32)
    jstate = jstate.replace(params=params, opt_state=jstate.tx.init(params))
    state_dict = from_jax_variables(
        {"params": params, "batch_stats": _numpy(jstate.batch_stats)})
    batches = _batches(worker.K, n=8, joints=17, seed=9, with_3d=True)
    torch.save({"state_dict": state_dict, "batches": batches},
               tmp / "inputs.pt")
    env = dict(os.environ, WORLD_SIZE=str(worker.WORLD),
               OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, str(pathlib.Path(worker.__file__)), str(tmp)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(worker.WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(worker.WORLD)]
    mesh = jax_make_mesh(jcfg, num_devices=2)
    jstep = jax_make_train_step(jcfg, jmodel, mesh=mesh, donate=False,
                                fused_steps=worker.K)
    superbatch = shard_batch(next(jax_stack(iter(batches), worker.K)), mesh,
                             batch_axis=1)
    jstate, jm = jstep(jstate, superbatch)
    return {"ranks": ranks, "loss": np.asarray(jm["loss"]),
            "state_dict": _jax_weights(jstate)}


def test_two_gloo_processes_match_jax_sharded_fused_step(gloo_run):
    """Both ranks: (K,) losses against JAX's, the same on both ranks bit
    for bit (weights and BN buffers too), ``state.step`` K, parameters
    against JAX."""
    a, b = gloo_run["ranks"]
    assert a["step"] == b["step"] == worker.K
    np.testing.assert_array_equal(a["loss"], b["loss"])
    np.testing.assert_allclose(a["loss"], gloo_run["loss"], rtol=1e-5)
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    _check_params(a["state_dict"], gloo_run["state_dict"], steps=worker.K)
