"""The port's model axis (``TPU.MESH.MODEL > 1``) on the CPU: image rows
split over a model group of ``gloo`` processes, against one process on
the global batch, against the whole layers, and against the JAX
package's step sharded over a ``(data, model)`` mesh.

Three jobs of ``tests/torch_spatial_worker.py`` run side by side
(``OMP_NUM_THREADS`` 1, ``file://`` rendezvous, joined with a timeout):
two processes on a 1 x 2 mesh, four on a 2 x 2 mesh (data x model) and
one process without a process group (the reference, on one thread as the
ranks are, so that no result depends on the machine's thread count),
ResNet-18 at 64x64 (32 rows a process; one row a process at layer 4), D
8, float32. Each takes its data group's slice of every global batch and
runs:

- (a) each row-sensitive layer alone on a model axis of every process
  of its job (2, and 4: interior ranks), its forward and input gradient
  against the whole layer's rows, to 1e-6 of the largest entry;
- (b) two FS integral steps and one gaussian step (8 crops a global
  batch, half at a quarter of the brightness), against one process;
- (c) the first FS step against JAX's ``make_train_step(mesh=...)`` with
  ``shard_batch`` at ``MESH.DATA``/``MODEL`` 1/2 and 2/2;
- (d) the flip-test eval step against one process and JAX's sharded
  ``make_eval_step``;
- (e) one SS step on the ``given`` and ``estimated`` routes (4 view
  groups of 4 views, 5-D ``input`` rows split);
- (f) the first FS step with ``TPU.REMAT``;
- (g) ``validate`` over ``epoch_loader``;
- (h) a checkpoint written by the first process;
- and the step builders' refusal of a model that was not switched.

Tolerances, as ``tests/test_torch_parallel.py`` sets them out: against
one process, losses relative 1e-5, step-1 gradients and BN buffers 1e-5
of each tensor's largest entry (1e-2 after step 2), parameters by Adam's
sign rule (an entry whose step-1 gradient is at least 1e-6 within 1e-6,
every entry within ``2 * lr`` a step); against JAX, the train-step parity
rules with the float64 evaluation's addition (at 2 x 2 JAX's own
gradients are off: ``test_fs_step_matches_jax_sharded``). Every process
of a job ends a step with the same loss, gradients and state, bit for
bit. A split layer is not bit-equal to the whole one (its rows' sums run
in another order), so the layers are held to a tolerance.

The batches' seeds. A ReLU input within float32 rounding of zero (about
1e-7) can land on either side in the split and the whole run; where one
does, the gradients upstream of it differ in one 3x3 patch of one crop,
by up to 1e-2 of a tensor's largest entry, and no 1e-5 rule holds. Seen
here: the gaussian batch of seed 6 (one ``layer1.1.bn1`` output at
1.3e-7, the only one within 1e-6 of zero in that tensor; the 2 x 2
gradients 1.3e-2 off at ``layer1.1.bn1.bias``, 1 x 2 and 2 x 1 within
9e-6) and the estimated SS batch of seed 5 (1 x 2, a patch at row 6 of
``layer2.0``'s output, inside a process's rows). The batches below have
none on any route; a change of seed, weights or thread count can meet
one, and the failure then shows that signature.
"""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch import nn

from epipolarpose_tpu.config import load_config as jax_load_config
from epipolarpose_tpu.core.steps import make_eval_step as jax_make_eval_step
from epipolarpose_tpu.core.steps import make_train_step as jax_make_train_step
from epipolarpose_tpu.core.train_state import (
    create_train_state as jax_create_train_state)
from epipolarpose_tpu.data.h36m import FLIP_PAIRS as JAX_FLIP_PAIRS
from epipolarpose_tpu.models import get_model as jax_get_model
from epipolarpose_tpu.parallel import make_mesh as jax_make_mesh
from epipolarpose_tpu.parallel import shard_batch
from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.core import create_train_state, make_train_step
from epipolarpose_tpu_torch.models import (from_jax_variables, get_pose_net,
                                           is_row_split, partition_rows)
from epipolarpose_tpu_torch.parallel import (check_row_split, gather_rows,
                                             halo_exchange, local_rows,
                                             make_mesh)
from test_torch_parallel import (_buffers, _float64_gradients, _fs_batch,
                                 _head_redrawn, _numpy, _params, _ss_batches,
                                 _worst)
import torch_parallel_worker as pw
import torch_spatial_worker as worker

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5
LAYER_TOL = 1e-6
LR = 1e-3
JOIN_TIMEOUT_S = 300
LAYOUTS = {"1x2": (1, 2), "2x2": (2, 2)}


def _gaussian_batch(seed, n=8, size=64, joints=16):
    """Crops whose first half is at a quarter of the brightness; joints
    partly outside the crop, some not visible."""
    r = np.random.default_rng(seed)
    img = r.integers(0, 256, (n, size, size, 3), np.uint8)
    img[:n // 2] //= 4
    return {"input": img,
            "joints": r.uniform(-6, size + 6, (n, joints, 2)).astype(
                np.float32),
            "joints_vis": (r.uniform(size=(n, joints)) > 0.1).astype(
                np.float32)}


def _eval_batch(seed, n=8, size=64):
    r = np.random.default_rng(seed)
    return {"input": r.integers(0, 256, (n, size, size, 3), np.uint8),
            "center": r.uniform(80, 400, (n, 2)).astype(np.float32),
            "scale": r.uniform(0.2, 0.6, (n, 2)).astype(np.float32)}


def _start(tmp: pathlib.Path, data: int, model: int) -> list:
    """The job's processes (one for ``1 x 1``: the reference)."""
    tmp.mkdir()
    os.symlink(tmp.parent / "inputs.pt", tmp / "inputs.pt")
    world = data * model
    env = dict(os.environ, WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT))
    return [subprocess.Popen(
        [sys.executable, str(pathlib.Path(worker.__file__)), str(tmp),
         str(data), str(model)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _join(procs: list) -> list:
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
    return logs


def _jax_runs(jcfg, jmodel, jstate, fs_batch, eval_batch) -> dict:
    """JAX's first FS step and its flip-test eval step on a (data, model)
    mesh of the virtual CPU devices, for each layout."""
    out = {}
    ecfg = jax_load_config(str(worker.pw.DEBUG_3D))
    ecfg.TPU.COMPUTE_DTYPE = "float32"
    ecfg.TEST.FLIP_TEST = ecfg.TEST.SHIFT_HEATMAP = True
    for name, (data, model) in LAYOUTS.items():
        jcfg.TPU.MESH.DATA = ecfg.TPU.MESH.DATA = data
        jcfg.TPU.MESH.MODEL = ecfg.TPU.MESH.MODEL = model
        mesh = jax_make_mesh(jcfg)
        assert mesh.shape == {"data": data, "model": model}
        batch = shard_batch(fs_batch, mesh)
        assert batch["input"].sharding.spec[1] == "model"
        step = jax_make_train_step(jcfg, jmodel, mesh=mesh, donate=False)
        state, metrics = step(jstate, batch)
        estep = jax_make_eval_step(ecfg, jmodel, mesh=jax_make_mesh(ecfg),
                                   flip_pairs=JAX_FLIP_PAIRS)
        out[name] = {
            "loss": float(metrics["loss"]),
            "moment": from_jax_variables(
                {"params": _numpy(state.opt_state[0].mu)}),
            "state_dict": from_jax_variables(
                {"params": _numpy(state.params),
                 "batch_stats": _numpy(state.batch_stats)}),
            "eval": np.asarray(estep(jstate, shard_batch(eval_batch,
                                                         mesh))["preds"])}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, both jobs' results, the one-process results, the whole
    layers and JAX's sharded steps."""
    tmp = tmp_path_factory.mktemp("spatial")
    jcfg = jax_load_config(str(pw.DEBUG_3D))
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
    fs_state = from_jax_variables({"params": params,
                                   "batch_stats": _numpy(jstate.batch_stats)})
    inputs = {
        "fs_state": fs_state,
        "fs_batches": [_fs_batch(k) for k in range(pw.FS_STEPS)],
        "gaussian_state": _head_redrawn(get_pose_net(
            worker.gaussian_config(),
            generator=torch.Generator().manual_seed(4)), seed=5),
        "gaussian_batch": _gaussian_batch(8),
        "eval_batch": _eval_batch(7),
        "ss_state": _head_redrawn(get_pose_net(
            pw.ss_config("given"), generator=torch.Generator().manual_seed(1)),
            seed=2)}
    # the batches' seeds put no ReLU input within float32 rounding of zero
    # (module docstring)
    inputs["ss_given"] = _ss_batches(5)[0]
    inputs["ss_estimated"] = _ss_batches(6)[1]
    torch.save(inputs, tmp / "inputs.pt")
    jobs = dict(LAYOUTS, one=(1, 1))
    procs = {name: _start(tmp / name, *layout)
             for name, layout in jobs.items()}
    try:    # while the processes run: the float64 gradients and JAX
        exact = _float64_gradients(pw.fs_config(), fs_state,
                                   inputs["fs_batches"][0])
        jax_out = _jax_runs(jcfg, jmodel, jstate, inputs["fs_batches"][0],
                            inputs["eval_batch"])
    finally:
        logs = {name: _join(p) for name, p in procs.items()}
    ranks = {name: [torch.load(tmp / name / f"rank{r}.pt",
                               weights_only=False)
                    for r in range(len(procs[name]))]
             for name in LAYOUTS}
    one = torch.load(tmp / "one" / "one.pt", weights_only=False)
    one["fs_grads_f64"] = exact
    for path in tmp.rglob("*.pt"):   # loaded: free the shared tmp space
        path.unlink()
    return {"ranks": ranks, "one": one, "jax": jax_out, "procs": procs,
            "logs": logs}


def test_processes_ended(runs):
    """Every rank of both jobs exited 0 (checked in the fixture) and is
    gone."""
    assert all(p.poll() == 0 for procs in runs["procs"].values()
               for p in procs)


@pytest.mark.parametrize("name", list(worker.layer_cases()))
def test_split_layer_matches_the_whole_layer(runs, name):
    """(a) Each layer on a model axis of 2 and of 4 (edge and interior
    ranks): every rank's output rows and input-gradient rows equal the
    whole layer's, to 1e-6 of the largest entry; ``partition_rows``
    switched it unless it reads no halo (1x1, k2)."""
    want = runs["one"]["layers"][name]
    for job in LAYOUTS:
        ranks = runs["ranks"][job]
        for r, rank in enumerate(ranks):
            got = rank["layers"][name]
            m = len(ranks)
            assert rank["layer_mesh"] == (1, m)
            for key in ("y", "dx"):
                full = want[key]
                per = full.shape[2] // m
                rows = full[:, :, r * per:(r + 1) * per]
                assert got[key].shape == rows.shape, (job, r, key)
                gap = ((got[key] - rows).abs().max()
                       / full.abs().max()).item()
                assert gap <= LAYER_TOL, (job, r, key, gap)
    layer = partition_rows(nn.Sequential(worker.layer_inputs(name)[0]))
    assert is_row_split(layer) == (name not in ("conv1x1_s2", "deconv_k2",
                                                "final_k1"))


@pytest.mark.parametrize("job", list(LAYOUTS))
def test_ranks_agree_bit_for_bit(runs, job):
    """Every rank of a job ends each step with the same loss, gradients,
    parameters and BN buffers (the sha256 of each tensor's bytes), and
    returns the same eval predictions within a data group."""
    first, *rest = runs["ranks"][job]
    data, model = LAYOUTS[job]
    for r, other in enumerate(rest, 1):
        assert other["mesh"] == (data, model, r // model)
        for case in ("fs", "gaussian", "ss_given", "ss_estimated"):
            assert first[case]["loss"] == other[case]["loss"], case
            assert first[case]["digest"] == other[case]["digest"], case
        same_group = runs["ranks"][job][(r // model) * model]
        assert torch.equal(other["eval"], same_group["eval"])


def _adam_bound(param: torch.Tensor, steps: int) -> float:
    """How far two runs' parameters may be apart after ``steps`` Adam
    steps whose gradients differ in sign: ``2 * lr`` a step, plus the
    rounding of the parameters themselves (one float32 spacing of the
    largest entry a step: a BN scale near 1 moves by ``lr`` in steps of
    1.2e-7)."""
    eps = torch.finfo(torch.float32).eps
    return steps * (2 * LR + 2 * eps * param.abs().max().item())


def _hold_to_one_process(got: dict, want: dict, steps: int) -> None:
    for step in range(steps):
        np.testing.assert_allclose(got["loss"][step], want["loss"][step],
                                   rtol=TOL)
        if step == 0:
            gap, name = _worst(got["grads"][0], want["grads"][0],
                               want["grads"][0])
            assert gap <= TOL, (name, gap)
        sd, sw = got["state_dict"][step], want["state_dict"][step]
        gap, name = _worst(sd, sw, _buffers(sw))
        assert gap <= (TOL if step == 0 else 1e-2), (name, gap)
        assert all(torch.equal(sd[k], sw[k]) for k in sw
                   if "num_batches" in k)
        for k in _params(sw):
            diff = (sd[k] - sw[k]).abs()
            assert diff.max().item() <= _adam_bound(sw[k], step + 1), k
            if step == 0:
                steady = want["grads"][0][k].abs() >= 1e-6
                assert diff[steady].max().item() <= 1e-6, k


@pytest.mark.parametrize("job", list(LAYOUTS))
def test_fs_steps_match_one_process(runs, job):
    """(b) Two FS integral steps: loss, parameters and BN buffers of each
    step and step 1's gradients equal one process's on the global
    batches (module docstring)."""
    _hold_to_one_process(runs["ranks"][job][0]["fs"], runs["one"]["fs"],
                         pw.FS_STEPS)


@pytest.mark.parametrize("job", list(LAYOUTS))
def test_gaussian_step_matches_one_process(runs, job):
    """(b) One gaussian step: the heatmaps gathered whole before the MSE
    and the accuracy; loss, gradients, parameters and buffers as the FS
    steps."""
    _hold_to_one_process(runs["ranks"][job][0]["gaussian"],
                         runs["one"]["gaussian"], 1)


@pytest.mark.parametrize("job", list(LAYOUTS))
def test_fs_step_matches_jax_sharded(runs, job):
    """(c) Against JAX's first step on the same (data, model) mesh: the
    loss relative 1e-5 and BN buffers 1e-4; each port gradient within
    1e-5 of a float64 evaluation and within 1e-4 plus JAX's own float64
    distance of JAX's (Adam's first moment is ``0.1 * g``); the
    parameters by the Adam rule where JAX's gradient is within a tenth of
    the float64 one.

    At 1 x 2 the entries left out are under 1% of those compared. At
    2 x 2 JAX's own sharded step is off: its loss and buffers are right,
    but its gradients are several times a tensor's largest entry from the
    float64 evaluation (measured 6.7 at ``layer4.0.bn1.weight``; its
    first and second moments agree with each other, so the step used
    them) while its 2 x 1 and 1 x 2 steps are within 5e-4. That fault of
    the reference is pinned here (ROADMAP Queue C); the port's 2 x 2
    gradients are held to float64 and to one process."""
    got, want = runs["ranks"][job][0]["fs"], runs["jax"][job]
    np.testing.assert_allclose(got["loss"][0], want["loss"], rtol=1e-5)
    moment = {k: want["moment"][k] * 10.0 for k in got["grads"][0]}
    exact = runs["one"]["fs_grads_f64"]
    left_out = compared = 0
    jax_worst = 0.0
    sd, sw = got["state_dict"][0], want["state_dict"]
    for k in moment:
        to_exact, _ = _worst(got["grads"][0], exact, [k])
        assert to_exact <= TOL, (k, to_exact)
        jax_to_exact, _ = _worst(moment, exact, [k])
        jax_worst = max(jax_worst, jax_to_exact)
        to_jax, _ = _worst(got["grads"][0], moment, [k])
        assert to_jax <= 1e-4 + jax_to_exact, (k, to_jax, jax_to_exact)
        diff = (sd[k] - sw[k]).abs()
        assert diff.max().item() <= _adam_bound(sw[k], 1), k
        steady = exact[k].abs() >= 1e-6
        sure = (moment[k] - exact[k]).abs() <= 0.1 * exact[k].abs()
        if (steady & sure).any():
            assert diff[steady & sure].max().item() <= 1e-6, k
        left_out += int((steady & ~sure).sum())
        compared += int(steady.sum())
    if job == "2x2":
        assert jax_worst > 1.0, jax_worst
    else:
        assert jax_worst <= 1e-3, jax_worst
        assert left_out <= 0.01 * compared, (left_out, compared)
    gap, name = _worst(sd, sw, _buffers(sw))
    assert gap <= 1e-4, (name, gap)


@pytest.mark.parametrize("job", list(LAYOUTS))
def test_eval_step_matches_one_process_and_jax(runs, job):
    """(d) The flip-test eval step (H36M flip pairs, heatmap shift): each
    data group's predictions equal one process's rows of them and JAX's
    sharded step's, within 1e-3 px in (x, y) and 1e-2 mm in z (the
    bounds of ``tests/test_torch_eval_step.py``)."""
    data, model = LAYOUTS[job]
    one = runs["one"]["eval"].numpy()
    jax_preds = runs["jax"][job]["eval"]
    assert np.ptp(one[..., 0]) > 1.0, "joints should not all coincide"
    per = len(one) // data
    for r, rank in enumerate(runs["ranks"][job]):
        d = r // model
        got = rank["eval"].numpy()
        for want in (one[d * per:(d + 1) * per],
                     jax_preds[d * per:(d + 1) * per]):
            np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0,
                                       atol=1e-3)
            np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0,
                                       atol=1e-2)


@pytest.mark.parametrize("cameras", ["given", "estimated"])
@pytest.mark.parametrize("job", list(LAYOUTS))
def test_ss_step_matches_one_process(runs, job, cameras):
    """(e) One SS step with each process's rows of the 5-D ``input`` and
    ``input_aug``: loss, triangulation residual (1e-4 absolute),
    gradients and BN buffers equal the one-process step on the 4 groups;
    the estimated rig's last solve returns the global batch's 4 groups."""
    got = runs["ranks"][job][0][f"ss_{cameras}"]
    want = runs["one"][f"ss_{cameras}"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL)
    np.testing.assert_allclose(got["tri_residual"], want["tri_residual"],
                               atol=1e-4)
    gap, name = _worst(got["grads"], want["grads"], want["grads"])
    assert gap <= TOL, (name, gap)
    sw = want["state_dict"]
    gap, name = _worst(got["state_dict"], sw, _buffers(sw))
    assert gap <= TOL, (name, gap)
    if cameras == "estimated":
        assert got["solve_points"] == 4


@pytest.mark.parametrize("job", list(LAYOUTS))
def test_remat_under_the_model_axis_changes_no_bit(runs, job):
    """(f) With ``TPU.REMAT`` the recomputed blocks repeat their halo
    exchanges: the first step's loss, gradients and state are the same,
    bit for bit (each rank compares the sha256 of every tensor)."""
    for rank in runs["ranks"][job]:
        got, want = rank["fs_remat"], rank["fs"]
        assert got["loss"][0] == want["loss"][0]
        assert got["differs"] == []


@pytest.mark.parametrize("job", list(LAYOUTS))
def test_validate_matches_one_process(runs, job):
    """(g) ``validate`` over ``epoch_loader``, each data group's slice of
    every batch gathered back over the data group: the same ``evaluate``
    numbers as one process, relative 1e-5, on every rank."""
    want = runs["one"]["validate"]
    for rank in runs["ranks"][job]:
        got = rank["validate"]
        assert sorted(got["name_values"]) == sorted(want["name_values"])
        for k, v in want["name_values"].items():
            np.testing.assert_allclose(got["name_values"][k], v, rtol=TOL,
                                       err_msg=k)
        np.testing.assert_allclose(got["perf"], want["perf"], rtol=TOL)


@pytest.mark.parametrize("job", list(LAYOUTS))
def test_checkpoint_of_the_first_process_loads_strict(runs, job):
    """(h) The first process wrote the checkpoints; every rank restored
    the latest save bit for bit; ``final_state.pth.tar`` loads
    ``strict=True`` into a plain one-process model (and into a switched
    one: ``partition_rows`` keeps the names) with the trained weights.
    The other saves were deleted once restored (the worker's
    docstring)."""
    for rank in runs["ranks"][job]:
        ck = rank["checkpoint"]
        assert ck["restored_equal"] and ck["epoch"] == 1 and ck["step"] == 2
    final = runs["ranks"][job][0]["checkpoint"]["final"]
    sd = torch.load(final, map_location="cpu", weights_only=True)
    want = runs["ranks"][job][0]["fs"]["state_dict"][-1]
    for model in (get_pose_net(pw.fs_config()),
                  partition_rows(get_pose_net(pw.fs_config()))):
        model.load_state_dict(sd["state_dict"], strict=True)
        for k, v in model.state_dict().items():
            assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("job", list(LAYOUTS))
def test_a_model_not_switched_is_refused(runs, job):
    """Under a model axis the step builders refuse a model whose layers
    would pad each process's rows with zeros."""
    for rank in runs["ranks"][job]:
        assert "partition_rows" in rank.get("refused", "")


def test_row_split_refusals():
    """(i) A row split that is not 32-aligned raises by name (64 rows over
    4 processes); a mesh whose ``DATA x MODEL`` is not the number of
    processes raises; a 256-row image over 2 or 4 passes."""
    with pytest.raises(ValueError, match="TPU.MESH.MODEL = 4.*multiple of 32"):
        check_row_split([64, 64], 4)
    check_row_split([256, 256], 2)
    check_row_split([256, 256], 4)
    cfg = load_config(pw.DEBUG_3D)
    cfg.TPU.MESH.MODEL = 2
    with pytest.raises(ValueError, match="DATA = -1 x TPU.MESH.MODEL = 2"):
        make_mesh(cfg)
    cfg.TPU.MESH.MODEL, cfg.TPU.MESH.DATA = 1, 2
    with pytest.raises(ValueError, match="does not match 1 processes"):
        make_mesh(cfg)
    cfg.TPU.MESH.DATA = -1
    assert make_mesh(cfg) == (1, 1)


def test_one_process_helpers_pass_through():
    """Without a process group the row helpers are the identity and the
    exchange is the layer's padding; a switched model runs the same
    forward and the same train step, bit for bit."""
    x = torch.randn(2, 3, 8, 5, generator=torch.Generator().manual_seed(0))
    assert local_rows(x, 2) is x and gather_rows(x) is x
    torch.testing.assert_close(halo_exchange(x, 2, 1, -1.0),
                               torch.nn.functional.pad(x, (0, 0, 2, 1),
                                                       value=-1.0),
                               rtol=0, atol=0)
    cfg = pw.fs_config()
    batch = _fs_batch(11, n=2)
    out = []
    for split in (False, True):
        model = get_pose_net(cfg, generator=torch.Generator().manual_seed(8))
        if split:
            partition_rows(model)
        state = create_train_state(cfg, model, steps_per_epoch=1,
                                   device="cpu")
        _, metrics = make_train_step(cfg, model, "cpu")(state, batch)
        out.append((float(metrics["loss"]), model.state_dict()))
    assert out[0][0] == out[1][0]
    for k, v in out[0][1].items():
        assert torch.equal(v, out[1][1][k]), k
