"""The port's data parallelism on the CPU: two ``gloo`` processes against
one process on the global batch, and against the JAX package's step
sharded over two devices.

Two processes of ``tests/torch_parallel_worker.py`` (``OMP_NUM_THREADS``
1, ``file://`` rendezvous in a temporary directory, joined with a
timeout) each take their slice of every global batch through
``host_shard_indices`` and run:

- (a) two FS steps of ``make_train_step`` through ``parallel.wrap_model``
  (ResNet-18 at 64x64, D 8, float32, Adam; 8 crops a global batch, the
  first rank's 4 at a quarter of the brightness of the second's);
- (b) the same first step through DDP with each process's own batch norm,
  and with ``TPU.REMAT`` (the recomputed blocks repeat their collectives);
- (c) one SS step on the ``given`` and on the ``estimated`` route (2 of 4
  view groups each, detections in the batch);
- (d) ``validate`` over ``epoch_loader`` (12 records in global batches
  of 8, the second padded);
- (e) a checkpoint written by the first process and restored by both.

The same functions run here in one process on the global batches.

Tolerances. One process against two: the losses relative 1e-5; the
gradients and BN buffers to 1e-5 of each tensor's largest entry; the
parameters by the Adam rule of ROADMAP Queue C, "Matched": Adam's first
update is about ``lr * sign(g)``, so an entry whose gradient is rounding
noise can move by anything up to ``lr`` either way. After step 1 every
entry whose gradient is at least 1e-6 agrees to 1e-6 (a thousandth of
the step; measured 1.3e-7), and every entry is held within ``2 * lr`` a
step. A relative rule cannot hold parameters: an entry near zero moves
by ``lr`` in one step. Two processes
compute batch norm's variance as flax does, E[x^2] - E[x]^2 in float32
over the global batch, where one process takes torch's own; the
processes run one thread each. The two processes agree with each other
bit for bit. Step 2 starts from parameters that already differ by
Adam's sign noise, whose entries depend on rounding (the thread count
among it): its gradients are not compared (1e-4 to 1.7e-2 of a tensor's
largest entry apart in runs with other thread counts) and its buffers
are held to 1e-2 of each tensor's largest entry, as
``tests/test_torch_train_step.py`` holds Adam's after step 3.

The FS step against JAX's sharded step: the train-step parity rules of
``tests/test_torch_train_step.py`` (loss relative 1e-5, step-1 gradients
1e-4 of each tensor's largest entry, parameters by the Adam rule, BN
buffers 1e-4 of each tensor's largest after step 1), with one addition.
On this batch JAX's own float32 gradients are up to 4.6e-4 of a tensor's
largest entry from a float64 evaluation of the same step (layer2.0.conv1;
the port's, in one process or two, 6.9e-6), so each port gradient is held
to the float64 evaluation within 1e-5 and to JAX within 1e-4 plus JAX's
own distance from float64; after step 1 the parameters whose float64
gradient is at least 1e-6 agree with JAX's to 1e-6 where JAX's gradient
is within a tenth of the float64 one, and the entries left out are
counted and must be under 1% of those compared.
"""

import os
import pathlib
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from epipolarpose_tpu.config import load_config as jax_load_config
from epipolarpose_tpu.core.steps import make_train_step as jax_make_train_step
from epipolarpose_tpu.core.train_state import (
    create_train_state as jax_create_train_state)
from epipolarpose_tpu.models import get_model as jax_get_model
from epipolarpose_tpu.parallel import make_mesh as jax_make_mesh
from epipolarpose_tpu.parallel import shard_batch
from epipolarpose_tpu_torch.core.steps import normalize_images
from epipolarpose_tpu_torch.data.synthetic import SyntheticMultiviewDataset
from epipolarpose_tpu_torch.geometry.camera import project_point_radial
from epipolarpose_tpu_torch.kernels.softargmax import softmax_integral_plain
from epipolarpose_tpu_torch.models import from_jax_variables, get_pose_net
from epipolarpose_tpu_torch.ops.integral import generate_integral_target
from epipolarpose_tpu_torch.ops.losses import integral_l1_loss
import torch_parallel_worker as worker

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5
LR = 1e-3
JOIN_TIMEOUT_S = 240


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _fs_batch(seed, n=8, size=64, joints=17):
    """uint8 crops whose first half is at a quarter of the brightness;
    joints partly outside the crop, some not visible, depths partly
    beyond the 1000 mm bound."""
    r = np.random.default_rng(seed)
    img = r.integers(0, 256, (n, size, size, 3), np.uint8)
    img[:n // 2] //= 4
    return {"input": img,
            "joints": r.uniform(-4, size + 4, (n, joints, 2)).astype(
                np.float32),
            "joints_vis": (r.uniform(size=(n, joints)) > 0.1).astype(
                np.float32),
            "joints_3d": r.uniform(-700, 700, (n, joints, 3)).astype(
                np.float32)}


def _float64_gradients(cfg, state_dict, batch) -> dict:
    """The FS step's gradients on ``batch``, the model in float64."""
    model = get_pose_net(cfg)
    model.load_state_dict(state_dict)
    model.double().train()
    model.dtype = torch.float64
    x = normalize_images(torch.as_tensor(batch["input"])).permute(
        0, 3, 1, 2).double()
    with warnings.catch_warnings():      # CPU autocast has no float64
        warnings.simplefilter("ignore", UserWarning)
        vol = model(x)
    z = torch.as_tensor(batch["joints_3d"])[..., 2]
    target, tw = generate_integral_target(
        torch.as_tensor(batch["joints"]), torch.as_tensor(batch["joints_vis"]),
        tuple(float(v) for v in cfg.MODEL.IMAGE_SIZE),
        depth_bound=float(cfg.MODEL.EXTRA.DEPTH_BOUND),
        joints_depth=z - z[:, :1])
    coords = softmax_integral_plain(vol, int(cfg.MODEL.NUM_JOINTS),
                                    int(cfg.MODEL.EXTRA.DEPTH_DIM))
    integral_l1_loss(coords, target.double(), tw.double()).backward()
    return {n: p.grad for n, p in model.named_parameters()}


def _head_redrawn(model, seed):
    """The head at std 0.05, so that gradients reach the backbone."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name in ("deconv_layers.0", "deconv_layers.3", "deconv_layers.6",
                     "final_layer"):
            w = model.get_submodule(name).weight
            w.copy_(torch.randn(w.shape, generator=g) * 0.05)
    return model.state_dict()


def _ss_batches(seed=5):
    """4 view groups of 4 views (noise crops for the student, the dual
    crop for ``given``), detections in the batch: ``given`` 2 px off the
    truth with confidences in [0.5, 1]; ``estimated`` the truth through
    an undistorted rig. ``seed`` draws the noise."""
    cfg = worker.ss_config("given")
    ds = SyntheticMultiviewDataset(cfg, num_frames=4, is_train=True,
                                   image_shape=(64, 64))
    r = np.random.default_rng(seed)
    groups = ds.view_groups[:4]
    given = next(ds.view_batches(4, shuffle=False, augment=True))
    gt = np.stack([[ds.records[i].joints for i in g] for g in groups])
    given["det_src"] = (gt + r.normal(0, 2.0, gt.shape)).astype(np.float32)
    given["det_conf"] = r.uniform(0.5, 1.0, gt.shape[:-1]).astype(
        np.float32)
    est = next(ds.view_batches(4, shuffle=False))
    est.pop("joints_3d")
    est["camera"] = est["camera"].replace(k=est["camera"].k * 0,
                                          p=est["camera"].p * 0)
    rig = [c.replace(k=c.k * 0, p=c.p * 0) for c in ds.rig]
    est["det_src"] = np.stack([[project_point_radial(
        torch.as_tensor(ds.records[i].meta["pose_world"])[None],
        rig[int(ds.records[i].meta["camera"])])[0][0].numpy()
        for i in g] for g in groups]).astype(np.float32)
    for b in (given, est):
        for key in ("input", "input_aug"):
            if key in b:
                b[key] = r.integers(0, 256, b[key].shape, np.uint8)
    return given, est


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, the two processes' results, the one-process results
    and JAX's sharded FS steps."""
    tmp = tmp_path_factory.mktemp("parallel")
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
    fs_state = from_jax_variables({"params": params,
                                   "batch_stats": _numpy(jstate.batch_stats)})
    fs_batches = [_fs_batch(k) for k in range(worker.FS_STEPS)]
    ss_state = _head_redrawn(get_pose_net(
        worker.ss_config("given"), generator=torch.Generator().manual_seed(1)),
        seed=2)
    given, est = _ss_batches()
    torch.save({"fs_state": fs_state, "fs_batches": fs_batches,
                "ss_state": ss_state, "ss_given": given,
                "ss_estimated": est, "eval_state": fs_state},
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

    fs_cfg = worker.fs_config()
    one = {"fs": worker.run_fs(fs_cfg, fs_state, fs_batches),
           "validate": worker.run_validate(fs_cfg, fs_state),
           "fs_grads_f64": _float64_gradients(fs_cfg, fs_state,
                                              fs_batches[0])}
    for cameras, batch in (("given", given), ("estimated", est)):
        one[f"ss_{cameras}"] = worker.run_ss(worker.ss_config(cameras),
                                             ss_state, batch)

    mesh = jax_make_mesh(jcfg, num_devices=2)
    jstep = jax_make_train_step(jcfg, jmodel, mesh=mesh, donate=False)
    jax_out = {"loss": [], "state_dict": []}
    for k, batch in enumerate(fs_batches):
        jstate, metrics = jstep(jstate, shard_batch(batch, mesh))
        jax_out["loss"].append(float(metrics["loss"]))
        if k == 0:
            jax_out["moment"] = from_jax_variables(
                {"params": _numpy(jstate.opt_state[0].mu)})
        jax_out["state_dict"].append(from_jax_variables(
            {"params": _numpy(jstate.params),
             "batch_stats": _numpy(jstate.batch_stats)}))
    return {"tmp": tmp, "ranks": ranks, "one": one, "jax": jax_out,
            "procs": procs}


def _worst(got: dict, want: dict, names) -> tuple[float, str]:
    """Largest gap over ``names``, each relative to its tensor's largest
    entry."""
    gaps = {n: ((got[n].double() - want[n].double()).abs().max()
                / want[n].double().abs().max().clamp_min(1e-30)).item()
            for n in names}
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def _params(sd) -> list[str]:
    return [k for k in sd if "running" not in k and "num_batches" not in k]


def _buffers(sd) -> list[str]:
    return [k for k in sd if "running" in k]


def test_processes_ended(runs):
    """Both ranks exited 0 (checked in the fixture) and are gone."""
    assert all(p.poll() == 0 for p in runs["procs"])


@pytest.mark.parametrize("step", range(2))
def test_ranks_agree_bit_for_bit(runs, step):
    """(a) After each step the two processes hold the same gradients,
    parameters and BN buffers, ``num_batches_tracked`` included."""
    a, b = (r["fs"] for r in runs["ranks"])
    assert a["loss"][step] == b["loss"][step]
    for k, v in a["state_dict"][step].items():
        assert torch.equal(v, b["state_dict"][step][k]), k
    for k, v in a["grads"][step].items():
        assert torch.equal(v, b["grads"][step][k]), k


@pytest.mark.parametrize("step", range(2))
def test_fs_step_matches_one_process(runs, step):
    """(a) Loss, parameters and BN buffers of each step, and step 1's
    gradients, equal the one-process step on the global batch (module
    docstring)."""
    got, want = runs["ranks"][0]["fs"], runs["one"]["fs"]
    np.testing.assert_allclose(got["loss"][step], want["loss"][step],
                               rtol=TOL)
    if step == 0:
        g, w = got["grads"][0], want["grads"][0]
        gap, name = _worst(g, w, w)
        assert gap <= TOL, (name, gap)
    sd, sw = got["state_dict"][step], want["state_dict"][step]
    gap, name = _worst(sd, sw, _buffers(sw))
    assert gap <= (TOL if step == 0 else 1e-2), (name, gap)
    assert all(torch.equal(sd[k], sw[k]) for k in sw if "num_batches" in k)
    for k in _params(sw):
        diff = (sd[k] - sw[k]).abs()
        assert diff.max().item() <= 2 * LR * (step + 1), k
        if step == 0:
            steady = want["grads"][0][k].abs() >= 1e-6
            assert diff[steady].max().item() <= 1e-6, k


def test_fs_step_matches_jax_sharded(runs):
    """(a) Against JAX's ``make_train_step`` on a two-device mesh with the
    batch sharded: losses, step-1 gradients (Adam's first moment is
    ``0.1 * g``; held with a float64 evaluation, module docstring),
    parameters, and BN buffers after step 1."""
    got, want = runs["ranks"][0]["fs"], runs["jax"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    moment = {k: want["moment"][k] * 10.0 for k in got["grads"][0]}
    exact = runs["one"]["fs_grads_f64"]
    for k in moment:
        to_exact, _ = _worst(got["grads"][0], exact, [k])
        assert to_exact <= TOL, (k, to_exact)
        jax_to_exact, _ = _worst(moment, exact, [k])
        to_jax, _ = _worst(got["grads"][0], moment, [k])
        assert to_jax <= 1e-4 + jax_to_exact, (k, to_jax, jax_to_exact)
    left_out = compared = 0
    for step in range(2):
        sd, sw = got["state_dict"][step], want["state_dict"][step]
        for k in moment:
            diff = (sd[k] - sw[k]).abs()
            assert diff.max().item() <= 2 * LR * (step + 1), k
            if step == 0:
                # where JAX's gradient has the float64 one's sign for sure
                steady = exact[k].abs() >= 1e-6
                sure = (moment[k] - exact[k]).abs() <= 0.1 * exact[k].abs()
                assert diff[steady & sure].max().item() <= 1e-6, k
                left_out += int((steady & ~sure).sum())
                compared += int(steady.sum())
    assert left_out <= 0.01 * compared, (left_out, compared)
    sd, sw = got["state_dict"][0], want["state_dict"][0]
    gap, name = _worst(sd, sw, _buffers(sw))
    assert gap <= 1e-4, (name, gap)


def test_remat_under_data_parallelism_changes_no_bit(runs):
    """(b) With ``TPU.REMAT`` the first step gives the same loss,
    gradients and state, buffers and step counts included, bit for
    bit."""
    for rank in runs["ranks"]:
        got, want = rank["fs_remat"], rank["fs"]
        assert got["loss"][0] == want["loss"][0]
        for key in ("grads", "state_dict"):
            for k, v in want[key][0].items():
                assert torch.equal(got[key][0][k], v), (key, k)


def test_per_process_batch_norm_misses(runs):
    """(b) The negative control: DDP with each process's own batch norm
    gives another first loss, by more than 10x the tolerance, because
    the two ranks' crops differ in brightness."""
    got = runs["ranks"][0]["fs_per_rank_bn"][0]
    want = runs["one"]["fs"]["loss"][0]
    assert abs(got - want) > 10 * TOL * abs(want), (got, want)


@pytest.mark.parametrize("cameras", ["given", "estimated"])
def test_ss_step_matches_one_process(runs, cameras):
    """(c) One SS step: loss, triangulation residual, gradients and BN
    buffers equal the one-process step on the 4 groups (module
    docstring; the residual 1e-4 absolute, of unit-row systems)."""
    got = runs["ranks"][0][f"ss_{cameras}"]
    want = runs["one"][f"ss_{cameras}"]
    other = runs["ranks"][1][f"ss_{cameras}"]
    assert got["loss"] == other["loss"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL)
    np.testing.assert_allclose(got["tri_residual"], want["tri_residual"],
                               atol=1e-4)
    gap, name = _worst(got["grads"], want["grads"], want["grads"])
    assert gap <= TOL, (name, gap)
    sw = want["state_dict"]
    gap, name = _worst(got["state_dict"], sw, _buffers(sw))
    assert gap <= TOL, (name, gap)


def test_estimated_rig_is_the_same_on_both_ranks(runs):
    """(c) The estimated route fits one rig to the global batch: every
    triangulation sees the same projection matrices on both ranks, bit
    for bit, and those of the one-process step (1e-5 of their largest
    entry); the last, the four-view solve, returns the global batch's
    points, each rank keeping its own groups."""
    a, b = (r["ss_estimated"]["solves"] for r in runs["ranks"])
    one = runs["one"]["ss_estimated"]["solves"]
    assert len(a) == len(b) == len(one) == 4
    for (pa, xa), (pb, xb), (p1, x1) in zip(a, b, one):
        assert torch.equal(pa, pb) and torch.equal(xa, xb)
        gap = ((pa - p1).abs().max() / p1.abs().max()).item()
        assert gap <= TOL, gap
    assert a[-1][1].shape[0] == 4


def test_validate_matches_one_process(runs):
    """(d) ``validate`` with each process's slice of every batch gathered
    back: the same ``evaluate`` numbers as one process, relative 1e-5."""
    want = runs["one"]["validate"]
    for rank in runs["ranks"]:
        got = rank["validate"]
        assert sorted(got["name_values"]) == sorted(want["name_values"])
        for k, v in want["name_values"].items():
            np.testing.assert_allclose(got["name_values"][k], v, rtol=TOL,
                                       err_msg=k)
        np.testing.assert_allclose(got["perf"], want["perf"], rtol=TOL)


def test_checkpoint_of_the_first_process_loads_strict(runs):
    """(e) The first process wrote the checkpoints; both restored the
    latest save bit for bit after a barrier; ``final_state.pth.tar``
    loads ``strict=True`` into a plain model and holds the trained
    weights."""
    for rank in runs["ranks"]:
        ck = rank["checkpoint"]
        assert ck["restored_equal"] and ck["epoch"] == 1 and ck["step"] == 2
    final = runs["ranks"][0]["checkpoint"]["final"]
    assert os.path.isfile(final)
    model = get_pose_net(worker.fs_config())
    sd = torch.load(final, map_location="cpu", weights_only=True)
    model.load_state_dict(sd["state_dict"], strict=True)
    want = runs["ranks"][0]["fs"]["state_dict"][-1]
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
