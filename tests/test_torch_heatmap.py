"""The port's 2D heatmap path against the JAX package's, on the CPU.

- ``ops/heatmap.py``: targets at negative and edge coordinates (the
  centre truncates toward zero; the weight drops only when the box ends
  left of 0), the argmax decode with ties and non-positive maxima, the
  quarter offset at the borders, ``get_final_preds``. The port works on
  (N, J, H, W) maps, JAX on (N, H, W, J): the tests transpose. Exact, or
  1e-6 where float32 sums of another order enter.
- ``joints_mse_loss`` (relative 1e-6) and ``heatmap_accuracy`` (exact).
- The gaussian train step, 1 and 3 steps, and the flip-test eval step on
  ``experiments/debug/synth_smoke.yaml`` (ResNet-18 at 64x64, 16 joints,
  16x16 heatmaps, float32), from the same weights and batches as JAX.
  Step-1 loss relative 1e-5 (float32 forwards in another order), later
  steps 1e-4 (Adam's first update is about lr*sign(g), so entries with
  near-zero gradients move apart by up to lr on rounding noise: measured
  5.5e-6 and 2.6e-5 after steps 2 and 3); accuracy exact; parameters by
  ``test_torch_train_step.py``'s Adam rule. Eval:
  an argmax or a quarter-offset sign can flip only where the JAX maps'
  top-2 gap, or the neighbour difference, is below twice the largest
  difference between the two packages' maps; joints where that happens
  are counted and left out, all others agree to 1e-4 px.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epipolarpose_tpu.config import load_config as jax_load_config
from epipolarpose_tpu.core.steps import make_eval_step as jax_make_eval_step
from epipolarpose_tpu.core.steps import make_train_step as jax_make_train_step
from epipolarpose_tpu.core.train_state import (
    create_train_state as jax_create_train_state)
from epipolarpose_tpu.data.mpii import FLIP_PAIRS as MPII_FLIP_PAIRS
from epipolarpose_tpu.models import get_model as jax_get_model
from epipolarpose_tpu.ops import heatmap as jhm
from epipolarpose_tpu.ops import losses as jloss
from epipolarpose_tpu.ops import metrics as jmet
from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.core import create_train_state, make_train_step
from epipolarpose_tpu_torch.core.steps import (make_eval_step,
                                               normalize_images)
from epipolarpose_tpu_torch.geometry.affine import flip_back, shift_right
from epipolarpose_tpu_torch.models import from_jax_variables, get_pose_net
from epipolarpose_tpu_torch.ops import heatmap as thm
from epipolarpose_tpu_torch.ops import losses as tloss
from epipolarpose_tpu_torch.ops import metrics as tmet

DEBUG_2D = "experiments/debug/synth_smoke.yaml"
N_STEPS = 3


def nchw(a):
    """JAX (..., H, W, J) -> the port's (..., J, H, W), as a tensor."""
    return torch.tensor(np.moveaxis(np.asarray(a), -1, -3))


def nhwc(t):
    return np.moveaxis(t.float().numpy(), -3, -1)


def decisive(hm, margin):
    """(N, J) mask of the joints of (N, J, H, W) float maps whose argmax
    and quarter-offset signs cannot flip under a change of the maps by
    less than ``margin / 2``: the top-2 gap exceeds ``margin`` and each
    neighbour difference the offset reads is 0 where the offset is off,
    else beyond ``margin``."""
    n, j, h, w = hm.shape
    flat = hm.reshape(n, j, -1)
    top2 = flat.topk(2, dim=-1).values
    ok = (top2[..., 0] - top2[..., 1]) > margin
    preds, _ = thm.get_max_preds(hm)
    px, py = preds[..., 0].long(), preds[..., 1].long()
    inner = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    dx = (thm._gather_hm(hm, px + 1, py) - thm._gather_hm(hm, px - 1, py))
    dy = (thm._gather_hm(hm, px, py + 1) - thm._gather_hm(hm, px, py - 1))
    return ok & (~inner | ((dx.abs() > margin) & (dy.abs() > margin)))


# ------------------------------------------------------------ targets
def test_generate_target_matches_jax_at_negative_and_edge_coords(rng):
    """sigma 1 on a 16x16 map of a 64x64 crop (stride 4). Joint 0 lands at
    centre -4 (box right edge 0: weight kept, map all zero); joint 1 at
    centre -5 (edge -1: weight 0); joint 2 at x/stride + 0.5 = -0.7, where
    trunc gives 0 and floor would give -1; joint 3 at the far edge."""
    joints = rng.uniform(-8, 72, (2, 8, 2)).astype(np.float32)
    joints[:, 0] = [-20.0, 30.0]          # -5.0 + 0.5 -> trunc -4
    joints[:, 1] = [-24.0, 30.0]          # -6.0 + 0.5 -> trunc -5
    joints[:, 2] = [-4.8, 30.0]           # -1.2 + 0.5 = -0.7 -> 0
    joints[:, 3] = [62.5, 63.9]
    vis = (rng.uniform(size=(2, 8)) > 0.2).astype(np.float32)
    vis[:, :4] = 1.0
    for v in (vis, np.repeat(vis[..., None], 3, -1)):
        got, gw = thm.generate_target(torch.tensor(joints), torch.tensor(v),
                                      (16, 16), 1.0, (64, 64))
        want, ww = jhm.generate_target(joints, v, (16, 16), 1.0, (64, 64))
        assert got.shape == (2, 8, 16, 16)
        np.testing.assert_array_equal(gw.numpy(), np.asarray(ww))
        np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=0,
                                   atol=1e-7)
    assert gw[0, 0] == 1 and got[0, 0].abs().max() == 0
    assert gw[0, 1] == 0
    assert got[0, 2, 8, 0] == 1.0        # centre column 0, not -1


# ------------------------------------------------------------ decode
def _maps_with_ties(rng, dtype):
    hm = rng.normal(size=(3, 5, 8, 10)).astype(np.float32)
    hm[0, 0] = 0.25
    hm[0, 0, 3, 4] = hm[0, 0, 6, 1] = 2.0        # two equal maxima
    hm[0, 1] = -1.0                              # max < 0: coords zeroed
    hm[0, 2] = 0.0                               # max == 0: zeroed too
    hm[1] = np.round(hm[1] * 2) / 2              # many ties, bf16-exact
    return torch.tensor(hm).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_get_max_preds_ties_and_nonpositive_maxima(rng, dtype):
    hm = _maps_with_ties(rng, dtype)
    preds, maxvals = thm.get_max_preds(hm)
    jp, jm = jhm.get_max_preds(jnp.asarray(nhwc(hm)).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32))
    np.testing.assert_array_equal(preds.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(maxvals.float().numpy(),
                                  np.asarray(jm).astype(np.float32))
    assert preds[0, 0].tolist() == [4.0, 3.0]    # the first of the ties
    assert preds[0, 1].tolist() == preds[0, 2].tolist() == [0.0, 0.0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_post_process_at_the_borders(rng, dtype):
    """Peaks at x, y in {0, 1, 2, W-2, W-1}: the offset applies only
    strictly inside (1, W-1) x (1, H-1); equal neighbours give sign 0."""
    h, w = 8, 10
    spots = [(0, 0), (1, 1), (2, 2), (w - 2, h - 2), (w - 1, h - 1),
             (2, h - 2), (w - 2, 2), (5, 4)]
    hm = rng.uniform(0, 0.5, (2, len(spots), h, w)).astype(np.float32)
    for k, (x, y) in enumerate(spots):
        hm[:, k, y, x] = 3.0
    hm[1, -1, 4, 4] = hm[1, -1, 4, 6] = 1.0      # equal x-neighbours
    hm = torch.tensor(hm).to(dtype)
    preds, _ = thm.get_max_preds(hm)
    got = thm.post_process_preds(hm, preds)
    jmaps = jnp.asarray(nhwc(hm)).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = jhm.post_process_preds(jmaps, jhm.get_max_preds(jmaps)[0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    moved = (got - preds).abs().sum(-1) > 0
    assert moved[0].tolist() == [False, False, True, True, False, True,
                                 True, True]
    assert got[1, -1, 0] == 5.0                  # sign(0) = 0 in x


def test_get_final_preds_matches_jax(rng):
    hm = rng.normal(size=(3, 6, 16, 12)).astype(np.float32)
    center = rng.uniform(100, 400, (3, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (3, 2)).astype(np.float32)
    for post in (False, True):
        got, gm = thm.get_final_preds(torch.tensor(hm), torch.tensor(center),
                                      torch.tensor(scale), post)
        want, wm = jhm.get_final_preds(np.moveaxis(hm, 1, -1), center, scale,
                                       post)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-3)
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


# ----------------------------------------------------- loss and accuracy
def test_joints_mse_loss_and_make_loss(rng):
    out = rng.normal(size=(3, 5, 8, 8)).astype(np.float32)
    tgt = rng.uniform(size=(3, 5, 8, 8)).astype(np.float32)
    tw = (rng.uniform(size=(3, 5)) > 0.3).astype(np.float32)
    for w, use in ((tw, True), (None, True), (tw, False)):
        got = tloss.joints_mse_loss(torch.tensor(out), torch.tensor(tgt),
                                    None if w is None else torch.tensor(w),
                                    use)
        want = jloss.joints_mse_loss(np.moveaxis(out, 1, -1),
                                     np.moveaxis(tgt, 1, -1), w, use)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    cfg = load_config(DEBUG_2D)
    crit = tloss.make_loss(cfg)
    np.testing.assert_allclose(
        crit(torch.tensor(out), torch.tensor(tgt), torch.tensor(tw)).item(),
        float(jloss.joints_mse_loss(np.moveaxis(out, 1, -1),
                                    np.moveaxis(tgt, 1, -1), tw)), rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_heatmap_accuracy_matches_jax(rng, dtype):
    joints = rng.uniform(-4, 68, (4, 6, 2)).astype(np.float32)
    vis = np.ones((4, 6), np.float32)
    target, _ = thm.generate_target(torch.tensor(joints), torch.tensor(vis),
                                    (16, 16), 1.0, (64, 64))
    out = (target + 0.3 * torch.tensor(rng.normal(size=target.shape))
           .float()).to(dtype)
    acc, avg, cnt, pred = tmet.heatmap_accuracy(out, target)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jacc, javg, jcnt, jpred = jmet.heatmap_accuracy(
        jnp.asarray(nhwc(out)).astype(jdt), jnp.asarray(nhwc(target)))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    assert avg.item() == pytest.approx(float(javg), rel=1e-6)
    assert int(cnt) == int(jcnt)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    d = tmet._calc_dists(pred, pred, torch.full((4,), 1.6))
    jd = jmet._calc_dists(np.asarray(jpred), np.asarray(jpred),
                          np.full((4,), 1.6, np.float32))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tmet._dist_acc(d).numpy(),
                                  np.asarray(jmet._dist_acc(jd)))


# ------------------------------------------- gaussian train and eval steps
def _configs():
    cfgs = []
    for load in (jax_load_config, load_config):
        cfg = load(DEBUG_2D)
        cfg.TPU.COMPUTE_DTYPE = "float32"
        cfg.TRAIN.LR_STEP = [1, 2]
        cfg.TEST.FLIP_TEST = True
        cfg.TEST.SHIFT_HEATMAP = True
        cfgs.append(cfg)
    return cfgs


def _batch(seed, n=4, size=64, joints=16):
    r = np.random.default_rng(seed)
    return {"input": r.integers(0, 256, (n, size, size, 3), np.uint8),
            "joints": r.uniform(-6, size + 6, (n, joints, 2)).astype(
                np.float32),
            "joints_vis": (r.uniform(size=(n, joints)) > 0.1).astype(
                np.float32),
            "center": r.uniform(80, 400, (n, 2)).astype(np.float32),
            "scale": r.uniform(0.2, 0.6, (n, 2)).astype(np.float32)}


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def run2d():
    """Three gaussian train steps of both packages from the same weights
    (the JAX init with the head at std 0.05), then a flip-test eval batch
    on the trained weights."""
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(11)
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
    out = {"lr": float(jcfg.TRAIN.LR), "metrics": [], "jax": {}, "port": {}}
    for k in range(N_STEPS):
        batch = _batch(k)
        state, jm = jstep(state, batch)
        tstate, tm = tstep(tstate, batch)
        out["metrics"].append(({n: float(v) for n, v in tm.items()},
                               {n: float(v) for n, v in jm.items()}))
        if k == 0:
            out["jax_moment"] = from_jax_variables(
                {"params": _numpy(state.opt_state[0].mu)})
        if k + 1 in (1, N_STEPS):
            out["jax"][k + 1] = from_jax_variables(
                {"params": _numpy(state.params),
                 "batch_stats": _numpy(state.batch_stats)})
            out["port"][k + 1] = copy.deepcopy(model.state_dict())
    out["names"] = [n for n, _ in model.named_parameters()]
    out["steps"] = tstate.step

    # eval on the weights JAX trained, loaded into the port's model
    jeval = jax_make_eval_step(jcfg, jmodel, flip_pairs=MPII_FLIP_PAIRS)
    model.load_state_dict(out["jax"][N_STEPS])
    teval = make_eval_step(tcfg, model, MPII_FLIP_PAIRS, device="cpu")
    batch = _batch(9, n=6)
    out["eval_jax"] = _numpy(jeval(state, batch))
    out["eval_port"] = teval(batch)
    with torch.no_grad():
        x = normalize_images(torch.tensor(batch["input"]))
        x = x.permute(0, 3, 1, 2).contiguous()
        model.eval()
        maps = model(x)
        maps = (maps + shift_right(flip_back(model(x.flip(-1)),
                                             MPII_FLIP_PAIRS))) * 0.5
    out["eval_port_maps"] = maps
    return out


def test_gaussian_train_step_loss_and_acc_match_jax(run2d):
    assert run2d["steps"] == N_STEPS
    for k, (got, want) in enumerate(run2d["metrics"]):
        assert sorted(got) == sorted(want) == ["acc", "loss"]
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=1e-5 if k == 0 else 1e-4)
        assert got["acc"] == want["acc"]
    losses = [g["loss"] for g, _ in run2d["metrics"]]
    assert all(np.isfinite(losses))


@pytest.mark.parametrize("after", [1, N_STEPS])
def test_gaussian_train_step_params_match_jax(run2d, after):
    """Adam: every entry within 2*lr summed over the steps; after step 1
    every entry whose JAX gradient is at least 1e-6 to 1e-6 (Adam's first
    update is about lr*sign(g), test_torch_train_step.py). BN statistics
    to 1e-4 of each tensor's largest after step 1, 1e-2 after 3."""
    got, want = run2d["port"][after], run2d["jax"][after]
    rates = [run2d["lr"] * 0.1 ** k for k in range(after)]
    for name in run2d["names"]:
        diff = (got[name] - want[name]).abs()
        assert diff.max().item() <= 2 * sum(rates), name
        if after == 1:
            steady = (run2d["jax_moment"][name] * 10.0).abs() >= 1e-6
            if steady.any():
                assert diff[steady].max().item() <= 1e-6, name
    tol = 1e-4 if after == 1 else 1e-2
    for name, v in want.items():
        if "running" in name:
            torch.testing.assert_close(got[name], v, rtol=0,
                                       atol=tol * v.abs().max().item())


def test_gaussian_eval_step_flip_test_matches_jax(run2d):
    jout, tout = run2d["eval_jax"], run2d["eval_port"]
    maps = nchw(jout["loss_out"])
    gap = (run2d["eval_port_maps"] - maps).abs().max().item()
    assert gap <= 1e-4 * maps.abs().max().item()
    keep = decisive(maps, 2 * gap)
    n_left_out = int((~keep).sum())
    # near-ties are counted, never hidden: none of the 96 joints on these
    # inputs (a change in that count fails here, to be looked at)
    assert n_left_out == 0, n_left_out
    preds, maxvals = tout["preds"], tout["maxvals"]
    assert preds.shape == (6, 16, 2) and maxvals.shape == (6, 16)
    np.testing.assert_allclose(maxvals.numpy(), jout["maxvals"], rtol=0,
                               atol=2 * gap)
    np.testing.assert_allclose(preds.numpy()[keep.numpy()],
                               jout["preds"][keep.numpy()], rtol=0,
                               atol=1e-4)
    assert np.ptp(jout["preds"][..., 0]) > 1.0
