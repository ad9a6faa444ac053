"""The port's evaluation vs the JAX package's, on the same numbers.

- Procrustes: ``tests/test_procrustes.py``'s cases on the port (1e-3
  against the truth, as there) and the port against JAX on random poses
  (s, R, t within 1e-4; the float32 SVDs differ in the last bits).
- ``pck``, ``pckh``, ``pa_mpjpe``: against JAX at rtol 1e-5 (float32 sums
  in another order).
- ``kmeans`` from the same start: equal assignments, centres within 1e-6
  (JAX sums a cluster by a matmul, the port by ``index_add_``). ``pss`` on
  the same centres: equal. The start itself comes from each package's
  own generator (``jax.random.choice`` cannot be reproduced in torch), so
  H36M's PSS is held to JAX through a shared ``pss_centers_k{k}_v2.npy``.
- ``H36MDataset.evaluate`` with cameras (undistort, then ``pixel2cam``)
  and without, and ``MPIIDataset.evaluate`` on the json and the
  ``gt_valid.mat`` routes: the same keys, values at rtol 1e-5.
"""

import json
import pathlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from epipolarpose_tpu.config import load_config as jax_load_config
from epipolarpose_tpu.data import h36m as jh36m
from epipolarpose_tpu.data import mpii as jmpii
from epipolarpose_tpu.data import synthetic as jsyn
from epipolarpose_tpu.geometry import procrustes as jproc
from epipolarpose_tpu.ops import metrics as jm
from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.data import h36m as th36m
from epipolarpose_tpu_torch.data import mpii as tmpii
from epipolarpose_tpu_torch.data import synthetic as tsyn
from epipolarpose_tpu_torch.geometry import procrustes as tproc
from epipolarpose_tpu_torch.ops import metrics as tm

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEBUG_3D = ROOT / "experiments/debug/synth_smoke_3d.yaml"


def _t(x):
    return torch.as_tensor(np.array(x))


def _rotation(rng):
    R, _ = cv2.Rodrigues(rng.standard_normal(3))
    return R.astype(np.float32)


# ------------------------------------------------------------ procrustes
@pytest.mark.parametrize("case", ["exact", "parameters", "reflection",
                                  "batched", "scipy"])
def test_procrustes_cases(case, rng):
    """The cases of tests/test_procrustes.py, run on the port."""
    X = rng.standard_normal((17, 3)).astype(np.float32)
    R = _rotation(rng)
    if case == "exact":
        t = rng.standard_normal(3).astype(np.float32)
        Y = 1.7 * X @ R.T + t
        np.testing.assert_allclose(
            tproc.procrustes_align(_t(X), _t(Y)).numpy(), Y, atol=1e-3)
    elif case == "parameters":
        Y = 2.0 * X @ R.T + np.array([1, 2, 3], np.float32)
        s, Rr, _ = tproc.compute_similarity_transform(_t(X), _t(Y))
        np.testing.assert_allclose(float(s), 2.0, atol=1e-3)
        np.testing.assert_allclose(Rr.numpy(), R.T, atol=1e-3)
    elif case == "reflection":
        Y = X.copy()
        Y[:, 0] *= -1
        _, Rr, _ = tproc.compute_similarity_transform(_t(X), _t(Y))
        assert np.linalg.det(Rr.numpy()) > 0
    elif case == "batched":
        Xb = rng.standard_normal((8, 17, 3)).astype(np.float32)
        Y = 1.3 * Xb @ R.T + 0.5
        np.testing.assert_allclose(
            tproc.procrustes_align(_t(Xb), _t(Y)).numpy(), Y, atol=1e-3)
    else:
        from scipy.linalg import orthogonal_procrustes
        X64 = X.astype(np.float64)
        Y = X64 @ R.astype(np.float64).T
        Rs, _ = orthogonal_procrustes(X64, Y)
        _, Rr, _ = tproc.compute_similarity_transform(
            _t(X64.astype(np.float32)), _t(Y.astype(np.float32)))
        np.testing.assert_allclose(Rr.numpy(), Rs, atol=1e-3)


def test_procrustes_matches_jax(rng):
    X = rng.standard_normal((32, 17, 3)).astype(np.float32) * 300
    Y = X @ _rotation(rng).T * 1.1 + rng.normal(0, 40, X.shape).astype(
        np.float32)
    Y[0, :, 0] *= -1                          # one near-reflection
    got = tproc.compute_similarity_transform(_t(X), _t(Y))
    want = jproc.compute_similarity_transform(X, Y)
    for g, w, name in zip(got, want, "sRt"):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    np.testing.assert_allclose(
        tproc.procrustes_align(_t(X), _t(Y)).numpy(),
        np.asarray(jproc.procrustes_align(X, Y)), rtol=1e-4, atol=1e-2)


# ----------------------------------------------------------------- metrics
def test_pck_pckh_pa_mpjpe_match_jax(rng):
    pred2 = rng.uniform(0, 64, (12, 16, 2)).astype(np.float32)
    gt2 = (pred2 + rng.normal(0, 4, pred2.shape)).astype(np.float32)
    gt2[0, :3] = 0.5                           # invalid targets
    norm = rng.uniform(5, 15, (12,)).astype(np.float32)
    vis = (rng.uniform(size=(12, 16)) > 0.2).astype(np.float32)
    np.testing.assert_allclose(
        tm.pck(_t(pred2), _t(gt2), _t(norm)).numpy(),
        np.asarray(jm.pck(pred2, gt2, norm)), rtol=1e-5)
    for v in (None, vis):
        got = tm.pckh(_t(pred2), _t(gt2), _t(norm),
                      None if v is None else _t(v))
        want = jm.pckh(pred2, gt2, norm, v)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    pred3 = rng.normal(0, 300, (10, 17, 3)).astype(np.float32)
    gt3 = (pred3 + rng.normal(0, 30, pred3.shape)).astype(np.float32)
    vis3 = (rng.uniform(size=(10, 17)) > 0.2).astype(np.float32)
    for v in (None, vis3):
        np.testing.assert_allclose(
            float(tm.pa_mpjpe(_t(pred3), _t(gt3),
                              None if v is None else _t(v))),
            float(jm.pa_mpjpe(pred3, gt3, v)), rtol=1e-5)


def _poses(rng, n=120, j=17):
    base = rng.normal(0, 200, (4, j, 3))
    pick = rng.integers(0, 4, n)
    return (base[pick] + rng.normal(0, 40, (n, j, 3))).astype(np.float32)


def test_kmeans_and_pss_match_jax_from_the_same_start(rng):
    poses = _poses(rng)
    emb = np.asarray(jm._pose_embed(poses))
    np.testing.assert_allclose(tm._pose_embed(_t(poses)).numpy(), emb,
                               rtol=1e-6, atol=1e-7)
    key = jax.random.PRNGKey(0)
    init = np.asarray(jax.random.choice(key, len(emb), (8,), replace=False))
    jc, ja = jm.kmeans(key, jnp.asarray(emb), 8)
    tc, ta = tm.kmeans(_t(emb), 8, init=torch.as_tensor(np.array(init)))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    pred = (poses + rng.normal(0, 60, poses.shape)).astype(np.float32)
    assert float(tm.pss(_t(pred), _t(poses), tc)) == pytest.approx(
        float(jm.pss(pred, poses, jc)))
    # the port's own start, from a generator: the same on every call
    a = tm.fit_pss_centers(torch.Generator().manual_seed(0), _t(poses), k=8)
    b = tm.fit_pss_centers(torch.Generator().manual_seed(0), _t(poses), k=8)
    assert a.shape == (8, 51) and torch.equal(a, b)
    with pytest.raises(ValueError, match="at least"):
        tm.kmeans(_t(emb[:3]), 8)


# ---------------------------------------------------------------- evaluate
def _cfgs():
    return jax_load_config(DEBUG_3D), load_config(DEBUG_3D)


def _h36m_preds(ds, rng):
    """Eval-step output space for the dataset's records: (x, y) source px
    and root-relative z, with noise."""
    px = np.stack([r.joints for r in ds.records])
    z = np.stack([r.joints_3d[:, 2] - r.joints_3d[0, 2]
                  for r in ds.records])
    preds = np.concatenate([px, z[..., None]], axis=-1)
    noise = np.concatenate([rng.normal(0, 3, px.shape),
                            rng.normal(0, 40, z.shape)[..., None]], -1)
    return (preds + noise).astype(np.float32)


@pytest.fixture(scope="module")
def h36m_tree(tmp_path_factory):
    """An H36M tree of 30 frames (120 records) from the JAX writer, with
    PSS centres for k = 50 and 100 fit by JAX on its train split and
    cached where both packages read them."""
    root = tmp_path_factory.mktemp("h36m")
    cfg, _ = _cfgs()
    jsyn.write_synthetic_h36m(str(root), cfg, num_frames=30,
                              camera_ids=jh36m.CAMERA_IDS)
    # bigger than 2k: both k fit on the train split
    train = json.loads((root / "annot/train.json").read_text())
    (root / "annot/train.json").write_text(json.dumps(train * 2))
    ds = jh36m.H36MDataset(cfg, str(root), "valid", is_train=False)
    for k in (50, 100):
        assert ds.pss_centers(k) is not None
        assert (root / f"annot/pss_centers_k{k}_v2.npy").exists()
    return root


@pytest.mark.parametrize("cameras", [True, False])
def test_h36m_evaluate_matches_jax(h36m_tree, cameras, tmp_path, rng):
    import shutil
    root = h36m_tree
    if not cameras:
        root = tmp_path / "h36m"
        shutil.copytree(h36m_tree, root)
        (root / "annot/cameras.json").unlink()
    jcfg, tcfg = _cfgs()
    jd = jh36m.H36MDataset(jcfg, str(root), "valid", is_train=False)
    td = th36m.H36MDataset(tcfg, str(root), "valid", is_train=False)
    preds = _h36m_preds(jd, rng)
    if not cameras:                  # then preds are camera-frame mm
        preds = np.stack([r.joints_3d for r in jd.records]) + rng.normal(
            0, 30, (len(jd), 17, 3)).astype(np.float32)
    (jn, jmean), (tn, tmean) = (jd.evaluate(jcfg, preds),
                                td.evaluate(tcfg, preds))
    assert list(tn) == list(jn)
    assert {"Synth", "MPJPE", "NMPJPE", "PA-MPJPE", "PSS@50",
            "PSS@100"} <= set(tn)
    for k in jn:
        assert tn[k] == pytest.approx(jn[k], rel=1e-5), k
    assert tmean == pytest.approx(jmean, rel=1e-5)
    assert td.perf_higher_is_better is False


def test_synthetic_multiview_evaluate_matches_jax(rng):
    """Cameras and absolute depths: the undistort + pixel2cam branch, with
    the port's and JAX's own float32 records (a few float32 spacings
    apart); PSS@50 from each package's own fit on the eval poses is
    reported by both, not compared."""
    jcfg, tcfg = _cfgs()
    kw = dict(num_frames=26, image_shape=(64, 64), seed=2,
              pose_mode="skeleton")
    jd = jsyn.SyntheticMultiviewDataset(jcfg, **kw)
    td = tsyn.SyntheticMultiviewDataset(tcfg, **kw)
    preds = _h36m_preds(jd, rng)
    jn, _ = jd.evaluate(jcfg, preds)
    tn, _ = td.evaluate(tcfg, preds)
    assert list(tn) == list(jn) == ["Synth", "MPJPE", "NMPJPE", "PA-MPJPE",
                                    "PSS@50"]
    for k in ("Synth", "MPJPE", "NMPJPE", "PA-MPJPE"):
        assert tn[k] == pytest.approx(jn[k], rel=1e-5), k
    assert 0.0 <= tn["PSS@50"] <= 1.0


@pytest.mark.parametrize("route", ["json", "mat"])
def test_mpii_evaluate_matches_jax(route, tmp_path, rng):
    jcfg, tcfg = _cfgs()
    for cfg in (jcfg, tcfg):
        cfg.MODEL.NUM_JOINTS = 16
    jsyn.write_synthetic_mpii(str(tmp_path), jcfg, num_samples=12)
    jd = jmpii.MPIIDataset(jcfg, str(tmp_path), "valid", is_train=False)
    gts = np.stack([r.joints for r in jd.records])
    preds = (gts + rng.normal(0, 8, gts.shape)).astype(np.float32)
    if route == "mat":
        n = len(gts)
        headbox = np.stack([gts[:, 9] - 10, gts[:, 9] + 10])      # (2, N, 2)
        scipy.io.savemat(str(tmp_path / "annot/gt_valid.mat"), {
            "jnt_missing": (rng.uniform(size=(16, n)) < 0.1).astype(float),
            "pos_gt_src": gts.transpose(1, 2, 0),
            "headboxes_src": headbox.transpose(0, 2, 1)})
        jd = jmpii.MPIIDataset(jcfg, str(tmp_path), "valid", is_train=False)
    td = tmpii.MPIIDataset(tcfg, str(tmp_path), "valid", is_train=False)
    (jn, jmean), (tn, tmean) = jd.evaluate(jcfg, preds), td.evaluate(tcfg,
                                                                      preds)
    assert list(tn) == list(jn)
    for k in jn:
        assert tn[k] == pytest.approx(jn[k], rel=1e-5), k
    assert tmean == pytest.approx(jmean, rel=1e-5)
    assert 0 < tmean < 100
