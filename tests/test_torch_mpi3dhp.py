"""The port's MPI-INF-3DHP reader and transfer evaluation vs the JAX
package's.

- Every case of ``tests/test_mpi3dhp.py`` on the port, against the JAX
  function on the same inputs: the joint map, the intrinsics fit, the
  v5, v7.3 and row-major v7.3 trees (records equal, intrinsics within
  1e-6 relative), ``_canon_annot`` (equal arrays, the same errors) and
  ``evaluate`` on perfect and random predictions (the same keys, values
  within 1e-4).
- ``pck3d`` and ``auc3d`` against JAX on seeded random arrays (within
  1e-4 percent: both count joints under each threshold in float32).
- The batches of a tree whose frames are OpenCV-written renders (2048 x
  2048 and 1920 x 1080, the dataset's two frame sizes): the port with
  its native loader off (its own JPEG decoder and ``warp_affine_u8``,
  the card's route) against JAX with its native loader off (OpenCV's
  decode and ``warpAffine``): within one grey level, and equal bits
  outside the last W mod 16 columns (OpenCV's scalar tail). With the
  native loader on, on both sides (the port's own decoder, no libjpeg,
  against the JAX package's libjpeg): equal, on that tree (64 px crops
  pick the DCT scale 2/8) and on a progressive twin at 64, 128 and 256 px
  crops (2/8, 3/8, 8/8).
- ``scripts.valid.main`` with ``--device cpu`` on
  ``valid_3dhp_transfer.yaml`` cut to the debug width, against JAX
  ``validate`` with the same weights (``from_jax_variables``), the
  native loader off on both sides, and on both sides on: PCK3D@150 and
  AUC within one joint's share, MPJPE within 1e-4 relative (the crops
  are equal at 64 px).
"""

import pathlib
import shutil
import sys
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import jpeg_fixtures as jf
from epipolarpose_tpu.config import load_config as jax_load_config
from epipolarpose_tpu.core import function as jfunction
from epipolarpose_tpu.core.steps import make_eval_step as jax_make_eval_step
from epipolarpose_tpu.data import fastloader as jfast
from epipolarpose_tpu.data import mpi3dhp as jm
from epipolarpose_tpu.data.pipeline import epoch_loader as jax_epoch_loader
from epipolarpose_tpu.models import get_model as jax_get_model
from epipolarpose_tpu.models import init_pose_net
from epipolarpose_tpu.ops import metrics as jmetrics
from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.data import fastloader as tfast
from epipolarpose_tpu_torch.data import get_dataset
from epipolarpose_tpu_torch.data import jpeg
from epipolarpose_tpu_torch.data import mpi3dhp as tm
from epipolarpose_tpu_torch.models import from_jax_variables
from epipolarpose_tpu_torch.ops import metrics as tmetrics
from epipolarpose_tpu_torch.scripts import valid as valid_cli
from test_torch_checkpoint import quiet_cli

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEBUG_3D = ROOT / "experiments/debug/synth_smoke_3d.yaml"
TRANSFER = ROOT / "experiments/h36m/valid_3dhp_transfer.yaml"
RECORD_FIELDS = ("center", "scale", "joints", "joints_vis", "joints_3d")


def _configs():
    return jax_load_config(DEBUG_3D), load_config(DEBUG_3D)


def _datasets(root, **tpu):
    out = []
    for (cfg, mod) in zip(_configs(), (jm, tm)):
        for k, v in tpu.items():
            cfg.TPU[k] = v
        out.append(mod.MPI3DHPDataset(cfg, str(root), "test",
                                      is_train=False))
    return out


def _assert_same_records(jd, td):
    assert len(td) == len(jd)
    for a, b in zip(jd.records, td.records):
        assert b.image == a.image and b.meta == a.meta
        for f in RECORD_FIELDS:
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f),
                                          err_msg=f)
    assert list(td.intrinsics) == list(jd.intrinsics)
    for seq in jd.intrinsics:
        np.testing.assert_allclose(td.intrinsics[seq], jd.intrinsics[seq],
                                   rtol=1e-6)


# ------------------------------------------ the cases of test_mpi3dhp.py
def test_constants_match_jax():
    assert sorted(tm.H36M_TO_3DHP) == list(range(17))
    assert tm.H36M_TO_3DHP == jm.H36M_TO_3DHP
    assert tm.ROOT_IDX == jm.ROOT_IDX
    assert tm.FLIP_PAIRS_3DHP == jm.FLIP_PAIRS_3DHP
    assert tm.MPI3DHPDataset.flip_pairs == jm.MPI3DHPDataset.flip_pairs
    assert tm.MPI3DHPDataset.perf_higher_is_better is True


def test_intrinsics_fit_matches_jax(rng):
    fx, fy, cx, cy = 1480.0, 1475.0, 1000.0, 990.0
    p3 = rng.uniform(-500, 500, (200, 3)).astype(np.float32)
    p3[:, 2] += 4000.0
    px = np.stack([fx * p3[:, 0] / p3[:, 2] + cx,
                   fy * p3[:, 1] / p3[:, 2] + cy], axis=1)
    got = tm.fit_pinhole_intrinsics(px, p3)
    np.testing.assert_allclose(got, (fx, fy, cx, cy), rtol=1e-4)
    assert got == jm.fit_pinhole_intrinsics(px, p3)


@pytest.mark.parametrize("fmt", ["v5", "v73", "v73_rowmajor"])
def test_reader_matches_jax(fmt, tmp_path):
    jm.write_synthetic_3dhp(str(tmp_path / "j"), num_frames=6, seed=3,
                            fmt=fmt)
    tm.write_synthetic_3dhp(str(tmp_path / "t"), num_frames=6, seed=3,
                            fmt=fmt)
    jd, td = _datasets(tmp_path / "j")
    assert len(td) == 10                   # 2 sequences x 5 valid frames
    _assert_same_records(jd, td)
    # the port's writer writes what JAX's writes: the port reads it alike
    _, td2 = _datasets(tmp_path / "t")
    for a, b in zip(td.records, td2.records):
        for f in RECORD_FIELDS:
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))


def test_all_layouts_read_alike(tmp_path):
    trees = {}
    for fmt in ("v5", "v73", "v73_rowmajor"):
        tm.write_synthetic_3dhp(str(tmp_path / fmt), num_frames=6, seed=3,
                                fmt=fmt)
        trees[fmt] = _datasets(tmp_path / fmt)[1]
    for fmt in ("v73", "v73_rowmajor"):
        for a, b in zip(trees["v5"].records, trees[fmt].records):
            np.testing.assert_allclose(a.joints, b.joints, rtol=1e-6)
            np.testing.assert_allclose(a.joints_3d, b.joints_3d, rtol=1e-6)


def _canon_case(name):
    a3 = np.arange(5 * 17 * 3, dtype=np.float32).reshape(5, 17, 3)
    a2 = np.arange(17 * 17 * 2, dtype=np.float32).reshape(17, 17, 2)
    return {"v5_4d": (a3[:, None], 3), "reversed": (a3.transpose(2, 1, 0), 3),
            "odd_permutation": (a3.transpose(1, 0, 2)[:, None], 3),
            "one_frame": (a3[2], 3),
            "17_frames_reversed": (a2.transpose(2, 1, 0), 2),
            "no_joint_axis": (np.zeros((4, 16, 3), np.float32), 2)}[name]


@pytest.mark.parametrize("name", ["v5_4d", "reversed", "odd_permutation",
                                  "one_frame", "17_frames_reversed",
                                  "no_joint_axis"])
def test_canon_annot_matches_jax(name):
    a, k = _canon_case(name)
    if name == "no_joint_axis":
        for mod in (jm, tm):
            with pytest.raises(ValueError):
                mod._canon_annot(a, k)
        return
    want = jm._canon_annot(a, k)
    np.testing.assert_array_equal(tm._canon_annot(a, k), want)


@pytest.mark.parametrize("thresh", [50.0, 150.0, 400.0])
def test_pck3d_auc3d_match_jax(thresh, rng):
    gt = rng.uniform(-500, 500, (64, 17, 3)).astype(np.float32)
    pred = gt + rng.normal(0, 120, gt.shape).astype(np.float32)
    t = [torch.from_numpy(x) for x in (pred, gt)]
    j = [jnp.asarray(x) for x in (pred, gt)]
    assert float(tmetrics.pck3d(*t, thresh)) == pytest.approx(
        float(jmetrics.pck3d(*j, thresh)), abs=1e-4)
    assert float(tmetrics.auc3d(*t, thresh)) == pytest.approx(
        float(jmetrics.auc3d(*j, thresh)), abs=1e-4)


@pytest.fixture(scope="module")
def tree8(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree8")
    jm.write_synthetic_3dhp(str(root), num_frames=8)
    return root


def test_perfect_transfer_eval_matches_jax(tree8):
    jd, td = _datasets(tree8)
    assert len(td) == 14 and set(td.intrinsics) == {"TS1", "TS2"}
    inv = np.argsort(np.asarray(tm.H36M_TO_3DHP))  # 3DHP -> H36M places
    preds = np.zeros((len(td), 17, 3), np.float32)
    for i, r in enumerate(td.records):
        z_rel = r.joints_3d[:, 2] - r.joints_3d[td.root_idx, 2]
        preds[i] = np.concatenate([r.joints, z_rel[:, None]], -1)[inv]
    jn, jperf = jd.evaluate(jd.cfg, preds)
    tn, tperf = td.evaluate(td.cfg, preds)
    assert tperf == 100.0 and tn["AUC"] > 95.0 and tn["MPJPE"] < 0.5, tn
    assert list(tn) == list(jn) == ["PCK3D@150", "AUC", "MPJPE"]
    for k in jn:
        assert tn[k] == pytest.approx(jn[k], abs=1e-4), k
    assert tperf == jperf


def test_random_preds_score_low_as_in_jax(tmp_path, rng):
    jm.write_synthetic_3dhp(str(tmp_path), num_frames=4, seed=1)
    jd, td = _datasets(tmp_path)
    preds = rng.uniform(0, 2048, (len(td), 17, 3)).astype(np.float32)
    preds[..., 2] = rng.uniform(-400, 400, (len(td), 17))
    jn, jperf = jd.evaluate(jd.cfg, preds)
    tn, tperf = td.evaluate(td.cfg, preds)
    assert tperf < 50.0
    for k in jn:
        assert tn[k] == pytest.approx(jn[k], rel=1e-4, abs=1e-4), k


def test_registry_builds_the_3dhp_dataset(tree8):
    _, cfg = _configs()
    cfg.DATASET.DATASET = "mpi_inf_3dhp"
    cfg.DATASET.ROOT = str(tree8)
    ds = get_dataset(cfg, "test", False)
    assert isinstance(ds, tm.MPI3DHPDataset) and len(ds) == 14


def test_v73_without_h5py_names_it(tmp_path, monkeypatch):
    tm.write_synthetic_3dhp(str(tmp_path), num_frames=4, fmt="v73")
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py reads v7.3"):
        tm._load_annot_mat(str(tmp_path / "TS1" / "annot_data.mat"))


# ------------------------------------------------- JPEG frames, batches
@pytest.fixture(scope="module")
def frames_tree(tmp_path_factory):
    """A v5 tree of 2 x 8 frames whose JPEGs are OpenCV-written renders:
    TS1 2048 x 2048 (studio), TS2 1920 x 1080 (outdoor), one file a
    sequence copied to each of its frames."""
    root = tmp_path_factory.mktemp("frames")
    jm.write_synthetic_3dhp(str(root), num_frames=8, seed=5)
    for ts, (h, w) in ((1, (2048, 2048)), (2, (1080, 1920))):
        buf = jf.cv2_encode(jf.render(h, w, seed=ts), 90)
        for f in range(8):
            (root / f"TS{ts}" / "imageSequence" / f"img_{f + 1:06d}.jpg"
             ).write_bytes(buf)
    return root


def _batches(root, size, native):
    jd, td = _datasets(root, NATIVE_LOADER=native)
    for d in (jd, td):
        d.image_size = size
    return jd.get_batch(list(range(len(jd))), seed=0), \
        td.get_batch(list(range(len(td))), seed=0)


def test_batches_without_the_native_loader_match_jax(frames_tree,
                                                     monkeypatch):
    """The card's route: the port's decoder (every frame through it, none
    through OpenCV) against OpenCV's decode and warp."""
    monkeypatch.setattr(tfast, "available", lambda: False)
    jpeg.reset_count()
    W = 72                                  # 8 columns in OpenCV's tail
    jb, tb = _batches(frames_tree, (W, W), native=False)
    assert jpeg.decode_count() == 14
    assert sorted(tb) == sorted(jb)
    for k in jb:
        if k != "input":
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    a, b = jb["input"].astype(int), tb["input"].astype(int)
    assert a.shape == (14, W, W, 3) and a.std() > 10
    tail = W - W % 16
    np.testing.assert_array_equal(b[:, :, :tail], a[:, :, :tail])
    assert np.abs(b - a).max() <= 1


def test_batches_with_the_native_loader_match_jax(frames_tree):
    if not (jfast.available() and tfast.available()):
        pytest.skip("no g++ or jpeglib.h: the native loader cannot build")
    jb, tb = _batches(frames_tree, (64, 64), native=True)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


@pytest.fixture(scope="module")
def progressive_tree(frames_tree, tmp_path_factory):
    """``frames_tree`` with progressive frames (OpenCV's scans)."""
    root = tmp_path_factory.mktemp("progressive")
    shutil.copytree(frames_tree, root, dirs_exist_ok=True)
    for ts, (h, w) in ((1, (2048, 2048)), (2, (1080, 1920))):
        buf = jf.cv2_encode(jf.render(h, w, seed=ts), 90, progressive=True)
        for f in range(8):
            (root / f"TS{ts}" / "imageSequence" / f"img_{f + 1:06d}.jpg"
             ).write_bytes(buf)
    return root


@pytest.mark.parametrize("crop,scale_num", [(64, 2), (128, 3), (256, 8)])
def test_progressive_batches_with_the_native_loader_match_jax(
        progressive_tree, crop, scale_num):
    """The port's decoder in its loader against libjpeg on progressive
    2048 x 2048 and 1920 x 1080 frames, at crops whose boxes pick the DCT
    scales 2/8, 3/8 and 8/8."""
    if not jfast.available():
        pytest.skip("no jpeglib.h: the JAX native loader cannot build")
    tfast.reset_counts()
    jb, tb = _batches(progressive_tree, (crop, crop), native=True)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    assert tfast.decode_counts() == {"scale": {scale_num: 14}, "failed": 0,
                                     "unsupported": 0, "warned": 0}


# ------------------------------------------------------ the valid CLI
class _State(NamedTuple):
    params: dict
    batch_stats: dict


def test_valid_cli_matches_jax_validate(frames_tree, tmp_path, monkeypatch):
    """``valid_3dhp_transfer.yaml`` at the debug width (ResNet-18, 64 px,
    DEPTH_DIM 8, flip test), float32, the same weights on both sides; the
    port's decoder on the pool route against OpenCV's."""
    monkeypatch.setattr(tfast, "available", lambda: False)
    _valid_case(frames_tree, tmp_path, native=False)


def test_valid_cli_with_the_native_loader_matches_jax_validate(
        frames_tree, tmp_path):
    """The same with ``TPU.NATIVE_LOADER: true`` on both sides: the port's
    loader (its decoder at 1/8 and 2/8, no libjpeg) against the JAX
    package's (libjpeg); every frame through the loader."""
    if not jfast.available():
        pytest.skip("no jpeglib.h: the JAX native loader cannot build")
    _valid_case(frames_tree, tmp_path, native=True)


def _valid_case(frames_tree, tmp_path, native: bool):
    cfg = yaml.safe_load(TRANSFER.read_text())
    debug = yaml.safe_load(DEBUG_3D.read_text())
    cfg["MODEL"] = debug["MODEL"]
    cfg["DATASET"]["ROOT"] = str(frames_tree)
    cfg["TEST"]["BATCH_SIZE"] = 8
    cfg["WORKERS"] = 2
    cfg["TPU"] = {"COMPUTE_DTYPE": "float32", "NATIVE_LOADER": native}
    cfg_path = tmp_path / "valid_3dhp_debug.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))

    jcfg = jax_load_config(cfg_path)
    jmodel = jax_get_model(jcfg)
    params, stats = init_pose_net(jmodel, jax.random.PRNGKey(0), (64, 64))
    params = jax.tree.map(np.asarray, params)
    stats = jax.tree.map(np.asarray, stats)
    rng = np.random.default_rng(3)
    for name in ("deconv1", "deconv2", "deconv3", "final_layer"):
        k = params[name]["kernel"]
        params[name]["kernel"] = rng.normal(0, 0.05, k.shape).astype(
            np.float32)
    weights = tmp_path / "weights.pth"
    torch.save(from_jax_variables({"params": params, "batch_stats": stats}),
               weights)

    jds = jm.MPI3DHPDataset(jcfg, str(frames_tree), "test", is_train=False)
    jstep = jax_make_eval_step(jcfg, jmodel, flip_pairs=jds.flip_pairs)
    jn, jperf = jfunction.validate(
        jcfg, jax_epoch_loader(jds, 8, 0, is_train=False), jds,
        _State(params, stats), jstep)

    jpeg.reset_count()
    tfast.reset_counts()
    with quiet_cli():
        perf = valid_cli.main(["--cfg", str(cfg_path), "--model-file",
                               str(weights), "--device", "cpu",
                               "--modelDir", str(tmp_path / "out"),
                               "--logDir", str(tmp_path / "log")])
    # 14 frames + the padded 2, through the decoder or the loader
    native_counts = tfast.decode_counts()
    if native:
        assert jpeg.decode_count() == 0 and native_counts["failed"] == 0
        assert sum(native_counts["scale"].values()) == 16
        assert set(native_counts["scale"]) <= {1, 2}
    else:
        assert jpeg.decode_count() == 16
        assert native_counts == {"scale": {}, "failed": 0, "unsupported": 0,
                                 "warned": 0}
    preds = np.load(next((tmp_path / "out").rglob("pred.npz")))["preds"]
    _, tcfg = _configs()
    tcfg.DATASET.MAP_H36M_JOINTS = True
    tn, tperf = tm.MPI3DHPDataset(tcfg, str(frames_tree), "test",
                                  is_train=False).evaluate(tcfg, preds)
    assert tperf == perf and 0.0 <= perf <= 100.0
    assert list(tn) == list(jn)
    one_joint = 100.0 / (len(jds) * 17)
    assert tn["PCK3D@150"] == pytest.approx(jn["PCK3D@150"], abs=one_joint)
    assert tn["AUC"] == pytest.approx(jn["AUC"], abs=one_joint)
    assert tn["MPJPE"] == pytest.approx(jn["MPJPE"], rel=1e-4)
    shutil.rmtree(tmp_path / "out", ignore_errors=True)
