"""The port's host data layer vs OpenCV and the JAX package's.

- ``imgproc.warp_affine_u8`` vs ``cv2.warpAffine(INTER_LINEAR)`` on uint8:
  OpenCV (5.0 here; 4.11 and later) computes it in float32 with fused
  multiply-adds, which the port reproduces: equal bits in every column
  but the last W mod 16 of a row, which OpenCV computes in a scalar tail
  that rounds otherwise: there within one grey level. Held on the cases
  of ``tests/test_warp.py`` and on 20 seeded random warps.
- ``imgproc.resize_bilinear_u8`` vs ``cv2.resize(INTER_LINEAR)``: OpenCV
  rounds its weights to 1/2048 and the port does not: within one grey
  level.
- The native loader: the port's build (no ``-march``) against the JAX
  package's (``-march=native``): uint8 crops bit for bit; float32 crops
  within one float32 spacing at 1.0 (the JAX build fuses multiply-adds).
- The synthetic datasets: the port projects the rig in float32 torch and
  the JAX package in float32 XLA, a few float32 spacings apart: records
  within 1e-4 absolute or 1e-6 relative, images within one grey level at
  a few pixels. From the same records, images, crops (64 px wide: exact),
  augmentation affines, flips and cameras are equal.
- On-disk trees written by the JAX writers: records, view groups and
  batches equal.
"""

import json
import os
import pathlib
import sys
import zipfile

import cv2
import numpy as np
import pytest
import torch

from epipolarpose_tpu.config import load_config as jax_load_config
from epipolarpose_tpu.data import fastloader as jfast
from epipolarpose_tpu.data import h36m as jh36m
from epipolarpose_tpu.data import mpii as jmpii
from epipolarpose_tpu.data import synthetic as jsyn
from epipolarpose_tpu.data import zipreader as jzip
from epipolarpose_tpu.geometry.affine import get_affine_transform_np
from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.data import fastloader as tfast
from epipolarpose_tpu_torch.data import get_dataset
from epipolarpose_tpu_torch.data import h36m as th36m
from epipolarpose_tpu_torch.data.mpi3dhp import (MPI3DHPDataset,
                                                 write_synthetic_3dhp)
from epipolarpose_tpu_torch.data import mpii as tmpii
from epipolarpose_tpu_torch.data import synthetic as tsyn
from epipolarpose_tpu_torch.data import zipreader as tzip
from epipolarpose_tpu_torch.data.imgproc import (resize_bilinear_u8,
                                                 warp_affine_u8)

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEBUG_3D = ROOT / "experiments/debug/synth_smoke_3d.yaml"
RECORD_FIELDS = ("center", "scale", "joints", "joints_vis", "joints_3d")


def _configs(**dataset):
    """The debug 3D config for both packages (64 px crops, 17 joints),
    with flips on so that the augmentation draws them."""
    out = []
    for load in (jax_load_config, load_config):
        cfg = load(DEBUG_3D)
        cfg.DATASET.FLIP = True
        for k, v in dataset.items():
            cfg.DATASET[k] = v
        out.append(cfg)
    return out


def _assert_batches_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        if k == "camera":
            for f in ("R", "T", "f", "c", "k", "p"):
                np.testing.assert_array_equal(
                    getattr(b[k], f).numpy(), np.asarray(getattr(a[k], f)),
                    err_msg=f"camera.{f}")
        else:
            np.testing.assert_array_equal(b[k], np.asarray(a[k]), err_msg=k)


# ------------------------------------------------------------- imgproc
def _warp_case(name, rng):
    if name.startswith("rot"):
        img = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
        M = get_affine_transform_np(np.array([320.0, 240.0], np.float32),
                                    np.array([1.1, 1.1], np.float32),
                                    float(name[3:]), (256, 256))
        return img, M, (256, 256)
    if name == "zero_border":          # most of the crop outside the image
        img = rng.integers(1, 256, (100, 120, 3), dtype=np.uint8)
        M = get_affine_transform_np(np.array([5.0, 95.0], np.float32),
                                    np.array([0.8, 0.8], np.float32), 20.0,
                                    (64, 64))
        return img, M, (64, 64)
    if name == "identity":
        img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
        return img, np.array([[1, 0, 0], [0, 1, 0]], np.float32), (64, 48)
    # a 250 px crop: 10 columns in OpenCV's scalar tail
    img = rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)
    M = get_affine_transform_np(np.array([200.0, 150.0], np.float32),
                                np.array([1.3, 1.3], np.float32), -23.0,
                                (250, 250))
    return img, M, (250, 250)


@pytest.mark.parametrize("case", ["rot0", "rot15", "rot-40", "zero_border",
                                  "identity", "ragged_width"])
def test_warp_affine_u8_matches_cv2(case, rng):
    img, M, size = _warp_case(case, rng)
    want = cv2.warpAffine(img, M, size, flags=cv2.INTER_LINEAR)
    got = warp_affine_u8(img, M, size)
    assert got.dtype == np.uint8 and got.shape == want.shape
    tail = size[0] - size[0] % 16
    np.testing.assert_array_equal(got[:, :tail], want[:, :tail])
    d = np.abs(got[:, tail:].astype(int) - want[:, tail:])
    assert d.max(initial=0) <= 1
    if case == "zero_border":
        assert (want == 0).mean() > 0.3, "the crop should leave the image"
    if case == "identity":
        np.testing.assert_array_equal(got, img)


def test_warp_affine_u8_random_warps_match_cv2():
    """20 seeded random crops (sources 20-700 px, crops 8-300 px,
    rotations within 90 degrees, boxes partly outside): equal bits but
    in OpenCV's scalar tail, one grey level there."""
    rng = np.random.default_rng(1)
    tails = 0
    for _ in range(20):
        sh, sw = (int(v) for v in rng.integers(20, 700, 2))
        W, H = (int(v) for v in rng.integers(8, 300, 2))
        img = rng.integers(0, 256, (sh, sw, 3), dtype=np.uint8)
        M = get_affine_transform_np(
            rng.uniform(-50, [sw + 50, sh + 50]).astype(np.float32),
            np.full(2, rng.uniform(0.1, 3), np.float32),
            float(rng.uniform(-90, 90)), (W, H))
        want = cv2.warpAffine(img, M, (W, H), flags=cv2.INTER_LINEAR)
        got = warp_affine_u8(img, M, (W, H))
        tail = W - W % 16
        np.testing.assert_array_equal(got[:, :tail], want[:, :tail])
        d = np.abs(got[:, tail:].astype(int) - want[:, tail:])
        assert d.max(initial=0) <= 1
        tails += int((d > 0).sum())
    assert tails < 100


@pytest.mark.parametrize("src,dst", [((64, 64), (32, 32)),
                                     ((50, 70), (121, 97)),
                                     ((256, 256), (128, 128))])
def test_resize_bilinear_u8_matches_cv2(src, dst, rng):
    img = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    want = cv2.resize(img, dst, interpolation=cv2.INTER_LINEAR)
    got = resize_bilinear_u8(img, dst)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want).max() <= 1


def test_imgproc_refuses_float_images():
    with pytest.raises(TypeError, match="uint8"):
        warp_affine_u8(np.zeros((4, 4, 3), np.float32), np.eye(2, 3), (4, 4))
    with pytest.raises(TypeError, match="uint8"):
        resize_bilinear_u8(np.zeros((4, 4, 3), np.float32), (2, 2))


# ----------------------------------------------------------- zipreader
def test_zipreader_round_trip_matches_jax(tmp_path, rng):
    img = cv2.GaussianBlur(rng.integers(0, 256, (40, 56, 3), dtype=np.uint8),
                           (0, 0), 2.0)
    cv2.imwrite(str(tmp_path / "a.png"), img)
    cv2.imwrite(str(tmp_path / "a.jpg"), img)
    zpath = tmp_path / "s.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        z.write(tmp_path / "a.png", "sub/a.png")
        z.write(tmp_path / "a.jpg", "sub/a.jpg")
    paths = [str(tmp_path / "a.png"), str(tmp_path / "a.jpg"),
             f"{zpath}@/sub/a.png", f"{zpath}@/sub/a.jpg"]
    for p in paths:
        assert tzip.is_zip_path(p) == jzip.is_zip_path(p)
        assert tzip.read_file_bytes(p) == jzip.read_file_bytes(p)
        for rgb in (False, True):
            np.testing.assert_array_equal(tzip.imread(p, rgb=rgb),
                                          jzip.imread(p, rgb=rgb), err_msg=p)
    assert tzip.split_zip_path(paths[2]) == jzip.split_zip_path(paths[2])
    with pytest.raises(ValueError):
        tzip.split_zip_path(paths[0])


def test_imread_decodes_jpegs_without_native_loader_or_cv2(tmp_path,
                                                          monkeypatch):
    """A JPEG decodes with neither the native loader nor OpenCV (the
    port's own decoder, libjpeg-turbo's bits); a PNG without OpenCV raises
    ImportError naming it."""
    img = np.random.default_rng(0).integers(0, 256, (8, 8, 3), np.uint8)
    jpg, png = tmp_path / "a.jpg", tmp_path / "a.png"
    cv2.imwrite(str(jpg), img)
    cv2.imwrite(str(png), img)
    want = cv2.imread(str(jpg), cv2.IMREAD_COLOR)
    monkeypatch.setattr(tfast, "available", lambda: False)
    monkeypatch.setitem(sys.modules, "cv2", None)    # import cv2 fails
    np.testing.assert_array_equal(tzip.imread(str(jpg)), want)
    with pytest.raises(ImportError, match="OpenCV"):
        tzip.imread(str(png))
    monkeypatch.undo()
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8not a jpeg")
    with pytest.raises(IOError):
        tzip.imread(str(bad))


# --------------------------------------------------------- native loader
@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """The sample image and the synthetic writer's JPEGs."""
    root = tmp_path_factory.mktemp("mpii")
    cfg, _ = _configs()
    cfg.MODEL.NUM_JOINTS = 16
    jsyn.write_synthetic_mpii(str(root), cfg, num_samples=3)
    bufs = [(ROOT / "sample_images/synthetic_person.jpg").read_bytes()]
    bufs += [p.read_bytes() for p in sorted((root / "images").iterdir())]
    return bufs


def test_native_loader_builds_into_the_port(jpegs):
    if not jfast.available():
        pytest.skip("no g++ or jpeglib.h: the native loader cannot build")
    assert tfast.available(), tfast.build_error()
    path = tfast.library_path()
    assert path.parent.parent == ROOT / "epipolarpose_tpu_torch/_build"
    assert "-march=native" not in " ".join(tfast.CXX_FLAGS)
    for b in jpegs:
        want = cv2.cvtColor(cv2.imdecode(np.frombuffer(b, np.uint8), 1),
                            cv2.COLOR_BGR2RGB)
        assert tfast.jpeg_size(b) == want.shape[1::-1]
        np.testing.assert_array_equal(tfast.decode(b), want)


@pytest.mark.parametrize("route", ["u8", "f32", "warp2", "warp_batch"])
def test_native_loader_matches_jax_binding(route, jpegs, rng):
    if not (jfast.available() and tfast.available()):
        pytest.skip("no g++ or jpeglib.h: the native loader cannot build")
    n = len(jpegs)
    c = rng.uniform(60, 200, (n, 2)).astype(np.float32)
    s = rng.uniform(0.4, 1.6, (n, 2)).astype(np.float32)
    r = rng.uniform(-40, 40, n).astype(np.float32)
    M = get_affine_transform_np(c, s, r, (64, 64))
    M2 = get_affine_transform_np(c, s * 1.2, -r, (64, 64))
    M1h = get_affine_transform_np(c, s, 0 * r, (32, 32))
    if route == "u8":
        pairs = [(f.decode_warp_batch(jpegs, M, (64, 64)))
                 for f in (tfast, jfast)]
    elif route == "warp2":
        got = tfast.decode_warp2_batch(jpegs, M1h, M2, (64, 64), (32, 32))
        want = jfast.decode_warp2_batch(jpegs, M1h, M2, (64, 64), (32, 32))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        return
    elif route == "f32":
        pairs = [f.decode_warp_batch(jpegs, M, (64, 64), dtype=np.float32)
                 for f in (tfast, jfast)]
    else:
        imgs = rng.integers(0, 256, (n, 80, 90, 3), dtype=np.uint8)
        pairs = [f.warp_batch(imgs, M, (64, 64)) for f in (tfast, jfast)]
    got, want = pairs
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.uint8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=np.spacing(np.float32(1.0)))


# ------------------------------------------------------ synthetic datasets
def test_synthetic_pose_dataset_matches_jax():
    jcfg, tcfg = _configs()
    kw = dict(num_samples=6, image_shape=(96, 96), seed=3)
    jd = jsyn.SyntheticPoseDataset(jcfg, **kw)
    td = tsyn.SyntheticPoseDataset(tcfg, **kw)
    for a, b in zip(jd.records, td.records):
        for f in ("center", "scale", "joints", "joints_vis"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
        np.testing.assert_array_equal(td._read_image(b.image),
                                      jd._read_image(a.image))
    for is_train in (True, False):
        jd.is_train = td.is_train = is_train
        for a, b in zip(jd.batches(4, seed=2, drop_last=False),
                        td.batches(4, seed=2, drop_last=False)):
            _assert_batches_equal(a, b)
    preds = np.stack([r.joints for r in jd.records]) + np.random.default_rng(
        1).normal(0, 12, (6, 17, 2))
    assert jd.evaluate(jcfg, preds) == td.evaluate(tcfg, preds)


@pytest.fixture(scope="module")
def multiview():
    """The JAX and port multiview datasets (skeleton poses, depth cue) on
    the same seed, 6 frames of 4 views, 256 px views."""
    jcfg, tcfg = _configs()
    kw = dict(num_frames=6, image_shape=(64, 64), seed=3,
              pose_mode="skeleton", depth_cue=1.0)
    return (jsyn.SyntheticMultiviewDataset(jcfg, **kw),
            tsyn.SyntheticMultiviewDataset(tcfg, **kw))


def test_synthetic_multiview_records_match_jax(multiview):
    jd, td = multiview
    assert td.view_groups == jd.view_groups
    for a, b in zip(jd.records, td.records):
        for f in RECORD_FIELDS:
            np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                       rtol=1e-6, atol=1e-4, err_msg=f)
        assert b.image == a.image
        assert {k: v for k, v in b.meta.items() if k != "pose_world"} == {
            k: v for k, v in a.meta.items() if k != "pose_world"}
        np.testing.assert_array_equal(b.meta["pose_world"],
                                      a.meta["pose_world"])
        d = np.abs(td._read_image(b.image).astype(int)
                   - jd._read_image(a.image))
        assert d.max() <= 1 and (d > 0).mean() < 1e-4
    for a, b in zip(jd.rig, td.rig):
        for f in ("R", "T", "f", "c", "k", "p"):
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          getattr(a, f))


def test_render_blobs_matches_jax(rng):
    joints = rng.uniform(-10, 110, (17, 2)).astype(np.float32)
    for sigma in (4.0, rng.uniform(2, 9, 17).astype(np.float32)):
        np.testing.assert_array_equal(
            tsyn._render_blobs(joints, (100, 120), 17, sigma),
            jsyn._render_blobs(joints, (100, 120), 17, sigma))


@pytest.fixture(scope="module")
def same_records(multiview):
    """A port dataset holding the JAX dataset's records, so that every
    batch from them can be held to equal bits."""
    jd, _ = multiview
    _, tcfg = _configs()
    td = tsyn.SyntheticMultiviewDataset(tcfg, num_frames=6,
                                        image_shape=(64, 64), seed=3,
                                        pose_mode="skeleton", depth_cue=1.0)
    for a, b in zip(jd.records, td.records):
        for f in RECORD_FIELDS:
            setattr(b, f, getattr(a, f).copy())
    return jd, td


@pytest.mark.parametrize("mode", ["batches_train", "batches_eval",
                                  "view_batches", "view_batches_augment",
                                  "view_batches_augment_teacher_half"])
def test_synthetic_multiview_batches_match_jax(mode, same_records):
    """Equal bits, but for the ``SS_TEACHER_SCALE`` 0.5 teacher crop:
    ``resize_bilinear_u8`` is within one grey level of OpenCV's resize
    (ROADMAP Queue C), on under 2% of the pixels."""
    jd, td = same_records
    half = mode.endswith("teacher_half")
    mode = mode.replace("_teacher_half", "")
    for ds in (jd, td):
        ds.is_train = mode.endswith(("train", "augment"))
        ds.cfg.TPU.SS_TEACHER_SCALE = 0.5 if half else 1.0
    try:
        if mode.startswith("batches"):
            kw = dict(seed=4, drop_last=False)
            pairs = list(zip(jd.batches(5, **kw), td.batches(5, **kw)))
        else:
            kw = dict(seed=5, augment=mode.endswith("augment"))
            pairs = list(zip(jd.view_batches(2, **kw),
                             td.view_batches(2, **kw)))
    finally:
        for ds in (jd, td):
            ds.cfg.TPU.SS_TEACHER_SCALE = 1.0
    off = []
    for a, b in pairs:
        if half:
            assert b["input"].shape == a["input"].shape == (2, 4, 32, 32, 3)
            d = np.abs(b["input"].astype(int) - a["input"])
            assert d.max() <= 1
            off.append((d > 0).mean())
            a = {k: v for k, v in a.items() if k != "input"}
            b = {k: v for k, v in b.items() if k != "input"}
        _assert_batches_equal(a, b)
    assert len(pairs) == (5 if mode.startswith("batches") else 3)
    if half:
        assert max(off) < 0.02, off
    if mode == "view_batches_augment":
        assert b["aug_flip"].any() and not b["aug_flip"].all()
        assert isinstance(b["camera"], th36m.Camera)
        assert b["camera"].R.shape == (2, 4, 3, 3)


# ----------------------------------------------------------- on-disk trees
@pytest.fixture(scope="module")
def h36m_tree(tmp_path_factory):
    """An H36M tree (real camera ids) written by the JAX writer."""
    root = tmp_path_factory.mktemp("h36m")
    cfg, _ = _configs()
    jsyn.write_synthetic_h36m(str(root), cfg, num_frames=4,
                              camera_ids=jh36m.CAMERA_IDS)
    return str(root)


@pytest.mark.parametrize("subsample", [1, 2])
@pytest.mark.parametrize("native", [False, True])
def test_h36m_tree_reads_as_in_jax(h36m_tree, subsample, native):
    if native and not (jfast.available() and tfast.available()):
        pytest.skip("no g++ or jpeglib.h: the native loader cannot build")
    jcfg, tcfg = _configs(SUBSAMPLE=subsample)
    for cfg in (jcfg, tcfg):
        cfg.TPU.NATIVE_LOADER = native
    jd = jh36m.H36MDataset(jcfg, h36m_tree, "valid", is_train=True)
    td = th36m.H36MDataset(tcfg, h36m_tree, "valid", is_train=True)
    assert len(td) == len(jd) == 16 // subsample
    assert td.view_groups == jd.view_groups
    for a, b in zip(jd.records, td.records):
        assert b.image == a.image and b.meta == a.meta
        for f in RECORD_FIELDS:
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    assert sorted(td.cameras) == sorted(jd.cameras)
    _assert_batches_equal(jd.get_batch([0, 3, 2], seed=7),
                          td.get_batch([0, 3, 2], seed=7))
    for a, b in zip(jd.view_batches(1, seed=1, augment=True),
                    td.view_batches(1, seed=1, augment=True)):
        _assert_batches_equal(a, b)


def test_mpii_tree_reads_as_in_jax(tmp_path):
    jcfg, tcfg = _configs()
    for cfg in (jcfg, tcfg):
        cfg.MODEL.NUM_JOINTS = 16
        cfg.TPU.NATIVE_LOADER = False
    jsyn.write_synthetic_mpii(str(tmp_path), jcfg, num_samples=5)
    jd = jmpii.MPIIDataset(jcfg, str(tmp_path), "train", is_train=True)
    td = tmpii.MPIIDataset(tcfg, str(tmp_path), "train", is_train=True)
    for a, b in zip(jd.records, td.records):
        assert b.image == a.image and b.meta == a.meta
        for f in ("center", "scale", "joints", "joints_vis"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    for a, b in zip(jd.batches(2, seed=3), td.batches(2, seed=3)):
        _assert_batches_equal(a, b)
    # the registry builds the same dataset from the config
    tcfg.DATASET.DATASET = "mpii"
    tcfg.DATASET.ROOT = str(tmp_path)
    assert len(get_dataset(tcfg, "valid", False)) == 5


@pytest.mark.parametrize("which", ["mpii", "h36m"])
def test_writers_write_what_jax_writes(which, tmp_path):
    jcfg, tcfg = _configs()
    if which == "mpii":
        for cfg in (jcfg, tcfg):
            cfg.MODEL.NUM_JOINTS = 16
        jsyn.write_synthetic_mpii(str(tmp_path / "j"), jcfg, num_samples=3)
        tsyn.write_synthetic_mpii(str(tmp_path / "t"), tcfg, num_samples=3)
    else:
        jsyn.write_synthetic_h36m(str(tmp_path / "j"), jcfg, num_frames=2)
        tsyn.write_synthetic_h36m(str(tmp_path / "t"), tcfg, num_frames=2)
    for split in ("train", "valid"):
        a = json.loads((tmp_path / "j/annot" / f"{split}.json").read_text())
        b = json.loads((tmp_path / "t/annot" / f"{split}.json").read_text())
        assert len(a) == len(b)
        for x, y in zip(a, b):
            x["image"] = os.path.basename(x["image"])
            y["image"] = os.path.basename(y["image"])
            for k in x:
                if isinstance(x[k], list):
                    np.testing.assert_allclose(y[k], x[k], rtol=1e-6,
                                               atol=1e-4, err_msg=k)
                else:
                    assert y[k] == x[k], k
    if which == "h36m":
        a = json.loads((tmp_path / "j/annot/cameras.json").read_text())
        b = json.loads((tmp_path / "t/annot/cameras.json").read_text())
        assert a == b


def test_registry(tmp_path):
    _, tcfg = _configs()
    tcfg.DATASET.DATASET = "synthetic_multiview"
    ds = get_dataset(tcfg, "valid", False, num_frames=2)
    assert isinstance(ds, tsyn.SyntheticMultiviewDataset) and len(ds) == 8
    tcfg.DATASET.DATASET = "mpi_inf_3dhp"
    tcfg.DATASET.ROOT = str(tmp_path)
    write_synthetic_3dhp(str(tmp_path), num_frames=3)
    ds = get_dataset(tcfg, "test", False)
    assert isinstance(ds, MPI3DHPDataset) and len(ds) == 4
    tcfg.DATASET.DATASET = "nope"
    with pytest.raises(ValueError):
        get_dataset(tcfg, "valid", False)


def test_dataset_pickles_without_its_pool():
    import pickle
    _, tcfg = _configs()
    ds = tsyn.SyntheticPoseDataset(tcfg, num_samples=2, image_shape=(64, 64))
    back = pickle.loads(pickle.dumps(ds))
    assert back.pool is not None
    _assert_batches_equal(ds.get_batch([0, 1]), back.get_batch([0, 1]))


def test_decide_native_matches_jax():
    from epipolarpose_tpu.data.joints_dataset import JointsDataset as J
    from epipolarpose_tpu_torch.data.joints_dataset import JointsDataset as T
    for tn, tp in (([1.0, 1.1, 0.9], [2.0, 2.1, 1.9]),
                   ([1.0, 1.0, 1.0], [1.1, 1.1, 1.1])):
        assert T.decide_native(tn, tp) == J.decide_native(tn, tp)


def test_host_shard_indices_match_jax():
    from epipolarpose_tpu.data.joints_dataset import host_shard_indices as j
    from epipolarpose_tpu_torch.data.joints_dataset import (
        host_shard_indices as t)
    idx = np.arange(12) * 3
    for pi in range(4):
        np.testing.assert_array_equal(t(idx, pi, 4), j(idx, pi, 4))
    with pytest.raises(ValueError):
        t(idx, 0, 5)


def test_camera_stack_in_view_batches_is_a_tensor_camera(same_records):
    _, td = same_records
    b = next(td.view_batches(3, seed=0))
    assert torch.is_tensor(b["camera"].P) and b["camera"].P.shape == (
        3, 4, 3, 4)


@pytest.mark.parametrize("mode", ["batches", "view_batches"])
def test_process_slices_reassemble_the_global_batch(mode, same_records):
    """With 2 processes each decodes its contiguous half of every global
    batch, with the same content as one process decodes (the augmentation
    keys on the record): the halves stack into the single-process batch."""
    _, td = same_records
    td.is_train = True
    kw = dict(seed=6)
    if mode == "batches":
        whole = list(td.batches(6, **kw))
        parts = [list(td.batches(6, process_index=i, process_count=2, **kw))
                 for i in range(2)]
    else:
        kw["augment"] = True
        whole = list(td.view_batches(2, **kw))
        parts = [list(td.view_batches(2, process_index=i, process_count=2,
                                      **kw)) for i in range(2)]
    assert len(whole) == len(parts[0]) == len(parts[1]) > 0
    for w, a, b in zip(whole, *parts):
        for k, v in w.items():
            if k == "camera":
                for f in ("R", "T", "f", "c", "k", "p"):
                    assert torch.equal(torch.cat([getattr(a[k], f),
                                                  getattr(b[k], f)]),
                                       getattr(v, f))
            else:
                np.testing.assert_array_equal(
                    np.concatenate([a[k], b[k]]), v, err_msg=k)
