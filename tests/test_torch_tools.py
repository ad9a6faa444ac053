"""The port's user tools against the JAX package's, on the CPU.

- ``tools/export_torch.py`` against the JAX tool on the same input (a
  ``.pth.tar`` that JAX ``save_torch_checkpoint`` wrote): the same keys
  and the same tensors, bit for bit; on a port training checkpoint (with
  its optimizer) the weights loaded back with ``strict=True``, and the
  JAX tool's re-save of the port's file equal to it; an orbax directory
  refused with the export hint.
- ``tools/prepare_h36m.py`` against the JAX functions on every case of
  ``tests/test_tools.py`` (field aliases, ``cameras.h5`` with uint16,
  uint8, ASCII and integer names, the CLI): equal dicts and byte-equal
  json; without ``h5py`` the ``--cameras-h5`` route's ImportError names
  it.
- ``tools/dualcrop_headroom.py`` at the ``ci`` preset's sizes (ResNet-18
  at 64x64, D = 4, float32): part A's bytes shipped an image equal to the
  JAX tool's at both teacher scales; part B's detections on the same
  bridged teacher (JAX init, BN statistics and head re-drawn) and the
  same crops equal to JAX ``teacher_detect``'s to 1e-3 px (the eval
  step's bound; no argmax can flip, ``test_torch_heatmap.decisive``), and
  the floor, given equal detections (2 px noise on the ground truth),
  within 2e-3 mm of the JAX tool's (the pseudo-GT floor's bound in
  ``test_torch_ss_convergence.py``); the port's crops equal JAX's but the
  half-size teacher crop, within one grey level; part C's first SS loss
  at teacher scale 0.5 relative 1e-5 of JAX ``make_ss_train_step``'s
  (``test_torch_self_supervised.py``'s step-1 bound), and at
  ``TPU.FUSED_STEPS: 2`` the unfused step's (relative 1e-6: the same
  step in a loop on the CPU).
- ``demo_torch.ipynb``'s code cells, exec'd with ``DEVICE = 'cpu'`` and
  the debug config, against JAX ``demo.ipynb``'s on the same ``.pth.tar``:
  predictions within 1e-3 px in x, y and 1e-2 mm in z (the eval step's
  bounds).
"""

import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epipolarpose_tpu.config import load_config as jax_load_config
from epipolarpose_tpu.core import self_supervised as jss
from epipolarpose_tpu.core.steps import normalize_images as jax_normalize
from epipolarpose_tpu.data import \
    SyntheticMultiviewDataset as JaxMultiviewDataset
from epipolarpose_tpu.models import get_model as jax_get_model
from epipolarpose_tpu.models import save_torch_checkpoint
from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.core import create_train_state
from epipolarpose_tpu_torch.core.checkpoint import (ORBAX_HINT,
                                                    CheckpointManager)
from epipolarpose_tpu_torch.core.self_supervised import Teacher, teacher_net
from epipolarpose_tpu_torch.core.steps import normalize_images
from epipolarpose_tpu_torch.data import SyntheticMultiviewDataset
from epipolarpose_tpu_torch.models import from_jax_variables, get_model
from epipolarpose_tpu_torch.tools import dualcrop_headroom as tdc
from epipolarpose_tpu_torch.tools import export_torch as tet
from epipolarpose_tpu_torch.tools import prepare_h36m as tph
from epipolarpose_tpu_torch.tools.ss_convergence import make_teacher_cfg
from test_torch_heatmap import decisive, nchw
from test_torch_models import _perturbed_variables
from test_torch_self_supervised import _students, port_batch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import dualcrop_headroom as jdc  # noqa: E402
import export_torch as jet  # noqa: E402
import prepare_h36m as jph  # noqa: E402

DEBUG_3D = ROOT / "experiments/debug/synth_smoke_3d.yaml"
SS_CFG = ROOT / "experiments/h36m/train_ss_r50_256_integral.yaml"


@pytest.fixture(scope="module")
def jax_pth(tmp_path_factory):
    """A reference ``.pth.tar`` that JAX ``save_torch_checkpoint`` wrote:
    the debug 3D model with BN statistics and head re-drawn."""
    variables = _perturbed_variables(
        jax_get_model(jax_load_config(DEBUG_3D)), np.random.default_rng(0))
    path = tmp_path_factory.mktemp("pth") / "jax.pth.tar"
    save_torch_checkpoint(str(path), variables)
    return path, variables


def _jax_cli(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    module.main()


def _state_dict(path):
    return torch.load(path, map_location="cpu",
                      weights_only=True)["state_dict"]


def _assert_same(a: dict, b: dict, skip=()):
    assert sorted(a) == sorted(b)
    for k in a:
        if not k.endswith(skip) or not skip:
            assert a[k].dtype == b[k].dtype, k
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


# ------------------------------------------------------------ export_torch
def test_export_torch_matches_the_jax_tool(jax_pth, tmp_path, monkeypatch):
    src, _ = jax_pth
    argv = ["--cfg", str(DEBUG_3D), "--model-file", str(src)]
    _jax_cli(monkeypatch, jet, argv + ["--out", str(tmp_path / "j.pth.tar")])
    got = tet.main(argv + ["--out", str(tmp_path / "t.pth.tar")])
    want = _state_dict(tmp_path / "j.pth.tar")
    _assert_same(_state_dict(tmp_path / "t.pth.tar"), want)
    _assert_same(got, want)


def test_export_torch_reads_a_port_training_checkpoint(jax_pth, tmp_path,
                                                       monkeypatch):
    """A latest save (model, Adam's moments, schedule) through
    ``checkpoints/latest``: the weights come back with ``strict=True``, and
    the JAX tool reads the port's file into the same entries."""
    _, variables = jax_pth
    cfg = load_config(DEBUG_3D)
    model = get_model(cfg, False)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    state = create_train_state(cfg, model, 10, "cpu")
    ckpt = tmp_path / "checkpoints"
    CheckpointManager(str(ckpt), best_mode="min").save(7, state, 0, 12.5)
    out = tmp_path / "t.pth.tar"
    got = tet.main(["--cfg", str(DEBUG_3D), "--model-file",
                    str(ckpt / "latest"), "--out", str(out)])
    _assert_same(got, model.state_dict())
    fresh = get_model(cfg, False)
    fresh.load_state_dict(_state_dict(out), strict=True)
    _assert_same(fresh.state_dict(), model.state_dict())
    _jax_cli(monkeypatch, jet, ["--cfg", str(DEBUG_3D), "--model-file",
                                str(out), "--out", str(tmp_path / "j.pth")])
    _assert_same(_state_dict(tmp_path / "j.pth"), _state_dict(out))


def test_export_torch_refuses_an_orbax_directory(tmp_path):
    (tmp_path / "orbax" / "7").mkdir(parents=True)
    with pytest.raises(ValueError) as err:
        tet.main(["--cfg", str(DEBUG_3D), "--model-file",
                  str(tmp_path / "orbax"), "--out", str(tmp_path / "o")])
    assert ORBAX_HINT in str(err.value)


# ------------------------------------------------------------ prepare_h36m
def test_prepare_h36m_annotations_match_jax(tmp_path):
    raw = [{
        "img_path": "S1/img_000001.jpg", "c": [500.0, 400.0], "s": 2.1,
        "joint_img": [[10.0, 20.0, 0.5]] * 17,
        "joint_cam": [[1.0, 2.0, 3.0]] * 17, "joint_vis": [[1.0]] * 17,
        "s_id": 1, "act_id": 2, "subact_id": 1, "cam_id": "54138969",
        "image_id": 7,
    }, {"image": "b.jpg", "center": [1, 2], "scale": [1.5, 1.25],
        "joints_2d": [[0, 0]] * 17, "subject": 9, "action": "Walk",
        "subaction": 2, "camera": "60457274", "frame": 3}]
    src = tmp_path / "raw.json"
    src.write_text(json.dumps(raw))
    got = tph.convert_annotations(str(src))
    assert got == jph.convert_annotations(str(src))
    assert json.dumps(got) == json.dumps(jph.convert_annotations(str(src)))
    assert got[0]["scale"] == [2.1, 2.1] and got[0]["frame"] == 7


def test_prepare_h36m_camera_name_decode_matches_jax():
    want = "54138969"
    codes = [ord(c) for c in want]
    names = [np.frombuffer(want.encode("utf-16-le"), np.uint16),
             np.array(codes, np.uint8), np.array([54138969], np.int64),
             np.array(list(want), "U1"), np.array([b"54138969"], "S8")]
    names += [np.array(codes, dt) for dt in (np.int16, np.int32,
                                             np.float64)]
    for a in names:
        assert tph._decode_camera_name(a) == jph._decode_camera_name(a) \
            == want, a.dtype


def _write_cameras_h5(path, name_key, name, slot="camera1"):
    import h5py
    from scipy.spatial.transform import Rotation
    rot = Rotation.from_euler("xyz", [10, 20, 30], degrees=True).as_matrix()
    with h5py.File(path, "w") as f:
        g = f.create_group(f"subject1/{slot}")
        g["R"] = rot.T
        g[name_key] = name
        g["T"] = np.array([1.0, 2.0, 3.0])
        g["f"] = np.array([1100.0, 1101.0])
        g["c"] = np.array([512.0, 510.0])
        g["k"] = np.array([-0.2, 0.2, -0.001])
        g["p"] = np.array([0.001, -0.0005])


@pytest.mark.parametrize("name_key,name,slot,key", [
    ("Name", np.frombuffer("54138969".encode("utf-16-le"), np.uint16),
     "camera1", "1:54138969"),
    ("name", np.frombuffer(b"54138969", np.uint8), "camera2", "1:54138969"),
    ("Name", np.array([54138969], np.int64), "camera3", "1:54138969"),
    ("Name", np.array([ord(c) for c in "55011271"], np.int32), "camera1",
     "1:55011271"),
    ("Other", np.zeros(1), "camera2", "1:55011271"),
], ids=["uint16", "ascii-uint8", "int", "int32-codes", "positional"])
def test_prepare_h36m_cameras_match_jax(tmp_path, name_key, name, slot,
                                        key):
    path = tmp_path / "cameras.h5"
    _write_cameras_h5(path, name_key, name, slot)
    got = tph.convert_cameras_h5(str(path))
    assert list(got) == [key]
    assert got == jph.convert_cameras_h5(str(path))


def test_prepare_h36m_cli_writes_the_jax_bytes(tmp_path, monkeypatch):
    _write_cameras_h5(tmp_path / "cameras.h5", "Name",
                      np.frombuffer("58860488".encode("utf-16-le"),
                                    np.uint16))
    raw = [{"image": "a.jpg", "center": [1, 2], "scale": 1.0,
            "joints_2d": [[0, 0]] * 17, "subject": 1, "action": "X",
            "subaction": 1, "camera": "54138969", "frame": 0}]
    (tmp_path / "t.json").write_text(json.dumps(raw))
    (tmp_path / "v.json").write_text(json.dumps(raw * 2))
    argv = ["--cameras-h5", str(tmp_path / "cameras.h5"), "--train-annot",
            str(tmp_path / "t.json"), "--valid-annot",
            str(tmp_path / "v.json"), "--out"]
    _jax_cli(monkeypatch, jph, argv + [str(tmp_path / "jax")])
    written = tph.main(argv + [str(tmp_path / "port")])
    assert sorted(written) == ["cameras.json", "train.json", "valid.json"]
    for name, path in written.items():
        assert pathlib.Path(path).read_bytes() == (
            tmp_path / "jax" / name).read_bytes(), name


def test_prepare_h36m_without_h5py_names_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        tph.main(["--cameras-h5", str(tmp_path / "c.h5"), "--out",
                  str(tmp_path / "out")])


# ------------------------------------------------------- dualcrop_headroom
def _ci_configs():
    out = []
    for load in (jax_load_config, load_config):
        cfg = load(SS_CFG)
        tdc.ci_config(cfg)
        out.append(cfg)
    return out


def test_dualcrop_loader_ships_the_jax_bytes(tmp_path):
    jcfg, tcfg = _ci_configs()
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = jdc.bench_loader(jcfg, str(tmp_path / "j"), 4, 2, print)
    got = tdc.bench_loader(tcfg, str(tmp_path / "t"), 4, 2, print)
    for scale in tdc.SCALES:
        assert got[scale]["bytes_per_img"] == want[scale]["bytes_per_img"]
        assert got[scale]["img_s"] > 0
    assert got[1.0]["bytes_per_img"] == 2 * 64 * 64 * 3
    assert got[0.5]["bytes_per_img"] == (32 * 32 + 64 * 64) * 3
    assert "native loader" in got["route"]
    assert tcfg.TPU.SS_TEACHER_SCALE == 1.0
    assert tcfg.TPU.NATIVE_LOADER == "auto"


@pytest.fixture(scope="module")
def bridged():
    """The ci configs, the rig datasets, and one teacher on both sides:
    the JAX init with BN statistics and head re-drawn, bridged."""
    jcfg, tcfg = _ci_configs()
    jt_cfg = make_teacher_cfg(jcfg)
    jmodel = jax_get_model(jt_cfg)
    variables = _perturbed_variables(jmodel, np.random.default_rng(2))
    jteacher = jss.Teacher(jmodel, variables["params"],
                           variables["batch_stats"])
    net = teacher_net(make_teacher_cfg(tcfg))
    net.load_state_dict(from_jax_variables(variables), strict=True)
    kw = dict(num_frames=6, is_train=True, image_shape=(64, 64), seed=0)
    return (jcfg, tcfg, jteacher, Teacher(net),
            JaxMultiviewDataset(jcfg, **kw), SyntheticMultiviewDataset(tcfg,
                                                                       **kw))


def _jax_batch(jcfg, jds, scale, groups, **kw):
    jcfg.TPU.SS_TEACHER_SCALE = scale
    try:
        return next(jds.view_batches(groups, **kw))
    finally:
        jcfg.TPU.SS_TEACHER_SCALE = 1.0


@pytest.mark.parametrize("scale", tdc.SCALES)
def test_dualcrop_batches_match_jax(bridged, scale):
    """The dual crop's batches at both teacher scales: the same bits but
    the half-size teacher crop, which the port resizes within one grey
    level of OpenCV (``data/imgproc.py::resize_bilinear_u8``)."""
    jcfg, tcfg, _, _, jds, tds = bridged
    want = _jax_batch(jcfg, jds, scale, 6, shuffle=False, augment=True)
    tcfg.TPU.SS_TEACHER_SCALE = scale
    try:
        got = next(tds.view_batches(6, shuffle=False, augment=True))
    finally:
        tcfg.TPU.SS_TEACHER_SCALE = 1.0
    assert got["input"].shape[2:4] == (64, 64) if scale == 1.0 else (32, 32)
    diff = np.abs(got["input"].astype(int) - want["input"].astype(int))
    assert diff.max() <= (0 if scale == 1.0 else 1)
    np.testing.assert_array_equal(got["input_aug"], want["input_aug"])


@pytest.mark.parametrize("scale", tdc.SCALES)
def test_dualcrop_detections_match_jax(bridged, monkeypatch, scale):
    """Part B's teacher decode on JAX's batch (the same crops) against
    JAX ``teacher_detect``; the floor is the floor of its detections."""
    jcfg, tcfg, jteacher, teacher, jds, tds = bridged
    aug = scale != 1.0
    batch0 = _jax_batch(jcfg, jds, scale, 6, shuffle=False, augment=aug)
    monkeypatch.setattr(tds, "view_batches",
                        lambda *a, **k: iter([port_batch(batch0)]))
    floor, det, conf = tdc.pseudo_gt_floor_at(tcfg, tds, teacher, scale,
                                              "cpu")
    g, v = batch0["input"].shape[:2]

    def flat(x):
        return x.reshape((g * v,) + x.shape[2:])
    imgs = jax_normalize(jnp.asarray(flat(batch0["input"])))
    hm = jteacher(imgs)
    assert hm.shape[1] == (16 if scale == 1.0 else 8)
    port_hm = teacher(normalize_images(torch.from_numpy(
        flat(batch0["input"]))).permute(0, 3, 1, 2).contiguous())
    gap = (port_hm - nchw(hm)).abs().max().item()
    assert bool(decisive(nchw(hm), 2 * gap).all()), "a decode could flip"
    j_src, jconf = jss.teacher_detect(jcfg, jteacher, imgs,
                                      flat(batch0["center"]),
                                      flat(batch0["scale"]))
    np.testing.assert_allclose(det.reshape(-1, 17, 2).numpy(),
                               np.asarray(j_src), rtol=0, atol=1e-3)
    # confidences are heatmap maxima: 1e-5 of the largest
    np.testing.assert_allclose(conf.reshape(-1, 17).numpy(),
                               np.asarray(jconf), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jconf)).max())
    assert floor == tdc.floor_from_detections(
        tcfg, tds, det, conf, port_batch(batch0)["camera"])


def test_dualcrop_floor_matches_jax(bridged):
    """The floor given equal detections (the ground truth plus 2 px of
    noise, seeded confidences), against the JAX tool's ``floor()``
    arithmetic: JAX ``generate_pseudo_gt``, the mean over finite joints."""
    jcfg, tcfg, _, _, jds, tds = bridged
    batch0 = next(jds.view_batches(6, shuffle=False))
    g, v = batch0["input"].shape[:2]
    rng = np.random.default_rng(1)
    det = np.stack([jds.records[i].joints[:, :2]
                    for i in batch0["index"].reshape(-1)])
    det = (det + rng.normal(0, 2.0, det.shape)).astype(np.float32).reshape(
        g, v, 17, 2)
    conf = rng.uniform(0.2, 1.0, (g, v, 17)).astype(np.float32)
    x_w, _ = jss.generate_pseudo_gt(jcfg, jnp.asarray(det),
                                    jnp.asarray(conf), batch0["camera"])
    gt_w = np.stack([jds.records[jds.view_groups[t][0]].meta["pose_world"]
                     for t in range(g)])
    err = np.linalg.norm(np.asarray(x_w) - gt_w, axis=-1)
    want = float(err[np.isfinite(err)].mean())
    got = tdc.floor_from_detections(tcfg, tds, torch.from_numpy(det),
                                    torch.from_numpy(conf),
                                    port_batch(batch0)["camera"])
    assert 1.0 < want < 100.0
    assert got == pytest.approx(want, abs=2e-3)


def test_dualcrop_half_scale_ss_loss_matches_jax(bridged, monkeypatch):
    """Part C's first step at teacher scale 0.5 on JAX's batch, against
    JAX ``make_ss_train_step`` from the same student and teacher."""
    jcfg, tcfg, jteacher, teacher, jds, tds = bridged
    jmodel, jstate, _, tstate = _students(jcfg, tcfg)
    batch = _jax_batch(jcfg, jds, 0.5, 2, seed=1, shuffle=True,
                       augment=True)
    batch.pop("joints_3d", None)
    assert batch["input"].shape[2:4] == (32, 32)
    monkeypatch.setattr(tds, "view_batches",
                        lambda *a, **k: iter([port_batch(batch)]))
    got = tdc.ss_step_rate(tcfg, tds, tstate, teacher, 0.5, 2, 0, "cpu")
    jstep = jss.make_ss_train_step(jcfg, jmodel, jteacher, donate=False,
                                   flip_pairs=jds.flip_pairs)
    _, metrics = jstep(jstate, jax.device_put(batch))
    want = float(metrics["loss"])
    assert want > 0.0, "every target gated: the comparison tests nothing"
    assert got["loss"] == pytest.approx(want, rel=1e-5)
    assert tcfg.TPU.SS_TEACHER_SCALE == 1.0
    # TPU.FUSED_STEPS honoured: one call of 2 steps from the same student,
    # its first step's loss the unfused step's
    _, _, _, fstate = _students(jcfg, tcfg)
    tcfg.TPU.FUSED_STEPS = 2
    try:
        fused = tdc.ss_step_rate(tcfg, tds, fstate, teacher, 0.5, 2, 0,
                                 "cpu")
    finally:
        tcfg.TPU.FUSED_STEPS = 1
    assert fstate.step == 2
    assert fused["loss"] == pytest.approx(got["loss"], rel=1e-6)


@pytest.mark.parametrize("tool", ["dualcrop_headroom", "export_model"])
def test_tools_default_to_the_card(tool, tmp_path):
    """Without ``--device`` the tools run on the card, and with none they
    raise at once (no quiet fall back to the CPU)."""
    from epipolarpose_tpu_torch.tools import export_model as tex
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    main = {"dualcrop_headroom": tdc.main, "export_model": tex.main}[tool]
    argv = {"dualcrop_headroom": ["--preset", "ci", "--cfg", str(SS_CFG)],
            "export_model": ["--cfg", str(DEBUG_3D), "--out",
                             str(tmp_path / "m.pt2")]}[tool]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


# ---------------------------------------------------------- demo_torch.ipynb
def _cells(path: pathlib.Path, subs: dict) -> list[str]:
    cells = [c for c in json.loads(path.read_text())["cells"]
             if c["cell_type"] == "code"]
    out = []
    for c in cells:
        src = "".join(c["source"])
        for a, b in subs.items():
            src = src.replace(a, b)
        out.append(src)
    return out


def test_demo_notebook_matches_the_jax_notebook(jax_pth, tmp_path,
                                                monkeypatch):
    """The debug config in float32 (a copy of the yaml), where the eval
    step's bounds hold."""
    src, _ = jax_pth
    monkeypatch.chdir(ROOT)
    cfg = tmp_path / "debug_3d_f32.yaml"
    cfg.write_text(DEBUG_3D.read_text() + "\nTPU:\n  COMPUTE_DTYPE: float32\n")
    common = {"CFG = 'experiments/h36m/valid_r50_256_integral.yaml'":
              f"CFG = {str(cfg)!r}",
              "MODEL_FILE = None": f"MODEL_FILE = {str(src)!r}"}
    jax_cells = _cells(ROOT / "demo.ipynb", common)
    port_cells = _cells(ROOT / "demo_torch.ipynb", {
        **common, "DEVICE = 'cuda'": "DEVICE = 'cpu'",
        "OUT = 'demo_out'": f"OUT = {str(tmp_path)!r}"})
    assert all(a in jax_cells[0] for a in common.values())
    assert "DEVICE = 'cpu'" in port_cells[0]
    jg, tg = {}, {}
    for cell in jax_cells[:2]:            # the third draws with matplotlib
        exec(compile(cell, "demo.ipynb", "exec"), jg)
    for cell in port_cells:
        exec(compile(cell, "demo_torch.ipynb", "exec"), tg)
    want, got = np.asarray(jg["preds"]), tg["preds"]
    assert got.shape == want.shape == (17, 3)
    assert np.ptp(want[:, 0]) > 1.0, "joints should not coincide"
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=0, atol=1e-2)
    assert [pathlib.Path(f).name for f in tg["figures"]] == [
        "pose_2d.png", "pose_3d.png"]
    assert all(pathlib.Path(f).stat().st_size > 0 for f in tg["figures"])
    assert "cv2" not in "".join(port_cells)
    assert "matplotlib" not in "".join(port_cells)
