"""The port's offline pseudo-GT workflow against the JAX package's, on the
CPU: the per-batch pseudo-GT, the merge into an annot json, and the CLI
``epipolarpose_tpu_torch.scripts.generate_pseudo_gt`` on an on-disk H36M
tree, beside the JAX script's ``main`` run in this process (no
subprocess: ``tests/test_pseudo_gt_roundtrip.py`` runs one and is slow).

Tolerances: pseudo-GT 0.05 mm and residuals 1e-4 (as
``tests/test_torch_self_supervised.py``: float32 solves of one system at
4.5 m); the json's joints 0.05 mm, its confidences equal and residuals
1e-4; the merged annot equal to JAX's merge of the same pseudo json; the
round trip's error under the JAX test's 5 mm.
"""

import importlib.util
import json
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from epipolarpose_tpu.config import config as jax_config
from epipolarpose_tpu.config import load_config as jax_load_config
from epipolarpose_tpu.core import self_supervised as jss
from epipolarpose_tpu.data.h36m import CAMERA_IDS
from epipolarpose_tpu.data.pseudo_gt import (
    merge_pseudo_gt_into_annot as jax_merge)
from epipolarpose_tpu.data.synthetic import (SyntheticMultiviewDataset,
                                             write_synthetic_h36m)
from epipolarpose_tpu.geometry import world_to_camera_frame as jax_w2c
from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.core import self_supervised as tss
from epipolarpose_tpu_torch.data.h36m import H36MDataset
from epipolarpose_tpu_torch.data.pseudo_gt import merge_pseudo_gt_into_annot
from epipolarpose_tpu_torch.geometry.camera import (Camera,
                                                    world_to_camera_frame)
from epipolarpose_tpu_torch.scripts import generate_pseudo_gt as port_cli

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEBUG_3D = ROOT / "experiments/debug/synth_smoke_3d.yaml"
G, V, J = 2, 4, 17

TREE_YAML = """
DATASET:
  DATASET: h36m
  ROOT: {root}
  TRAIN_SET: train
  TEST_SET: valid
  LABEL_SOURCE: gt
MODEL:
  NAME: pose3d_resnet
  IMAGE_SIZE: [64, 64]
  NUM_JOINTS: 17
  EXTRA:
    TARGET_TYPE: integral
    HEATMAP_SIZE: [16, 16]
    SIGMA: 1
    NUM_LAYERS: 18
    NUM_DECONV_FILTERS: [32, 32, 32]
    DEPTH_DIM: 8
LOSS:
  USE_TARGET_WEIGHT: true
  TYPE: IntegralL1Loss
TPU:
  COMPUTE_DTYPE: float32
"""


def test_batch_pseudo_gt_in_camera_frames_matches_jax():
    """What the CLI writes for one batch: ``generate_pseudo_gt`` then each
    view's camera frame, from noisy weighted detections."""
    jcfg = jax_load_config(DEBUG_3D)
    tcfg = load_config(DEBUG_3D)
    ds = SyntheticMultiviewDataset(jcfg, num_frames=G, is_train=False,
                                   image_shape=(64, 64))
    batch = next(ds.view_batches(G, shuffle=False))
    rng = np.random.default_rng(3)
    gt = np.stack([[ds.records[i].joints for i in g]
                   for g in ds.view_groups[:G]])
    det = (gt + rng.normal(0, 2.0, gt.shape)).astype(np.float32)
    conf = rng.uniform(0.3, 1.0, (G, V, J)).astype(np.float32)
    jx, jres = jss.generate_pseudo_gt(jcfg, det, conf, batch["camera"])
    want = np.asarray(jax_w2c(jx[:, None], batch["camera"]))
    cam = Camera.from_arrays(jax.tree.map(np.array, batch["camera"]))
    x, res = tss.generate_pseudo_gt(tcfg, torch.tensor(det),
                                    torch.tensor(conf), cam)
    got = world_to_camera_frame(x[:, None], cam).numpy()
    assert got.shape == want.shape == (G, V, J, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.05)
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("conf_min", [0.0, 0.5])
def test_merge_json_equals_jax(tmp_path, conf_min):
    rng = np.random.default_rng(4)
    annot = [{"image": f"S1/img_{i:05d}.jpg", "joints_3d":
              rng.uniform(-500, 500, (J, 3)).tolist(), "subject": 1}
             for i in range(6)]
    pseudo = {str(i): {"joints_3d": rng.uniform(-500, 500, (J, 3)).tolist(),
                       "conf": rng.uniform(0.2, 1.0, J).tolist(),
                       "residual": float(rng.uniform())}
              for i in (0, 2, 3, 5, 9)}          # 9: past the annot's end
    pseudo["3"]["conf"] = None
    (tmp_path / "annot.json").write_text(json.dumps(annot))
    (tmp_path / "pseudo.json").write_text(json.dumps(pseudo))
    n = merge_pseudo_gt_into_annot(str(tmp_path / "annot.json"),
                                   str(tmp_path / "pseudo.json"),
                                   str(tmp_path / "port.json"), conf_min)
    jn = jax_merge(str(tmp_path / "annot.json"),
                   str(tmp_path / "pseudo.json"),
                   str(tmp_path / "jax.json"), conf_min)
    assert n == jn
    assert n == (4 if conf_min == 0.0 else 1)
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()


def _run_jax_script(monkeypatch, argv):
    """The JAX script's ``main`` in this process, with ``argv``."""
    spec = importlib.util.spec_from_file_location(
        "jax_generate_pseudo_gt", ROOT / "scripts" / "generate_pseudo_gt.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["generate_pseudo_gt.py"] + argv)
    mod.main()


def test_cli_gt_detections_merge_and_read_back(tmp_path, monkeypatch,
                                               capsys):
    """``--device cpu --gt-detections --merge-into`` on a 4-frame H36M
    tree: the json equals the JAX script's, the merged annot is JAX's
    merge, and the port's H36M reader reads it back within the JAX round
    trip's 5 mm."""
    jax_config.MODEL.NUM_JOINTS = J
    write_synthetic_h36m(str(tmp_path), jax_config, num_frames=4,
                         camera_ids=CAMERA_IDS)
    yaml = tmp_path / "cfg.yaml"
    yaml.write_text(TREE_YAML.format(root=tmp_path))
    annot = tmp_path / "annot" / "train.json"
    args = ["--cfg", str(yaml), "--gt-detections", "--groups-per-batch",
            "2", "--merge-into", str(annot)]
    _run_jax_script(monkeypatch, args + [
        "--out", str(tmp_path / "jax.json"),
        "--merge-out", str(tmp_path / "annot" / "train_jax.json")])
    capsys.readouterr()
    out = port_cli.main(args + [
        "--out", str(tmp_path / "port.json"), "--device", "cpu",
        "--merge-out", str(tmp_path / "annot" / "train_pseudo.json")])
    printed = capsys.readouterr().out
    assert f"wrote {tmp_path / 'port.json'}: 16 records" in printed
    assert "pseudo-GT MPJPE vs dataset GT: " in printed
    assert "merged pseudo-GT into 16 records -> " in printed
    assert out["records"] == out["merged"] == 16 and out["mpjpe"] < 5.0
    assert out["loop_s"] > 0

    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k]["joints_3d"], w["joints_3d"],
                                   rtol=0, atol=0.05, err_msg=k)
        assert got[k]["conf"] == w["conf"]
        np.testing.assert_allclose(got[k]["residual"], w["residual"],
                                   rtol=0, atol=1e-4)

    # the merge of the port's json is JAX's merge of it
    jax_merge(str(annot), str(tmp_path / "port.json"),
              str(tmp_path / "annot" / "train_check.json"))
    assert json.loads((tmp_path / "annot" / "train_pseudo.json")
                      .read_text()) == json.loads(
        (tmp_path / "annot" / "train_check.json").read_text())

    cfg = load_config(str(yaml))
    ds = H36MDataset(cfg, str(tmp_path), "train_pseudo", is_train=True)
    gt_ds = H36MDataset(cfg, str(tmp_path), "train", is_train=True)
    assert len(ds) == len(gt_ds) == 16
    errs = []
    for i, (r, g) in enumerate(zip(ds.records, gt_ds.records)):
        np.testing.assert_allclose(r.joints_3d, got[str(i)]["joints_3d"],
                                   rtol=1e-6)
        errs.append(np.linalg.norm((r.joints_3d - r.joints_3d[:1])
                                   - (g.joints_3d - g.joints_3d[:1]),
                                   axis=-1).mean())
    assert np.mean(errs) < 5.0, np.mean(errs)
