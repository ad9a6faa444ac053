"""The port's SS convergence tool (``tools/ss_convergence.py``).

- The JAX CI pin's operating point (``tests/test_ss_convergence.py``: the
  SS config cut to ResNet-18 at 64x64, D = 4, float32, LR 0.005;
  ``frames=2, groups=2``, noisy GT detections in the batch, a randomly
  initialized student, the curve on the training poses, 48 steps) run in
  the port: the loss falls at every evaluation point and the MPJPE drops
  as the JAX test asserts (final under 0.8 of the start, floor under 0.2
  of the start).
- ``axis_breakdown``, given the same predictions, equals the JAX tool's
  computation within 1e-3 mm; the pseudo-GT floor, given the same
  detections, within 2e-3 mm: a mean over 51 points of the ``fast``
  solver, whose float32 rounding differs between the packages by up to
  0.05 mm a point (``tests/test_torch_self_supervised.py``); on this
  batch the two floors of 28.3 mm differ by 1.05e-3 mm.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epipolarpose_tpu.config import load_config as jax_load_config
from epipolarpose_tpu.core.self_supervised import \
    generate_pseudo_gt as jax_generate_pseudo_gt
from epipolarpose_tpu.data import \
    SyntheticMultiviewDataset as JaxMultiviewDataset
from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.data import SyntheticMultiviewDataset
from epipolarpose_tpu_torch.tools.ss_convergence import (axis_breakdown,
                                                         make_teacher_cfg,
                                                         pseudo_gt_floor,
                                                         run)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SS_CFG = ROOT / "experiments/h36m/train_ss_r50_256_integral.yaml"


def _ci_cfg(load=load_config):
    cfg = load(SS_CFG)
    cfg.MODEL.IMAGE_SIZE = [64, 64]
    cfg.MODEL.EXTRA.HEATMAP_SIZE = [16, 16]
    cfg.MODEL.EXTRA.NUM_LAYERS = 18
    cfg.MODEL.EXTRA.NUM_DECONV_FILTERS = [32, 32, 32]
    cfg.MODEL.EXTRA.DEPTH_DIM = 4
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TRAIN.LR = 0.005
    return cfg


def test_student_mpjpe_descends_under_ss():
    curve, floor, losses = run(
        _ci_cfg(), frames=2, val_frames=2, groups=2, teacher_steps=0,
        ss_steps=48, eval_every=12, log=lambda *a: None,
        detector="gt_noise", noise_px=2.0, merge_backbone=False,
        eval_on="train", device="cpu")
    start, final = curve[0][1], curve[-1][1]
    assert [s for s, _ in curve] == [0, 12, 24, 36, 48]
    assert final < 0.8 * start, (start, final, curve)
    ls = [v for _, v in losses]
    assert all(a > b for a, b in zip(ls, ls[1:])), losses
    assert ls[-1] < 0.9 * ls[0], losses
    assert floor < 0.2 * start, (floor, start)


def test_make_teacher_cfg():
    t = make_teacher_cfg(_ci_cfg())
    assert (t.MODEL.NAME, t.MODEL.EXTRA.TARGET_TYPE, t.MODEL.EXTRA.DEPTH_DIM,
            t.LOSS.TYPE, t.TRAIN.LR, t.MODEL.EXTRA.SIGMA) == (
        "pose_resnet", "gaussian", 1, "JointsMSELoss", 0.003, 1.0)


def _datasets():
    kw = dict(num_frames=3, is_train=False, image_shape=(64, 64), seed=1,
              pose_mode="skeleton")
    return (JaxMultiviewDataset(_ci_cfg(jax_load_config), **kw),
            SyntheticMultiviewDataset(_ci_cfg(), **kw))


def test_axis_breakdown_matches_jax():
    jds, tds = _datasets()
    rng = np.random.default_rng(0)
    gt = np.stack([np.concatenate([r.joints[:, :2], r.joints_3d[:, 2:]
                                   - r.joints_3d[:1, 2:]], -1)
                   for r in tds.records])
    preds = (gt + rng.normal(0, [3.0, 3.0, 40.0], gt.shape)).astype(
        np.float32)
    # the JAX tool's axis_breakdown, on its own dataset
    recs = jds.records[:len(preds)]
    gts = np.stack([r.joints_3d - r.joints_3d[:1] for r in recs])
    pc = jds._preds_to_camera_mm(preds, recs)
    pc = pc - pc[:, :1]
    d = pc - gts
    want = (float(np.linalg.norm(d[..., :2], axis=-1).mean()),
            float(np.abs(d[..., 2]).mean()))
    got = axis_breakdown(preds, tds)
    assert want[0] > 1.0 and want[1] > 10.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_pseudo_gt_floor_matches_jax():
    jds, tds = _datasets()
    jb = next(jds.view_batches(3, shuffle=False))
    tb = next(tds.view_batches(3, shuffle=False))
    G, V, J = 3, 4, 17
    rng = np.random.default_rng(1)
    idx = jb["index"].reshape(-1)
    det = np.stack([jds.records[i].joints[:, :2] for i in idx])
    det = (det + rng.normal(0, 2.0, det.shape)).astype(np.float32).reshape(
        G, V, J, 2)
    conf = rng.uniform(0.2, 1.0, (G, V, J)).astype(np.float32)
    gt_w = np.stack([jds.records[jds.view_groups[t][0]].meta["pose_world"]
                     for t in range(G)])
    x_w, _ = jax_generate_pseudo_gt(_ci_cfg(jax_load_config),
                                    jnp.asarray(det), jnp.asarray(conf),
                                    jb["camera"])
    want = float(np.linalg.norm(np.asarray(x_w) - gt_w, axis=-1).mean())
    got = pseudo_gt_floor(_ci_cfg(), torch.from_numpy(det),
                          torch.from_numpy(conf), tb["camera"], gt_w)
    assert want > 0.1
    assert got == pytest.approx(want, abs=2e-3)
