"""The port's rig self-calibration against the JAX package's, on the CPU.

The four cases of ``tests/test_rig.py`` (12 frames x 17 joints x 4 views
of a pinhole rig) through ``epipolarpose_tpu_torch.geometry.rig`` and the
JAX functions on the same seeded numpy inputs, plus noisy weighted
detections held to a float64 oracle.

Tolerances:
- port vs JAX, exact detections: P within 1e-4, X and the residual within
  1e-4 of X's largest magnitude (both float32; measured 3.3e-6 and 1.5e-6
  of a unit-baseline scene ~0.8 across);
- noisy detections (2 px, confidences in [0.5, 1]): the port is held to
  the port's own code run in float64 (the oracle) no further than JAX's
  distance to it plus 1e-4 of X's scale. float32 ``eigh`` and SVD make
  JAX's bits no yardstick there; the port also stays within 1e-3 of JAX;
- ``tests/test_rig.py``'s own bounds against the truth (rotations 5e-2,
  50 mm after one scale, reprojection 1e-5, depth ratio 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_rig import _scene

from epipolarpose_tpu.geometry import rig as jrig
from epipolarpose_tpu.geometry import world_to_camera_frame
from epipolarpose_tpu.geometry.camera import normalized_camera_coords
from epipolarpose_tpu_torch.geometry import rig as trig
from epipolarpose_tpu_torch.geometry.camera import Camera

PAIRS = [(0, 1), (2, 3), (4, 5)]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _port_cams(cam_stack) -> Camera:
    return Camera.from_arrays(jax.tree.map(np.array, cam_stack))


def _gt_cam0(poses, cams):
    return np.asarray(world_to_camera_frame(jnp.asarray(poses), cams[0]))


def _true_bone(gt):
    a = np.array([p[0] for p in PAIRS])
    b = np.array([p[1] for p in PAIRS])
    return float(np.linalg.norm(gt[:, a] - gt[:, b], axis=-1).mean())


def test_estimate_rig_recovers_rotations_as_jax_does(rng):
    poses, det, cams, cam_stack = _scene(rng)
    norm = np.zeros_like(det)
    for v, c in enumerate(cams):
        norm[:, v] = np.asarray(normalized_camera_coords(
            jnp.asarray(det[:, v]), c))
    jp, jx = jrig.estimate_rig(jnp.asarray(norm))
    p, x = trig.estimate_rig(_t(norm))
    assert p.shape == (4, 3, 4) and x.shape == (12 * 17, 3)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-4)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx),
                               atol=1e-4 * np.abs(np.asarray(jx)).max())
    r0 = np.asarray(cams[0].R)
    for v in range(1, 4):
        r_gt = np.asarray(cams[v].R) @ r0.T
        assert np.abs(p[v, :, :3].numpy() - r_gt).max() < 5e-2


def test_uncalibrated_pseudo_gt_up_to_scale_as_jax(rng):
    poses, det, cams, cam_stack = _scene(rng)
    jx, jp, jres = jrig.pseudo_gt_uncalibrated(jnp.asarray(det), cam_stack)
    x, p, res = trig.pseudo_gt_uncalibrated(_t(det), _port_cams(cam_stack))
    scale = np.abs(np.asarray(jx)).max()
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-4 * scale)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-4)
    np.testing.assert_allclose(res.numpy(), np.asarray(jres),
                               atol=1e-4 * scale)
    gt = _gt_cam0(poses, cams)
    x = x.numpy()
    s = (x * gt).sum() / (x * x).sum()
    assert np.linalg.norm(s * x - gt, axis=-1).max() < 50.0


def test_uncalibrated_bone_length_scale_as_jax(rng):
    poses, det, cams, cam_stack = _scene(rng)
    gt = _gt_cam0(poses, cams)
    bone = _true_bone(gt)
    jx, _, _ = jrig.pseudo_gt_uncalibrated(jnp.asarray(det), cam_stack,
                                           bone_pairs=PAIRS,
                                           bone_length_mm=bone)
    x, _, _ = trig.pseudo_gt_uncalibrated(_t(det), _port_cams(cam_stack),
                                          bone_pairs=PAIRS,
                                          bone_length_mm=bone)
    # in mm now: 1e-4 of the scene's ~5 m
    np.testing.assert_allclose(x.numpy(), np.asarray(jx),
                               atol=1e-4 * np.abs(gt).max())
    assert np.linalg.norm(x.numpy() - gt, axis=-1).max() < 50.0


def test_bone_scale_keeps_reprojection(rng):
    poses, det, cams, cam_stack = _scene(rng)
    bone = _true_bone(_gt_cam0(poses, cams))
    pc = _port_cams(cam_stack)
    x1, p1, _ = trig.pseudo_gt_uncalibrated(_t(det), pc)
    x2, p2, _ = trig.pseudo_gt_uncalibrated(_t(det), pc, bone_pairs=PAIRS,
                                            bone_length_mm=bone)

    def reproject(x, p):
        xh = torch.cat([x, torch.ones_like(x[..., :1])], -1)
        xc = (p[None, :, None] * xh[:, None, :, None, :]).sum(-1)
        return (xc[..., :2] / xc[..., 2:3]).numpy(), xc[..., 2].numpy()

    r1, z1 = reproject(x1, p1)
    r2, z2 = reproject(x2, p2)
    np.testing.assert_allclose(r1, r2, atol=1e-5)
    s = float(x2.norm() / x1.norm())
    np.testing.assert_allclose(z2, z1 * s, rtol=1e-5)


def test_noisy_weighted_rig_held_to_float64(rng):
    poses, det, cams, cam_stack = _scene(rng)
    det = det + rng.normal(0, 2.0, det.shape).astype(np.float32)
    conf = rng.uniform(0.5, 1.0, det.shape[:-1]).astype(np.float32)
    pc = _port_cams(cam_stack)
    jx, jp, _ = jrig.pseudo_gt_uncalibrated(jnp.asarray(det), cam_stack,
                                            conf=jnp.asarray(conf))
    x, p, _ = trig.pseudo_gt_uncalibrated(_t(det), pc, conf=_t(conf))
    ox, op, _ = trig.pseudo_gt_uncalibrated(
        _t(det).double(), pc, conf=_t(conf).double())
    ox, op = ox.numpy(), op.numpy()
    scale = np.abs(ox).max()
    jx, jp = np.asarray(jx, np.float64), np.asarray(jp, np.float64)
    port_gap = np.abs(x.double().numpy() - ox).max()
    jax_gap = np.abs(jx - ox).max()
    assert port_gap <= jax_gap + 1e-4 * scale, (port_gap, jax_gap)
    assert np.abs(p.double().numpy() - op).max() <= \
        np.abs(jp - op).max() + 1e-4
    np.testing.assert_allclose(x.numpy(), jx, atol=1e-3 * scale)
