"""The port's camera model against the JAX package's, on the CPU.

The cases of ``tests/test_camera.py`` (frame round trip, the pinhole
closed form, the H36M projection formula in float64, OpenCV's radial-only
model, undistortion, the projection matrix, batched cameras, pixel2cam),
each run through ``epipolarpose_tpu_torch.geometry.camera`` on the same
seeded numpy inputs, plus the port against the JAX function itself.

Tolerances: port vs JAX 1e-5 relative to the largest magnitude (both
float32; the JAX code contracts at HIGHEST precision, the port with
elementwise products, so sums of three terms round in another order);
the reference cases keep ``tests/test_camera.py``'s bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epipolarpose_tpu.geometry import Camera as JaxCamera
from epipolarpose_tpu.geometry import camera as jcam
from epipolarpose_tpu_torch.data.synthetic import make_rig as port_make_rig
from epipolarpose_tpu_torch.geometry import camera as tcam
from epipolarpose_tpu_torch.geometry.camera import Camera


def _random_fields(rng, with_distortion=True):
    import cv2
    R, _ = cv2.Rodrigues(rng.standard_normal(3) * 0.3)
    return dict(
        R=np.asarray(R, np.float32),
        T=rng.uniform(-2, 2, 3).astype(np.float32)
        + np.array([0, 0, -6], np.float32),
        f=np.array([1100.0, 1100.0], np.float32),
        c=np.array([512.0, 510.0], np.float32),
        k=(np.array([-0.2, 0.2, -0.002], np.float32) if with_distortion
           else np.zeros(3, np.float32)),
        p=(np.array([0.001, -0.0005], np.float32) if with_distortion
           else np.zeros(2, np.float32)))


def _pair(rng, with_distortion=True):
    f = _random_fields(rng, with_distortion)
    return JaxCamera(**f), Camera.from_arrays(**f)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1.0))


def test_camera_fields_and_matrices_match_jax(rng):
    jc, tc = _pair(rng)
    assert tc.R.dtype == torch.float32 and tc.T.shape == (3,)
    _close(tc.K, jc.K)
    _close(tc.P, jc.P)
    back = Camera.from_arrays(jc)
    for name in ("R", "T", "f", "c", "k", "p"):
        assert torch.equal(getattr(back, name), getattr(tc, name))


def test_world_camera_roundtrip(rng):
    jc, tc = _pair(rng)
    P = rng.uniform(-1, 1, (10, 3)).astype(np.float32)
    x = tcam.world_to_camera_frame(_t(P), tc)
    _close(x, jcam.world_to_camera_frame(P, jc))
    back = tcam.camera_to_world_frame(x, tc)
    _close(back, jcam.camera_to_world_frame(np.asarray(x), jc))
    np.testing.assert_allclose(back.numpy(), P, atol=1e-4)


def test_pinhole_projection_closed_form():
    cam = Camera.identity().replace(f=torch.tensor([100.0, 100.0]),
                                    c=torch.tensor([50.0, 60.0]))
    px, d = tcam.project_point_radial(torch.tensor([[1.0, 2.0, 10.0]]), cam)
    np.testing.assert_allclose(px[0].numpy(), [100 * 0.1 + 50,
                                               100 * 0.2 + 60], atol=1e-4)
    np.testing.assert_allclose(d[0].item(), 10.0, atol=1e-5)


def test_projection_matches_h36m_formula_f64_and_jax(rng):
    """The full model against an independent float64 evaluation of the
    H36M formula (0.05 px, as tests/test_camera.py) and against JAX."""
    jc, tc = _pair(rng)
    P = rng.uniform(-1, 1, (20, 3)).astype(np.float64)
    px, d = tcam.project_point_radial(_t(P), tc)
    jpx, jd = jcam.project_point_radial(P.astype(np.float32), jc)
    _close(px, jpx)
    _close(d, jd)
    R, T, f, c, k, p = (np.asarray(getattr(jc, n), np.float64)
                        for n in ("R", "T", "f", "c", "k", "p"))
    X = (R @ (P - T).T).T
    XX = X[:, :2] / X[:, 2:3]
    r2 = (XX ** 2).sum(1)
    radial = 1 + k[0] * r2 + k[1] * r2 ** 2 + k[2] * r2 ** 3
    tan = p[0] * XX[:, 1] + p[1] * XX[:, 0]
    XXX = XX * (radial + tan)[:, None] + np.outer(r2, np.array([p[1], p[0]]))
    np.testing.assert_allclose(px.numpy(), f * XXX + c, atol=0.05)


def test_radial_only_matches_cv2(rng):
    import cv2
    jc, tc = _pair(rng)
    tc = tc.replace(p=torch.zeros(2))
    P = rng.uniform(-1, 1, (20, 3)).astype(np.float64)
    px, _ = tcam.project_point_radial(_t(P), tc)
    R = tc.R.double().numpy()
    rvec, _ = cv2.Rodrigues(R)
    tvec = -R @ tc.T.double().numpy()
    f, c, k = tc.f.numpy(), tc.c.numpy(), tc.k.numpy()
    K = np.array([[f[0], 0, c[0]], [0, f[1], c[1]], [0, 0, 1]], np.float64)
    dist = np.array([k[0], k[1], 0.0, 0.0, k[2]], np.float64)
    expected, _ = cv2.projectPoints(P, rvec, tvec, K, dist)
    np.testing.assert_allclose(px.numpy(), expected[:, 0, :], atol=0.1)


@pytest.mark.parametrize("iters", [5, 8])
def test_undistort_inverts_distortion_and_matches_jax(rng, iters):
    """Undistortion recovers the pinhole pixels to 0.05 px (as
    tests/test_camera.py) and follows the JAX iteration to 1e-5 relative."""
    jc, tc = _pair(rng)
    pinhole = tc.replace(k=torch.zeros(3), p=torch.zeros(2))
    P = _t(rng.uniform(-1, 1, (50, 3)))
    ideal, _ = tcam.project_point_radial(P, pinhole)
    distorted, _ = tcam.project_point_radial(P, tc)
    got = tcam.undistort_points(distorted, tc, iters=iters)
    np.testing.assert_allclose(got.numpy(), ideal.numpy(), atol=0.05)
    _close(got, jcam.undistort_points(distorted.numpy(), jc, iters=iters))


def test_projection_matrix_pinhole_consistency(rng):
    _, tc = _pair(rng, with_distortion=False)
    P3 = _t(rng.uniform(-1, 1, (10, 3)))
    px, _ = tcam.project_point_radial(P3, tc)
    ph = torch.cat([P3, torch.ones(10, 1)], 1)
    proj = (tc.P.double() @ ph.double().T).T
    proj = proj[:, :2] / proj[:, 2:3]
    np.testing.assert_allclose(px.numpy(), proj.numpy(), atol=1e-2)


def test_batched_cameras(rng):
    cams = Camera.identity((4,))
    P = _t(rng.uniform(-1, 1, (4, 7, 3)) + np.array([0, 0, 5]))
    px, d = tcam.project_point_radial(P, cams)
    assert px.shape == (4, 7, 2) and d.shape == (4, 7)
    jpx, jd = jcam.project_point_radial(P.numpy(), JaxCamera.identity((4,)))
    _close(px, jpx)


def test_pixel2cam_inverts_projection(rng):
    jc, tc = _pair(rng)
    pts = _t(rng.uniform(-400, 400, (1, 10, 3)) + np.array([0, 0, 4000.0]))
    px, depth = tcam.project_point_radial(pts, tc)
    ideal = tcam.undistort_points(px, tc)
    back = tcam.pixel2cam(ideal, depth, tc)
    gt = tcam.world_to_camera_frame(pts, tc)
    np.testing.assert_allclose(back.numpy(), gt.numpy(), atol=0.5)
    _close(back, jcam.pixel2cam(ideal.numpy(), depth.numpy(), jc))
    _close(tcam.normalized_camera_coords(px, tc),
           jcam.normalized_camera_coords(px.numpy(), jc))


def test_geometry_ignores_the_tf32_flag(rng):
    """Camera math is elementwise float32: the matmul TF32 flag cannot
    change a bit of it (on the CPU the flag is inert, so this pins the
    code's form; the card check is in chip_smoke.py)."""
    _, tc = _pair(rng)
    P = _t(rng.uniform(-1, 1, (2, 30, 3)))
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        outs = []
        for flag in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            px, _ = tcam.project_point_radial(P, tc)
            outs.append((tc.P, px, tcam.undistort_points(px, tc)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_port_rig_matches_jax_rig():
    """The port's copy of ``make_rig`` gives the JAX rig's numbers."""
    from epipolarpose_tpu.data.synthetic import make_rig as jax_make_rig
    for seed in (0, 3):
        for jc, tc in zip(jax_make_rig(4, img_size=256, seed=seed),
                          port_make_rig(4, img_size=256, seed=seed)):
            for name in ("R", "T", "f", "c", "k", "p"):
                np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                              np.asarray(getattr(jc, name)))


def test_port_skeleton_poses_match_jax():
    from epipolarpose_tpu.data import synthetic as jsyn
    from epipolarpose_tpu_torch.data import synthetic as tsyn
    a = jsyn.synth_skeleton_poses(np.random.default_rng(5), 6, 17)
    b = tsyn.synth_skeleton_poses(np.random.default_rng(5), 6, 17)
    np.testing.assert_array_equal(a, b)
    aa = np.random.default_rng(1).normal(size=(4, 3)).astype(np.float32)
    np.testing.assert_array_equal(jsyn._rodrigues_batch(aa),
                                  tsyn._rodrigues_batch(aa))
    for x, y in zip(jsyn.skeleton_template(16), tsyn.skeleton_template(16)):
        np.testing.assert_array_equal(x, y)


def test_camera_stack_map_and_to():
    cams = port_make_rig(3)
    stacked = Camera.stack(cams)
    assert stacked.R.shape == (3, 3, 3) and stacked.k.shape == (3, 3)
    grouped = stacked.map(lambda t: t[None].expand((2,) + t.shape))
    assert grouped.P.shape == (2, 3, 3, 4)
    moved = grouped.to("cpu")
    assert torch.equal(moved.P, grouped.P)
    np.testing.assert_allclose(stacked.P[1].numpy(), cams[1].P.numpy())
    jp = jnp.asarray(JaxCamera(**{n: getattr(cams[1], n).numpy()
                                  for n in ("R", "T", "f", "c", "k",
                                            "p")}).P)
    _close(cams[1].P, jp)
