"""The port's epipolar geometry against the JAX package's, on the CPU.

The six cases of ``tests/test_epipolar.py`` on the same seeded two-view
scenes, each through ``epipolarpose_tpu_torch.geometry.epipolar`` and the
JAX function, plus the TF32 flag.

Tolerances, all float32 on both sides (the 9x9 ``eigh`` and the 3x3 SVDs
round differently in LAPACK through XLA and through torch):
- F and E are compared up to scale and sign, within 1e-3 of unit norm
  (measured up to 8.4e-5, RANSAC's refit on noisy points);
- ``recover_pose``'s final R within 5e-4 and unit t within 5e-4 of JAX's
  (measured 9e-6 and 4e-5), the same count of points in front. The
  ``decompose_essential`` candidates are not compared: E's two equal
  singular values leave U and Vᵀ free, so they may come in another order;
- RANSAC gets the indices ``jax.random.permutation`` drew, and must give
  the same inlier mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_epipolar import two_view_scene

from epipolarpose_tpu.geometry import epipolar as je
from epipolarpose_tpu_torch.geometry import epipolar as te

F_TOL, POSE_TOL = 1e-3, 5e-4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _up_to_sign(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    return float(min(np.abs(a - b).max(), np.abs(a + b).max()))


def test_fundamental_epipolar_constraint(rng):
    x1, x2, _, _ = two_view_scene(rng)
    f = te.estimate_fundamental(_t(x1), _t(x2))
    d = te.sampson_distance(f, _t(x1), _t(x2))
    assert d.max().item() < 1e-8
    assert np.linalg.svd(f.double().numpy(), compute_uv=False)[2] < 1e-6
    assert _up_to_sign(f, je.estimate_fundamental(x1, x2)) < F_TOL


def test_fundamental_matches_jax_and_cv2(rng):
    import cv2
    x1, x2, _, _ = two_view_scene(rng, noise=1e-4)
    f = te.estimate_fundamental(_t(x1), _t(x2)).numpy()
    assert _up_to_sign(f, je.estimate_fundamental(x1, x2)) < F_TOL
    f_cv, _ = cv2.findFundamentalMat(x1, x2, cv2.FM_8POINT)
    assert _up_to_sign(f, f_cv) < 5e-3          # test_epipolar.py's bound


@pytest.mark.parametrize("noise", [0.0, 1e-4])
def test_recover_pose_matches_jax(rng, noise):
    x1, x2, r_gt, t_gt = two_view_scene(rng, noise=noise)
    e = te.estimate_essential(_t(x1), _t(x2))
    je_ = je.estimate_essential(x1, x2)
    assert _up_to_sign(e, je_) < F_TOL
    r, t, n_good = te.recover_pose(e, _t(x1), _t(x2))
    jr, jt, jn = je.recover_pose(je_, x1, x2)
    assert int(n_good) == int(jn) == x1.shape[0]
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=POSE_TOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=POSE_TOL)
    # test_epipolar.py's bounds against the truth, sign included
    np.testing.assert_allclose(r.numpy(), r_gt, atol=1e-2)
    np.testing.assert_allclose(t.numpy(), t_gt, atol=1e-2)


def test_decompose_essential_rotations_proper(rng):
    x1, x2, _, _ = two_view_scene(rng)
    r1, r2, t = te.decompose_essential(te.estimate_essential(_t(x1),
                                                             _t(x2)))
    for r in (r1, r2):
        assert abs(np.linalg.det(r.double().numpy()) - 1) < 1e-4
        np.testing.assert_allclose(r.double().numpy() @ r.double().numpy().T,
                                   np.eye(3), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(t.numpy()), 1.0, atol=1e-4)
    # the closed-form determinant the port uses for the signs
    m = _t(rng.standard_normal((5, 3, 3)))
    np.testing.assert_allclose(te._det3(m).numpy(),
                               np.linalg.det(m.double().numpy()), rtol=1e-5)


def test_ransac_rejects_outliers_as_jax_does(rng):
    x1, x2, _, _ = two_view_scene(rng, n=60, noise=1e-4)
    n_out = 12
    x2c = x2.copy()
    x2c[:n_out] += rng.uniform(0.3, 0.6, (n_out, 2)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, 128)
    idx = np.asarray(jax.vmap(
        lambda k: jax.random.permutation(k, 60)[:8])(keys))
    jf, jin = je.ransac_fundamental(key, jnp.asarray(x1), jnp.asarray(x2c),
                                    num_hypotheses=128, inlier_thresh=1e-5)
    f, inl = te.ransac_fundamental(_t(x1), _t(x2c), num_hypotheses=128,
                                   inlier_thresh=1e-5,
                                   idx=torch.from_numpy(idx.copy()))
    assert _up_to_sign(f, jf) < F_TOL
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jin))
    # the port's own draw from a generator keeps test_epipolar.py's bounds
    _, inl = te.ransac_fundamental(_t(x1), _t(x2c), num_hypotheses=128,
                                   inlier_thresh=1e-5,
                                   generator=torch.Generator().manual_seed(0))
    assert inl[n_out:].float().mean() > 0.95
    assert inl[:n_out].float().mean() < 0.2


def test_batched_fundamental_matches_jax(rng):
    scenes = [two_view_scene(rng) for _ in range(5)]
    x1 = np.stack([s[0] for s in scenes])
    x2 = np.stack([s[1] for s in scenes])
    f = te.estimate_fundamental(_t(x1), _t(x2))
    assert f.shape == (5, 3, 3)
    assert te.sampson_distance(f, _t(x1), _t(x2)).max().item() < 1e-7
    jf = np.asarray(je.estimate_fundamental(x1, x2))
    for b in range(5):
        assert _up_to_sign(f[b], jf[b]) < F_TOL
    np.testing.assert_allclose(
        te.sampson_distance(_t(jf), _t(x1), _t(x2)).numpy(),
        np.asarray(je.sampson_distance(jf, x1, x2)), rtol=0, atol=1e-12)


def test_epipolar_ignores_the_tf32_flag(rng):
    """Every 3x3 and N x 9 product is elementwise float32: the matmul TF32
    flag cannot change a bit (on the CPU the flag is inert, so this pins
    the code's form; the card check is chip_smoke.py's ``ss_nocam``)."""
    x1, x2, _, _ = two_view_scene(rng, noise=1e-4)
    old = torch.backends.cuda.matmul.allow_tf32
    outs = []
    try:
        for flag in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            e = te.estimate_essential(_t(x1), _t(x2))
            outs.append((e, *te.recover_pose(e, _t(x1), _t(x2))))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    for a, b in zip(*outs):
        assert torch.equal(a, b)
