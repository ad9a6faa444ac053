"""The port's DLT triangulation (and the rest of its affine helpers) against
the JAX package's, on the CPU in float32.

The cases of ``tests/test_triangulation.py:41-120`` with the bounds it
asserts (rig units: points in [-1, 1], cameras 5 away): exact recovery for
all three solvers (2e-3, residual 1e-3), ``fast`` and ``eigh`` against a
float64 SVD oracle on detections with 2 px noise (5e-3), a corrupted
view down-weighted (5e-3, and 10x worse without weights), two views
(5e-3), and the reprojection error (0.1 px). Each also runs the JAX
function on the same numpy inputs: the port follows it to 1e-3 in X for
``fast`` and ``eigh`` (float32 solves of the same system that round in
another order; the oracle bound is 5e-3) and to 1e-4 in the residual.

The rules the CUDA kernel must keep are pinned against JAX one by one:
the 1e-12 in the row norm, the first of equal column norms, the
Rayleigh step and its fallback, the sign of ``v3`` (0 counts as +) and
the 1e-12 clamp of ``|v3|``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epipolarpose_tpu.geometry import affine as jaff
from epipolarpose_tpu.geometry import triangulation as jtri
from epipolarpose_tpu.geometry.camera import Camera as JaxCamera
from epipolarpose_tpu.geometry.camera import project_point_radial
from epipolarpose_tpu_torch.geometry import affine as taff
from epipolarpose_tpu_torch.geometry import triangulation as ttri
from epipolarpose_tpu_torch.kernels import _build
from epipolarpose_tpu_torch.kernels import triangulate as ktri


def _rig(rng, num_views=4, radius=5.0):
    """tests/test_triangulation.py's rig: cameras on a circle looking at
    the origin, no distortion. Returns (P (V, 3, 4) float32, cameras)."""
    cams = []
    for v in range(num_views):
        ang = 2 * np.pi * v / num_views + rng.uniform(-0.1, 0.1)
        T = np.array([radius * np.cos(ang), radius * np.sin(ang),
                      rng.uniform(1.4, 1.8)], np.float32)
        z = -T / np.linalg.norm(T)
        x = np.cross(np.array([0, 0, 1.0], np.float32), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        cams.append(JaxCamera(R=np.stack([x, y, z]).astype(np.float32), T=T,
                              f=np.array([1145.0, 1143.0], np.float32),
                              c=np.array([512.5, 515.4], np.float32),
                              k=np.zeros(3, np.float32),
                              p=np.zeros(2, np.float32)))
    cams = jax.tree.map(lambda *a: jnp.stack(a), *cams)
    return np.asarray(cams.P, np.float32), cams


def _project(x_gt, cams):
    return np.asarray(project_point_radial(x_gt[:, None], cams)[0])


def _t(a):
    return None if a is None else torch.tensor(np.asarray(a, np.float32))


def _both(px, P, w=None, method="fast"):
    """(port X, port residual, JAX X, JAX residual) as numpy."""
    x, r = ttri.triangulate(_t(px), _t(P), _t(w), method=method)
    jx, jr = jtri.triangulate(jnp.asarray(px, jnp.float32),
                              jnp.asarray(P, jnp.float32),
                              None if w is None else jnp.asarray(w),
                              method=method)
    return x.numpy(), r.numpy(), np.asarray(jx), np.asarray(jr)


def f64_oracle(px, P, w=None):
    """float64 SVD of the normalized, weighted system: X (N, J, 3)."""
    px = np.asarray(px, np.float64).swapaxes(1, 2)          # (N, J, V, 2)
    P = np.asarray(P, np.float64)
    Pb = P[None, None] if P.ndim == 3 else P[:, None]
    r0 = px[..., 0:1] * Pb[..., 2, :] - Pb[..., 0, :]
    r1 = px[..., 1:2] * Pb[..., 2, :] - Pb[..., 1, :]
    A = np.concatenate([r0, r1], axis=-2)
    A = A / np.linalg.norm(A, axis=-1, keepdims=True)
    if w is not None:
        w = np.asarray(w, np.float64).swapaxes(1, 2)
        A = A * np.concatenate([w, w], axis=-1)[..., None]
    h = np.linalg.svd(A)[2][..., -1, :]
    return h[..., :3] / h[..., 3:4]


def _err(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b), axis=-1)


@pytest.mark.parametrize("method", ["svd", "eigh", "fast"])
def test_exact_recovery(method, rng):
    P, cams = _rig(rng)
    x_gt = rng.uniform(-1, 1, (8, 17, 3)).astype(np.float32)
    px = _project(x_gt, cams)
    x, r, jx, jr = _both(px, P, method=method)
    assert _err(x, x_gt).max() < 2e-3
    assert r.max() < 1e-3
    assert _err(x, jx).max() < 1e-3
    np.testing.assert_allclose(r, jr, rtol=0, atol=1e-4)


@pytest.mark.parametrize("method", ["eigh", "fast"])
def test_matches_f64_svd(method, rng):
    P, cams = _rig(rng)
    x_gt = rng.uniform(-1, 1, (4, 17, 3)).astype(np.float32)
    px = _project(x_gt, cams) + rng.normal(0, 2.0, (4, 4, 17, 2))
    oracle = f64_oracle(px, P)
    x, r, jx, jr = _both(px, P, method=method)
    assert _err(x, oracle).max() < 5e-3
    assert _err(x, jx).max() < 1e-3
    np.testing.assert_allclose(r, jr, rtol=0, atol=1e-4)


def test_confidence_weights_downweight_bad_view(rng):
    P, cams = _rig(rng)
    x_gt = rng.uniform(-1, 1, (4, 17, 3)).astype(np.float32)
    px = _project(x_gt, cams).copy()
    px[:, 0] += 300.0
    w = np.ones((4, 4, 17), np.float32)
    w[:, 0] = 1e-4
    x, _, jx, _ = _both(px, P, w)
    err = _err(x, x_gt)
    assert err.max() < 5e-3
    assert _err(x, jx).max() < 1e-3
    assert _err(x, f64_oracle(px, P, w)).max() < 5e-3
    x_bad, _, _, _ = _both(px, P)
    assert _err(x_bad, x_gt).mean() > 10 * err.mean()


def test_two_view_minimum(rng):
    P, cams = _rig(rng, num_views=2)
    x_gt = rng.uniform(-1, 1, (3, 17, 3)).astype(np.float32)
    x, _, jx, _ = _both(_project(x_gt, cams), P)
    assert _err(x, x_gt).max() < 5e-3
    assert _err(x, jx).max() < 1e-3


def test_per_frame_projection_matrices(rng):
    """P (N, V, 3, 4), one rig per frame, as the SS step passes it."""
    rigs = [_rig(rng) for _ in range(3)]
    x_gt = rng.uniform(-1, 1, (3, 17, 3)).astype(np.float32)
    px = np.stack([_project(x_gt[i:i + 1], c)[0]
                   for i, (_, c) in enumerate(rigs)])
    P = np.stack([p for p, _ in rigs])
    x, r, jx, _ = _both(px, P)
    assert _err(x, x_gt).max() < 2e-3 and r.max() < 1e-3
    assert _err(x, jx).max() < 1e-3


def test_reprojection_error_zero_on_exact(rng):
    P, cams = _rig(rng)
    x_gt = rng.uniform(-1, 1, (2, 5, 3)).astype(np.float32)
    pts = np.swapaxes(_project(x_gt, cams), 1, 2)           # (N, J, V, 2)
    e = ttri.reprojection_error(_t(x_gt), _t(pts), _t(P)[None, None])
    assert e.max().item() < 0.1
    je = jtri.reprojection_error(jnp.asarray(x_gt), jnp.asarray(pts),
                                 jnp.asarray(P)[None, None])
    np.testing.assert_allclose(e.numpy(), np.asarray(je), atol=1e-3)
    assert ttri.triangulate_dlt is ttri.triangulate


# ------------------------------------------------- the rules, one by one
def test_build_dlt_system_matches_jax(rng):
    pts = rng.uniform(0, 1000, (5, 4, 2)).astype(np.float32)
    P = rng.normal(size=(4, 3, 4)).astype(np.float32)
    w = rng.uniform(0, 1, (5, 4)).astype(np.float32)
    for weights in (None, w):
        got = ttri.build_dlt_system(_t(pts), _t(P), _t(weights))
        want = jtri.build_dlt_system(pts, P, weights)
        assert got.shape == (5, 8, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    # an all-zero row stays zero: the 1e-12 keeps the division finite
    zero = ttri.build_dlt_system(torch.zeros(1, 2, 2), torch.zeros(2, 3, 4))
    assert torch.equal(zero, torch.zeros(1, 4, 4))


def test_adjugate_and_largest_column_match_jax(rng):
    m = rng.normal(size=(6, 4, 4)).astype(np.float32)
    adj = ttri.adjugate4(_t(m))
    np.testing.assert_allclose(adj.numpy(), np.asarray(jtri.adjugate4(m)),
                               rtol=0, atol=1e-5)
    # adj(M) M = det(M) I
    np.testing.assert_allclose(
        (adj.double() @ _t(m).double()).numpy(),
        np.linalg.det(m.astype(np.float64))[:, None, None] * np.eye(4),
        atol=1e-4)
    # equal column norms: the first column wins, as in JAX
    ties = np.stack([np.eye(4), np.diag([1.0, -1.0, 1.0, 1.0]),
                     np.diag([0.5, 2.0, 2.0, 1.0])]).astype(np.float32)
    got = ttri._max_norm_column(_t(ties))
    want = jtri._max_norm_column(jnp.asarray(ties))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [[1, 0, 0, 0], [1, 0, 0, 0],
                                                [0, 1, 0, 0]])


def test_smallest_eigvec_refinement_and_fallback_match_jax(rng):
    # DLT-like: A (8, 4) with singular values (1, 0.8, 0.5, 1e-3), so the
    # smallest eigenvalue of AᵀA is far below the next, as the solver
    # assumes
    u = np.linalg.qr(rng.normal(size=(5, 8, 4)))[0]
    vt = np.linalg.qr(rng.normal(size=(5, 4, 4)))[0]
    a = (u * np.array([1.0, 0.8, 0.5, 1e-3])) @ vt
    m = np.einsum("nki,nkj->nij", a, a)
    # diag(1e-3): the shifted adjugate is 1e-21 I, below the 1e-12 cut,
    # so the unrefined column is kept
    m = np.concatenate([m, np.diag([1e-3] * 4)[None]]).astype(np.float32)
    for refine in (False, True):
        got = ttri._smallest_eigvec_fast(_t(m), refine=refine)
        want = jtri._smallest_eigvec_fast(jnp.asarray(m), refine=refine)
        np.testing.assert_allclose(np.abs(got.numpy()),
                                   np.abs(np.asarray(want)), atol=1e-4)
    np.testing.assert_array_equal(got[-1].numpy(), [1, 0, 0, 0])
    vecs = np.linalg.eigh(m[:5].astype(np.float64))[1][..., 0]
    cos = np.abs((got[:5].double().numpy() * vecs).sum(-1))
    assert cos.min() > 1 - 1e-5


@pytest.mark.parametrize("v", [[1.0, 2.0, 3.0, 0.0], [1.0, 2.0, 3.0, -2.0],
                               [1.0, 2.0, 3.0, 1e-13],
                               [1.0, 2.0, 3.0, -1e-13],
                               [1.0, -2.0, 3.0, 0.5]])
def test_sign_and_clamp_rules_match_jax(monkeypatch, v):
    """The null vector's sign follows v3 (0 counts as +) and |v3| below
    1e-12 is clamped to 1e-12, in both packages."""
    v = np.asarray(v, np.float32)
    monkeypatch.setattr(ttri, "_null_vector",
                        lambda a, method: torch.from_numpy(v).expand(
                            a.shape[:-2] + (4,)))
    monkeypatch.setattr(jtri, "_null_vector",
                        lambda a, method: jnp.broadcast_to(
                            jnp.asarray(v), a.shape[:-2] + (4,)))
    pts = np.zeros((1, 2, 2), np.float32)
    P = np.tile(np.eye(3, 4, dtype=np.float32), (2, 1, 1))
    x, _ = ttri.triangulate_points(_t(pts), _t(P))
    jx, _ = jtri.triangulate_points(pts, P)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    s = -1.0 if v[3] < 0 else 1.0
    den = max(abs(v[3]), 1e-12) if abs(v[3]) < 1e-12 else abs(v[3])
    np.testing.assert_allclose(x.numpy()[0], s * v[:3] / den, rtol=1e-6)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="method"):
        ttri.triangulate(torch.zeros(1, 2, 1, 2), torch.zeros(2, 3, 4),
                         method="qr")


# ---------------------------------------- the kernel's wrapper, on the CPU
def test_kernel_wrapper_takes_the_plain_version_on_the_cpu(rng):
    P, cams = _rig(rng)
    x_gt = rng.uniform(-1, 1, (2, 17, 3)).astype(np.float32)
    px = _t(_project(x_gt, cams))
    w = _t(rng.uniform(0.5, 1, (2, 4, 17)))
    before = ktri.triangulate_fast.launches
    x, r = ktri.triangulate_fast(px, _t(P), w)
    want = ttri.triangulate(px, _t(P), w, method="fast")
    assert torch.equal(x, want[0]) and torch.equal(r, want[1])
    assert ktri.triangulate_fast.launches == before
    assert _build.library.cache_info().currsize == 0


@pytest.mark.parametrize("views", [1, 2, 8, 9])
def test_kernel_host_check_takes_two_to_eight_views(views):
    """``epk_triangulate`` is built for 2..8 views; the host check refuses
    any other count before a launch."""
    pts = torch.zeros((3, views, 17, 2))
    P = torch.zeros((views, 3, 4))
    if 2 <= views <= 8:
        assert ktri.check_kernel_args(pts, P, None) is False
        assert ktri.check_kernel_args(pts, torch.zeros((3, views, 3, 4)),
                                      torch.zeros((3, views, 17))) is True
    else:
        with pytest.raises(ValueError, match="2 to 8 views"):
            ktri.check_kernel_args(pts, P, None)


@pytest.mark.parametrize("points, layout",
                         [(1, "split"), (544, "split"), (8704, "split"),
                          (8705, "thread"), (1114112, "thread")])
def test_kernel_route_splits_small_batches(points, layout):
    """Four lanes a point up to ``SPLIT_MAX_POINTS`` points (the SS step's
    544 among them), one thread a point beyond."""
    assert ktri.SPLIT_MAX_POINTS == 8704
    assert ktri.route(points) == layout


def test_kernel_host_check_refuses_more_points_than_it_numbers():
    pts = torch.empty((2 ** 16, 2, 2 ** 16, 2), device="meta")
    P = torch.empty((2, 3, 4), device="meta")
    with pytest.raises(ValueError, match="at most"):
        ktri.check_kernel_args(pts, P, None)


def test_kernel_host_check_refuses_other_layouts():
    pts = torch.zeros((3, 4, 17, 2))
    P = torch.zeros((4, 3, 4))
    bad = [(pts.double(), P, None), (pts, P.double(), None),
           (pts.transpose(0, 1), P, None), (pts, torch.zeros(3, 4), None),
           (pts, torch.zeros((2, 4, 3, 4)), None),
           (pts, P, torch.zeros((3, 4, 16))),
           (pts, P, torch.zeros((3, 17, 4)).transpose(1, 2)),
           (torch.zeros((3, 4, 17, 3)), P, None)]
    for args in bad:
        with pytest.raises(ValueError):
            ktri.check_kernel_args(*args)


# ------------------------------------------------- the rest of the affines
def test_affine_helpers_match_jax(rng):
    center = rng.uniform(100, 900, (5, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 2, (5, 2)).astype(np.float32)
    rot = rng.uniform(-30, 30, 5).astype(np.float32)
    for inv in (False, True):
        got = taff.get_affine_transform_np(center, scale, rot, (256, 192),
                                           shift=(0.1, -0.05), inv=inv)
        want = jaff.get_affine_transform_np(center, scale, rot, (256, 192),
                                            shift=(0.1, -0.05), inv=inv)
        np.testing.assert_array_equal(got, want)
        torch_m = taff.get_affine_transform(center, scale, rot, (256, 192),
                                            shift=(0.1, -0.05), inv=inv)
        np.testing.assert_allclose(torch_m.numpy(), got, rtol=1e-5,
                                   atol=1e-3)
    m = taff.get_affine_transform(center, scale, rot, (256, 256))
    inv = taff.invert_affine(m)
    np.testing.assert_allclose(inv.numpy(),
                               np.asarray(jaff.invert_affine(m.numpy())),
                               rtol=1e-5, atol=1e-4)
    pts = _t(rng.uniform(0, 256, (5, 3, 2)))
    back = taff.affine_transform(taff.affine_transform(pts, m[:, None]),
                                 inv[:, None])
    np.testing.assert_allclose(back.numpy(), pts.numpy(), atol=1e-3)


def test_fliplr_joints_matches_jax(rng):
    joints = rng.uniform(0, 200, (2, 6, 3)).astype(np.float32)
    vis = (rng.uniform(size=(2, 6, 3)) > 0.3).astype(np.float32)
    pairs = ((0, 1), (2, 5))
    got, got_vis = taff.fliplr_joints(_t(joints), _t(vis), 200.0, pairs)
    want, want_vis = jaff.fliplr_joints(joints, vis, 200.0, pairs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_vis.numpy(), np.asarray(want_vis))
