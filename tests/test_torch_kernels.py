"""The port's CUDA kernels against their plain versions, on the card.

Imports torch and numpy only, so it runs on the card's machine without
JAX (``--noconftest`` skips the suite's JAX setup there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py

Without a CUDA card every test here skips. Tolerances: soft-argmax 1e-5
in normalized coordinates (float32 sums in other orders); its saved
statistics 1e-4 in lse and 1e-5 of the axis length in Ex, Ey, Ez; its
backward 1e-5 of the largest incoming gradient in float32 (both round the
same float32 product in other orders) and 2^-7 of it in bfloat16 (one
bf16 spacing of the output, whose entries stay below the incoming
gradient); matmul y within one bf16 spacing (both round an f32 sum of the
same products; entries below 1/256 of y's rms are measured at that
floor), stats 1e-3 of the largest stat (both routes sum the rows in
another order than the plain version; the simt route's atomics add block
partials in any order, the wgmma route's partials are summed in a fixed
order, so its stats are the same bits from call to call); triangulation
(mm, the synthetic H36M-like rig): residual within 1e-4 of the plain
version; X no further from the same solver run in float64 than twice the
plain version's distance from it plus 0.05 mm (the plain version rounds
in float32 throughout, the kernel its rows in float32 and AᵀA and the
Rayleigh step in float64; at this scale AᵀA spans many decades and a
float32 adjugate amplifies rounding to millimetres where the data
disagree), and no further from a float64 SVD than the plain version plus
that allowance.
"""

import numpy as np
import pytest
import torch

from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.core import create_train_state, make_train_step
from epipolarpose_tpu_torch.core.steps import (configure_backends,
                                               make_eval_step)
from epipolarpose_tpu_torch.kernels import matmul_stats as kms
from epipolarpose_tpu_torch.core import self_supervised as tss
from epipolarpose_tpu_torch.data.synthetic import (make_rig,
                                                  synth_skeleton_poses)
from epipolarpose_tpu_torch.geometry import triangulation as ttri
from epipolarpose_tpu_torch.geometry.camera import (Camera,
                                                    project_point_radial,
                                                    undistort_points)
from epipolarpose_tpu_torch.kernels import softargmax as ksa
from epipolarpose_tpu_torch.kernels import triangulate as ktri
from epipolarpose_tpu_torch.models import get_pose_net

H36M_FLIP_PAIRS = ((1, 4), (2, 5), (3, 6), (11, 14), (12, 15), (13, 16))

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _max_bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| in bf16 spacings at max(|a|, |b|, rms(b) / 256).

    The floor: an entry near zero by cancellation carries the f32 rounding
    of its K-term sum, which depends on the summation order and can exceed
    its own bf16 spacing in any two implementations."""
    floor = b.pow(2).mean().sqrt() / 256
    mag = torch.maximum(torch.maximum(a.abs(), b.abs()), floor)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((a - b).abs() / ulp).max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 1, 16, 16), (2, 17, 8, 16, 24),
                                   (3, 5, 4, 7, 32)])
def test_softargmax_kernel_matches_plain(cuda, dtype, shape):
    n, j, d, h, w = shape
    g = torch.Generator(cuda).manual_seed(0)
    x = (3 * torch.randn((n, j * d, h, w), generator=g, device=cuda)).to(dtype)
    before = ksa.softmax_integral.launches
    got = ksa.softmax_integral(x, j, d)
    assert ksa.softmax_integral.launches == before + 1
    want = ksa.softmax_integral_plain(x, j, d)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    if d == 1:
        assert torch.all(got[..., 2] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 1, 16, 16), (2, 17, 8, 13, 24),
                                   (2, 4, 64, 8, 16)])
def test_softargmax_forward_saves_the_plain_statistics(cuda, dtype, shape):
    n, j, d, h, w = shape
    g = torch.Generator(cuda).manual_seed(1)
    x = (3 * torch.randn((n, j * d, h, w), generator=g, device=cuda)).to(dtype)
    before = ksa.softmax_integral.launches
    coords, stats = ksa.softmax_integral_fwd(x, j, d)
    assert ksa.softmax_integral.launches == before + 1
    want = ksa.softmax_integral_stats_plain(x, j, d)
    torch.testing.assert_close(stats[..., 0], want[..., 0], rtol=0,
                               atol=1e-4)
    for axis, size in ((1, w), (2, h), (3, d)):
        torch.testing.assert_close(stats[..., axis], want[..., axis],
                                   rtol=0, atol=1e-5 * size)
    torch.testing.assert_close(coords, ksa.softmax_integral_plain(x, j, d),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 1, 16, 16), (2, 17, 8, 13, 24),
                                   (2, 4, 64, 8, 16)])
def test_softargmax_backward_kernel_matches_plain(cuda, dtype, shape):
    n, j, d, h, w = shape
    g = torch.Generator(cuda).manual_seed(2)
    x = (3 * torch.randn((n, j * d, h, w), generator=g, device=cuda)).to(dtype)
    grad = torch.randn((n, j, 3), generator=g, device=cuda)
    stats = ksa.softmax_integral_stats_plain(x, j, d)
    before = ksa.softmax_integral_bwd.launches
    got = ksa.softmax_integral_bwd(x, stats, grad)
    assert ksa.softmax_integral_bwd.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = ksa.softmax_integral_bwd_plain(x, stats, grad)
    gmax = grad.abs().max()
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert diff.max() <= 1e-5 * gmax
    else:
        # each entry within one bf16 spacing of the plain entry (both round
        # one float32 value) plus 1e-6 x max|g| (float32 cancellation)
        _, e = torch.frexp(want.float())
        spacing = torch.where(want == 0, 0.0,
                              torch.ldexp(torch.ones_like(diff), e - 8))
        assert (diff <= spacing + 1e-6 * gmax).all()
    assert want.abs().max() > 1e-3 * gmax


def test_softargmax_gradient_on_card_matches_cpu(cuda):
    """Through the autograd Function on the card (both kernels) against
    ordinary autograd of the plain version on the CPU, float32; a
    non-contiguous incoming gradient; no statistics without a gradient."""
    n, j, d, h, w = 2, 5, 8, 12, 16
    x = 3 * torch.randn((n, j * d, h, w), generator=torch.Generator()
                        .manual_seed(3))
    grad = torch.randn((n, 3, j), generator=torch.Generator().manual_seed(4))
    grad = grad.transpose(1, 2)                    # (n, j, 3), strided
    xc = x.clone().requires_grad_(True)
    ksa.softmax_integral(xc, j, d).backward(grad)
    xg = x.to(cuda).requires_grad_(True)
    fwd, bwd = ksa.softmax_integral.launches, ksa.softmax_integral_bwd.launches
    out = ksa.softmax_integral(xg, j, d)
    assert out.grad_fn is not None
    out.backward(grad.to(cuda))
    assert ksa.softmax_integral.launches == fwd + 1
    assert ksa.softmax_integral_bwd.launches == bwd + 1
    torch.testing.assert_close(xg.grad.cpu(), xc.grad, rtol=0,
                               atol=1e-5 * xc.grad.abs().max().item())
    with torch.inference_mode():
        assert ksa.softmax_integral(xg, j, d).grad_fn is None


def test_softargmax_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros((2, 6, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ksa.softmax_integral(x.transpose(2, 3), 3, 2)
    with pytest.raises(TypeError):
        ksa.softmax_integral(x.half(), 3, 2)
    stats = torch.zeros((2, 3, 4), device=cuda)
    grad = torch.zeros((2, 3, 3), device=cuda)
    with pytest.raises(ValueError, match="stats"):
        ksa.softmax_integral_bwd(x, stats[..., :3].contiguous(), grad)
    with pytest.raises(ValueError, match="grad"):
        ksa.softmax_integral_bwd(x, stats, grad.double())


# (M, K, N), elements x starts into its storage, the route it must take:
# full tool shapes of each ResNet stage, M not a multiple of the 128-row
# tile, column tiles cut by N, K not a multiple of the 64-deep stage, and
# what TMA cannot describe (K, N not multiples of 8; a misaligned view)
MATMUL_CASES = [
    ((524288, 64, 256), 0, "wgmma"), ((131072, 256, 512), 0, "wgmma"),
    ((32768, 512, 1024), 0, "wgmma"), ((8192, 1024, 2048), 0, "wgmma"),
    ((8192, 512, 256), 0, "wgmma"), ((256, 64, 64), 0, "wgmma"),
    ((1000, 128, 136), 0, "wgmma"), ((300, 72, 200), 0, "wgmma"),
    ((131, 13, 70), 0, "simt"), ((256, 64, 64), 1, "simt"),
]


@pytest.mark.parametrize("shape,offset,route", MATMUL_CASES,
                         ids=lambda v: str(v))
def test_matmul_stats_kernel_matches_plain(cuda, shape, offset, route):
    m, k, n = shape
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn(offset + m * k, generator=g, device=cuda,
                    dtype=torch.bfloat16)[offset:].view(m, k)
    w = torch.randn((k, n), generator=g, device=cuda, dtype=torch.bfloat16)
    count = {"wgmma": "launches_wgmma", "simt": "launches_simt"}
    before = {a: getattr(kms.matmul_stats, a)
              for a in ("launches", *count.values())}
    y, s = kms.matmul_stats(x, w)
    after = {a: getattr(kms.matmul_stats, a) for a in before}
    assert after["launches"] == before["launches"] + 1
    for way, attr in count.items():
        assert after[attr] == before[attr] + (way == route), way
    y_ref, s_ref = kms.matmul_stats_plain(x, w)
    assert _max_bf16_ulps(y.float(), y_ref.float()) <= 1.0
    scale = s_ref.abs().amax(dim=1, keepdim=True)
    assert torch.all((s - s_ref).abs() <= 1e-3 * scale)


@pytest.mark.parametrize("shape", [(524288, 64, 64), (8192, 1024, 2048),
                                   (1000, 128, 136)], ids=str)
def test_matmul_stats_wgmma_stats_are_deterministic(cuda, shape):
    """The wgmma route sums its per-block partials in a fixed order: two
    calls give the same bits, in y and in the stats."""
    m, k, n = shape
    g = torch.Generator(cuda).manual_seed(1)
    x = torch.randn((m, k), generator=g, device=cuda, dtype=torch.bfloat16)
    w = torch.randn((k, n), generator=g, device=cuda, dtype=torch.bfloat16)
    before = kms.matmul_stats.launches_wgmma
    y1, s1 = kms.matmul_stats(x, w)
    y2, s2 = kms.matmul_stats(x, w)
    assert kms.matmul_stats.launches_wgmma == before + 2
    assert torch.equal(s1, s2) and torch.equal(y1, y2)


def test_eval_step_on_card_matches_cpu(cuda):
    """Debug config in float32 with flip test: the card (TF32 off, the
    soft-argmax kernel) against the CPU (plain decode), same weights."""
    cfg = load_config("experiments/debug/synth_smoke_3d.yaml")
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TEST.FLIP_TEST = cfg.TEST.SHIFT_HEATMAP = True
    configure_backends(cfg)
    gen = torch.Generator().manual_seed(0)
    model = get_pose_net(cfg, generator=gen)
    with torch.no_grad():
        for mod in (*model.deconv_layers, model.final_layer):
            w = getattr(mod, "weight", None)
            if w is not None and w.ndim == 4:
                w.normal_(0.0, 0.05, generator=gen)
    rng = np.random.default_rng(0)
    batch = {"input": rng.integers(0, 256, (4, 64, 64, 3), np.uint8),
             "center": rng.uniform(80, 400, (4, 2)).astype(np.float32),
             "scale": rng.uniform(0.2, 0.6, (4, 2)).astype(np.float32)}
    want = make_eval_step(cfg, model, H36M_FLIP_PAIRS, device="cpu")(batch)
    before = ksa.softmax_integral.launches
    got = make_eval_step(cfg, model, H36M_FLIP_PAIRS, device=cuda)(batch)
    assert ksa.softmax_integral.launches == before + 1
    got, want = got["preds"].cpu(), want["preds"]
    torch.testing.assert_close(got[..., :2], want[..., :2], rtol=0, atol=1e-3)
    torch.testing.assert_close(got[..., 2], want[..., 2], rtol=0, atol=1e-2)


def test_train_steps_on_card_match_cpu(cuda):
    """Debug config in float32 (TF32 off), three Adam steps on one batch
    each: the card (cuDNN, both soft-argmax kernels) against the CPU
    (plain version), from the same weights. Loss of each step relative
    1e-4; Adam's first moment after step 1 (0.1 x the gradient) to 1e-3
    of each tensor's largest."""
    cfg = load_config("experiments/debug/synth_smoke_3d.yaml")
    cfg.TPU.COMPUTE_DTYPE = "float32"
    configure_backends(cfg)
    gen = torch.Generator().manual_seed(0)
    base = get_pose_net(cfg, generator=gen)
    with torch.no_grad():
        for mod in (*base.deconv_layers, base.final_layer):
            w = getattr(mod, "weight", None)
            if w is not None and w.ndim == 4:
                w.normal_(0.0, 0.05, generator=gen)
    rng = np.random.default_rng(0)
    batches = [{"input": rng.integers(0, 256, (4, 64, 64, 3), np.uint8),
                "joints": rng.uniform(0, 64, (4, 17, 2)).astype(np.float32),
                "joints_vis": np.ones((4, 17), np.float32),
                "joints_3d": rng.uniform(-700, 700, (4, 17, 3)).astype(
                    np.float32)} for _ in range(3)]
    runs = {}
    for dev in ("cpu", cuda):
        model = get_pose_net(cfg)
        model.load_state_dict(base.state_dict())
        state = create_train_state(cfg, model, steps_per_epoch=10,
                                   device=dev)
        step = make_train_step(cfg, model, device=dev)
        fwd = ksa.softmax_integral.launches
        bwd = ksa.softmax_integral_bwd.launches
        losses, moments = [], None
        for k, batch in enumerate(batches):
            losses.append(step(state, batch)[1]["loss"].item())
            if k == 0:
                # a copy: Adam updates the moment in place in later steps
                moments = {name: state.optimizer.state[p]["exp_avg"]
                           .to("cpu", copy=True)
                           for name, p in model.named_parameters()}
        runs[str(dev)] = (losses, moments, ksa.softmax_integral.launches
                          - fwd, ksa.softmax_integral_bwd.launches - bwd)
    cpu, card = runs["cpu"], runs[str(cuda)]
    assert cpu[2:] == (0, 0) and card[2:] == (3, 3)
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-4)
    for name, want in cpu[1].items():
        scale = want.abs().max().item()
        torch.testing.assert_close(card[1][name], want, rtol=0,
                                   atol=1e-3 * scale, msg=name)


def _rig_points(views, frames, joints, seed, device, per_frame):
    """Undistorted noisy detections (N, V, J, 2) of skeleton poses seen by
    the synthetic rig (one rig for all frames, or one of its own per
    frame), its P ((V, 3, 4) or (N, V, 3, 4)), weights (with 3 views or
    more, view 0 moved by 60 px and weighted 1e-3), and the poses."""
    rng = np.random.default_rng(seed)
    poses = synth_skeleton_poses(rng, frames, joints) + rng.uniform(
        [-150, -150, 600], [150, 150, 1000], (frames, 1, 3)).astype(
            np.float32)
    # two views from a 4-camera ring stand 90 degrees apart (a 2-camera
    # ring would face each other, and their rays would nearly coincide)
    rigs = [Camera.stack(make_rig(max(views, 4), seed=seed + n)[:views])
            for n in range(frames if per_frame else 1)]
    cams = Camera.stack(rigs)                        # (1 or N, V, ...)
    px, _ = project_point_radial(torch.tensor(poses)[:, None], cams)
    px = px + torch.tensor(rng.normal(0, 2.0, px.shape), dtype=torch.float32)
    w = torch.tensor(rng.uniform(0.5, 1.0, (frames, views, joints)),
                     dtype=torch.float32)
    if views > 2:
        px[:, 0] += 60.0
        w[:, 0] = 1e-3
    und = undistort_points(px, cams)
    P = cams.P if per_frame else cams.P[0]
    return (und.contiguous().to(device), P.contiguous().to(device),
            w.to(device), torch.tensor(poses))


# each layout of the kernel, forced through the route's threshold
LAYOUTS = {"thread": -1, "split": 2 ** 31}


def _launch_in(layout, monkeypatch, pts, P, w):
    """One call of the wrapper in ``layout``; asserts that it launched once,
    in that layout."""
    monkeypatch.setattr(ktri, "SPLIT_MAX_POINTS", LAYOUTS[layout])
    before = (ktri.triangulate_fast.launches,
              getattr(ktri.triangulate_fast, f"launches_{layout}"))
    out = ktri.triangulate_fast(pts, P, w)
    assert (ktri.triangulate_fast.launches,
            getattr(ktri.triangulate_fast, f"launches_{layout}")) == (
        before[0] + 1, before[1] + 1)
    return out


def _check_against_plain_and_f64(x, res, pts, P, w):
    """Residual within 1e-4 of the plain version; X no further from the
    same solver in float64 than twice the plain version plus 0.05 mm, and
    no further from a float64 SVD than the plain version plus that."""
    n, _, j, _ = pts.shape
    want, want_res = ktri.triangulate_fast_plain(pts, P, w)
    w64 = None if w is None else w.double()
    same64, _ = ttri.triangulate(pts.double(), P.double(), w64,
                                 method="fast")
    oracle, _ = ttri.triangulate(pts.double(), P.double(), w64,
                                 method="svd")
    torch.cuda.synchronize()
    assert x.shape == (n, j, 3) and res.shape == (n, j)
    assert torch.isfinite(x).all() and torch.isfinite(res).all()
    torch.testing.assert_close(res, want_res, rtol=0, atol=1e-4)

    def gap(a, b):
        return (a.double() - b).norm(dim=-1).max().item()
    # rounding: as close to the same solver in float64 as the plain version
    allowance = 2 * gap(want, same64) + 0.05
    assert gap(x, same64) <= allowance, (gap(x, same64), allowance)
    # the solver's own error (one refinement step) against the float64
    # SVD: the kernel's is the plain version's, to that rounding
    assert gap(x, oracle) <= gap(want, oracle) + allowance


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("per_frame", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("views", range(2, 9))
def test_triangulate_kernel_matches_plain_and_f64(cuda, monkeypatch, views,
                                                  weighted, per_frame,
                                                  layout):
    pts, P, w, poses = _rig_points(views, 300, 17, views, cuda, per_frame)
    w = w if weighted else None
    x, res = _launch_in(layout, monkeypatch, pts, P, w)
    _check_against_plain_and_f64(x, res, pts, P, w)
    if weighted and views > 2:     # the moved view is weighted away
        err = (x.cpu() - poses).norm(dim=-1)
        assert err.mean().item() < 20.0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("frames, joints",
                         [(1, 1), (1, 16), (1, 17), (31, 16), (31, 17),
                          (300, 16), (300, 17)])
@pytest.mark.parametrize("views", [3, 4, 5])
def test_triangulate_kernel_ragged_sizes(cuda, monkeypatch, views, frames,
                                         joints, layout):
    """Point counts that leave a warp, a block or a frame part-full, with
    per-frame P at odd frame counts: every point right."""
    pts, P, w, _ = _rig_points(views, frames, joints, 40 + frames, cuda,
                               per_frame=frames % 2 == 1)
    x, res = _launch_in(layout, monkeypatch, pts, P, w)
    _check_against_plain_and_f64(x, res, pts, P, w)


def test_triangulate_kernel_at_the_ss_step_shape(cuda):
    """The self-supervised step's call: 32 frames x 17 joints, 4 views,
    per-frame P, weights; the wrapper's own route."""
    pts, P, w, poses = _rig_points(4, 32, 17, 7, cuda, per_frame=True)
    assert ktri.route(32 * 17) == "split"
    before = ktri.triangulate_fast.launches_split
    x, res = ktri.triangulate_fast(pts, P, w)
    assert ktri.triangulate_fast.launches_split == before + 1
    _check_against_plain_and_f64(x, res, pts, P, w)
    assert (x.cpu() - poses).norm(dim=-1).mean().item() < 20.0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_triangulate_kernel_gives_the_same_bits_twice(cuda, monkeypatch,
                                                      layout):
    pts, P, w, _ = _rig_points(4, 300, 17, 8, cuda, per_frame=False)
    first = _launch_in(layout, monkeypatch, pts, P, w)
    second = _launch_in(layout, monkeypatch, pts, P, w)
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


def test_triangulate_kernel_exact_data_and_tf32(cuda):
    """Exact detections: the poses to under 1 mm with a residual under
    1e-3; the same bits with the TF32 flags set and cleared."""
    rng = np.random.default_rng(1)
    poses = torch.tensor(synth_skeleton_poses(rng, 64, 17) + 800.0)
    cams = Camera.stack([Camera.stack(make_rig(4, seed=1))])   # (1, V)
    px, _ = project_point_radial(poses[:, None], cams)
    und = undistort_points(px, cams).contiguous().to(cuda)
    P = cams.P[0].contiguous().to(cuda)
    outs = []
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    try:
        for flag in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            torch.backends.cudnn.allow_tf32 = flag
            outs.append(ktri.triangulate_fast(und, P))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    x, res = outs[0]
    assert (x.cpu() - poses).norm(dim=-1).max().item() < 1.0
    assert res.max().item() < 1e-3
    want, _ = ktri.triangulate_fast_plain(und, P)
    same64, _ = ttri.triangulate(und.double(), P.double(), method="fast")

    def gap(a):
        return (a.double() - same64).norm(dim=-1).max().item()
    assert gap(x) <= 2 * gap(want) + 0.05, (gap(x), gap(want))


def test_triangulate_kernel_rejects_what_it_does_not_take(cuda):
    pts = torch.zeros((2, 9, 17, 2), device=cuda)
    with pytest.raises(ValueError, match="2 to 8 views"):
        ktri.triangulate_fast(pts, torch.zeros((9, 3, 4), device=cuda))
    pts = torch.zeros((2, 4, 17, 2), device=cuda)
    with pytest.raises(ValueError):
        ktri.triangulate_fast(pts.double(), torch.zeros((4, 3, 4),
                                                        device=cuda))
    with pytest.raises(ValueError):
        ktri.triangulate_fast(pts, torch.zeros((4, 3, 4)))


def test_ss_step_on_card_matches_cpu(cuda):
    """One self-supervised step at the debug size in float32 (TF32 off):
    the card (triangulation and soft-argmax kernels) against the CPU
    (plain versions), from the same weights and detections. Loss relative
    1e-4, mean residual 1e-4; one launch of each kernel."""
    cfg = load_config("experiments/debug/synth_smoke_3d.yaml")
    cfg.TPU.COMPUTE_DTYPE = "float32"
    configure_backends(cfg)
    base = get_pose_net(cfg, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    groups, views, joints = 2, 4, 17
    poses = synth_skeleton_poses(rng, groups, joints) + 800.0
    cams = Camera.stack(make_rig(views, img_size=256, seed=2))
    cams = cams.map(lambda t: t[None].repeat((groups,) + (1,) * t.ndim))
    px, _ = project_point_radial(torch.tensor(poses)[:, None], cams)
    centre = px.mean(dim=2)
    batch = {"input": rng.integers(0, 256, (groups, views, 64, 64, 3),
                                   np.uint8),
             "center": centre.numpy(),
             "scale": np.full((groups, views, 2), 1.5, np.float32),
             "camera": cams,
             "det_src": (px + torch.tensor(rng.normal(0, 1.0, px.shape),
                                           dtype=torch.float32)).numpy(),
             "det_conf": rng.uniform(0.5, 1, (groups, views, joints)
                                     ).astype(np.float32)}
    runs = {}
    for dev in ("cpu", cuda):
        model = get_pose_net(cfg)
        model.load_state_dict(base.state_dict())
        state = create_train_state(cfg, model, 10, device=dev)
        step = tss.make_ss_train_step(cfg, model, None, device=dev)
        counts = (ktri.triangulate_fast.launches,
                  ksa.softmax_integral.launches,
                  ksa.softmax_integral_bwd.launches)
        _, m = step(state, batch)
        runs[str(dev)] = ({k: v.item() for k, v in m.items()},
                          (ktri.triangulate_fast.launches - counts[0],
                           ksa.softmax_integral.launches - counts[1],
                           ksa.softmax_integral_bwd.launches - counts[2]))
    cpu, card = runs["cpu"], runs[str(cuda)]
    assert cpu[1] == (0, 0, 0) and card[1] == (1, 1, 1)
    assert cpu[0]["loss"] > 0
    np.testing.assert_allclose(card[0]["loss"], cpu[0]["loss"], rtol=1e-4)
    np.testing.assert_allclose(card[0]["tri_residual"],
                               cpu[0]["tri_residual"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(card[0]["teacher_conf"],
                               cpu[0]["teacher_conf"], rtol=1e-6)


# ------------------------------------------------ the loader on the card
def _busy(device: torch.device) -> None:
    """Queue about a millisecond of work on the current stream, so a read
    that did not wait for the loader's copy would race it."""
    a = torch.randn((2048, 2048), device=device)
    for _ in range(4):
        a = a @ a
        a = a / a.norm()


@pytest.mark.parametrize("mode", ["eval", "multiview"])
def test_epoch_loader_on_card_equals_the_host_batches(cuda, mode):
    """Every batch the loader puts on the card (pinned copies on a side
    stream) holds the host batch's bits, read by a busy consumer stream,
    with the copies' memory recycled from batch to batch."""
    from epipolarpose_tpu_torch.data import epoch_loader, get_dataset
    cfg = load_config("experiments/debug/synth_smoke_3d.yaml")
    cfg.DATASET.DATASET = ("synthetic_multiview" if mode == "multiview"
                           else "synthetic")
    kw = (dict(num_frames=8, image_shape=(64, 64)) if mode == "multiview"
          else dict(num_samples=40, image_shape=(96, 96)))
    ds = get_dataset(cfg, "valid", mode == "multiview", **kw)
    if mode == "multiview":
        want = list(ds.view_batches(2, seed=3, shuffle=True, augment=True))
        got = epoch_loader(ds, 2, 3, is_train=True, device=cuda,
                           multiview=True, prefetch=3)
    else:
        want = list(ds.batches(8, seed=3, shuffle=False, drop_last=False))
        got = epoch_loader(ds, 8, 3, is_train=False, device=cuda, prefetch=3)
    n = 0
    for g, w in zip(got, want):
        _busy(cuda)
        for k, v in w.items():
            if k == "camera":
                for f in ("R", "T", "f", "c", "k", "p"):
                    t = getattr(g[k], f)
                    assert t.device.type == "cuda"
                    assert torch.equal(t.cpu(), getattr(v, f))
            else:
                assert g[k].device.type == "cuda", k
                assert torch.equal(g[k].cpu(), torch.from_numpy(v)), k
        n += 1
        del g
    assert n == len(want) == (4 if mode == "multiview" else 5)


def test_validate_over_epoch_loader_on_card_matches_cpu(cuda):
    """Debug config in float32 with flip test: validate over epoch_loader
    on the card (soft-argmax kernel) and on the CPU (plain decode), same
    weights, scored by the synthetic multiview dataset's H36M evaluate;
    MPJPE-family values within 1e-3 relative."""
    from epipolarpose_tpu_torch.core.function import validate
    from epipolarpose_tpu_torch.data import epoch_loader, get_dataset
    cfg = load_config("experiments/debug/synth_smoke_3d.yaml")
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TEST.FLIP_TEST = True
    cfg.DATASET.DATASET = "synthetic_multiview"
    configure_backends(cfg)
    gen = torch.Generator().manual_seed(0)
    model = get_pose_net(cfg, generator=gen)
    with torch.no_grad():
        for mod in (*model.deconv_layers, model.final_layer):
            w = getattr(mod, "weight", None)
            if w is not None and w.ndim == 4:
                w.normal_(0.0, 0.05, generator=gen)
    ds = get_dataset(cfg, "valid", False, num_frames=8, image_shape=(64, 64),
                     pose_mode="skeleton")
    out = {}
    for dev in ("cpu", cuda):
        step = make_eval_step(cfg, model, (), device=dev)
        before = ksa.softmax_integral.launches
        out[str(dev)] = validate(cfg, epoch_loader(ds, 16, 0, is_train=False,
                                                   device=dev), ds, step)[0]
        launched = ksa.softmax_integral.launches - before
        assert launched == (2 if dev == cuda else 0)
    want, got = out["cpu"], out[str(cuda)]
    assert list(got) == list(want) == ["Synth", "MPJPE", "NMPJPE",
                                       "PA-MPJPE"]
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-3), k
