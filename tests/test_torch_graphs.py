"""CUDA graphs of whole steps (``epipolarpose_tpu_torch/graphs.py``) and
what makes a step capturable, without JAX (the card's machine has none).

On the CPU: the helpers a capture relies on, each with its plain
behaviour outside a capture: ``constant`` (small tensors copied from the
host once), ``host_op`` (the call itself), the launch counters'
``telemetry.count``/``capture_tally``/``add_tally``, the constant-index
forms of the flip-back and pair swaps against list indexing, and the
cached copies of ``make_gt_teacher``.

On the card (marker ``cuda``; they skip here), run as
``python -m pytest --noconftest -p no:cacheprovider -q -m cuda
tests/test_torch_graphs.py``: the fused FS step's graph replays against
the eager loop bit for bit in float32, the calibration-free SS step's
graph split around its cuSOLVER calls against its eager loop, and a step
that cannot be captured raising with the line that did it.
"""

import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from epipolarpose_tpu_torch import telemetry
from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.core import create_train_state, make_train_step
from epipolarpose_tpu_torch.core import self_supervised as tss
from epipolarpose_tpu_torch.data import stack_batches
from epipolarpose_tpu_torch.geometry.affine import (flip_back,
                                                    flip_back_volume,
                                                    get_affine_transform)
from epipolarpose_tpu_torch.graphs import constant, host_op
from epipolarpose_tpu_torch.models import get_pose_net

ROOT = pathlib.Path(__file__).resolve().parents[1]
FUSED_YAML = ROOT / "experiments/debug/synth_smoke_fused.yaml"
H36M_FLIP_PAIRS = ((1, 4), (2, 5), (3, 6), (11, 14), (12, 15), (13, 16))


def _integral_config():
    """The fused debug config as an integral model: ResNet-18 at 64x64,
    4 joints, D 4, 32-wide deconvs, float32."""
    cfg = load_config(FUSED_YAML)
    cfg.MODEL.NUM_JOINTS = 4
    cfg.MODEL.EXTRA.NUM_DECONV_FILTERS = [32, 32, 32]
    cfg.MODEL.NAME = "pose3d_resnet"
    cfg.MODEL.EXTRA.TARGET_TYPE = "integral"
    cfg.MODEL.EXTRA.DEPTH_DIM = 4
    cfg.LOSS.TYPE = "IntegralL1Loss"
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TRAIN.LR_STEP = [2]
    return cfg


def _batches(k, n=4, size=64, joints=4, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input": rng.integers(0, 256, (n, size, size, 3), np.uint8),
             "joints": rng.uniform(5, size - 5, (n, joints, 2)).astype(
                 np.float32),
             "joints_vis": np.ones((n, joints), np.float32),
             "joints_3d": rng.uniform(-700, 700, (n, joints, 3)).astype(
                 np.float32)} for _ in range(k)]


# ------------------------------------------------------------- the CPU
def test_constant_is_copied_once_and_keyed_by_value_and_type():
    a = constant([[0.0, -1.0], [1.0, 0.0]], torch.float32, "cpu")
    assert a is constant([[0.0, -1.0], [1.0, 0.0]], torch.float32, "cpu")
    assert torch.equal(a, torch.tensor([[0.0, -1.0], [1.0, 0.0]]))
    b = constant([[0.0, -1.0], [1.0, 0.0]], torch.float64, "cpu")
    assert b is not a and b.dtype == torch.float64
    assert constant([1, 2], torch.int64, "cpu") is not constant(
        [2, 1], torch.int64, "cpu")


def test_host_op_outside_a_capture_is_the_call():
    m = torch.randn(3, 4, 4, dtype=torch.float64)
    m = m @ m.transpose(-1, -2)
    got = host_op(torch.linalg.eigh, m)
    want = torch.linalg.eigh(m)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_launch_counts_outside_a_capture_add_at_once():
    def fn():
        pass
    fn.launches = fn.launches_split = 0
    telemetry.count(fn, "launches", "launches_split")
    with telemetry.capture_tally() as tally:
        telemetry.count(fn, "launches")   # not capturing: counted at once
        with pytest.raises(RuntimeError, match="already open"):
            with telemetry.capture_tally():
                pass
    assert (fn.launches, fn.launches_split) == (2, 1) and not tally
    tally[(fn, "launches")] += 3
    telemetry.add_tally(tally)
    telemetry.add_tally(tally)
    assert fn.launches == 8


def test_flip_back_swaps_pairs_as_list_indexing_does():
    """The swap through a constant index tensor (no copy from the host in
    a graph) gives what indexing with the permutation list gave."""
    x = torch.randn(2, 17, 8, 8)
    perm = list(range(17))
    for a, b in H36M_FLIP_PAIRS:
        perm[a], perm[b] = perm[b], perm[a]
    assert torch.equal(flip_back(x, H36M_FLIP_PAIRS),
                       x.flip(-1)[..., perm, :, :])
    v = torch.randn(2, 17 * 3, 8, 8)
    want = v.reshape(2, 17, 3, 8, 8).flip(-1)[:, perm].reshape(v.shape)
    assert torch.equal(flip_back_volume(v, H36M_FLIP_PAIRS, 17, 3), want)


def test_affine_defaults_from_constants_match_explicit_tensors():
    c = torch.tensor([[320.0, 240.0], [100.0, 80.0]])
    s = torch.tensor([[1.2, 1.2], [0.5, 0.7]])
    got = get_affine_transform(c, s, 0.0, (64, 64))
    want = get_affine_transform(c, s, torch.zeros(2), (64, 64),
                                shift=torch.zeros(2))
    assert torch.equal(got, want)
    rot = get_affine_transform(c, s, 30.0, (64, 64))
    assert torch.equal(rot, get_affine_transform(c, s, torch.full((2,), 30.0),
                                                 (64, 64)))


def test_gt_teacher_copies_its_detections_once_per_device():
    det = np.random.default_rng(0).uniform(0, 100, (8, 4, 2))
    detect = tss.make_gt_teacher(det)
    a = detect(torch.zeros(1), None, None)
    b = detect(torch.zeros(1), None, None)
    assert a[0] is b[0] and a[1] is b[1]
    assert torch.equal(a[0], torch.as_tensor(det, dtype=torch.float32))
    assert torch.equal(a[1], torch.ones(8, 4))


# ------------------------------------------------------------ the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _same_state(a, b) -> None:
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa = a.optimizer.state_dict()["state"]
    ob = b.optimizer.state_dict()["state"]
    for i, st in oa.items():
        for k, v in st.items():
            assert torch.equal(v, ob[i][k]), (i, k)
    assert a.step == b.step


@pytest.mark.cuda
def test_graph_replays_equal_the_eager_loop(cuda):
    """float32, TF32 off, deterministic cuDNN: super-batches of 2 (the
    first the warm-up, the second captured, the third replayed, then a
    tail of 1) give the eager loop's losses, weights, BN buffers, Adam
    moments and rate (the milestone at step 2 falls inside the second
    super-batch) bit for bit; each call counts its kernels' launches, 2
    soft-argmax forwards and backwards for 2 steps."""
    from epipolarpose_tpu_torch.kernels import softargmax as ksa
    cfg = _integral_config()
    batches = [{k: torch.from_numpy(v).to(cuda) for k, v in b.items()}
               for b in _batches(7, seed=4)]
    runs = {}
    for fused in (1, 2):
        model = get_pose_net(cfg, generator=torch.Generator().manual_seed(0))
        state = create_train_state(cfg, model, steps_per_epoch=1,
                                   device=cuda)
        step = make_train_step(cfg, model, device=cuda, fused_steps=fused)
        losses, launches = [], []
        groups = ([[b] for b in batches] if fused == 1 else
                  [batches[i:i + 2] for i in range(0, len(batches), 2)])
        for group in groups:
            ksa.softmax_integral.launches = 0
            ksa.softmax_integral_bwd.launches = 0
            if fused == 1:
                state, m = step(state, group[0])
                losses.append(m["loss"].reshape(1))
            else:
                state, m = step(state, next(stack_batches(iter(group), 2)))
                losses.append(m["loss"])
            launches.append((ksa.softmax_integral.launches,
                             ksa.softmax_integral_bwd.launches))
        torch.cuda.synchronize()
        runs[fused] = {"loss": torch.cat(losses).cpu(), "state": state,
                       "launches": launches, "step": step}
    eager, graph = runs[1], runs[2]
    assert torch.equal(eager["loss"], graph["loss"])
    _same_state(eager["state"], graph["state"])
    assert graph["state"].step == 7
    assert graph["state"].scheduler.last_epoch == 7
    assert eager["state"].scheduler.get_last_lr() == \
        graph["state"].scheduler.get_last_lr()
    assert graph["launches"] == [(2, 2), (2, 2), (2, 2), (1, 1)]
    assert len(graph["step"].graphs) == 2 and graph["step"].replays == 3


@pytest.mark.cuda
def test_estimated_ss_graph_split_equals_the_eager_loop(cuda):
    """``TPU.SS_CAMERAS: estimated``: cuSOLVER's ``eigh``/``svd`` read
    their status on the host, so the step's graph is split around them
    (5 host ops a step) and gives the eager loop's bits; 4 triangulation
    launches a step."""
    from epipolarpose_tpu_torch.data.synthetic import (make_rig,
                                                      synth_skeleton_poses)
    from epipolarpose_tpu_torch.geometry.camera import (Camera,
                                                        project_point_radial)
    from epipolarpose_tpu_torch.kernels.triangulate import triangulate_fast
    cfg = load_config(ROOT / "experiments/debug/synth_smoke_ss_nocam.yaml")
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.SS_CONF_MIN = -1.0
    G, V = 2, 4
    J = int(cfg.MODEL.NUM_JOINTS)
    size = int(cfg.MODEL.IMAGE_SIZE[0])
    rng = np.random.default_rng(5)
    cams = Camera.stack(make_rig(V, seed=5)).to(cuda)
    cams = cams.replace(k=torch.zeros_like(cams.k), p=torch.zeros_like(cams.p))
    cams = cams.map(lambda t: t[None].expand((G,) + t.shape).contiguous())
    batches = []
    for i in range(5):
        poses = synth_skeleton_poses(rng, G, J) + rng.uniform(
            [-150, -150, 600], [150, 150, 1000], (G, 1, 3))
        px, _ = project_point_radial(torch.tensor(
            poses, dtype=torch.float32, device=cuda)[:, None], cams)
        c = px.mean(dim=2)
        batches.append({
            "input": torch.randint(0, 256, (G, V, size, size, 3),
                                   dtype=torch.uint8, device=cuda),
            "center": c, "scale": torch.full((G, V, 2), 4.0, device=cuda),
            "camera": cams, "det_src": px + torch.randn_like(px),
            "det_conf": torch.rand(px.shape[:-1], device=cuda) * 0.5 + 0.5})
    runs = {}
    for fused in (1, 2):
        model = get_pose_net(cfg, generator=torch.Generator().manual_seed(1))
        state = create_train_state(cfg, model, steps_per_epoch=100,
                                   device=cuda)
        step = tss.make_ss_train_step(cfg, model, None, device=cuda,
                                      fused_steps=fused)
        triangulate_fast.launches = 0
        losses = []
        groups = ([[b] for b in batches] if fused == 1 else
                  [batches[i:i + 2] for i in range(0, len(batches), 2)])
        for group in groups:
            sb = group[0] if fused == 1 else next(stack_batches(iter(group),
                                                                2))
            state, m = step(state, sb)
            losses.append(m["loss"].reshape(-1))
        torch.cuda.synchronize()
        runs[fused] = {"loss": torch.cat(losses).cpu(), "state": state,
                       "step": step, "tri": triangulate_fast.launches}
    assert torch.equal(runs[1]["loss"], runs[2]["loss"])
    _same_state(runs[1]["state"], runs[2]["state"])
    assert runs[1]["tri"] == runs[2]["tri"] == 4 * 5
    # graphs of 2 steps and of 1: 5 host ops a step
    assert runs[2]["step"].host_ops == 5 * 2 + 5 * 1


@pytest.mark.cuda
def test_a_step_that_cannot_be_captured_raises_naming_the_op(cuda,
                                                             tmp_path):
    """A step that reads a value back to the host inside the graph fails
    its capture with the line that did it; it does not run eagerly in
    its place. In a subprocess: a failed capture leaves the CUDA random
    generator in capture mode for the rest of the process."""
    code = textwrap.dedent("""
        import torch
        from epipolarpose_tpu_torch.core.steps import FusedSteps
        from epipolarpose_tpu_torch.graphs import CaptureError

        def step(state, batch):
            x = batch["x"] * 2.0
            if float(x.sum()) > 0:   # a host read inside the step
                x = x + 1.0
            return state, {"y": x.sum()}

        fused = FusedSteps(step, 2, "cuda")
        sb = {"x": torch.ones(2, 3, device="cuda")}
        fused([], sb)                      # warm-up: eager, allowed
        try:
            fused([], sb)
        except CaptureError as e:
            assert "uncapturable.py:8 in step" in str(e), str(e)
            assert "float(x.sum()) > 0" in str(e), str(e)
            assert fused.replays == 0 and not fused.graphs
            print("RAISED")
    """)
    script = tmp_path / "uncapturable.py"
    script.write_text(code)
    res = subprocess.run([sys.executable, str(script)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "RAISED" in res.stdout, res.stdout + res.stderr
