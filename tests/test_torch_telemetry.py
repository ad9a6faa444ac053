"""The port's spans and counters (``epipolarpose_tpu_torch/telemetry.py``),
without JAX (the card's machine has none).

On the CPU at the debug size (ResNet-18 at 64x64, 17 joints): spans
record nothing with no profiler; under ``torch.profiler`` the FS, SS
(``given`` cameras, the teacher's forward) and flip-test eval steps and
the loops record their spans with the right parents and one step id a
call, and the spans reach the Chrome trace as ``user_annotation`` events;
self times are at most totals; a new profiler session starts a fresh
aggregate; the pending queue stays bounded; threads keep their own
parents; ``reset`` zeroes every launch counter.

On the card (marker ``cuda``; they skip here), run as ``python -m pytest
--noconftest -p no:cacheprovider -q -m cuda tests/test_torch_telemetry.py``:
``device_ms`` from the events, a ``FusedSteps`` capture and replay under
a recording profiler, and no span synchronising inside a step
(``torch.cuda.set_sync_debug_mode("error")``).
"""

import json
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch

from epipolarpose_tpu_torch import telemetry
from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.core import (create_train_state, function,
                                         make_eval_step, make_train_step)
from epipolarpose_tpu_torch.core import self_supervised as tss
from epipolarpose_tpu_torch.models import get_pose_net

ROOT = pathlib.Path(__file__).resolve().parents[1]
H36M_FLIP_PAIRS = ((1, 4), (2, 5), (3, 6), (11, 14), (12, 15), (13, 16))
CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]

FS_SPANS = {"train.step": [], "train.inputs": ["train.step"],
            "train.targets": ["train.step"], "train.forward": ["train.step"],
            "train.backward": ["train.step"],
            "train.optimizer": ["train.step"]}
SS_SPANS = {"ss.step": [], "ss.inputs": ["ss.step"],
            "ss.teacher": ["ss.step"], "ss.pseudo_gt": ["ss.step"],
            "ss.targets": ["ss.step"], "train.forward": ["ss.step"],
            "train.backward": ["ss.step"], "train.optimizer": ["ss.step"]}
EVAL_SPANS = {"eval.step": [], "eval.inputs": ["eval.step"],
              "eval.forward": ["eval.step"], "eval.flip": ["eval.step"],
              "eval.decode": ["eval.step"]}


def _config(cameras="given"):
    """The calibration-free debug config (integral, ResNet-18 at 64x64,
    17 joints, D 8), float32, with the flip test and its shift."""
    cfg = load_config(ROOT / "experiments/debug/synth_smoke_ss_nocam.yaml")
    cfg.TPU.SS_CAMERAS = cameras
    cfg.TEST.FLIP_TEST = True
    cfg.TEST.SHIFT_HEATMAP = True
    return cfg


def _fs_batch(rng, n=2, device="cpu"):
    b = {"input": rng.integers(0, 256, (n, 64, 64, 3), np.uint8),
         "joints": rng.uniform(5, 59, (n, 17, 2)).astype(np.float32),
         "joints_vis": np.ones((n, 17), np.float32),
         "joints_3d": rng.uniform(-700, 700, (n, 17, 3)).astype(np.float32),
         "center": rng.uniform(20, 40, (n, 2)).astype(np.float32),
         "scale": np.full((n, 2), 0.3, np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _ss_batch(rng, G=1, V=4):
    from epipolarpose_tpu_torch.data.synthetic import (make_rig,
                                                      synth_skeleton_poses)
    from epipolarpose_tpu_torch.geometry.camera import (Camera,
                                                        project_point_radial)
    cams = Camera.stack(make_rig(V, seed=3))
    cams = cams.map(lambda t: t[None].expand((G,) + t.shape).contiguous())
    poses = synth_skeleton_poses(rng, G, 17) + rng.uniform(
        [-150, -150, 600], [150, 150, 1000], (G, 1, 3))
    px, _ = project_point_radial(
        torch.tensor(poses, dtype=torch.float32)[:, None], cams)
    return {"input": torch.from_numpy(rng.integers(0, 256, (G, V, 64, 64, 3),
                                                   np.uint8)),
            "center": px.mean(dim=2), "scale": torch.full((G, V, 2), 4.0),
            "camera": cams}


def _fs():
    cfg = _config()
    model = get_pose_net(cfg, generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model, steps_per_epoch=10, device="cpu")
    step = make_train_step(cfg, model, device="cpu")
    rng = np.random.default_rng(0)
    return (lambda b: step(state, b)), [_fs_batch(rng) for _ in range(2)]


def _ss():
    cfg = _config()
    model = get_pose_net(cfg, generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model, steps_per_epoch=10, device="cpu")
    teacher = tss.load_teacher(cfg, "cpu", torch.Generator().manual_seed(1))
    step = tss.make_ss_train_step(cfg, model, teacher, device="cpu",
                                  flip_pairs=H36M_FLIP_PAIRS)
    rng = np.random.default_rng(1)
    return (lambda b: step(state, b)), [_ss_batch(rng) for _ in range(2)]


def _eval():
    cfg = _config()
    model = get_pose_net(cfg, generator=torch.Generator().manual_seed(0))
    step = make_eval_step(cfg, model, H36M_FLIP_PAIRS, device="cpu")
    rng = np.random.default_rng(2)
    return step, [_fs_batch(rng) for _ in range(2)]


STEPS = {"fs": (_fs, FS_SPANS), "ss": (_ss, SS_SPANS),
         "eval": (_eval, EVAL_SPANS)}


@pytest.fixture(autouse=True)
def fresh():
    telemetry.reset()


def test_the_profiler_flag_the_spans_read_exists():
    """Spans read ``torch.autograd.profiler._is_profiler_enabled``: false
    with no profiler and in a schedule's warm-up, true while it
    records."""
    assert torch.autograd.profiler._is_profiler_enabled is False
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    seen = []
    with torch.profiler.profile(activities=CPU_ONLY, schedule=sched) as p:
        for _ in range(2):
            seen.append(torch.autograd.profiler._is_profiler_enabled)
            p.step()
    assert seen == [False, True]
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_spans_record_nothing_without_a_profiler():
    telemetry.reset()
    assert telemetry.span("a") is telemetry.span("b")
    call, batches = _fs()
    for b in batches:
        call(b)
    snap = telemetry.snapshot()
    assert snap["spans"] == {} and snap["steps"] == 0


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_step_records_its_spans_under_a_profiler(kind, tmp_path):
    """Two calls under a CPU profiler: each span once a call (the
    optimizer's twice: before and after the backward), under its parent,
    in one step a call; self host time at most the total; no device time
    on the CPU; every name a ``user_annotation`` in the Chrome trace."""
    make, want = STEPS[kind]
    call, batches = make()
    call(batches[0])                       # unrecorded: warm
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        for b in batches:
            call(b)
    snap = telemetry.snapshot()
    spans = snap["spans"]
    assert snap["steps"] == 2
    assert {name: s["parents"] for name, s in spans.items()} == want
    for name, s in spans.items():
        assert s["calls"] == (4 if name == "train.optimizer" else 2), name
        assert s["steps"] == 2, name
        assert 0 <= s["self_host_ms"] <= s["host_ms"], name
        assert s["device_ms"] is None and s["self_device_ms"] is None
    top = next(n for n, parents in want.items() if not parents)
    assert spans[top]["self_host_ms"] < spans[top]["host_ms"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    annotated = {e["name"] for e in events
                 if e.get("cat") == "user_annotation"}
    assert set(want) <= annotated


def test_loops_record_data_wait_log_and_to_host(caplog):
    """``train``: a ``loop.data_wait`` a ``next`` (the last finds the
    end), a ``loop.log`` a logged step; ``validate``: a
    ``loop.to_host`` a batch. Each loop span is a step of its own."""
    cfg = _config()
    cfg.PRINT_FREQ = 2
    call, batches = _fs()
    batches = batches + batches[:1]

    with torch.profiler.profile(activities=CPU_ONLY):
        function.train(cfg, batches, None, lambda st, b: call(b), epoch=0)
    spans = telemetry.snapshot()["spans"]
    assert spans["loop.data_wait"]["calls"] == 4
    assert spans["loop.log"]["calls"] == 2
    assert spans["train.step"]["calls"] == 3
    assert spans["loop.log"]["parents"] == spans["loop.data_wait"][
        "parents"] == []

    class Scored:
        def __len__(self):
            return 4

        def evaluate(self, cfg, preds, output_dir):
            return {"n": float(len(preds))}, 0.0
    step, eval_batches = _eval()
    with torch.profiler.profile(activities=CPU_ONLY):
        function.validate(cfg, eval_batches, Scored(), step)
    spans = telemetry.snapshot()["spans"]
    assert spans["loop.to_host"]["calls"] == 2
    assert spans["loop.data_wait"]["calls"] == 3
    assert spans["eval.step"]["calls"] == 2 and "loop.log" not in spans


def test_a_new_profiler_session_starts_a_fresh_aggregate():
    """A snapshot, or a span entered with no profiler, ends a stretch: the
    next snapshot holds the next session's spans alone."""
    with torch.profiler.profile(activities=CPU_ONLY):
        for _ in range(3):
            with telemetry.span("outer"):
                pass
    assert telemetry.snapshot()["spans"]["outer"]["calls"] == 3
    with torch.profiler.profile(activities=CPU_ONLY):
        with telemetry.span("outer"):
            pass
    snap = telemetry.snapshot()                 # ended by the snapshot
    assert snap["spans"]["outer"]["calls"] == 1
    assert telemetry.snapshot() == snap         # and read again
    with telemetry.span("outer"):           # no profiler: ends the stretch
        pass
    assert telemetry.snapshot() == snap
    with torch.profiler.profile(activities=CPU_ONLY):
        with telemetry.span("outer"):
            with telemetry.span("inner"):
                pass
    snap = telemetry.snapshot()
    assert snap["spans"]["outer"]["calls"] == 1 and snap["steps"] == 1
    assert snap["spans"]["inner"]["parents"] == ["outer"]


def test_pending_spans_stay_bounded(monkeypatch):
    monkeypatch.setattr(telemetry, "PENDING_CAP", 16)
    with torch.profiler.profile(activities=CPU_ONLY):
        for _ in range(200):
            with telemetry.span("many"):
                pass
            assert len(telemetry._recorder.pending) <= 16
    assert telemetry.snapshot()["spans"]["many"]["calls"] == 200


def test_threads_keep_their_own_parents():
    """Eight threads nest spans at once, the interpreter switching every
    few microseconds: every inner span's parent is its own thread's outer
    span, and no occurrence is lost."""
    switch = sys.getswitchinterval()
    errors = []

    def work(k):
        try:
            for _ in range(100):
                with telemetry.span(f"outer{k}"):
                    with telemetry.span(f"inner{k}"):
                        pass
        except Exception as exc:     # reported below, with the thread
            errors.append((k, exc))
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile(activities=CPU_ONLY):
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert not errors, errors
    snap = telemetry.snapshot()
    assert snap["steps"] == 800
    for k in range(8):
        assert snap["spans"][f"inner{k}"]["parents"] == [f"outer{k}"]
        assert snap["spans"][f"inner{k}"]["calls"] == 100
        assert snap["spans"][f"inner{k}"]["steps"] == 100


def test_reset_zeroes_every_launch_counter():
    """Every counter the smoke's ``reset_counts`` once zeroed by name is
    declared through ``telemetry``, read by its old name, listed in
    ``snapshot()["counters"]`` and zeroed by ``reset``."""
    from epipolarpose_tpu_torch.kernels.matmul_stats import matmul_stats
    from epipolarpose_tpu_torch.kernels.softargmax import (
        softmax_integral, softmax_integral_bwd)
    from epipolarpose_tpu_torch.kernels.triangulate import triangulate_fast
    named = [(softmax_integral, "launches"),
             (softmax_integral_bwd, "launches"),
             (triangulate_fast, "launches"),
             (triangulate_fast, "launches_thread"),
             (triangulate_fast, "launches_split"),
             (tss.teacher_detect, "calls"), (matmul_stats, "launches"),
             (matmul_stats, "launches_wgmma"),
             (matmul_stats, "launches_simt")]
    for fn, name in named:
        telemetry.count(fn, name)
    counters = telemetry.snapshot()["counters"]
    for fn, name in named:
        assert counters[f"{fn.__name__}.{name}"] == getattr(fn, name) >= 1
    telemetry.reset()
    assert all(getattr(fn, name) == 0 for fn, name in named)
    assert set(telemetry.counters().values()) == {0}


def test_table_lists_each_span_per_call():
    with torch.profiler.profile(activities=CPU_ONLY):
        for _ in range(2):
            with telemetry.span("outer"):
                with telemetry.span("inner"):
                    pass
    rows = telemetry.table(telemetry.snapshot()).splitlines()
    assert rows[0].startswith("span  calls")
    assert [r.split()[:2] for r in rows[1:]] == [["outer", "2"],
                                                 ["inner", "2"]]
    assert rows[1].split()[4] == "-"        # no device time on the CPU


# ------------------------------------------------------------ the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cudnn.benchmark = False
    return torch.device("cuda")


def _card_steps(cuda):
    cfg = _config()
    model = get_pose_net(cfg, generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model, steps_per_epoch=100, device=cuda)
    train = make_train_step(cfg, model, device=cuda)
    evals = make_eval_step(cfg, model, H36M_FLIP_PAIRS, device=cuda)
    rng = np.random.default_rng(0)
    batches = [_fs_batch(rng, n=8, device=cuda) for _ in range(2)]
    return state, train, evals, batches


@pytest.mark.cuda
def test_device_time_comes_from_the_events(cuda):
    """On the card each span's ``device_ms`` is filled; a parent's device
    time covers its children's."""
    state, train, evals, batches = _card_steps(cuda)
    for b in batches:
        train(state, b)
        evals(b)
    torch.cuda.synchronize()
    acts = CPU_ONLY + [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        for b in batches:
            train(state, b)
            evals(b)
    spans = telemetry.snapshot()["spans"]
    for name in list(FS_SPANS) + list(EVAL_SPANS):
        s = spans[name]
        assert s["device_ms"] is not None and s["device_ms"] > 0, name
        assert s["self_device_ms"] <= s["device_ms"] + 1e-3, name
    parts = sum(spans[n]["device_ms"] for n in FS_SPANS if n != "train.step")
    assert parts <= spans["train.step"]["device_ms"] * 1.001 + 1e-3


@pytest.mark.cuda
def test_steps_under_the_sync_check_with_and_without_spans(cuda):
    """After warm-up, on batches already on the card, one FS step and one
    eval step under ``set_sync_debug_mode("error")``, with a profiler
    recording and without: no span, and no step, waits for the card."""
    state, train, evals, batches = _card_steps(cuda)
    for b in batches:
        train(state, b)
        evals(b)
    torch.cuda.synchronize()

    def checked():
        torch.cuda.set_sync_debug_mode("error")
        try:
            train(state, batches[0])
            evals(batches[1])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    checked()
    acts = CPU_ONLY + [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        checked()
    spans = telemetry.snapshot()["spans"]
    assert spans["train.step"]["calls"] == spans["eval.step"]["calls"] == 1


@pytest.mark.cuda
def test_fused_capture_and_replay_under_a_recording_profiler(cuda):
    """A ``FusedSteps`` warm-up, capture and two replays all under a
    recording profiler: nothing raises, ``fused.capture`` and
    ``fused.replay`` are recorded with device time, and the spans inside
    the capture keep their host record alone."""
    from epipolarpose_tpu_torch.data import stack_batches
    cfg = _config()
    model = get_pose_net(cfg, generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model, steps_per_epoch=100, device=cuda)
    step = make_train_step(cfg, model, device=cuda, fused_steps=2)
    rng = np.random.default_rng(0)
    sb = next(stack_batches(iter([_fs_batch(rng, n=8, device=cuda)
                                  for _ in range(2)]), 2))
    acts = CPU_ONLY + [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        for _ in range(4):              # warm-up, capture, two replays
            state, out = step(state, sb)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out["loss"]).all())
    spans = telemetry.snapshot()["spans"]
    assert spans["fused.capture"]["calls"] == 1
    assert spans["fused.replay"]["calls"] == 2
    assert spans["fused.replay"]["device_ms"] > 0
    assert spans["fused.capture"]["device_ms"] > 0
    # 2 eager steps of the warm-up, 2 in the capture (host records only)
    assert spans["train.step"]["calls"] == 4
    assert spans["train.step"]["parents"] == ["fused.capture"]
