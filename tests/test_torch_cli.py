"""The port's command-line entry points on the CPU, at the debug sizes.

``scripts.train`` -> ``scripts.valid`` -> ``scripts.demo`` in-process with
``--device cpu`` on ``experiments/debug/synth_smoke_3d.yaml`` (ResNet-18 at
64x64, 17 joints, D = 8): the run directory is the JAX package's
``create_logger`` directory for the same config; ``valid`` on the saved
weights gives the last epoch's ``validate`` perf exactly (same process,
same data, same weights); the demo's two PNGs decode. The SS route: a 2D
teacher trained by the CLI, then the SS CLI with that teacher as
``MODEL.PRETRAINED`` (its backbone merged into the student, the head
skipped) and a refiner from ``train_refiner`` as ``TPU.SS_REFINER``;
the calibration-free debug config (``TPU.SS_CAMERAS: estimated``)
through ``train``. ``train --distributed --device cpu`` in two ``gloo``
processes under ``torch.distributed.run`` against one process on the same
global batch, and ``train`` and ``valid`` with ``TPU.MESH.MODEL: 2`` (the
image rows split over the two) against the same runs without the flag.
Refused: ``--device cuda`` without a card, a model axis whose row split
is not 32-aligned; ``TPU.FUSED_STEPS > 1`` runs
(``tests/test_torch_fused_steps.py`` drives it through ``train``).
"""

import json
import os
import pathlib
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch
import yaml

from epipolarpose_tpu.config import load_config as jax_load_config
from epipolarpose_tpu.core.logger import create_logger as jax_create_logger
from epipolarpose_tpu_torch.config import get_model_name, load_config
from epipolarpose_tpu_torch.core import function
from epipolarpose_tpu_torch.core.logger import (create_logger,
                                                create_metric_writer)
from epipolarpose_tpu_torch.models import get_pose_net
from epipolarpose_tpu_torch.scripts import demo, train, train_refiner, valid
from epipolarpose_tpu_torch.utils.vis import read_png
from test_torch_checkpoint import quiet_cli

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEBUG_3D = ROOT / "experiments/debug/synth_smoke_3d.yaml"


def _yaml(dst: pathlib.Path, **sections) -> str:
    """The debug 3D yaml with overrides ``SECTION={KEY: value}``, float32,
    written as ``dst``."""
    data = yaml.safe_load(DEBUG_3D.read_text())
    data.setdefault("TPU", {})["COMPUTE_DTYPE"] = "float32"
    for sec, kv in sections.items():
        if isinstance(kv, dict):
            data.setdefault(sec, {}).update(kv)
        else:
            data[sec] = kv
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(yaml.safe_dump(data))
    return str(dst)


def _common(tmp):
    return ["--device", "cpu", "--modelDir", str(tmp / "out"), "--logDir",
            str(tmp / "log")]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Two epochs of ``train`` on the debug 3D config, ``--synthetic``."""
    tmp = tmp_path_factory.mktemp("cli")
    cfg = _yaml(tmp / "smoke3d.yaml")
    with quiet_cli():
        out = train.main(["--cfg", cfg, "--synthetic", "--samples", "32",
                          "--epochs", "2"] + _common(tmp))
    return tmp, cfg, out


def test_run_directory_is_the_jax_one(run):
    tmp, cfg, out = run
    jcfg = jax_load_config(cfg)
    jcfg.OUTPUT_DIR, jcfg.LOG_DIR = str(tmp / "out"), str(tmp / "log")
    with quiet_cli():
        _, jdir, jtb = jax_create_logger(jcfg, cfg, "train")
    assert out["output_dir"] == jdir
    assert pathlib.Path(out["output_dir"]) == (
        tmp / "out" / "synthetic" / "pose3d_resnet_18_64x64_d8" / "smoke3d")
    ckpts = pathlib.Path(out["output_dir"]) / "checkpoints"
    assert sorted(p.name for p in ckpts.iterdir()) == [
        "2.pth.tar", "4.pth.tar", "best", "final_state.pth.tar"]
    assert list(pathlib.Path(out["output_dir"]).glob(
        "smoke3d_*_train.log"))
    assert get_model_name(load_config(cfg)) == ("pose3d_resnet_18",
                                                 "pose3d_resnet_18_64x64_d8")


def test_valid_gives_the_last_epochs_perf(run):
    tmp, cfg, out = run
    with quiet_cli():
        perf = valid.main(["--cfg", cfg, "--synthetic", "--samples", "32",
                           "--model-file", out["final"]] + _common(tmp))
    assert perf == out["perf"]
    logs = list(pathlib.Path(out["output_dir"]).glob("smoke3d_*_valid.log"))
    assert logs and f"perf: {perf:.6f}" in logs[0].read_text()


def test_demo_writes_two_pngs(run, tmp_path):
    _, cfg, out = run
    res = demo.main(["--cfg", cfg, "--device", "cpu", "--model-file",
                     out["final"], "--out", str(tmp_path)])
    assert res["preds"].shape == (17, 3) and np.isfinite(res["preds"]).all()
    for f in res["files"]:
        img = read_png(f)
        np.testing.assert_array_equal(cv2.imread(f)[..., ::-1], img)
    assert [pathlib.Path(f).name for f in res["files"]] == [
        "pose_2d.png", "pose_3d.png"]


def test_ss_route_with_a_trained_teacher_and_refiner(tmp_path):
    """A 2D teacher from the CLI feeds the SS CLI: strict teacher load,
    the student's backbone merged from it, its head skipped."""
    teacher_cfg = _yaml(tmp_path / "teacher.yaml",
                        MODEL={"NAME": "pose_resnet",
                               "EXTRA": {**yaml.safe_load(
                                   DEBUG_3D.read_text())["MODEL"]["EXTRA"],
                                   "TARGET_TYPE": "gaussian",
                                   "DEPTH_DIM": 1}},
                        LOSS={"TYPE": "JointsMSELoss"})
    with quiet_cli():
        teacher = train.main(["--cfg", teacher_cfg, "--synthetic",
                              "--samples", "16", "--epochs", "1"]
                             + _common(tmp_path))
    ref = train_refiner.main(["--cfg", str(DEBUG_3D), "--synthetic",
                              "--device", "cpu", "--steps", "3", "--poses",
                              "16", "--hidden", "32", "--out",
                              str(tmp_path / "ref")])
    ss_cfg = _yaml(tmp_path / "ss.yaml",
                   DATASET={"LABEL_SOURCE": "triangulated"},
                   MODEL={"PRETRAINED": teacher["final"]},
                   TRAIN={"BATCH_SIZE": 2},
                   TPU={"SS_REFINER": ref["path"],
                        "COMPUTE_DTYPE": "float32"})
    teacher_sd = torch.load(teacher["final"], weights_only=True)[
        "state_dict"]
    with quiet_cli():
        ss = train.main(["--cfg", ss_cfg, "--synthetic", "--samples", "16",
                         "--epochs", "1"] + _common(tmp_path))
    assert "synthetic_multiview" in ss["output_dir"]
    assert ss["state"].step == 2             # 4 frames, 2 groups a step
    assert np.isfinite(ss["perf"])
    log = next(pathlib.Path(ss["output_dir"]).glob("ss_*_train.log"))
    text = log.read_text()
    assert "pretrained: skipping final_layer.weight" in text
    assert "refining pseudo-GT with" in text
    # the backbone started from the teacher: conv1 moved only by 2 steps
    moved = (ss["state"].model.conv1.weight.detach()
             - teacher_sd["conv1.weight"]).abs().max().item()
    assert moved < 0.01


def test_nocam_config_takes_the_estimated_rig(tmp_path, monkeypatch):
    """``experiments/debug/synth_smoke_ss_nocam.yaml`` (``SS_CAMERAS:
    estimated``, a random teacher) through ``scripts.train``: every SS
    step recovers the rig from the detections, and the run ends with a
    finite loss and perf."""
    from epipolarpose_tpu_torch.core import self_supervised as tss
    calls = []
    real = tss.pseudo_gt_uncalibrated

    def counted(*args, **kwargs):
        calls.append(kwargs.get("solve"))
        return real(*args, **kwargs)
    monkeypatch.setattr(tss, "pseudo_gt_uncalibrated", counted)
    with quiet_cli():
        ss = train.main(["--cfg", str(ROOT / "experiments/debug/"
                                      "synth_smoke_ss_nocam.yaml"),
                         "--synthetic", "--samples", "16", "--epochs", "1"]
                        + _common(tmp_path))
    assert ss["state"].step == 2             # 4 frames, 2 groups a step
    assert len(calls) == 2
    assert np.isfinite(ss["loss"]) and np.isfinite(ss["perf"])


def test_device_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--cfg", str(DEBUG_3D), "--synthetic", "--modelDir",
                    str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        valid.main(["--cfg", str(DEBUG_3D), "--synthetic"])


def test_unported_flags_raise(tmp_path):
    """``refuse_unported``, which both CLIs call before any process group
    is joined, passes a model axis whose row split is 32-aligned
    (``TPU.MESH.MODEL: 2`` at 256x256, alone and with ``FUSED_STEPS: 2``)
    and fused steps alone; a split that is not (``MODEL: 2`` at a 48-row
    image: 24 rows a process) raises by name in both CLIs."""
    from epipolarpose_tpu_torch.scripts.common import refuse_unported
    for tpu in ({"MESH": {"MODEL": 2}}, {"FUSED_STEPS": 2},
                {"FUSED_STEPS": 2, "MESH": {"MODEL": 2}}):
        refuse_unported(load_config(_yaml(
            tmp_path / "ok.yaml", MODEL={"IMAGE_SIZE": [256, 256]},
            TPU=tpu)))
    rows48 = _yaml(tmp_path / "rows48.yaml", MODEL={"IMAGE_SIZE": [48, 48]},
                   TPU={"MESH": {"MODEL": 2}})
    for cli in (train, valid):
        with pytest.raises(ValueError,
                           match="TPU.MESH.MODEL = 2: 48 image rows"):
            cli.main(["--cfg", rows48, "--distributed", "--device", "cpu"])


def test_loops_write_scalars_to_the_writer():
    """``train`` and ``validate`` call ``add_scalar`` where the JAX loops
    call ``write_scalars``: the loss (and accuracy) at the optimizer step
    of each logged batch, the perf after validation."""
    calls = []

    class Writer:
        def add_scalar(self, tag, value, step):
            calls.append((tag, value, step))

    class State:
        step = 0

    def step(state, batch):
        state.step += 1
        return state, {"loss": torch.tensor(2.0), "acc": torch.tensor(0.5)}

    cfg = load_config(DEBUG_3D)
    batches = [{"input": np.zeros((2, 4, 4, 3), np.uint8)}] * 3
    function.train(cfg, batches, State(), step, 0, writer=Writer())
    assert calls == [("train/loss", 2.0, 1), ("train/acc", 0.5, 1),
                     ("train/loss", 2.0, 3), ("train/acc", 0.5, 3)]

    class Dataset:
        def __len__(self):
            return 2

        def evaluate(self, cfg, preds, output_dir):
            return None, 7.0

    calls.clear()
    function.validate(cfg, [{"center": np.zeros((2, 2)),
                             "scale": np.ones((2, 2))}], Dataset(),
                      lambda b: {"preds": torch.zeros(2, 17, 3)},
                      writer=Writer(), step=5)
    assert calls == [("valid/perf", 7.0, 5)]


def test_metric_writer_is_tensorboard_or_none(tmp_path, monkeypatch):
    writer = create_metric_writer(str(tmp_path / "tb"))
    try:
        import tensorboard  # noqa: F401
    except ImportError:
        assert writer is None
    else:
        from torch.utils.tensorboard import SummaryWriter
        assert isinstance(writer, SummaryWriter)
        writer.add_scalar("train/loss", 1.0, 0)
        writer.close()
        assert list((tmp_path / "tb").glob("events.out.tfevents.*"))
    monkeypatch.setitem(__import__("sys").modules, "tensorboard", None)
    monkeypatch.delitem(__import__("sys").modules, "torch.utils.tensorboard",
                        raising=False)
    assert create_metric_writer(str(tmp_path / "none")) is None


def test_create_logger_matches_jax(tmp_path):
    tcfg, jcfg = load_config(DEBUG_3D), jax_load_config(DEBUG_3D)
    for cfg in (tcfg, jcfg):
        cfg.OUTPUT_DIR, cfg.LOG_DIR = str(tmp_path / "o"), str(tmp_path / "l")
    with quiet_cli():
        _, out, tb = create_logger(tcfg, "a/b/run.yaml", "valid")
        _, jout, jtb = jax_create_logger(jcfg, "a/b/run.yaml", "valid")
    assert (out, tb) == (jout, jtb)


def test_trace_summary_counts_overlaps_once(tmp_path):
    import json

    from epipolarpose_tpu_torch.tools.trace_summary import summarize
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "step", "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 100, "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 250, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 600, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 800, "dur": 50},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 900}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = summarize(str(path))
    assert got["window_ms"] == pytest.approx(1.0)
    # busy: [100, 350] + [600, 700] + [800, 850] = 400 us
    assert got["device_busy_ms"] == pytest.approx(0.4)
    assert got["idle_share"] == pytest.approx(0.6)
    assert [(k["name"], k["calls"]) for k in got["top_kernels"]] == [
        ("a", 2), ("b", 1)]
    assert got["top_kernels"][0]["ms"] == pytest.approx(0.25)


def test_profile_writes_a_trace_from_the_third_step(tmp_path):
    cfg = _yaml(tmp_path / "prof.yaml")
    with quiet_cli():
        train.main(["--cfg", cfg, "--synthetic", "--samples", "64",
                    "--epochs", "1", "--profile"] + _common(tmp_path))
    traces = list((tmp_path / "log").rglob("trace_epoch0.json"))
    assert len(traces) == 1
    log = next((tmp_path / "out").rglob("prof_*_train.log")).read_text()
    assert "profiler trace of steps 3-4 written to" in log
    assert "spans of the recorded steps" in log
    assert "\ntrain.step  2  " in log


RUNNER = """
import json, os, sys
sys.modules["tensorboard"] = None      # no metric writer: no TensorFlow
from epipolarpose_tpu_torch.scripts import train
out = train.main(sys.argv[2:])
with open(os.path.join(sys.argv[1], f"rank{os.environ['RANK']}.json"),
          "w") as f:
    json.dump({"loss": out["loss"], "perf": out["perf"],
               "steps": out["state"].step, "final": out["final"]}, f)
"""

VALID_RUNNER = """
import json, os, sys
from epipolarpose_tpu_torch.scripts import valid
perf = valid.main(sys.argv[2:])
with open(os.path.join(sys.argv[1], f"valid{os.environ['RANK']}.json"),
          "w") as f:
    json.dump({"perf": perf}, f)
"""


def _torchrun(tmp_path, runner: str, args: list,
              name: str = "runner.py") -> None:
    """``runner`` in two ``gloo`` processes under ``torch.distributed.run``
    (one thread each)."""
    path = tmp_path / name
    path.write_text(runner)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(path), str(tmp_path)] + args,
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]


def test_distributed_train_under_torch_distributed_run(tmp_path):
    """``train --distributed --device cpu`` in two processes started by
    ``torch.distributed.run`` (8 crops a process, 2 steps) against one
    process with the global batch of 16 (``TRAIN`` and ``TEST``): the
    same step count (the schedule counts global batches), the first
    step's loss relative 1e-5 (batch norm over the global batch), the
    perf after both steps relative 1e-4 (Adam's sign noise on near-zero
    gradients moves the second step's weights apart, ROADMAP Queue C),
    one final checkpoint that loads ``strict=True`` into a plain model
    and gives the same perf through ``valid``."""
    per_rank = _yaml(tmp_path / "ddp.yaml", PRINT_FREQ=2,
                     TRAIN={"BATCH_SIZE": 8}, TEST={"BATCH_SIZE": 8})
    one = _yaml(tmp_path / "one.yaml", PRINT_FREQ=2,
                TRAIN={"BATCH_SIZE": 16}, TEST={"BATCH_SIZE": 16})
    args = ["--cfg", per_rank, "--synthetic", "--samples", "32", "--epochs",
            "1", "--device", "cpu", "--modelDir", str(tmp_path / "out"),
            "--logDir", str(tmp_path / "log"), "--distributed"]
    _torchrun(tmp_path, RUNNER, args)
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(2)]
    assert ranks[0] == ranks[1]
    with quiet_cli():
        want = train.main(["--cfg", one, "--synthetic", "--samples", "32",
                           "--epochs", "1"] + _common(tmp_path / "one"))
    got = ranks[0]
    assert got["steps"] == want["state"].step == 2
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["perf"], want["perf"], rtol=1e-4)
    net = get_pose_net(load_config(one))
    sd = torch.load(got["final"], map_location="cpu", weights_only=True)
    net.load_state_dict(sd["state_dict"], strict=True)
    logs = list(pathlib.Path(got["final"]).parents[1].glob("ddp_*_train.log"))
    assert len(logs) == 1 and "2 process(es)" in logs[0].read_text()
    with quiet_cli():
        perf = valid.main(["--cfg", per_rank, "--synthetic", "--samples",
                           "32", "--model-file", got["final"]]
                          + _common(tmp_path / "valid"))
    assert perf == pytest.approx(got["perf"], rel=1e-6)


def test_model_axis_train_and_valid_under_torch_distributed_run(tmp_path):
    """``train`` and ``valid`` with ``--distributed`` and
    ``TPU.MESH.MODEL: 2`` in two ``gloo`` processes under
    ``torch.distributed.run`` (one data group: each process runs 32 of
    the 64 rows of the same 8 crops a step) against the same runs in one
    process without the flag: the same step count, the first step's loss
    relative 1e-5, the perf after both steps relative 1e-4 (Adam's sign
    noise, as above), the layout logged, a final checkpoint that loads
    ``strict=True`` into a plain model; ``valid`` on that checkpoint with
    the rows split gives the perf of one process, relative 1e-5."""
    split = _yaml(tmp_path / "split.yaml", PRINT_FREQ=2,
                  TRAIN={"BATCH_SIZE": 8}, TEST={"BATCH_SIZE": 8},
                  TPU={"MESH": {"MODEL": 2}})
    one = _yaml(tmp_path / "one.yaml", PRINT_FREQ=2,
                TRAIN={"BATCH_SIZE": 8}, TEST={"BATCH_SIZE": 8})
    common = ["--synthetic", "--samples", "16", "--device", "cpu"]
    _torchrun(tmp_path, RUNNER, ["--cfg", split, "--epochs", "1",
                                 "--modelDir", str(tmp_path / "out"),
                                 "--logDir", str(tmp_path / "log"),
                                 "--distributed"] + common)
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(2)]
    assert ranks[0] == ranks[1]
    got = ranks[0]
    with quiet_cli():
        want = train.main(["--cfg", one, "--epochs", "1"] + common[:-2]
                          + _common(tmp_path / "one"))
    assert got["steps"] == want["state"].step == 2
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["perf"], want["perf"], rtol=1e-4)
    logs = list(pathlib.Path(got["final"]).parents[1].glob(
        "split_*_train.log"))
    assert len(logs) == 1
    assert "2 process(es): data 1 x model 2" in logs[0].read_text()
    net = get_pose_net(load_config(one))
    sd = torch.load(got["final"], map_location="cpu", weights_only=True)
    net.load_state_dict(sd["state_dict"], strict=True)

    _torchrun(tmp_path, VALID_RUNNER, ["--cfg", split, "--model-file",
                                       got["final"], "--modelDir",
                                       str(tmp_path / "vout"), "--logDir",
                                       str(tmp_path / "vlog"),
                                       "--distributed"] + common,
              "valid_runner.py")
    perfs = [json.loads((tmp_path / f"valid{r}.json").read_text())["perf"]
             for r in range(2)]
    assert perfs[0] == perfs[1]
    with quiet_cli():
        perf = valid.main(["--cfg", one, "--model-file", got["final"]]
                          + common[:-2] + _common(tmp_path / "vone"))
    assert perfs[0] == pytest.approx(perf, rel=1e-5)
