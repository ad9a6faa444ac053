"""The harness on the CPU at a tiny size: finding parts by name, a cell
added from a temporary directory, the check's faults and its control."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.reference import quant
from benchmark.spec import REPO_DIR, Spec
from benchmark.tests import portbench_tiny as tiny


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return tiny.write(tmp_path_factory.mktemp("bench"))


def test_real_benchmark_finds_every_part_by_name():
    spec = Spec()
    for w in spec.bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell["config"] == w["config"]
        assert spec.config(w["config"])["port"]["MODEL"]
        assert spec.traffic(w["traffic"])["kind"]
        assert cell["limits"]
    for m in spec.bench["end_to_end"] + spec.bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


NEW_KIND = '''
"""A traffic kind added from a temporary directory: fs batches whose 3D
joints all lie at one depth."""
import torch
from benchmark.generate import crops, uniform


def samples_per_batch(mix):
    return int(mix["batch"])


def pool(mix, arch, g, device):
    n, j = int(mix["batch"]), arch["num_joints"]
    w, h = arch["image_size"]
    out = []
    for _ in range(int(mix["pool"])):
        xy = torch.stack([uniform(g, (n, j), 0, w, device),
                          uniform(g, (n, j), 0, h, device)], -1)
        out.append({"input": crops(g, (n, h, w, 3), device), "joints": xy,
                    "joints_vis": torch.ones((n, j), device=device),
                    "joints_3d": torch.full((n, j, 3), 4500.0,
                                            device=device)})
    return out
'''


def test_added_traffic_kind_is_found_by_name_and_runs(spec):
    base = spec.root / "tinybench"
    (base / "traffic/flat_depth.py").write_text(NEW_KIND)
    mix, cell = tiny.CELLS["tiny_fs"]
    (base / "traffic/tiny_flat.json").write_text(
        json.dumps({"kind": "flat_depth", "batch": 4, "pool": 3}))
    (base / "cells/tiny_flat_fs.json").write_text(json.dumps(cell))
    bench = json.loads(spec.file.read_text())
    bench["workloads"].append({"name": "tiny_flat_fs", "config": "tiny",
                               "traffic": "tiny_flat", "chips": 1,
                               "why": "a traffic kind added from files"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny_fs" in m.get("workloads", []):
            m["workloads"].append("tiny_flat_fs")
    added = spec.root / "BENCHMARK_added.json"
    added.write_text(json.dumps(bench))
    grown = Spec(added)
    assert grown.generator("flat_depth").samples_per_batch({"batch": 4}) == 4
    result, _ = tiny.run(grown, "tiny_flat_fs")
    assert result["correct"], result["checks"]
    assert "train_samples_per_s" in result["metrics"]


def test_spec_searches_only_the_listed_paths(tmp_path):
    bench = json.loads((REPO_DIR / "BENCHMARK.json").read_text())
    bench["paths"] = ["elsewhere"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    lone = Spec(tmp_path / "BENCHMARK.json")
    with pytest.raises(FileNotFoundError):
        lone.reader("setup_s")
    with pytest.raises(FileNotFoundError):
        lone.generator("fs")


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_added_cell_runs_and_is_correct(spec, cell):
    result, lines = tiny.run(spec, cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert "setup_s" in result["metrics"]
    assert set(result["checks"]) == set(tiny.CELLS[cell][1]["limits"])
    assert lines[-1].startswith("check ")


def test_traced_cpu_run_reports_no_device_metric(spec):
    result, _ = tiny.run(spec, "tiny_fs", trace=True)
    names = set(result["metrics"])
    assert names <= {"host_ms_per_step.train", "mfu.train"}
    assert "breakdown" not in result


def _fault(monkeypatch, kind):
    from epipolarpose_tpu_torch.core import self_supervised as tss
    from epipolarpose_tpu_torch.core import steps
    if kind == "state_unchanged":
        monkeypatch.setattr(steps, "optimizer_step",
                            lambda state, loss: None)
    elif kind == "half_batch":
        whole = steps.integral_update

        def half(state, model, x, target, tw, *args, **kwargs):
            k = x.shape[0] // 2
            return whole(state, model, x[:k], target[:k],
                         None if tw is None else tw[:k], *args, **kwargs)
        monkeypatch.setattr(steps, "integral_update", half)
        monkeypatch.setattr(tss, "integral_update", half)
    elif kind == "answer_altered":
        moved = steps.transform_preds
        monkeypatch.setattr(steps, "transform_preds",
                            lambda *a, **k: moved(*a, **k) + 1.0)


@pytest.mark.parametrize("cell,kind", [
    ("tiny_fs", "state_unchanged"), ("tiny_fs", "half_batch"),
    ("tiny_ss", "state_unchanged"), ("tiny_ss", "half_batch"),
    ("tiny_eval", "answer_altered")])
def test_broken_timed_path_is_not_correct(spec, monkeypatch, cell, kind):
    _fault(monkeypatch, kind)
    result, _ = tiny.run(spec, cell, seconds=0.5)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_in_lower_precision_is_not_correct(spec, cell):
    ctx, entry = harness.make_ctx(spec, cell, 11, torch.device("cpu"))
    kwargs = {"quant": quant.FP8}
    if ctx.cell["entry"] == "ss_train":
        kwargs["tri_round"] = quant.tf32
    readings, _ = entry.stand_in(ctx, **kwargs)
    correct, checks = harness.checks.judge(readings, ctx.cell["limits"])
    assert not correct, checks


@pytest.mark.parametrize("cell,fault", [
    ("tiny_fs", "half"), ("tiny_ss", "half"), ("tiny_ss", "moved"),
    ("tiny_eval", "no_shift"), ("tiny_eval", "no_swap")])
def test_planted_fault_in_the_stand_in_is_not_correct(spec, cell, fault):
    ctx, entry = harness.make_ctx(spec, cell, 13, torch.device("cpu"))
    assert fault in entry.FAULTS
    readings, _ = entry.stand_in(ctx, fault=fault)
    correct, checks = harness.checks.judge(readings, ctx.cell["limits"])
    assert not correct, checks


def test_command_needs_a_card():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "fs_r50_256_b128", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=REPO_DIR, capture_output=True,
                         text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_short_run_on_the_card(card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "eval_r50_256_flip_b64", "--seed", "5",
                          "--seconds", "3", "--trace", "0"], cwd=REPO_DIR,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
