"""One run of one cell: set-up, the window, the check, the result line.

:func:`run_cell` does the run on any device (the tests drive it on the
CPU at tiny sizes); :func:`main` is the command, which runs only on the
card.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from benchmark import checks, weights, window
from benchmark.reference import model as ref_model
from benchmark.spec import Spec

# top-level module names the run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chex", "orbax",
             "epipolarpose_tpu")


@dataclasses.dataclass
class Ctx:
    name: str
    cell: dict
    config: dict
    mix: dict
    cfg: object
    arch: dict
    seed: int
    device: torch.device
    samples: int
    pool: list = dataclasses.field(default_factory=list)


def _merge(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def port_config(config: dict, cell: dict):
    """The program's config: its defaults, then the configuration's
    ``port`` block, then the cell's, read by the program's own loader
    (JSON is YAML) from a file in ``TMPDIR``."""
    from epipolarpose_tpu_torch.config import load_config
    merged = _merge(json.loads(json.dumps(config["port"])),
                    cell.get("port", {}))
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_cfg_")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(merged, f)
        return load_config(path), merged
    finally:
        os.remove(path)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def make_ctx(spec: Spec, name: str, seed: int, device: torch.device):
    """The cell's context, its batches made, and its entry's module."""
    cell = spec.cell(name)
    config = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    maker = spec.generator(mix["kind"])
    cfg, merged = port_config(config, cell)
    ctx = Ctx(name, cell, config, mix, cfg, ref_model.arch_of(merged),
              int(seed), device, maker.samples_per_batch(mix))
    if device.type == "cuda":
        torch.cuda.set_device(device)
        from epipolarpose_tpu_torch.kernels import _build
        _build.library()
    entry = importlib.import_module(f"benchmark.entries.{cell['entry']}")
    ctx.pool = maker.pool(mix, ctx.arch,
                          weights.generator(seed, weights.DATA, device),
                          device)
    return ctx, entry


def run_cell(spec: Spec, name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float) -> tuple[dict, list]:
    """The result line's object and the check's lines for stderr."""
    ctx, entry = make_ctx(spec, name, seed, device)
    job = entry.Job(ctx)
    window.sync(device)
    setup_s = time.perf_counter() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    stats = window.run(job.call, seconds, device, job.after)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    summary = None
    if trace:
        summary = window.profiled(job.call, stats["calls"], device,
                                  job.after)
    readings, notes = job.check()
    correct, checked = checks.judge(readings, ctx.cell["limits"])

    record = dict(stats, kind=entry.KIND, cell=ctx.cell, arch=ctx.arch,
                  mix=ctx.mix, samples=ctx.samples, setup_s=setup_s,
                  peak_bytes=peak, trace=summary,
                  dtype=str(ctx.cfg.TPU.COMPUTE_DTYPE),
                  flops_per_sample=entry.flops_per_sample(ctx))
    metrics = {}
    for m in spec.metrics_for(name, trace):
        value = spec.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit_w()
    result = {"correct": bool(correct), "attempted": stats["calls"],
              "failed": job.failed(), "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checked
    notes = dict(notes, readings={k: v for k, v in readings.items()
                                  if k not in checked})
    lines = [f"notes {json.dumps(notes)}"] + [
        f"check {k} {v['value']} limit {v['limit']}"
        for k, v in checked.items()]
    return result, lines


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="One run of one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = Spec()
    chips = int(spec.workload(args.workload)["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    result, lines = run_cell(spec, args.workload, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0),
                             t_start)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the port "
              "alone", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
