"""A tiny benchmark beside the real one, for CPU runs of the harness: the
real configuration's architecture at 64x64 crops, 16x16 heatmaps and 4
depth bins in float32, three cells added from a temporary directory under
their own BENCHMARK.json, with limits for float32 at this size."""

from __future__ import annotations

import json
import pathlib
import time

import torch

from benchmark import harness
from benchmark.spec import PACKAGE_DIR, REPO_DIR, Spec

PAIRS = [[1, 4], [2, 5], [3, 6], [11, 14], [12, 15], [13, 16]]
TRAIN = {"OPTIMIZER": "adam", "LR": 0.001}
CELLS = {
    "tiny_fs": ({"kind": "fs", "batch": 4, "pool": 3, "depth_mm": 900.0,
                 "vis_share": 0.95},
                {"entry": "fs_train",
                 "port": {"TRAIN": dict(TRAIN, BATCH_SIZE=4),
                          "PRINT_FREQ": 2},
                 "warmup_calls": 1, "check": {"steps": 3},
                 "limits": {"loss1_gap": 1e-4, "grad_gap": 0.02,
                            "change_gap": 0.3}}),
    "tiny_eval": ({"kind": "eval", "batch": 4, "pool": 3,
                   "flip_pairs": PAIRS},
                  {"entry": "eval_flip",
                   "port": {"TEST": {"BATCH_SIZE": 4, "FLIP_TEST": True,
                                     "SHIFT_HEATMAP": True}},
                   "warmup_calls": 1, "check": {"batches": 3},
                   "limits": {"xy_gap_px": 0.05, "xy_mean_gap_px": 0.01,
                              "z_gap_mm": 0.5}}),
    "tiny_ss": ({"kind": "ss", "groups": 2, "views": 4, "pool": 3,
                 "pose_noise_mm": 40.0, "scale_factor": 0.25,
                 "rot_factor": 30.0, "flip_pairs": PAIRS},
                {"entry": "ss_train",
                 "port": {"TRAIN": dict(TRAIN, BATCH_SIZE=2),
                          "PRINT_FREQ": 2,
                          "TPU": {"TRIANGULATION": {"METHOD": "fast",
                                                    "CONF_WEIGHT": True}}},
                 "warmup_calls": 1, "check": {"steps": 3},
                 "limits": {"loss1_gap": 1e-4, "grad_gap": 0.02,
                            "change_gap": 0.3, "hm_gap": 0.01,
                            "pgt_gap": 5e-6}}),
}


def write(tmp: pathlib.Path) -> Spec:
    """The tiny benchmark under ``tmp``; its metrics and traffic kinds are
    the real benchmark's, found through the package's directory, which its
    ``paths`` list after its own."""
    base = tmp / "tinybench"
    for d in ("configs", "cells", "traffic"):
        (base / d).mkdir(parents=True, exist_ok=True)
    real = json.loads((REPO_DIR / "benchmark/configs/r50_256_integral.json")
                      .read_text())
    port = real["port"]
    port["MODEL"]["IMAGE_SIZE"] = [64, 64]
    port["MODEL"]["EXTRA"].update(HEATMAP_SIZE=[16, 16], DEPTH_DIM=4)
    port["TPU"]["COMPUTE_DTYPE"] = "float32"
    (base / "configs/tiny.json").write_text(json.dumps({"port": port}))
    for name, (mix, cell) in CELLS.items():
        (base / f"traffic/{name}.json").write_text(json.dumps(mix))
        (base / f"cells/{name}.json").write_text(json.dumps(cell))
    bench = json.loads((REPO_DIR / "BENCHMARK.json").read_text())
    train = ["tiny_fs", "tiny_ss"]
    bench.update(
        paths=["tinybench", str(PACKAGE_DIR)],
        configs=[{"name": "tiny", "source": "https://arxiv.org/abs/1711.08229",
                  "file": "tinybench/configs/tiny.json", "reduced": []}],
        workloads=[{"name": n, "config": "tiny", "traffic": n, "chips": 1,
                    "why": "a CPU run of the harness"} for n in CELLS])
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = ("eval" if any("eval" in w for w in m["workloads"])
                    else "train")
            m["workloads"] = ["tiny_eval"] if kind == "eval" else train
            if m["name"] == "triangulate_roofline.train":
                m["workloads"] = ["tiny_ss"]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return Spec(tmp / "BENCHMARK.json")


def run(spec: Spec, cell: str, seconds: float = 1.0, trace: bool = False,
        seed: int = 2 ** 31 + 7) -> tuple[dict, list]:
    """One CPU run of a tiny cell (the harness's look for a card skipped)."""
    torch.set_num_threads(2)
    return harness.run_cell(spec, cell, seed, seconds, trace,
                            torch.device("cpu"), time.perf_counter())
