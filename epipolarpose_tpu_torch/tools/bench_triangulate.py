"""Time the triangulation kernel at the SS step's call and in bulk.

    python -m epipolarpose_tpu_torch.tools.bench_triangulate [--layouts]

Seven shapes of (frames x 17 joints, 4 views, weights): the SS step's
call (32 frames, per-frame P) and 256 to 65,536 frames seen by one rig
(shared P), the last the bulk pseudo-GT shape of ``chip_smoke.py``.
Detections are the projected skeleton poses 2 px off, view 0 moved 60 px
and weighted 1e-3. For each shape it prints one JSON line: the wrapper's
time a call with the host (``ms``, the median of five ``time_ms`` runs)
and on the card alone (``card_ms``, ``tools.profile_step.card_time_ms``),
the launch floor (the card time of a one-element in-place add) and the
largest |dX| against the plain version; at the SS shape also the host's
microseconds a call (the wrapper, and of it the host check, the two
output allocations and the current stream's handle, through a ``Stream``
object and, where ``_build`` has it, raw; the least of five host-clock
runs of 1,000 calls, no synchronisation).
``--layouts`` adds both layouts of the kernel at every shape (forced
through ``SPLIT_MAX_POINTS``), which the route's threshold rests on. It
uses only the wrapper, so the same file times another checkout's package:

    PYTHONPATH=<checkout> python epipolarpose_tpu_torch/tools/bench_triangulate.py

Needs a CUDA card; the first line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import time

import numpy as np
import torch

from epipolarpose_tpu_torch.data.synthetic import (make_rig,
                                                  synth_skeleton_poses)
from epipolarpose_tpu_torch.geometry.camera import (Camera,
                                                    project_point_radial,
                                                    undistort_points)
from epipolarpose_tpu_torch.kernels import _build
from epipolarpose_tpu_torch.kernels import triangulate as ktri
from epipolarpose_tpu_torch.tools.profile_step import card_time_ms, time_ms

VIEWS, JOINTS = 4, 17
# (name, frames, P per frame)
SHAPES = (("ss", 32, True), ("4k", 256, False), ("9k", 512, False),
          ("17k", 1024, False), ("35k", 2048, False), ("70k", 4096, False),
          ("1m", 65536, False))
REPEATS = 5     # ms is the median of this many timings


def inputs(frames: int, per_frame: bool, seed: int, device):
    """Undistorted detections (N, V, J, 2), P, weights (N, V, J)."""
    rng = np.random.default_rng(seed)
    poses = synth_skeleton_poses(rng, frames, JOINTS) + 800.0
    rigs = [Camera.stack(make_rig(VIEWS, seed=seed + n))
            for n in range(frames if per_frame else 1)]
    cams = Camera.stack(rigs).to(device)                # (1 or N, V)
    px, _ = project_point_radial(
        torch.tensor(poses, dtype=torch.float32, device=device)[:, None],
        cams)
    g = torch.Generator(device).manual_seed(seed)
    px = px + 2.0 * torch.randn(px.shape, generator=g, device=device)
    w = 0.5 + 0.5 * torch.rand(px.shape[:-1], generator=g, device=device)
    px[:, 0] += 60.0
    w[:, 0] = 1e-3
    und = undistort_points(px, cams).contiguous()
    P = (cams.P if per_frame else cams.P[0]).contiguous()
    return und, P, w.contiguous()


def timings(fn, device, iters: int) -> dict:
    return {"ms": statistics.median(time_ms(fn, device, iters=iters)
                                    for _ in range(REPEATS)),
            "card_ms": card_time_ms(fn, iters=iters)}


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds a call of ``fn``, with no synchronisation: the
    least of ``REPEATS`` runs of ``calls`` calls (the host is shared)."""
    fn()
    best = math.inf
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best * 1e6 / calls


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layouts", action="store_true",
                    help="also time each layout of the kernel")
    args = ap.parse_args()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    print(smi.stdout.strip(), flush=True)
    one = torch.zeros(1, device=dev)
    for name, frames, per_frame in SHAPES:
        pts, P, w = inputs(frames, per_frame, seed=frames, device=dev)
        iters = 100 if frames <= 4096 else 50
        row = {"shape": name, "points": frames * JOINTS,
               "p_per_frame": per_frame,
               "floor_card_ms": card_time_ms(lambda: one.add_(1.0),
                                             iters=iters)}
        fn = lambda: ktri.triangulate_fast(pts, P, w)   # noqa: E731
        row.update(timings(fn, dev, iters))
        x, _ = fn()
        xp, _ = ktri.triangulate_fast_plain(pts, P, w)
        row["max_abs_dx_vs_plain"] = (x - xp).abs().max().item()
        if name == "ss":
            n, _, j, _ = pts.shape
            row["host_us"] = {
                "wrapper": host_us(fn),
                "check": host_us(lambda: ktri.check_kernel_args(pts, P, w)),
                "outputs": host_us(lambda: (
                    torch.empty((n, j, 3), dtype=torch.float32, device=dev),
                    torch.empty((n, j), dtype=torch.float32, device=dev))),
                "stream_object": host_us(
                    lambda: torch.cuda.current_stream(0).cuda_stream)}
            if hasattr(_build, "current_stream"):
                row["host_us"]["stream_raw"] = host_us(
                    lambda: _build.current_stream(0))
        if args.layouts:
            default = ktri.SPLIT_MAX_POINTS
            for layout, limit in (("thread", -1), ("split", 2 ** 31)):
                ktri.SPLIT_MAX_POINTS = limit
                row[layout] = timings(fn, dev, iters)
            ktri.SPLIT_MAX_POINTS = default
            row["route"] = ktri.route(frames * JOINTS)
        print("bench_triangulate " + json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
