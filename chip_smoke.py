#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``epipolarpose_tpu_torch/csrc`` (one
``nvcc`` call), holds each kernel against its plain PyTorch version on the
card, then drives the port's paths through their entry points:

1. environment and build: the card, torch/CUDA versions, build seconds;
2. soft-argmax kernel vs its plain version on a flagship-shaped bf16
   volume (64, 17*64, 64, 64);
3. matmul+stats kernel vs its plain version on the 15 ResNet-50 1x1-conv
   shapes, each of which must take the kernel's wgmma route (and give the
   same stats bits twice), beside ``torch.matmul`` as the library
   yardstick; then a ragged shape that must take the simt route;
4. the H36M 3D eval path (``experiments/h36m/valid_r50_256_integral.yaml``:
   ResNet-50 at 256x256, 17 joints, DEPTH_DIM 64, flip test, batch 64) via
   ``validate`` over 3 seeded random batches; then, with the head re-drawn
   so that the joints decode apart, the step through the kernel against
   the same step through the plain decode on one batch;
5. the H36M 3D train path (``experiments/h36m/train_fs_r50_256_integral.yaml``:
   ResNet-50 at 256x256, 17 joints, DEPTH_DIM 64, batch 32, bf16, Adam)
   via ``create_train_state`` -> ``make_train_step`` -> ``train``, three
   timed calls of 40 steps each on one seeded batch; then train, eval,
   train on that one model (the eval preds against a fresh eval-mode copy,
   no buffer moved by the eval); then the soft-argmax forward (with its
   saved statistics) and backward kernels against their plain versions at
   the flagship shape (32, 17*64, 64, 64), and one train step through the
   kernels against the same step through the plain decode;
6. the self-supervised 3D train path
   (``experiments/h36m/train_ss_r50_256_integral.yaml``: G = 32 groups of
   V = 4 views, 128 crops a step, student ResNet-50 at 256x256, J = 17,
   D = 64, bf16, Adam; ``fast`` confidence-weighted triangulation) on a
   batch built on the card from the port's synthetic rig and skeleton
   poses, with a seeded dual crop: the triangulation kernel against its
   plain version and float64 ``svd``/``eigh`` oracles at 544 and about
   10^6 points (with TF32 allowed and not), timed beside the launch floor
   and with its registers from the build's report, the soft-argmax kernels at
   (128, 17*64, 64, 64), the perfect teacher (pseudo-GT within 1 mm,
   3 warm-up steps and 2 timed windows of 20 steps through
   ``make_ss_train_step``), a random bf16 ResNet-50 teacher for 3 steps
   (its weights and buffers unchanged), and one step through the kernels
   against the same step through the plain versions;
7. the MPII 2D path (``experiments/mpii/train_r50_256x256_d256x3_adam_lr1e-3.yaml``:
   16 joints, 64x64 heatmaps, batch 32): 3 gaussian train steps and one
   flip-test eval batch, the teacher's own network, with no hand-written
   kernel;
8. the tool path: ``tools.profile_step.bench_conv1x1()``, every shape on
   the wgmma route;
9. the eval path fed by the port's own data: the eval config of phase 4
   over 48 frames x 4 views of the port's ``synthetic_multiview`` dataset
   (skeleton poses, cameras, absolute depths, 1024 px views) through
   ``epoch_loader`` -> ``validate`` -> the dataset's H36M ``evaluate``
   (the undistort + ``pixel2cam`` lift, MPJPE, NMPJPE, PA-MPJPE, PSS@50);
   the first loader batch on the card bit-equal to ``get_batch`` on the
   host;
10. the SS path fed by the port's own data: the config of phase 6 over
   96 frames through ``epoch_loader(multiview=True, is_train=True)``, the
   real dual crop, the batches' labels as detections: two epochs of 3
   steps, the loss falling from the first to the second, the first
   batch's pseudo-GT within 1 mm of the world poses;
11. the 2D path fed by the port's own data: the MPII config over the
   port's ``synthetic`` dataset through ``epoch_loader``: 3 gaussian
   steps, then ``validate`` on 64 held-out samples scored by the
   dataset's PCKh ``evaluate``;
12. none of OpenCV, PIL, torchvision or matplotlib was imported on the
   way;
13. the user's workflow through the CLIs' ``main(argv)`` at ResNet-50@256
   (outputs in a temporary directory, deleted at the end): a 2D teacher
   derived from the SS config as ``make_teacher_cfg`` does (1 epoch); the
   FS config for 2 epochs, the restored state bit-equal to the one saved,
   a resume to epoch 3, ``best/`` in the MPJPE direction; ``valid`` on
   the final weights in this process and as a ``python -m`` subprocess
   against ``validate`` here (within 0.01 mm); the SS config with that
   teacher (strict load, backbone merged, head skipped, one triangulation
   a step); ``train_refiner`` and the data-free ``demo`` with the refiner
   (both PNGs decode); the ``DEBUG.DEBUG`` dumps of one 2D ``train``
   call; checkpoint bytes and save and restore seconds; and the
   calibration-free SS config (``train_ss_nocam_r50_256_integral.yaml``)
   with that teacher, four triangulation launches a step;
14. a cut run of the port's SS convergence tool at ResNet-50@256, D 64
   (the JAX CI pin's operating point): the train-pose MPJPE at the last
   point below the first, the pseudo-GT floor finite;
15. calibration-free SS (``train_ss_nocam_r50_256_integral.yaml``:
   ``TPU.SS_CAMERAS: estimated``, 32 groups x 4 views) on a batch built
   on the card from an undistorted synthetic rig: with perfect
   detections the estimated rotations within 0.1 degree and the
   pseudo-GT within 1 mm of the truth (after one scale, and through
   ``SS_BONE_LENGTH_MM``); the triangulation kernel against its plain
   version and float64 oracles at the rig's shapes (544 two-view points
   with a shared P (2, 3, 4) in normalized coordinates, and 32 x 4 x 17),
   the rig's bits the same with TF32 allowed and not; one step through
   the kernel against one through the plain solver (the same targets);
   timed steps beside phase 6's (4 triangulation launches a step, the
   loss falling), peak memory and the host synchronisations a step
   (``torch.cuda.set_sync_debug_mode``) beside the calibrated step's;
16. the offline pseudo-GT CLI's ``main(argv)`` on the SS config's
   synthetic rig in batches of its 32 groups, with phase 13's teacher and
   with ``--gt-detections`` merged into an annot json (MPJPE under 5 mm,
   every record merged); the triangulation kernel on each run's first
   batch against its plain version and float64 oracles; records/s of
   the batch loop and of the whole call, and launches;
17. loader-fed eval and FS-step rates with ``TPU.LOADER: grain`` at 0, 4
   and 8 worker processes beside ``threads`` over 32 batches each: the
   whole epoch, the seconds to its first batch and the rate from the
   loader's second round on; every eval batch equal to the ``threads``
   route's, ``os.cpu_count()``;
18. JPEG data: the port's own decoder (``native/jpegdec.cpp``, built by
   one ``g++`` call; the card's machine has neither libjpeg's headers nor
   OpenCV) on every fixture of ``tests/data/jpeg`` against the sha256 of
   libjpeg-turbo's decode in its manifest, the progressive fixture
   refused with its mode named; ms a decode of the 2048 x 2048, 1920 x
   1080 and 1000 x 1000 frames, and the rate on 1, 2, 4 and 8 threads;
   ``demo --image`` on the 2048 x 2048 frame at ResNet-50@256;
19. the H36M -> MPI-INF-3DHP transfer evaluation through the ``valid``
   CLI (``experiments/h36m/valid_3dhp_transfer.yaml`` unchanged,
   ``--dataDir`` at a tree of 2 x 129 frames: 256 records, 4 batches of
   64) with phase 13's FS weights: ``evaluate`` on perfect predictions
   (PCK3D 100, AUC above 95, MPJPE under 0.5 mm), the CLI's perf in [0,
   100], every frame through the port's decoder and none through OpenCV,
   validation samples/s and the loader's stage shares, one soft-argmax
   launch a batch;
20. ``ops/warp.py``: 64 rotation-free 256 x 256 crops of 1000 x 1000
   frames on the card against the CPU and ``imgproc``'s numpy crops,
   the separable warp's bits with TF32 allowed and not, card ms beside
   the host's numpy ms;
21. no process left: every process this script started has ended but
   the worker loader's ``forkserver`` and its resource tracker, and those
   two end when ``stop_worker_server`` stops them.

Kernel launch counters are set to 0 just before each path and read just
after it. Each phase checks its own time limit. Any failed phase makes the
script exit 1 without a result; without a CUDA card it exits 1 at once.
On success the line before the last is the kernels' JSON record and the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import logging
import math
import pathlib
import subprocess
import sys
import time
import traceback

import torch

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

# seconds each phase may take; the whole run aims at under 600 s
PHASE_LIMITS = {"build": 120.0, "softargmax": 30.0, "matmul_stats": 60.0,
                "eval": 90.0, "train": 150.0, "ss": 150.0, "pose2d": 60.0,
                "tool": 30.0, "eval_data": 60.0, "ss_data": 90.0,
                "pose2d_data": 60.0, "image_libs": 1.0, "cli": 300.0,
                "ss_convergence": 120.0, "ss_nocam": 150.0,
                "pseudo_gt": 120.0, "loader_workers": 360.0,
                "jpeg": 15.0, "mpi3dhp": 30.0, "warp": 15.0,
                "processes": 30.0}

# H36M left/right joint pairs (the JAX package's data/h36m.py FLIP_PAIRS)
H36M_FLIP_PAIRS = ((1, 4), (2, 5), (3, 6), (11, 14), (12, 15), (13, 16))
EVAL_BATCH, EVAL_BATCHES = 64, 3
# the train path: warm-up steps, then TRAIN_WINDOWS calls of train() of
# TRAIN_STEPS steps each, each timed on its own (about 1.3 s a window)
TRAIN_BATCH, TRAIN_STEPS, TRAIN_WINDOWS, TRAIN_WARMUP = 32, 40, 3, 3
# the SS path: groups x views, warm-up steps, timed windows of steps
SS_GROUPS, SS_VIEWS, SS_WARMUP, SS_WINDOWS, SS_STEPS = 32, 4, 3, 2, 20
# the triangulation kernel's large check: frames x joints, 4 views
TRI_FRAMES = 65536
POSE2D_BATCH, POSE2D_STEPS = 32, 3
# the loader-fed paths: the port's own datasets through epoch_loader.
# eval: 48 frames x 4 views = 192 records, 3 batches of 64; ss: 96 frames,
# 3 batches of 32 groups an epoch, two epochs (the loss rises over the
# first three steps from the init and falls in the second epoch);
# pose2d: 3 train batches, 2 eval batches
EVAL_FRAMES, SS_FRAMES, SS_EPOCHS = 48, 96, 2
POSE2D_SAMPLES, POSE2D_EVAL_SAMPLES = 96, 64
# the CLI path: 2 steps of the 2D teacher, 3 FS steps an epoch (24 frames
# x 4 views), 2 SS steps of 32 groups, refiner steps
CLI_TEACHER_SAMPLES, CLI_FS_SAMPLES, CLI_SS_SAMPLES = 64, 96, 256
CLI_REFINER_STEPS = 40
# the cut convergence run: the JAX CI pin's 2 frames in batches of 2 groups,
# twice its 48 steps, the evaluation interval
CONV_FRAMES, CONV_STEPS, CONV_EVAL_EVERY = 2, 96, 24
# the pseudo-GT CLI: records (frames x 4 views), groups a batch: the SS
# config's 32, so its triangulation launches at the SS step's shape
PGT_SAMPLES, PGT_GROUPS = 512, SS_GROUPS
# the worker-process loader: frames x 4 views of the eval and FS datasets
# (32 eval batches of 64 and 32 FS batches of 32: a DataLoader worker
# builds whole batches, so 8 workers take 4 rounds an epoch), worker counts
LOADER_EVAL_FRAMES, LOADER_FS_FRAMES = 512, 256
LOADER_WORKERS = (0, 4, 8)
# image libraries the card's machine does not have
IMAGE_LIBS = ("cv2", "PIL", "torchvision", "matplotlib")


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def bound(n_bytes: float, flops: float,
          peak_flops: float) -> tuple[float, str]:
    """Least time (ms) the card needs: max of bytes and operations times."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_env(res: dict) -> None:
    from epipolarpose_tpu_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    card = smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    path, compile_s = _build.build(verbose=True)
    _build.library()
    res["build_s"] = time.perf_counter() - t0
    res["ptxas"] = _build.kernel_resources(
        (path.parent / _build.PTXAS_LOG).read_text())
    log(f"[build] {path.name} in {res['build_s']:.1f} s "
        f"(nvcc {compile_s:.1f} s)")


def phase_softargmax(res: dict) -> None:
    from epipolarpose_tpu_torch.kernels.softargmax import (
        softmax_integral, softmax_integral_plain)
    from epipolarpose_tpu_torch.tools.profile_step import time_ms
    dev = torch.device("cuda")
    n, j, d, h, w = 64, 17, 64, 64, 64
    g = torch.Generator(dev).manual_seed(1)
    # standard-normal logits times 4 plus one sharp peak per joint: the
    # softmax is neither uniform nor one-hot
    vol = torch.randn((n, j * d, h, w), generator=g, device=dev) * 4.0
    vol.view(n, j, -1)[..., 12345] += 20.0
    vol = vol.to(torch.bfloat16)
    out = softmax_integral(vol, j, d)
    ref = softmax_integral_plain(vol, j, d)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    check(out.shape == (n, j, 3) and bool(torch.isfinite(out).all()),
          "softargmax output not finite / wrong shape")
    check(err <= 1e-4, f"softargmax max abs err {err:.3g} > 1e-4")
    ms = time_ms(lambda: softmax_integral(vol, j, d), dev)
    plain_ms = time_ms(lambda: softmax_integral_plain(vol, j, d), dev)
    elems = vol.numel()
    # per element: one subtract-and-scale, one exp, three accumulations
    bound_ms, bound_by = bound(elems * 2 + n * j * 3 * 4, 5.0 * elems,
                               F32_FLOPS)
    res["softargmax"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=None)
    log(f"[softargmax] (64, 1088, 64, 64) bf16: max abs err {err:.3g} "
        f"(limit 1e-4), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")


def bf16_ulps(a, b, floor):
    """|a - b| in bf16 spacings (8 significant bits) at max(|a|, |b|,
    floor)."""
    mag = torch.maximum(torch.maximum(a.abs(), b.abs()),
                        torch.as_tensor(floor, device=a.device))
    mag = mag.clamp(min=torch.finfo(torch.float32).tiny)
    return (a - b).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


def bf16_spacing(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bfloat16 (8 significant bits) at each entry of ``x``,
    ``2**(floor(log2|x|) - 7)``, as float32; 0 where ``x`` is 0."""
    _, e = torch.frexp(x.float())              # |x| = m * 2**e, m in [.5, 1)
    one = torch.ones_like(x, dtype=torch.float32)
    return torch.where(x == 0, 0.0, torch.ldexp(one, e - 8))


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter (the triangulation kernel's
    also per layout; and the teacher's decodes, which launch no
    hand-written kernel)."""
    from epipolarpose_tpu_torch.core.self_supervised import teacher_detect
    from epipolarpose_tpu_torch.kernels import softargmax as ksa
    from epipolarpose_tpu_torch.kernels.matmul_stats import matmul_stats
    from epipolarpose_tpu_torch.kernels.triangulate import triangulate_fast
    return {"softargmax_fwd": ksa.softmax_integral.launches,
            "softargmax_bwd": ksa.softmax_integral_bwd.launches,
            "matmul_stats": matmul_stats.launches,
            "triangulate": triangulate_fast.launches,
            "triangulate_split": triangulate_fast.launches_split,
            "teacher_decode": teacher_detect.calls}


def reset_counts() -> None:
    """Set every launch counter to 0."""
    from epipolarpose_tpu_torch.core.self_supervised import teacher_detect
    from epipolarpose_tpu_torch.kernels import softargmax as ksa
    from epipolarpose_tpu_torch.kernels.triangulate import triangulate_fast
    ksa.softmax_integral.launches = ksa.softmax_integral_bwd.launches = 0
    triangulate_fast.launches = teacher_detect.calls = 0
    triangulate_fast.launches_thread = triangulate_fast.launches_split = 0
    reset_matmul_routes()


def matmul_routes():
    from epipolarpose_tpu_torch.kernels.matmul_stats import matmul_stats
    return (matmul_stats.launches, matmul_stats.launches_wgmma,
            matmul_stats.launches_simt)


def reset_matmul_routes() -> None:
    from epipolarpose_tpu_torch.kernels.matmul_stats import matmul_stats
    matmul_stats.launches = 0
    matmul_stats.launches_wgmma = matmul_stats.launches_simt = 0


def phase_matmul_stats(res: dict) -> None:
    from epipolarpose_tpu_torch.kernels.matmul_stats import (
        matmul_stats, matmul_stats_plain)
    from epipolarpose_tpu_torch.tools.profile_step import (CONV1X1_SHAPES,
                                                           card_time_ms,
                                                           time_ms)
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(2)
    rows = []
    # the tool's shapes on the wgmma route, then a ragged one (K and N not
    # multiples of 8) on the simt route
    for (m, k, n), want in ([(s, "wgmma") for s in CONV1X1_SHAPES]
                            + [((131, 13, 70), "simt")]):
        x = torch.randn((m, k), generator=g, device=dev, dtype=torch.bfloat16)
        w = torch.randn((k, n), generator=g, device=dev, dtype=torch.bfloat16)
        before = matmul_routes()
        y, st = matmul_stats(x, w)
        after = matmul_routes()
        took = ("wgmma" if after[1] > before[1] else
                "simt" if after[2] > before[2] else "none")
        check(after[0] == before[0] + 1 and took == want,
              f"{(m, k, n)}: took the {took} route, expected {want}")
        y_ref, st_ref = matmul_stats_plain(x, w)
        _, st_again = matmul_stats(x, w)
        torch.cuda.synchronize()
        same_bits = bool(torch.equal(st, st_again))
        yk, yr = y.float(), y_ref.float()
        diff = (yk - yr).abs()
        # An entry near zero by cancellation carries f32 rounding of its
        # K-term sum that depends on the summation order and exceeds its
        # own bf16 spacing; its ulps are counted at 1/256 of y's rms.
        floor = yr.pow(2).mean().sqrt().item() / 256
        ulps = bf16_ulps(yk, yr, floor).max().item()
        raw_ulps = bf16_ulps(yk, yr, 0.0).max().item()
        # stats error relative to the largest magnitude in each stats row
        rel = ((st - st_ref).abs().amax(1)
               / st_ref.abs().amax(1).clamp(min=1e-30)).max().item()
        check(bool(torch.isfinite(st).all()), f"{(m, k, n)}: stats not finite")
        check(ulps <= 1.0, f"{(m, k, n)}: y off by {ulps:.3g} bf16 ulp")
        check(rel <= 1e-3, f"{(m, k, n)}: stats rel err {rel:.3g} > 1e-3")
        # the wgmma route sums its partials in a fixed order
        check(same_bits or want == "simt",
              f"{(m, k, n)}: two calls gave different stats")
        ms = time_ms(lambda: matmul_stats(x, w), dev)
        plain_ms = time_ms(lambda: matmul_stats_plain(x, w), dev)
        lib_ms = time_ms(lambda: torch.matmul(x, w), dev)
        dev_ms = card_time_ms(lambda: matmul_stats(x, w))
        lib_dev_ms = card_time_ms(lambda: torch.matmul(x, w))
        b_ms, b_by = bound((m * k + k * n + m * n) * 2 + 2 * n * 4,
                           2.0 * m * k * n, BF16_TENSOR_FLOPS)
        row = dict(shape=[m, k, n], route=took,
                   y_max_abs_err=diff.max().item(), y_max_ulp=ulps,
                   y_max_ulp_raw=raw_ulps, stats_rel_err=rel,
                   stats_same_bits=same_bits, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, device_ms=dev_ms,
                   library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"[matmul_stats] {(m, k, n)} {took}: y {ulps:.2f} ulp "
            f"({raw_ulps:.1f} without the floor), max |dy| "
            f"{diff.max().item():.3g}, stats rel {rel:.2e}, same bits twice "
            f"{same_bits}, kernel {ms:.4f} ms (card alone {dev_ms:.4f}), "
            f"plain {plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms (card "
            f"alone {lib_dev_ms:.4f}), bound {b_ms:.4f} ms ({b_by}), "
            f"{b_ms / ms:.0%} of it")
        if want == "wgmma":
            rows.append(row)
        else:
            res["matmul_stats_ragged"] = row
        del x, w, y, y_ref, yk, yr, diff
    log(f"[matmul_stats] sum over the {len(rows)} tool shapes: kernel "
        f"{sum(r['ms'] for r in rows):.4f} ms (card alone "
        f"{sum(r['device_ms'] for r in rows):.4f}), torch.matmul "
        f"{sum(r['library_ms'] for r in rows):.4f} ms (card alone "
        f"{sum(r['library_device_ms'] for r in rows):.4f}), bound "
        f"{sum(r['bound_ms'] for r in rows):.4f} ms")
    by_kind = {"bytes": 0.0, "operations": 0.0}
    for r in rows:
        by_kind[r["bound_by"]] += r["bound_ms"]
    res["matmul_stats"] = dict(
        max_abs_err=max(r["y_max_abs_err"] for r in rows),
        y_max_ulp=max(r["y_max_ulp"] for r in rows),
        stats_max_rel_err=max(r["stats_rel_err"] for r in rows),
        ms=sum(r["ms"] for r in rows),
        plain_ms=sum(r["plain_ms"] for r in rows),
        bound_ms=sum(r["bound_ms"] for r in rows),
        bound_by=max(by_kind, key=by_kind.get),
        library_ms=sum(r["library_ms"] for r in rows),
        device_ms=sum(r["device_ms"] for r in rows),
        library_device_ms=sum(r["library_device_ms"] for r in rows),
        shapes=rows)


class SmokeH36M:
    """Seeded random eval set: uint8 crops, boxes and 3D joints on the card;
    ``evaluate`` scores root-relative MPJPE with the port's metric."""

    root_idx = 0

    def __init__(self, n_batches: int, batch: int, size: int, joints: int,
                 seed: int, device="cuda"):
        dev = torch.device(device)
        g = torch.Generator(dev).manual_seed(seed)
        self.batches = []
        for _ in range(n_batches):
            self.batches.append({
                "input": torch.randint(0, 256, (batch, size, size, 3),
                                       generator=g, device=dev,
                                       dtype=torch.uint8),
                "center": 200 + 600 * torch.rand((batch, 2), generator=g,
                                                 device=dev),
                "scale": 0.8 + 0.4 * torch.rand((batch, 2), generator=g,
                                                device=dev),
                "joints_3d": 800 * torch.rand((batch, joints, 3),
                                              generator=g, device=dev) - 400,
            })
        self.gt = torch.cat([b["joints_3d"] for b in self.batches]).cpu()

    def __len__(self) -> int:
        return self.gt.shape[0]

    def evaluate(self, cfg, preds, output_dir=None):
        from epipolarpose_tpu_torch.ops.metrics import mpjpe
        p = torch.as_tensor(preds)
        r = self.root_idx
        err = float(mpjpe(p - p[:, r:r + 1], self.gt - self.gt[:, r:r + 1]))
        self.preds = p
        return {"MPJPE": err}, err


def spread_volume(n: int, j: int, d: int, h: int, w: int, seed: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """Standard-normal logits times 4 plus a +20 peak at a random place in
    each joint's volume: the softmax is neither uniform nor one-hot, and
    the joints decode apart."""
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(seed)
    vol = torch.randn((n, j * d, h, w), generator=g, device=dev) * 4.0
    peak = torch.randint(0, d * h * w, (n, j, 1), generator=g, device=dev)
    vol.view(n, j, -1).scatter_add_(
        -1, peak, torch.full((n, j, 1), 20.0, device=dev))
    return vol.to(dtype)


def redraw_head(model: torch.nn.Module, seed: int) -> None:
    """Deconv and final conv weights at std 0.05: the init's std 0.001
    leaves the volumes near uniform, and every joint at the crop centre."""
    g = torch.Generator(model.final_layer.weight.device).manual_seed(seed)
    with torch.no_grad():
        for mod in (*model.deconv_layers, model.final_layer):
            weight = getattr(mod, "weight", None)
            if weight is not None and weight.ndim == 4:
                weight.normal_(0.0, 0.05, generator=g)


def phase_eval(res: dict) -> None:
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.core.function import validate
    from epipolarpose_tpu_torch.core.steps import (configure_backends,
                                                   make_eval_step)
    from epipolarpose_tpu_torch.kernels.matmul_stats import matmul_stats
    from epipolarpose_tpu_torch.kernels.softargmax import (
        softmax_integral, softmax_integral_bwd, softmax_integral_plain)
    from epipolarpose_tpu_torch.models import get_model

    cfg = load_config(ROOT / "experiments/h36m/valid_r50_256_integral.yaml")
    check(cfg.TEST.FLIP_TEST and cfg.MODEL.EXTRA.DEPTH_DIM == 64
          and cfg.TEST.BATCH_SIZE == EVAL_BATCH, "unexpected flagship config")
    joints = int(cfg.MODEL.NUM_JOINTS)
    size = int(cfg.MODEL.IMAGE_SIZE[0])
    model = get_model(cfg, False, torch.Generator().manual_seed(0))
    data = SmokeH36M(EVAL_BATCHES, EVAL_BATCH, size, joints, seed=4)
    configure_backends(cfg)
    log(f"[eval] cudnn.benchmark {torch.backends.cudnn.benchmark}, "
        f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, "
        f"cuda.matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, "
        f"compute dtype {cfg.TPU.COMPUTE_DTYPE}")
    step = make_eval_step(cfg, model, H36M_FLIP_PAIRS, device="cuda")
    step(data.batches[0])          # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    name_values, _ = validate(cfg, data.batches, data, step)
    wall = time.perf_counter() - t0
    res["paths"]["eval"] = launch_counts()
    launches = softmax_integral.launches
    check(matmul_stats.launches == 0, "eval path launched matmul_stats")
    check(softmax_integral_bwd.launches == 0,
          "eval path launched the soft-argmax backward")
    check(launches == EVAL_BATCHES,
          f"soft-argmax kernel launched {launches} times, "
          f"expected {EVAL_BATCHES}")
    preds = data.preds
    check(tuple(preds.shape) == (EVAL_BATCHES * EVAL_BATCH, joints, 3),
          f"preds shape {tuple(preds.shape)}")
    check(bool(torch.isfinite(preds).all()), "preds not finite")
    res["eval_launches"] = launches
    res["samples_per_s"] = len(data) / wall
    log(f"[eval] ResNet-50@256 J=17 D=64 flip test, {len(data)} samples "
        f"via validate in {wall:.3f} s = {res['samples_per_s']:.1f} "
        f"samples/s; soft-argmax launches {launches}; MPJPE on random "
        f"weights {name_values['MPJPE']:.1f} mm")

    # The init's head (std 0.001) leaves the volumes near uniform, so every
    # joint decodes to about the crop centre and any decode would agree.
    # Re-draw the head at std 0.05 so the joints land apart, and check that
    # they do, before holding the kernel against the plain decode.
    redraw_head(model, seed=5)
    plain_step = make_eval_step(cfg, model, H36M_FLIP_PAIRS, device="cuda",
                                decode=softmax_integral_plain)
    a = step(data.batches[0])["preds"]
    b = plain_step(data.batches[0])["preds"]
    check(bool(torch.isfinite(a).all()), "re-drawn head: preds not finite")
    # mean over samples of each coordinate's range over the 17 joints
    spread = (b.amax(1) - b.amin(1)).mean(0).tolist()
    log(f"[eval] re-drawn head: joints spread over {spread[0]:.1f} px in x, "
        f"{spread[1]:.1f} px in y, {spread[2]:.1f} mm in z "
        f"(need 4 px, 4 px, 10 mm)")
    check(spread[0] >= 4 and spread[1] >= 4 and spread[2] >= 10,
          "joints do not spread; the decode comparison would test nothing")
    dxy = (a[..., :2] - b[..., :2]).abs().max().item()
    dz = (a[..., 2] - b[..., 2]).abs().max().item()
    # 1e-4 in normalized coords is 0.0256 crop px and 0.2 mm; the un-crop
    # scales px by at most 1.2*200/256
    log(f"[eval] kernel vs plain decode, one batch: max |dxy| {dxy:.3g} px "
        f"(limit 0.05), max |dz| {dz:.3g} mm (limit 0.5)")
    check(dxy <= 0.05 and dz <= 0.5, "kernel and plain decode disagree")


def train_kernels_vs_plain(res: dict, n: int, j: int, d: int, h: int,
                           w: int, path: str = "train") -> None:
    """The soft-argmax forward (with statistics) and backward kernels
    against their plain versions at a train path's shape; the records go
    to ``res`` under names suffixed with the path (none for ``train``)."""
    suffix = "" if path == "train" else f"_{path}"
    from epipolarpose_tpu_torch.kernels import softargmax as ksa
    from epipolarpose_tpu_torch.tools.profile_step import time_ms
    dev = torch.device("cuda")
    grad = torch.randn((n, j, 3), generator=torch.Generator(dev)
                       .manual_seed(9), device=dev)
    gmax = grad.abs().max().item()
    vol = spread_volume(n, j, d, h, w, seed=8, dtype=torch.bfloat16)
    coords, stats = ksa.softmax_integral_fwd(vol, j, d)
    ref_stats = ksa.softmax_integral_stats_plain(vol, j, d)
    ref = ksa.softmax_integral_plain(vol, j, d)
    spread = (ref.amax(1) - ref.amin(1)).mean().item()
    check(spread >= 0.1, f"test volume decodes to joints {spread:.3g} apart")
    fwd_err = (coords - ref).abs().max().item()
    # statistics: lse in absolute terms; Ex, Ey, Ez in normalized units
    lse_err = (stats[..., 0] - ref_stats[..., 0]).abs().max().item()
    size = torch.tensor([w, h, d], device=dev, dtype=torch.float32)
    e_err = ((stats[..., 1:] - ref_stats[..., 1:]).abs() / size).max().item()
    log(f"[{path}] forward kernel with statistics vs plain at "
        f"{(n, j * d, h, w)} bf16: coords {fwd_err:.3g} (limit 1e-4), lse "
        f"{lse_err:.3g} (limit 1e-3), Ex/Ey/Ez {e_err:.3g} of the axis "
        f"(limit 1e-4)")
    check(fwd_err <= 1e-4 and lse_err <= 1e-3 and e_err <= 1e-4,
          "forward kernel statistics disagree with the plain version")

    # float32: within 1e-5 x max|g| everywhere. bfloat16: each entry
    # within one bf16 spacing of the plain entry (both round the same
    # float32 value, which may land on either side of a rounding point)
    # plus 1e-6 x max|g| (the float32 cancellation in a*w + b*h + c*d + r,
    # times p <= 1), so a fault in the small entries cannot hide under the
    # largest one's rounding.
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = vol.to(dtype)
        got = ksa.softmax_integral_bwd(x, stats, grad)
        want = ksa.softmax_integral_bwd_plain(x, stats, grad)
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        big = want.abs().max().item()
        if dtype == torch.float32:
            ratio = err / (1e-5 * gmax)
            rule = "1e-5 x max|g|"
        else:
            ratio = (diff / (bf16_spacing(want) + 1e-6 * gmax)).max().item()
            rule = "one bf16 spacing of the entry + 1e-6 x max|g|"
        log(f"[{path}] backward kernel vs plain, {str(dtype)[6:]}: max "
            f"|d dlogits| {err:.3g} = {err / gmax:.3g} x max|g|; worst "
            f"entry at {ratio:.3g} of its limit ({rule}); max |dlogits| "
            f"{big:.3g}, max |g| {gmax:.3g}")
        check(big >= 1e-2 * gmax, "backward test gradients are all tiny")
        check(ratio <= 1.0, f"backward kernel disagrees ({dtype})")
        errs[dtype] = (err, ratio)
        del x, got, want, diff

    elems = vol.numel()
    rows = n * j
    fwd_ms = time_ms(lambda: ksa.softmax_integral_fwd(vol, j, d), dev)
    fwd_plain_ms = time_ms(
        lambda: ksa.softmax_integral_stats_plain(vol, j, d), dev)
    # per element: one subtract-and-scale, one exp, three accumulations
    fb_ms, fb_by = bound(elems * 2 + rows * 7 * 4, 5.0 * elems, F32_FLOPS)
    res["softargmax_fwd_stats" + suffix] = dict(
        max_abs_err=fwd_err, ms=fwd_ms, plain_ms=fwd_plain_ms,
        bound_ms=fb_ms, bound_by=fb_by, library_ms=None)
    bwd_ms = time_ms(lambda: ksa.softmax_integral_bwd(vol, stats, grad),
                     dev)
    bwd_plain_ms = time_ms(
        lambda: ksa.softmax_integral_bwd_plain(vol, stats, grad), dev)
    # per element: one exp, two multiply-adds for the coefficient, one
    # multiply; reads the logits, writes dlogits
    bb_ms, bb_by = bound(elems * 2 * 2 + rows * 7 * 4, 6.0 * elems,
                         F32_FLOPS)
    res["softargmax_bwd" + suffix] = dict(
        max_abs_err=errs[torch.bfloat16][0],
        max_abs_err_f32=errs[torch.float32][0],
        worst_share_of_limit_bf16=errs[torch.bfloat16][1],
        ms=bwd_ms, plain_ms=bwd_plain_ms, bound_ms=bb_ms, bound_by=bb_by,
        library_ms=None)
    log(f"[{path}] soft-argmax at {(n, j * d, h, w)} bf16: forward with "
        f"statistics {fwd_ms:.4f} ms (plain {fwd_plain_ms:.4f} ms, bound "
        f"{fb_ms:.4f} ms, {fb_by}); backward {bwd_ms:.4f} ms (plain "
        f"{bwd_plain_ms:.4f} ms, bound {bb_ms:.4f} ms, {bb_by})")


def train_eval_train(cfg, batch, device="cuda") -> dict:
    """Train step, eval step, train step on one model of ``cfg`` (random
    weights, head re-drawn so that the joints decode apart): the eval
    preds match a fresh eval-mode copy of the weights, the eval moves no
    buffer, and the next train step runs. Returns what it measured."""
    from epipolarpose_tpu_torch.core import (create_train_state,
                                             make_train_step)
    from epipolarpose_tpu_torch.core.steps import make_eval_step
    from epipolarpose_tpu_torch.models import get_model
    model = get_model(cfg, True, torch.Generator().manual_seed(13))
    model.to(device)
    redraw_head(model, seed=11)
    # both steps built first, as a train-then-validate loop builds them
    state = create_train_state(cfg, model, steps_per_epoch=1000,
                               device=device)
    step = make_train_step(cfg, model, device=device)
    eval_step = make_eval_step(cfg, model, H36M_FLIP_PAIRS, device)
    step(state, batch)
    joints, size = int(cfg.MODEL.NUM_JOINTS), int(cfg.MODEL.IMAGE_SIZE[0])
    data = SmokeH36M(1, int(batch["input"].shape[0]), size, joints, seed=12,
                     device=device)
    fresh = copy.deepcopy(model).eval()
    before = {n: b.clone() for n, b in model.named_buffers()}
    got = eval_step(data.batches[0])["preds"]
    want = make_eval_step(cfg, fresh, H36M_FLIP_PAIRS, device)(
        data.batches[0])["preds"]
    moved = [n for n, b in model.named_buffers()
             if b.is_inference() or not torch.equal(b, before[n])]
    spread = (want.amax(1) - want.amin(1)).mean(0).tolist()
    dxy = (got[..., :2] - want[..., :2]).abs().max().item()
    dz = (got[..., 2] - want[..., 2]).abs().max().item()
    _, metrics = step(state, batch)
    loss = metrics["loss"].item()
    need_px = size / 64               # 4 px on a 256 crop
    log(f"[train] train -> eval -> train on one model: eval preds vs a "
        f"fresh eval-mode copy max |dxy| {dxy:.3g} px (limit 0.05), max "
        f"|dz| {dz:.3g} mm (limit 0.5), joints spread {spread[0]:.1f} px, "
        f"{spread[1]:.1f} px, {spread[2]:.1f} mm (need {need_px:g} px, "
        f"{need_px:g} px, 10 mm); buffers moved by the eval: {len(moved)}; "
        f"next train step loss {loss:.4f}")
    check(min(spread[:2]) >= need_px and spread[2] >= 10,
          "joints do not spread; the eval comparison would test nothing")
    check(not moved, f"the eval step moved buffers: {moved[:3]}")
    check(dxy <= 0.05 and dz <= 0.5, "eval after train differs from a "
          "fresh eval-mode model")
    check(math.isfinite(loss), "the train step after the eval failed")
    return dict(dxy=dxy, dz=dz, spread=spread, moved=moved, loss=loss,
                steps=state.step)


def phase_train(res: dict) -> None:
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.core import (create_train_state,
                                             make_train_step, train)
    from epipolarpose_tpu_torch.core.steps import configure_backends
    from epipolarpose_tpu_torch.kernels import softargmax as ksa
    from epipolarpose_tpu_torch.kernels.matmul_stats import matmul_stats
    from epipolarpose_tpu_torch.models import get_model
    from epipolarpose_tpu_torch.tools.profile_step import seeded_train_batch

    cfg = load_config(ROOT / "experiments/h36m/train_fs_r50_256_integral.yaml")
    check(cfg.TRAIN.BATCH_SIZE == TRAIN_BATCH
          and cfg.MODEL.EXTRA.DEPTH_DIM == 64
          and cfg.TPU.COMPUTE_DTYPE == "bfloat16"
          and cfg.TRAIN.OPTIMIZER == "adam", "unexpected flagship config")
    joints, depth = int(cfg.MODEL.NUM_JOINTS), int(cfg.MODEL.EXTRA.DEPTH_DIM)
    size = int(cfg.MODEL.IMAGE_SIZE[0])
    hm = int(cfg.MODEL.EXTRA.HEATMAP_SIZE[0])
    bound_mm = float(cfg.MODEL.EXTRA.DEPTH_BOUND)
    configure_backends(cfg)
    model = get_model(cfg, True, torch.Generator().manual_seed(6))
    # steps_per_epoch puts the schedule's first boundary (LR_STEP[0] x it)
    # far beyond this run: the rate stays LR
    state = create_train_state(cfg, model, steps_per_epoch=1000,
                               device="cuda")
    step = make_train_step(cfg, model, device="cuda")
    g = torch.Generator("cuda").manual_seed(7)
    batch = seeded_train_batch(TRAIN_BATCH, size, joints, bound_mm, g,
                               "cuda")
    losses = []

    def recording(st, b):
        st, metrics = step(st, b)
        losses.append(metrics["loss"])
        return st, metrics

    for _ in range(TRAIN_WARMUP):  # cuDNN picks its algorithms
        recording(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rates = []
    for epoch in range(TRAIN_WINDOWS):
        t0 = time.perf_counter()
        state, _ = train(cfg, [batch] * TRAIN_STEPS, state, recording, epoch)
        torch.cuda.synchronize()
        rates.append(TRAIN_BATCH * TRAIN_STEPS / (time.perf_counter() - t0))
    res["paths"]["train"] = launch_counts()
    fwd, bwd = ksa.softmax_integral.launches, ksa.softmax_integral_bwd.launches
    steps = TRAIN_STEPS * TRAIN_WINDOWS
    check(matmul_stats.launches == 0, "train path launched matmul_stats")
    check(fwd == steps and bwd == steps,
          f"soft-argmax kernels launched {fwd} (forward) and {bwd} "
          f"(backward) times in {steps} steps")
    curve = torch.stack(losses).tolist()
    check(all(math.isfinite(v) for v in curve), f"losses {curve}")
    check(curve[-1] < curve[0],
          f"loss did not fall on a repeated batch: {curve}")
    check(state.step == steps + TRAIN_WARMUP
          and state.optimizer.param_groups[0]["lr"] == float(cfg.TRAIN.LR),
          "step count or rate off")
    res["train_launches"] = (fwd, bwd)
    res["train_samples_per_s"] = sorted(rates)[len(rates) // 2]
    res["train_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[train] ResNet-50@256 J=17 D=64 bf16 Adam, batch {TRAIN_BATCH}: "
        f"{TRAIN_WINDOWS} x {TRAIN_STEPS} steps via train, samples/s per "
        f"window " + ", ".join(f"{r:.1f}" for r in rates)
        + f" (median {res['train_samples_per_s']:.1f}, spread "
        f"{(max(rates) - min(rates)) / res['train_samples_per_s']:.2%}); "
        f"peak memory {res['train_peak_gb']:.2f} GB; launches forward "
        f"{fwd}, backward {bwd}; losses ({TRAIN_WARMUP} warm-up steps "
        f"first) " + ", ".join(f"{v:.4f}" for v in curve[:6]) + " ... "
        + ", ".join(f"{v:.4f}" for v in curve[-3:]))

    train_eval_train(cfg, batch)
    train_kernels_vs_plain(res, TRAIN_BATCH, joints, depth, hm, hm)

    # one step through the kernels against the same step through the plain
    # decode, from identical state (head re-drawn so the joints spread)
    redraw_head(model, seed=10)
    twin = copy.deepcopy(model)
    b2 = seeded_train_batch(TRAIN_BATCH, size, joints, bound_mm, g, "cuda")
    out = {}
    for name, m, decode in (("kernel", model, ksa.softmax_integral),
                            ("plain", twin, ksa.softmax_integral_plain)):
        st = create_train_state(cfg, m, steps_per_epoch=1000, device="cuda")
        _, metrics = make_train_step(cfg, m, "cuda", decode)(st, b2)
        out[name] = (metrics["loss"].item(),
                     m.final_layer.weight.grad.detach().clone())
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    dgrad = (gk - gp).abs().max().item()
    gmax = gp.abs().max().item()
    # the decodes agree to 1e-4 per coordinate; the loss sums 3*J of them
    # per sample; dlogits round to bf16 on both routes
    loss_limit = 3 * joints * 1e-4
    log(f"[train] one step, kernels vs plain decode: loss {lk:.6f} vs "
        f"{lp:.6f} (|d| {abs(lk - lp):.3g}, limit {loss_limit:.3g}); "
        f"final_layer.weight grad max |d| {dgrad:.3g} = "
        f"{dgrad / max(gmax, 1e-30):.3g} x max|grad| (limit 2^-7)")
    check(math.isfinite(lk) and abs(lk - lp) <= loss_limit,
          "train step loss: kernels and plain decode disagree")
    check(gmax > 0 and dgrad <= 2 ** -7 * gmax,
          "final_layer gradient: kernels and plain decode disagree")


def ss_rig_batch(cfg, groups: int, views: int, seed: int, device="cuda",
                 distortion: bool = True):
    """A multi-view batch built on ``device`` from the port's synthetic
    rig (H36M-like, 1000 px images, with distortion unless
    ``distortion`` is False) and skeleton poses: centres and scales from
    the projected joints, seeded uint8 crops, and a dual crop from a
    seeded scale, rotation and flip. Returns (batch, world poses
    (G, J, 3), projected joints (G, V, J, 2))."""
    from epipolarpose_tpu_torch.data.synthetic import (make_rig,
                                                      synth_skeleton_poses)
    from epipolarpose_tpu_torch.geometry.affine import get_affine_transform
    from epipolarpose_tpu_torch.geometry.camera import (Camera,
                                                        project_point_radial)
    import numpy as np
    dev = torch.device(device)
    size = int(cfg.MODEL.IMAGE_SIZE[0])
    joints = int(cfg.MODEL.NUM_JOINTS)
    rng = np.random.default_rng(seed)
    poses = synth_skeleton_poses(rng, groups, joints) + rng.uniform(
        [-150, -150, 600], [150, 150, 1000], (groups, 1, 3))
    world = torch.tensor(poses, dtype=torch.float32, device=dev)
    cams = Camera.stack(make_rig(views, seed=seed)).to(dev)
    if not distortion:
        cams = cams.replace(k=torch.zeros_like(cams.k),
                            p=torch.zeros_like(cams.p))
    cams = cams.map(lambda t: t[None].expand((groups,) + t.shape)
                    .contiguous())
    px, _ = project_point_radial(world[:, None], cams)       # (G, V, J, 2)
    center = px.mean(dim=2)
    extent = (px - center[:, :, None]).abs().amax(dim=(2, 3)) * 2.4 + 40
    scale = (extent / 200)[..., None].expand(groups, views, 2).contiguous()
    g = torch.Generator(dev).manual_seed(seed)

    def crops():
        return torch.randint(0, 256, (groups, views, size, size, 3),
                             generator=g, device=dev, dtype=torch.uint8)

    sf, rf = float(cfg.DATASET.SCALE_FACTOR), float(cfg.DATASET.ROT_FACTOR)
    s_mult = 1 + sf * (2 * torch.rand((groups, views), generator=g,
                                      device=dev) - 1)
    rot = rf * (2 * torch.rand((groups, views), generator=g, device=dev) - 1)
    flip = (torch.rand((groups, views), generator=g, device=dev)
            < 0.5).float()
    m = get_affine_transform(center, scale * s_mult[..., None], rot,
                             (size, size))
    # fold the crop-space flip x' = (W - 1) - x into the affine
    m_flip = m.clone()
    m_flip[..., 0, :] = -m[..., 0, :]
    m_flip[..., 0, 2] += size - 1.0
    aug_m = torch.where(flip[..., None, None] > 0.5, m_flip, m)
    batch = {"input": crops(), "center": center, "scale": scale,
             "camera": cams, "joints_vis": torch.ones((groups, views, joints),
                                                      device=dev),
             "input_aug": crops(), "aug_M": aug_m, "aug_flip": flip}
    return batch, world, px


def tri_flops(views: int) -> int:
    """f32 operations per point of the reference algorithm (the plain
    version's arithmetic), the bound's work: rows, norms and weights 50V,
    AᵀA 64V, residual 16V; two adjugates of 16 3x3 minors (14 each) 448;
    column norms, argmax, normalize, the Rayleigh step, sign and
    dehomogenize about 140."""
    return 130 * views + 590


# matrices per torch.linalg.eigh call: on the card one call on 69,632
# batched 4x4 float64 matrices fails (CUSOLVER_STATUS_INVALID_VALUE)
EIGH_CHUNK = 16384


def eigh_chunked(m: torch.Tensor):
    """``torch.linalg.eigh`` of (..., 4, 4) matrices, in chunks."""
    parts = [torch.linalg.eigh(c)
             for c in m.reshape(-1, *m.shape[-2:]).split(EIGH_CHUNK)]
    return (torch.cat([p[0] for p in parts]).reshape(m.shape[:-1]),
            torch.cat([p[1] for p in parts]).reshape(m.shape))


def triangulate_in_chunks(pts, P, w, method: str):
    """X of ``triangulate(..., method)``, over frames in chunks of at most
    ``EIGH_CHUNK`` points."""
    from epipolarpose_tpu_torch.geometry import triangulation as ttri
    step = max(EIGH_CHUNK // pts.shape[2], 1)
    return torch.cat([ttri.triangulate(
        pts[i:i + step], P if P.ndim == 3 else P[i:i + step],
        None if w is None else w[i:i + step], method=method)[0]
        for i in range(0, pts.shape[0], step)])


def tri_check(res: dict, key: str, pts, P, w, tag: str = "ss",
              mm_per_unit: float = 1.0) -> None:
    """``epk_triangulate`` against its plain version and float64 ``svd``
    and ``eigh`` oracles, twice (TF32 allowed, then not: the same bits),
    then timed beside the plain version and ``torch.linalg.eigh`` on the
    same AᵀA (a yardstick: no one PyTorch call computes the function).
    ``mm_per_unit``: millimetres in one unit of X (1 for pixel systems in
    mm; a rig's baseline length for its unit-baseline systems): every
    distance is reported and bounded in mm."""
    from epipolarpose_tpu_torch.geometry import triangulation as ttri
    from epipolarpose_tpu_torch.kernels import triangulate as ktri
    from epipolarpose_tpu_torch.tools.profile_step import (card_time_ms,
                                                           time_ms)
    dev = pts.device
    n, v, j, _ = pts.shape
    check(bool(torch.isfinite(pts).all()), "triangulation input not finite")
    outs = []
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            torch.backends.cudnn.allow_tf32 = flag
            outs.append(ktri.triangulate_fast(pts, P, w))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    x, r = outs[1]
    xp, rp = ktri.triangulate_fast_plain(pts, P, w)
    w64 = None if w is None else w.double()
    sub = slice(0, min(n, 4096))       # the float64 SVD on a slice
    refs = {"fast64": (slice(None), ttri.triangulate(
        pts.double(), P.double(), w64, method="fast")[0]),
        "eigh64": (slice(None), triangulate_in_chunks(
            pts.double(), P.double(), w64, "eigh")),
        "svd64": (sub, ttri.triangulate(
            pts[sub].double(), P.double() if P.ndim == 3 else
            P[sub].double(), None if w is None else w64[sub],
            method="svd")[0])}
    gaps = {name: ((x[rows].double() - o).norm(dim=-1).max().item()
                   * mm_per_unit,
                   (xp[rows].double() - o).norm(dim=-1).max().item()
                   * mm_per_unit)
            for name, (rows, o) in refs.items()}
    # the spread of the distances to the float64 run: 99th percentile and
    # share of points beyond 1 mm, kernel and plain
    spread = {}
    for name, t in (("kernel", x), ("plain", xp)):
        d = (t.double() - refs["fast64"][1]).norm(dim=-1).flatten().float()
        d = d * mm_per_unit
        spread[name] = (d.quantile(0.99).item(),
                        (d > 1.0).float().mean().item())
    torch.cuda.synchronize()
    dx = (x - xp).abs().max().item()
    dr = (r - rp).abs().max().item()
    # The plain version rounds in float32 throughout; AᵀA in mm spans many
    # decades, so its adjugate amplifies that rounding where views
    # disagree (the kernel sums AᵀA and takes the Rayleigh step in
    # float64). The kernel must stay as close to the same solver in
    # float64 as twice the plain version does, plus 0.05 mm.
    allowance = 2 * gaps["fast64"][1] + 0.05
    log(f"[{tag}] triangulation {key}: {n} x {j} points, V {v}, P "
        f"{'per frame' if P.ndim == 4 else 'shared'}, weights "
        f"{'yes' if w is not None else 'no'}: max |dX| kernel vs plain "
        f"{dx * mm_per_unit:.3g} mm, |d residual| {dr:.3g} (limit 1e-4); "
        f"max distance "
        + ", ".join(f"to {name} {k:.3g} mm (plain {p:.3g})"
                    for name, (k, p) in gaps.items())
        + f"; limits: fast64 {allowance:.3g} mm, the oracles the plain's "
        f"+ {allowance:.3g}; to fast64 99th percentile kernel "
        f"{spread['kernel'][0]:.3g} mm, plain {spread['plain'][0]:.3g} mm "
        f"(limit twice the plain's + 0.05), beyond 1 mm kernel "
        f"{spread['kernel'][1]:.3g}, plain {spread['plain'][1]:.3g} of the "
        f"points; same bits with TF32 allowed and not: {same}")
    check(bool(torch.isfinite(x).all() and torch.isfinite(r).all()),
          "triangulation not finite")
    check(same, "the TF32 flags changed the triangulation")
    check(dr <= 1e-4, "triangulation residual: kernel and plain disagree")
    check(gaps["fast64"][0] <= allowance
          and spread["kernel"][0] <= 2 * spread["plain"][0] + 0.05,
          "triangulation kernel rounds further from float64 than the plain "
          "version")
    check(all(k <= p + allowance for name, (k, p) in gaps.items()
              if name != "fast64"),
          "triangulation kernel further from the float64 oracles than the "
          "plain version")
    ms = time_ms(lambda: ktri.triangulate_fast(pts, P, w), dev, iters=20)
    dev_ms = card_time_ms(lambda: ktri.triangulate_fast(pts, P, w), iters=20)
    # the launch floor: the card time of a one-element elementwise launch
    one = torch.zeros(1, device=dev)
    floor_ms = card_time_ms(lambda: one.add_(1.0), iters=20)
    layout = ktri.route(n * j)
    usage = tri_resources(res["ptxas"], v, layout, P.ndim == 4)
    plain_ms = time_ms(lambda: ktri.triangulate_fast_plain(pts, P, w), dev,
                       iters=5)
    ata = ttri.normal_matrix(ttri.build_dlt_system(
        pts.transpose(1, 2), P[None, None] if P.ndim == 3 else P[:, None],
        None if w is None else w.transpose(1, 2)))
    eigh_ms = time_ms(lambda: eigh_chunked(ata), dev, iters=5)
    points = n * j
    p_bytes = P.numel() * 4
    n_bytes = (pts.numel() + (w.numel() if w is not None else 0)) * 4 \
        + p_bytes + points * 4 * 4
    b_ms, b_by = bound(n_bytes, tri_flops(v) * points, F32_FLOPS)
    res[key] = dict(points=points, views=v, mm_per_unit=mm_per_unit,
                    max_abs_err=dx,
                    residual_max_abs_err=dr, gap_mm=gaps,
                    allowance_mm=allowance, p99_and_share_over_1mm=spread,
                    tf32_same_bits=same, ms=ms, device_ms=dev_ms,
                    plain_ms=plain_ms, eigh_ms=eigh_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None, floor_ms=floor_ms,
                    layout=layout, **usage)
    log(f"[{tag}] triangulation {key}: kernel {ms:.4g} ms (card alone "
        f"{dev_ms:.4g}; launch floor {floor_ms:.4g}), plain {plain_ms:.4g} "
        f"ms, torch.linalg.eigh on AᵀA {eigh_ms:.4g} ms (in chunks of "
        f"{EIGH_CHUNK}), bound {b_ms:.4g} ms ({b_by}); layout {layout}, "
        f"{usage['registers']} registers a thread, spills "
        f"{usage['spill_stores']} / {usage['spill_loads']} bytes")


def tri_resources(ptxas: dict, views: int, layout: str,
                  per_frame: bool) -> dict:
    """Registers a thread and spill bytes of the triangulation kernel's
    instance for ``views`` views in ``layout``, with P per frame or
    shared, from the build's report."""
    lanes = 4 if layout == "split" else 1
    tag = f"triangulate_kernelILi{views}ELi{lanes}ELb{int(per_frame)}E"
    found = [u for name, u in ptxas.items() if tag in name]
    check(len(found) == 1, f"ptxas report: {len(found)} kernels {tag}")
    return found[0]


def noisy_detections(px, seed: int, corrupt: bool = True):
    """Detections 2 px off with weights in [0.5, 1]; with ``corrupt``, view
    0 moved by 60 px and weighted 1e-3."""
    g = torch.Generator(px.device).manual_seed(seed)
    det = px + 2.0 * torch.randn(px.shape, generator=g, device=px.device)
    conf = 0.5 + 0.5 * torch.rand(px.shape[:-1], generator=g,
                                  device=px.device)
    if corrupt:
        det[:, 0] += 60.0
        conf[:, 0] = 1e-3
    return det, conf


def phase_ss(res: dict) -> None:
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.core import create_train_state
    from epipolarpose_tpu_torch.core import self_supervised as tss
    from epipolarpose_tpu_torch.core.steps import configure_backends
    from epipolarpose_tpu_torch.geometry.camera import (Camera,
                                                        undistort_points)
    from epipolarpose_tpu_torch.kernels import softargmax as ksa
    from epipolarpose_tpu_torch.kernels import triangulate as ktri
    from epipolarpose_tpu_torch.models import get_model
    from epipolarpose_tpu_torch.data.synthetic import (make_rig,
                                                      synth_skeleton_poses)
    from epipolarpose_tpu_torch.geometry.camera import project_point_radial
    import numpy as np

    cfg = load_config(ROOT / "experiments/h36m/train_ss_r50_256_integral.yaml")
    G, V = int(cfg.TRAIN.BATCH_SIZE), int(cfg.DATASET.NUM_VIEWS)
    check((G, V) == (SS_GROUPS, SS_VIEWS)
          and cfg.MODEL.EXTRA.DEPTH_DIM == 64
          and cfg.MODEL.EXTRA.NUM_LAYERS == 50
          and cfg.TPU.COMPUTE_DTYPE == "bfloat16"
          and cfg.TRAIN.OPTIMIZER == "adam"
          and cfg.TPU.TRIANGULATION.METHOD == "fast"
          and cfg.TPU.TRIANGULATION.CONF_WEIGHT, "unexpected SS config")
    joints, depth = int(cfg.MODEL.NUM_JOINTS), int(cfg.MODEL.EXTRA.DEPTH_DIM)
    hm = int(cfg.MODEL.EXTRA.HEATMAP_SIZE[0])
    configure_backends(cfg)
    dev = torch.device("cuda")
    batch, world, px = ss_rig_batch(cfg, G, V, seed=21)
    cam = batch["camera"]

    # 1. the kernel at the SS step's 544 points (per-frame P, noisy and
    # one corrupted view) and at about 10^6 points (one rig)
    det, conf = noisy_detections(px, seed=22)
    und = undistort_points(det, cam).contiguous()
    tri_check(res, "triangulate", und, cam.P.contiguous(), conf)
    rng = np.random.default_rng(23)
    big = synth_skeleton_poses(rng, TRI_FRAMES, joints) + 800.0
    rig = Camera.stack([Camera.stack(make_rig(V, seed=23))]).to(dev)
    bpx, _ = project_point_radial(
        torch.tensor(big, dtype=torch.float32, device=dev)[:, None], rig)
    bdet, bconf = noisy_detections(bpx, seed=24)
    bund = undistort_points(bdet, rig).contiguous()
    tri_check(res, "triangulate_1m", bund, rig.P[0].contiguous(), bconf)
    del big, bpx, bdet, bconf, bund

    # 2. the soft-argmax kernels at the student's shape, N = G*V = 128
    train_kernels_vs_plain(res, G * V, joints, depth, hm, hm, path="ss")

    # 3. the perfect teacher: detections are the projected joints
    x_w, tri_res = tss.generate_pseudo_gt(cfg, px, torch.ones(
        px.shape[:-1], device=dev), cam)
    pgt_err = (x_w - world).norm(dim=-1).max().item()
    log(f"[ss] perfect-teacher pseudo-GT: max |X - world| {pgt_err:.3g} mm "
        f"(limit 1), max residual {tri_res.max().item():.3g}")
    check(pgt_err < 1.0, "perfect-teacher pseudo-GT off by 1 mm or more")
    model = get_model(cfg, True, torch.Generator().manual_seed(25))
    state = create_train_state(cfg, model, steps_per_epoch=1000, device=dev)
    step = tss.make_ss_train_step(
        cfg, model, None, device=dev,
        detect_fn=tss.make_gt_teacher(px.reshape(G * V, joints, 2)),
        flip_pairs=H36M_FLIP_PAIRS)
    losses, resid = [], []

    def run(n):
        nonlocal state
        for _ in range(n):
            state, m = step(state, batch)
            losses.append(m["loss"])
            resid.append(m["tri_residual"])

    run(SS_WARMUP)                 # cuDNN picks its algorithms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rates, step_ms = [], []
    for _ in range(SS_WINDOWS):
        t0 = time.perf_counter()
        run(SS_STEPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates.append(G * V * SS_STEPS / dt)
        step_ms.append(dt * 1e3 / SS_STEPS)
    counts = launch_counts()
    res["paths"]["ss"] = counts
    steps = SS_WINDOWS * SS_STEPS
    curve = torch.stack(losses).tolist()
    max_res = torch.stack(resid).max().item()
    res["ss_samples_per_s"] = rates
    res["ss_step_ms"] = step_ms
    res["ss_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[ss] perfect teacher, G {G} x V {V} = {G * V} crops, ResNet-50@256 "
        f"J=17 D=64 bf16 Adam: {SS_WINDOWS} windows of {SS_STEPS} steps: "
        + ", ".join(f"{r:.1f} samples/s ({t:.2f} ms a step)"
                    for r, t in zip(rates, step_ms))
        + f"; peak memory {res['ss_peak_gb']:.2f} GB; launches {counts}; "
        f"max tri_residual {max_res:.3g} (limit 1e-3); losses "
        f"({SS_WARMUP} warm-up first) " + ", ".join(
            f"{v:.4f}" for v in curve[:4]) + " ... " + ", ".join(
            f"{v:.4f}" for v in curve[-3:]))
    check(all(math.isfinite(v) for v in curve), f"losses {curve}")
    check(curve[-1] < curve[0], "SS loss did not fall on a repeated batch")
    check(max_res < 1e-3, "perfect-teacher residual 1e-3 or more")
    check(counts["triangulate"] == counts["softargmax_fwd"]
          == counts["softargmax_bwd"] == steps,
          f"kernels launched {counts} times in {steps} steps, expected one "
          f"launch of each a step")
    check(counts["triangulate_split"] == steps,
          f"the SS step's {G * joints} points took the thread layout")
    check(counts["matmul_stats"] == 0 and counts["teacher_decode"] == 0,
          f"SS path with the perfect teacher launched {counts}")

    # 4. the random bf16 ResNet-50 teacher, from a generator
    teacher = tss.load_teacher(cfg, dev, torch.Generator().manual_seed(26))
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    tstep = tss.make_ss_train_step(cfg, model, teacher, device=dev,
                                   flip_pairs=H36M_FLIP_PAIRS)
    reset_counts()
    confs = [tstep(state, batch)[1]["teacher_conf"]]    # cuDNN warms up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    confs += [tstep(state, batch)[1]["teacher_conf"] for _ in range(2)]
    torch.cuda.synchronize()
    res["ss_teacher_step_ms"] = (time.perf_counter() - t0) * 1e3 / 2
    counts = launch_counts()
    confs = torch.stack(confs).tolist()
    moved = [k for k, v in teacher.state_dict().items()
             if not torch.equal(v, before[k])]
    log(f"[ss] random bf16 ResNet-50 teacher, 3 steps: teacher_conf "
        + ", ".join(f"{c:.4g}" for c in confs) + f"; steps 2-3 "
        f"{res['ss_teacher_step_ms']:.2f} ms a step ("
        f"{G * V * 1e3 / res['ss_teacher_step_ms']:.1f} samples/s); teacher "
        f"tensors changed: {len(moved)}; launches {counts}")
    check(all(math.isfinite(c) for c in confs), "teacher_conf not finite")
    check(not moved, f"the teacher changed: {moved[:3]}")
    check(counts["teacher_decode"] == 3 and counts["triangulate"] == 3
          and counts["softargmax_fwd"] == counts["softargmax_bwd"] == 3,
          f"teacher route: {counts} in 3 steps")

    # 5. one step through the kernels against the same step through the
    # plain versions, from one state (head re-drawn so the joints spread)
    redraw_head(model, seed=27)
    twin = copy.deepcopy(model)
    det, conf = noisy_detections(px, seed=28, corrupt=False)
    det_fn = tss.make_gt_teacher(det.reshape(G * V, joints, 2),
                                 conf.reshape(G * V, joints))
    out = {}
    for name, m, decode, solve in (
            ("kernel", model, ksa.softmax_integral, None),
            ("plain", twin, ksa.softmax_integral_plain,
             ktri.triangulate_fast_plain)):
        st = create_train_state(cfg, m, steps_per_epoch=1000, device=dev)
        _, metrics = tss.make_ss_train_step(
            cfg, m, None, device=dev, detect_fn=det_fn,
            flip_pairs=H36M_FLIP_PAIRS, decode=decode, solve=solve)(st, batch)
        out[name] = (metrics["loss"].item(), metrics["tri_residual"].item(),
                     m.final_layer.weight.grad.detach().clone())
    (lk, rk, gk), (lp, rp, gp) = out["kernel"], out["plain"]
    dgrad = (gk - gp).abs().max().item()
    gmax = gp.abs().max().item()
    loss_limit = 3 * joints * 1e-4
    log(f"[ss] one step, kernels vs plain (triangulation, decode): loss "
        f"{lk:.6f} vs {lp:.6f} (|d| {abs(lk - lp):.3g}, limit "
        f"{loss_limit:.3g}); tri_residual {rk:.4g} vs {rp:.4g}; "
        f"final_layer.weight grad max |d| {dgrad:.3g} = "
        f"{dgrad / max(gmax, 1e-30):.3g} x max|grad| (limit 2^-7)")
    check(math.isfinite(lk) and lk > 0 and abs(lk - lp) <= loss_limit,
          "SS step loss: kernels and plain versions disagree")
    check(abs(rk - rp) <= 1e-4, "SS step residual: kernel and plain differ")
    check(gmax > 0 and dgrad <= 2 ** -7 * gmax,
          "SS step final_layer gradient: kernels and plain disagree")


def count_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: returns
    (its result, the synchronizing calls it made, by source line). Only
    calls that go through PyTorch's own copy and synchronize wrappers are
    seen (a ``.item()``, cuSOLVER's status read after ``eigh``/``svd``)."""
    import collections
    import warnings
    old = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(old)
    where = collections.Counter(
        f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchronizing" in str(w.message))
    return out, sum(where.values()), dict(where)


def rotation_error_deg(r: torch.Tensor, r_gt: torch.Tensor) -> float:
    """Angle of ``r @ r_gtᵀ`` in degrees (float64)."""
    m = (r.double()[:, None, :] * r_gt.double()[None, :, :]).sum(-1)
    cos = ((m.trace() - 1) / 2).clamp(-1.0, 1.0).item()
    return math.degrees(math.acos(cos))


def catch_targets(run) -> dict:
    """``run()`` with the SS step's student update wrapped: the first
    update's targets and weights, and ``run()``'s result."""
    from epipolarpose_tpu_torch.core import self_supervised as tss
    caught, update = {}, tss.integral_update

    def catch(state, model, x, target, tw, *args):
        caught.setdefault("target", target.clone())
        caught.setdefault("tw", tw.clone())
        return update(state, model, x, target, tw, *args)
    tss.integral_update = catch
    try:
        caught["out"] = run()
    finally:
        tss.integral_update = update
    return caught


def phase_ss_nocam(res: dict) -> None:
    """Calibration-free SS (``TPU.SS_CAMERAS: estimated``) at the
    flagship width: the rig from the detections, its kernel launches at
    their shapes, the timed step and its host synchronisations."""
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.core import create_train_state
    from epipolarpose_tpu_torch.core import self_supervised as tss
    from epipolarpose_tpu_torch.core.steps import configure_backends
    from epipolarpose_tpu_torch.geometry.camera import world_to_camera_frame
    from epipolarpose_tpu_torch.geometry.rig import pseudo_gt_uncalibrated
    from epipolarpose_tpu_torch.kernels import triangulate as ktri
    from epipolarpose_tpu_torch.models import get_model

    cfg = load_config(ROOT / "experiments/h36m/"
                      "train_ss_nocam_r50_256_integral.yaml")
    G, V = int(cfg.TRAIN.BATCH_SIZE), int(cfg.DATASET.NUM_VIEWS)
    check((G, V) == (SS_GROUPS, SS_VIEWS)
          and cfg.TPU.SS_CAMERAS == "estimated"
          and float(cfg.TPU.SS_BONE_LENGTH_MM) == 0.0
          and cfg.MODEL.EXTRA.DEPTH_DIM == 64
          and cfg.MODEL.EXTRA.NUM_LAYERS == 50
          and cfg.TPU.COMPUTE_DTYPE == "bfloat16",
          "unexpected calibration-free SS config")
    joints = int(cfg.MODEL.NUM_JOINTS)
    configure_backends(cfg)
    dev = torch.device("cuda")
    batch, world, px = ss_rig_batch(cfg, G, V, seed=71, distortion=False)
    intr = batch["camera"].map(lambda t: t[0])
    ones = torch.ones(px.shape[:-1], device=dev)
    gt = world_to_camera_frame(world, intr.map(lambda t: t[0]))

    # 1. perfect detections: the rig's rotations, the pseudo-GT up to one
    # scale, and in mm through the mean bone
    x, p, _ = pseudo_gt_uncalibrated(px, intr, conf=ones)
    angles = [rotation_error_deg(p[v, :, :3], intr.R[v] @ intr.R[0].T)
              for v in range(1, V)]
    scale = ((x * gt).sum() / (x * x).sum()).item()
    ls_err = (scale * x - gt).norm(dim=-1).max().item()
    bones = tss._h36m_bones(joints)
    a, b = [q[0] for q in bones], [q[1] for q in bones]
    bone_mm = (gt[:, a] - gt[:, b]).norm(dim=-1).mean().item()
    xb, _, _ = pseudo_gt_uncalibrated(px, intr, conf=ones, bone_pairs=bones,
                                      bone_length_mm=bone_mm)
    bone_err = (xb - gt).norm(dim=-1).max().item()
    log(f"[ss_nocam] perfect detections, {G} groups x {V} views x {joints} "
        f"joints: rotation errors " + ", ".join(f"{e:.4f}" for e in angles)
        + f" deg (limit 0.1); pseudo-GT after one least-squares scale "
        f"({scale:.1f} mm a unit baseline) max {ls_err:.4f} mm (limit 1); "
        f"with SS_BONE_LENGTH_MM {bone_mm:.2f} (the poses' mean H36M bone) "
        f"max {bone_err:.4f} mm unscaled (limit 1)")
    check(max(angles) < 0.1, f"rotation errors {angles} deg")
    check(ls_err < 1.0, f"pseudo-GT up to scale {ls_err:.3g} mm off")
    check(bone_err < 1.0, f"bone-scaled pseudo-GT {bone_err:.3g} mm off")

    # 2. the kernel at the rig's shapes, from noisy weighted detections:
    # the V - 1 two-view calls and the V-view call, each held to its plain
    # version and float64 oracles; the TF32 flags change no bit
    det, conf = noisy_detections(px, seed=73, corrupt=False)
    calls = []

    def capture(pts, P, w):
        calls.append((pts, P, w))
        return ktri.triangulate_fast(pts, P, w)
    pseudo_gt_uncalibrated(det, intr, conf=conf, solve=capture)
    shapes = [(tuple(c[0].shape), tuple(c[1].shape), c[2] is not None)
              for c in calls]
    want = [((G * joints, 2, 1, 2), (2, 3, 4), False)] * (V - 1) + [
        ((G, V, joints, 2), (V, 3, 4), True)]
    check(shapes == want, f"the rig's solves took {shapes}, expected {want}")
    tri_check(res, "triangulate_rig_pair", *calls[0], tag="ss_nocam",
              mm_per_unit=scale)
    tri_check(res, "triangulate_rig_views", *calls[-1], tag="ss_nocam",
              mm_per_unit=scale)
    del calls
    old = torch.backends.cuda.matmul.allow_tf32
    outs = []
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            outs.append(pseudo_gt_uncalibrated(det, intr, conf=conf))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    same = all(torch.equal(u, w) for u, w in zip(*outs))
    log(f"[ss_nocam] estimate_rig and the pseudo-GT with TF32 allowed and "
        f"not: same bits {same}")
    check(same, "the TF32 flag changed the estimated rig")

    # 3. one step through the kernels against one through the plain
    # solver, from one state, on the noisy detections: the same targets
    model = get_model(cfg, True, torch.Generator().manual_seed(75))
    twin = copy.deepcopy(model)
    det_fn = tss.make_gt_teacher(det.reshape(G * V, joints, 2),
                                 conf.reshape(G * V, joints))
    got = {}
    for name, m, solve in (("kernel", model, None),
                           ("plain", twin, ktri.triangulate_fast_plain)):
        st = create_train_state(cfg, m, steps_per_epoch=1000, device=dev)
        step = tss.make_ss_train_step(cfg, m, None, device=dev,
                                      detect_fn=det_fn,
                                      flip_pairs=H36M_FLIP_PAIRS, solve=solve)
        got[name] = catch_targets(lambda: step(st, batch)[1])
    target_dt = (got["kernel"]["target"]
                 - got["plain"]["target"]).abs().max().item()
    same_tw = torch.equal(got["kernel"]["tw"], got["plain"]["tw"])
    lk, lp = (got[k]["out"]["loss"].item() for k in ("kernel", "plain"))
    loss_limit = 3 * joints * 1e-4
    log(f"[ss_nocam] one step, kernel vs plain solver (noisy detections): "
        f"targets max |d| {target_dt:.3g} (limit 1e-4), weights equal "
        f"{same_tw}, "
        f"loss {lk:.6f} vs {lp:.6f} (limit {loss_limit:.3g})")
    check(target_dt <= 1e-4 and same_tw,
          "estimated-rig targets: kernel and plain solver disagree")
    check(math.isfinite(lk) and abs(lk - lp) <= loss_limit,
          "estimated-rig loss: kernel and plain solver disagree")
    del twin, got

    # 4. the timed steps with the perfect detections
    model = get_model(cfg, True, torch.Generator().manual_seed(76))
    state = create_train_state(cfg, model, steps_per_epoch=1000, device=dev)
    step = tss.make_ss_train_step(
        cfg, model, None, device=dev,
        detect_fn=tss.make_gt_teacher(px.reshape(G * V, joints, 2)),
        flip_pairs=H36M_FLIP_PAIRS)
    losses = []

    def run(n):
        nonlocal state
        for _ in range(n):
            state, m = step(state, batch)
            losses.append(m["loss"])

    run(SS_WARMUP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rates, step_ms = [], []
    for _ in range(SS_WINDOWS):
        t0 = time.perf_counter()
        run(SS_STEPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates.append(G * V * SS_STEPS / dt)
        step_ms.append(dt * 1e3 / SS_STEPS)
    counts = launch_counts()
    res["paths"]["ss_nocam"] = counts
    steps = SS_WINDOWS * SS_STEPS
    curve = torch.stack(losses).tolist()
    peak = torch.cuda.max_memory_allocated() / 1e9

    # 5. host synchronisations a step: this step, and the calibrated step
    # on the same batch and model
    _, syncs, where = count_syncs(lambda: step(state, batch))
    given = copy.deepcopy(cfg)
    given.TPU.SS_CAMERAS = "given"
    gstep = tss.make_ss_train_step(
        given, model, None, device=dev,
        detect_fn=tss.make_gt_teacher(px.reshape(G * V, joints, 2)),
        flip_pairs=H36M_FLIP_PAIRS)
    _, given_syncs, given_where = count_syncs(lambda: gstep(state, batch))
    res["ss_nocam"] = dict(
        rotation_err_deg=angles, ls_err_mm=ls_err, bone_err_mm=bone_err,
        unit_baseline_mm=scale, step_ms=step_ms, samples_per_s=rates,
        peak_gb=peak, syncs_per_step=syncs, syncs_by_line=where,
        given_syncs_per_step=given_syncs, given_syncs_by_line=given_where,
        target_kernel_vs_plain=target_dt, loss_kernel_vs_plain=(lk, lp),
        losses=curve)
    log(f"[ss_nocam] perfect detections, G {G} x V {V} = {G * V} crops, "
        f"ResNet-50@256 J=17 D=64 bf16 Adam, rig estimated every step: "
        f"{SS_WINDOWS} windows of {SS_STEPS} steps: " + ", ".join(
            f"{r:.1f} samples/s ({t:.2f} ms a step)"
            for r, t in zip(rates, step_ms))
        + f" against the calibrated step's " + ", ".join(
            f"{t:.2f}" for t in res.get("ss_step_ms", []))
        + f" ms (phase ss); peak memory {peak:.2f} GB; host synchronisations"
        f" a step {syncs} ({where}), calibrated step {given_syncs} "
        f"({given_where}); launches {counts}; losses ({SS_WARMUP} warm-up "
        f"first) " + ", ".join(f"{v:.4f}" for v in curve[:4]) + " ... "
        + ", ".join(f"{v:.4f}" for v in curve[-3:]))
    check(all(math.isfinite(v) for v in curve), f"losses {curve}")
    check(curve[-1] < curve[SS_WARMUP],
          "the estimated-rig SS loss did not fall over the timed steps")
    check(counts["triangulate"] == counts["triangulate_split"] == 4 * steps,
          f"{counts} in {steps} steps: expected 4 triangulation launches a "
          f"step, all in the split layout")
    check(counts["softargmax_fwd"] == counts["softargmax_bwd"] == steps
          and counts["matmul_stats"] == 0 and counts["teacher_decode"] == 0,
          f"{counts} in {steps} steps: expected one soft-argmax forward and "
          f"backward a step")


def phase_pose2d(res: dict) -> None:
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.core import (create_train_state,
                                             make_train_step)
    from epipolarpose_tpu_torch.core.steps import (configure_backends,
                                                   make_eval_step)
    from epipolarpose_tpu_torch.models import get_model
    cfg = load_config(ROOT / "experiments/mpii/"
                      "train_r50_256x256_d256x3_adam_lr1e-3.yaml")
    check(cfg.MODEL.EXTRA.TARGET_TYPE == "gaussian"
          and cfg.MODEL.NUM_JOINTS == 16
          and cfg.TRAIN.BATCH_SIZE == POSE2D_BATCH
          and cfg.TEST.FLIP_TEST, "unexpected MPII config")
    configure_backends(cfg)
    dev = torch.device("cuda")
    size = int(cfg.MODEL.IMAGE_SIZE[0])
    joints = int(cfg.MODEL.NUM_JOINTS)
    model = get_model(cfg, True, torch.Generator().manual_seed(31))
    state = create_train_state(cfg, model, steps_per_epoch=1000, device=dev)
    step = make_train_step(cfg, model, device=dev)
    g = torch.Generator(dev).manual_seed(32)
    batch = {"input": torch.randint(0, 256, (POSE2D_BATCH, size, size, 3),
                                    generator=g, device=dev,
                                    dtype=torch.uint8),
             "joints": size * torch.rand((POSE2D_BATCH, joints, 2),
                                         generator=g, device=dev),
             "joints_vis": torch.ones((POSE2D_BATCH, joints), device=dev),
             "center": 200 + 600 * torch.rand((POSE2D_BATCH, 2), generator=g,
                                              device=dev),
             "scale": 0.8 + 0.4 * torch.rand((POSE2D_BATCH, 2), generator=g,
                                             device=dev)}
    mpii_pairs = ((0, 5), (1, 4), (2, 3), (10, 15), (11, 14), (12, 13))
    eval_step = make_eval_step(cfg, model, mpii_pairs, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    metrics = [step(state, batch)[1] for _ in range(POSE2D_STEPS)]
    out = eval_step(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    res["paths"]["pose2d"] = counts
    losses = [m["loss"].item() for m in metrics]
    accs = [m["acc"].item() for m in metrics]
    preds, maxvals = out["preds"], out["maxvals"]
    log(f"[pose2d] MPII ResNet-50@256, 16 joints, 64x64 heatmaps, batch "
        f"{POSE2D_BATCH}: {POSE2D_STEPS} gaussian train steps, losses "
        + ", ".join(f"{v:.6f}" for v in losses) + ", acc "
        + ", ".join(f"{a:.3f}" for a in accs) + f"; flip-test eval preds "
        f"{tuple(preds.shape)}, maxvals {tuple(maxvals.shape)}; "
        f"{wall:.2f} s with the first calls; launches {counts}")
    check(all(math.isfinite(v) for v in losses), "pose2d loss not finite")
    check(all(0.0 <= a <= 1.0 for a in accs), "pose2d acc outside [0, 1]")
    check(tuple(preds.shape) == (POSE2D_BATCH, joints, 2)
          and tuple(maxvals.shape) == (POSE2D_BATCH, joints)
          and bool(torch.isfinite(preds).all())
          and bool(torch.isfinite(maxvals).all()), "pose2d eval output")
    check(state.step == POSE2D_STEPS, "pose2d step count")
    check(not any(counts.values()), f"pose2d path launched {counts}")


def phase_tool(res: dict) -> None:
    from epipolarpose_tpu_torch.kernels.softargmax import (
        softmax_integral, softmax_integral_bwd)
    from epipolarpose_tpu_torch.tools.profile_step import (CONV1X1_SHAPES,
                                                           bench_conv1x1)
    reset_counts()
    rows = bench_conv1x1(iters=5)
    res["paths"]["tool"] = launch_counts()
    launches, wgmma, simt = matmul_routes()
    check(len(rows) == len(CONV1X1_SHAPES), "bench skipped shapes")
    check(launches > 0, "tool path never launched the matmul_stats kernel")
    check(wgmma == launches and simt == 0,
          f"tool path: {wgmma} wgmma and {simt} simt launches of {launches}")
    check(all(r["route"] == "wgmma" for r in rows), "a shape left wgmma")
    check(softmax_integral.launches == softmax_integral_bwd.launches == 0,
          "tool path launched softargmax")
    res["tool_launches"] = (launches, wgmma, simt)
    log(f"[tool] bench_conv1x1: {len(rows)} shapes, matmul_stats "
        f"launches {launches} (wgmma {wgmma}, simt {simt})")


def keep_first(batches, kept: list):
    """Yield ``batches``, keeping the first one in ``kept``."""
    for b in batches:
        if not kept:
            kept.append(b)
        yield b


def stats_shares(stats: dict, wall: float) -> dict:
    """Each loader stage's waits and work as shares of ``wall`` seconds."""
    return {stage: {k: stats[stage][k] / wall for k in
                    ("upstream_wait_s", "transform_s", "queue_full_s")}
            for stage in ("host", "device")}


def format_shares(shares: dict) -> str:
    """The host stage's ``upstream_wait_s`` is the dataset's decode and
    warp; the device stage's ``transform_s`` is the copy to the card."""
    return "shares of the wall time: " + "; ".join(
        f"{stage} " + ", ".join(f"{k} {v[k]:.1%}" for k in
                                ("upstream_wait_s", "transform_s",
                                 "queue_full_s"))
        for stage, v in shares.items())


def loader_route(ds) -> str:
    """Which route decodes ``ds``'s records, and whether the native
    loader is built."""
    from epipolarpose_tpu_torch.data import fastloader
    built = fastloader.available()
    native = "built" if built else f"not built ({fastloader.build_error()})"
    route = ("native decode + warp" if ds._native_eligible([0])
             else "numpy render + warp on the thread pool")
    return f"{route}; native loader {native}"


def assert_same_batch(on_card: dict, on_host: dict) -> None:
    """A loader batch on the card holds the host batch's bits."""
    check(sorted(on_card) == sorted(on_host),
          f"loader batch keys {sorted(on_card)} vs {sorted(on_host)}")
    for k, v in on_host.items():
        got = on_card[k].cpu()
        check(torch.equal(got, torch.from_numpy(v)),
              f"loader batch {k!r} on the card differs from the host's")


def eval_on_data(cfg, model, step, frames: int, seed: int,
                 device="cuda") -> dict:
    """``validate`` over ``epoch_loader`` of a synthetic multiview dataset
    (skeleton poses, cameras, absolute depths) of ``frames`` x 4 records,
    scored by the dataset's H36M ``evaluate``; the first batch on the
    device against ``get_batch`` on the host. Returns what it measured."""
    from epipolarpose_tpu_torch.core.function import validate
    from epipolarpose_tpu_torch.data import epoch_loader, get_dataset
    import numpy as np
    cfg.DATASET.DATASET = "synthetic_multiview"
    ds = get_dataset(cfg, cfg.DATASET.TEST_SET, False, num_frames=frames,
                     pose_mode="skeleton", seed=seed)
    bs = int(cfg.TEST.BATCH_SIZE)
    stats, kept = {}, []
    reset_counts()
    t0 = time.perf_counter()
    name_values, perf = validate(cfg, keep_first(epoch_loader(
        ds, bs, 0, is_train=False, device=device, stats=stats), kept), ds,
        step)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    assert_same_batch(kept[0], ds.get_batch(list(range(bs)), seed=0))
    root_z = np.abs([r.joints_3d[0, 2] for r in ds.records])
    # the keys JAX's H36MDataset.evaluate gives this dataset: its one
    # action, the MPJPE family, and PSS@50 (fit on the 4 x frames eval
    # poses; PSS@100 needs 200)
    keys = ["Synth", "MPJPE", "NMPJPE", "PA-MPJPE"] + (
        ["PSS@50"] if len(ds) >= 100 else [])
    check(list(name_values) == keys,
          f"evaluate gave {list(name_values)}, expected {keys}")
    check(all(math.isfinite(v) for v in name_values.values()),
          f"evaluate gave {name_values}")
    check(float(np.median(root_z)) > 1000.0,
          "records lack absolute depths: the camera lift would not run")
    return dict(name_values=name_values, perf=perf, wall=wall,
                samples_per_s=len(ds) / wall, counts=counts,
                shares=stats_shares(stats, wall), route=loader_route(ds),
                records=len(ds))


def ss_on_data(cfg, frames: int, epochs: int, seed: int,
               device="cuda") -> dict:
    """The SS step over ``epochs`` epochs of ``epoch_loader(multiview=True,
    is_train=True)`` of a synthetic multiview dataset of ``frames``
    frames: the real dual crop, each view rendered once and warped twice;
    the detections are the batch's labels mapped back to source pixels (a
    perfect teacher, through the batch's ``det_src`` route). The loss must
    fall from the first epoch to the last; the first batch's pseudo-GT is
    held to the dataset's world poses. Returns what it measured."""
    from epipolarpose_tpu_torch.core import create_train_state
    from epipolarpose_tpu_torch.core import self_supervised as tss
    from epipolarpose_tpu_torch.data import epoch_loader, get_dataset
    from epipolarpose_tpu_torch.geometry.affine import transform_preds
    from epipolarpose_tpu_torch.models import get_model
    import numpy as np
    dev = torch.device(device)
    cfg.DATASET.DATASET = "synthetic_multiview"
    ds = get_dataset(cfg, cfg.DATASET.TRAIN_SET, True, num_frames=frames,
                     pose_mode="skeleton", seed=seed)
    G = int(cfg.TRAIN.BATCH_SIZE)
    size = tuple(int(v) for v in cfg.MODEL.IMAGE_SIZE)
    model = get_model(cfg, True, torch.Generator().manual_seed(seed + 1))
    state = create_train_state(cfg, model, steps_per_epoch=1000, device=dev)
    step = tss.make_ss_train_step(cfg, model, None, device=dev,
                                  flip_pairs=ds.flip_pairs)
    stats, losses, resid, kept = {}, [], [], []
    reset_counts()
    t0 = time.perf_counter()
    for epoch in range(epochs):
        epoch_stats = stats if epoch == 0 else None
        for batch in keep_first(epoch_loader(ds, G, epoch, is_train=True,
                                             device=dev, multiview=True,
                                             stats=epoch_stats), kept):
            batch["det_src"] = transform_preds(
                batch["joints"], batch["center"], batch["scale"], size)
            state, m = step(state, batch)
            losses.append(m["loss"])
            resid.append(m["tri_residual"])
        if epoch == 0:
            epoch_wall = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    first = kept[0]
    x_w, _ = tss.generate_pseudo_gt(
        cfg, first["det_src"], torch.ones(first["det_src"].shape[:-1],
                                          device=dev), first["camera"])
    world = np.stack([ds.records[int(i)].meta["pose_world"]
                      for i in first["index"][:, 0].cpu()])
    pgt_err = (x_w.cpu() - torch.from_numpy(world)).norm(dim=-1).max().item()
    curve = torch.stack(losses).tolist()
    per_epoch = frames // G
    flips = first["aug_flip"]
    check(len(curve) == epochs * per_epoch, f"{len(curve)} steps, "
          f"expected {epochs * per_epoch}")
    check(tuple(first["input_aug"].shape) == tuple(first["input"].shape)
          == (G, 4, size[1], size[0], 3), "dual crop shapes")
    check(0 < int((flips > 0.5).sum()) < flips.numel(),
          "the dual crop drew no flips, or only flips")
    check(all(math.isfinite(v) for v in curve), f"losses {curve}")
    first_mean = sum(curve[:per_epoch]) / per_epoch
    last_mean = sum(curve[-per_epoch:]) / per_epoch
    check(curve[-1] < curve[0] and last_mean < first_mean,
          f"SS loss did not fall from the first epoch to the last: {curve}")
    check(pgt_err < 1.0, f"pseudo-GT {pgt_err:.3g} mm from the world poses")
    return dict(losses=curve, tri_residual=torch.stack(resid).max().item(),
                pgt_err_mm=pgt_err, wall=wall, steps=len(curve),
                samples_per_s=G * 4 * len(curve) / wall, counts=counts,
                shares=stats_shares(stats, epoch_wall),
                route=loader_route(ds))


def pose2d_on_data(cfg, samples: int, eval_samples: int, seed: int,
                   device="cuda") -> dict:
    """Gaussian train steps over ``epoch_loader`` of a synthetic 2D
    dataset, then ``validate`` on a held-out one scored by its PCKh
    ``evaluate``; beside them the same number of steps on the first batch
    already on the device. Returns what it measured."""
    from epipolarpose_tpu_torch.core import (create_train_state,
                                             make_train_step)
    from epipolarpose_tpu_torch.core.function import validate
    from epipolarpose_tpu_torch.core.steps import make_eval_step
    from epipolarpose_tpu_torch.data import epoch_loader, get_dataset
    from epipolarpose_tpu_torch.models import get_model
    dev = torch.device(device)
    cfg.DATASET.DATASET = "synthetic"
    size = tuple(int(v) for v in cfg.MODEL.IMAGE_SIZE)
    ds = get_dataset(cfg, cfg.DATASET.TRAIN_SET, True, num_samples=samples,
                     image_shape=size[::-1], seed=seed)
    held_out = get_dataset(cfg, cfg.DATASET.TEST_SET, False,
                           num_samples=eval_samples, image_shape=size[::-1],
                           seed=seed + 1)
    bs = int(cfg.TRAIN.BATCH_SIZE)
    model = get_model(cfg, True, torch.Generator().manual_seed(seed + 2))
    state = create_train_state(cfg, model, steps_per_epoch=1000, device=dev)
    step = make_train_step(cfg, model, device=dev)
    eval_step = make_eval_step(cfg, model, ds.flip_pairs, device=dev)
    stats, metrics, kept = {}, [], []
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    reset_counts()
    t0 = time.perf_counter()
    for b in keep_first(epoch_loader(ds, bs, 0, is_train=True, device=dev,
                                     stats=stats), kept):
        state, m = step(state, b)
        metrics.append(m)
    sync()
    wall = time.perf_counter() - t0
    name_values, pckh = validate(cfg, epoch_loader(
        held_out, bs, 0, is_train=False, device=dev), held_out, eval_step)
    sync()
    counts = launch_counts()
    t0 = time.perf_counter()
    for _ in range(len(metrics)):
        step(state, kept[0])
    sync()
    on_card = bs * len(metrics) / (time.perf_counter() - t0)
    losses = [m["loss"].item() for m in metrics]
    accs = [m["acc"].item() for m in metrics]
    check(len(losses) == samples // bs, f"{len(losses)} steps")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(all(0.0 <= a <= 1.0 for a in accs), f"acc {accs}")
    check(list(name_values) == ["Mean"] and 0.0 <= pckh <= 100.0,
          f"evaluate gave {name_values}")
    return dict(losses=losses, accs=accs, pckh=pckh, wall=wall,
                samples_per_s=bs * len(losses) / wall,
                on_card_samples_per_s=on_card, counts=counts,
                shares=stats_shares(stats, wall), route=loader_route(ds))


def phase_eval_data(res: dict) -> None:
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.core.steps import (configure_backends,
                                                   make_eval_step)
    from epipolarpose_tpu_torch.models import get_model
    cfg = load_config(ROOT / "experiments/h36m/valid_r50_256_integral.yaml")
    check(cfg.TEST.BATCH_SIZE == EVAL_BATCH and cfg.TEST.FLIP_TEST,
          "unexpected flagship config")
    configure_backends(cfg)
    model = get_model(cfg, False, torch.Generator().manual_seed(0))
    # the synthetic dataset's flip pairs: its blob colours do not change
    # sides
    step = make_eval_step(cfg, model, (), device="cuda")
    out = eval_on_data(cfg, model, step, EVAL_FRAMES, seed=41)
    res["paths"]["eval_data"] = c = out["counts"]
    check(c["softargmax_fwd"] == EVAL_BATCHES and c["softargmax_bwd"] == 0
          and c["matmul_stats"] == c["triangulate"] == 0,
          f"loader-fed eval launched {c}, expected {EVAL_BATCHES} forward "
          f"soft-argmax launches and nothing else")
    res["eval_data"] = {k: v for k, v in out.items() if k != "counts"}
    nv = out["name_values"]
    log(f"[eval_data] {out['records']} records of the port's "
        f"synthetic_multiview dataset (skeleton poses, 1024 px views) -> "
        f"epoch_loader -> validate -> H36M evaluate: "
        f"{out['samples_per_s']:.1f} samples/s loader-fed ({out['wall']:.3f}"
        f" s) against {res['samples_per_s']:.1f} samples/s with the data "
        f"already on the card; " + ", ".join(
            f"{k} {v:.4g}" for k, v in nv.items())
        + f" (random weights); first loader batch on the card equal to "
        f"get_batch on the host; soft-argmax launches {c['softargmax_fwd']}"
        f"; {out['route']}; {format_shares(out['shares'])}")


def phase_ss_data(res: dict) -> None:
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.core.steps import configure_backends
    cfg = load_config(ROOT / "experiments/h36m/train_ss_r50_256_integral.yaml")
    check(int(cfg.TRAIN.BATCH_SIZE) == SS_GROUPS, "unexpected SS config")
    configure_backends(cfg)
    out = ss_on_data(cfg, SS_FRAMES, SS_EPOCHS, seed=43)
    res["paths"]["ss_data"] = c = out["counts"]
    steps = out["steps"]
    check(c["triangulate"] == c["triangulate_split"] == c["softargmax_fwd"]
          == c["softargmax_bwd"] == steps and c["matmul_stats"] == 0
          and c["teacher_decode"] == 0,
          f"loader-fed SS launched {c} in {steps} steps, expected one "
          f"triangulation (split), soft-argmax forward and backward a step")
    res["ss_data"] = {k: v for k, v in out.items() if k != "counts"}
    log(f"[ss_data] {SS_FRAMES} frames of the port's synthetic_multiview "
        f"dataset -> epoch_loader(multiview, dual crop) -> SS step, "
        f"{SS_GROUPS} x 4 crops a step, labels as detections: {SS_EPOCHS} "
        f"epochs, {steps} steps "
        f"in {out['wall']:.3f} s = {out['samples_per_s']:.1f} samples/s "
        f"loader-fed against " + ", ".join(
            f"{r:.1f}" for r in res["ss_samples_per_s"])
        + f" samples/s with one batch on the card; losses " + ", ".join(
            f"{v:.4f}" for v in out["losses"])
        + f"; max tri_residual {out['tri_residual']:.3g}; first batch's "
        f"pseudo-GT within {out['pgt_err_mm']:.3g} mm of the world poses "
        f"(limit 1); launches {c}; {out['route']}; "
        f"{format_shares(out['shares'])}")


def phase_pose2d_data(res: dict) -> None:
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.core.steps import configure_backends
    cfg = load_config(ROOT / "experiments/mpii/"
                      "train_r50_256x256_d256x3_adam_lr1e-3.yaml")
    check(cfg.TRAIN.BATCH_SIZE == POSE2D_BATCH, "unexpected MPII config")
    configure_backends(cfg)
    out = pose2d_on_data(cfg, POSE2D_SAMPLES, POSE2D_EVAL_SAMPLES, seed=51)
    res["paths"]["pose2d_data"] = c = out["counts"]
    check(not any(c.values()), f"pose2d path launched {c}")
    res["pose2d_data"] = {k: v for k, v in out.items() if k != "counts"}
    log(f"[pose2d_data] {POSE2D_SAMPLES} samples of the port's synthetic "
        f"dataset -> epoch_loader -> gaussian steps, batch {POSE2D_BATCH}: "
        f"{out['samples_per_s']:.1f} samples/s loader-fed against "
        f"{out['on_card_samples_per_s']:.1f} samples/s on one batch on the "
        f"card; losses " + ", ".join(f"{v:.6f}" for v in out["losses"])
        + ", acc " + ", ".join(f"{a:.3f}" for a in out["accs"])
        + f"; held-out PCKh@0.5 {out['pckh']:.2f} (random weights, "
        f"{POSE2D_EVAL_SAMPLES} samples via validate); {out['route']}; "
        f"{format_shares(out['shares'])}")


def phase_image_libs(res: dict) -> None:
    loaded = [m for m in IMAGE_LIBS if m in sys.modules]
    check(not loaded, f"the card paths imported {loaded}")
    log(f"[image_libs] none of {', '.join(IMAGE_LIBS)} was imported")


# ------------------------------------------------- the user's entry points
def cli_yaml(dst: pathlib.Path, src: str, **sections) -> str:
    """Write ``experiments/<src>`` with ``SECTION={KEY: value}`` overrides
    (merged one level deep) as ``dst``; the run directory takes its name."""
    import yaml
    data = yaml.safe_load((ROOT / "experiments" / src).read_text())
    for sec, kv in sections.items():
        if isinstance(kv, dict):
            for k, v in kv.items():
                if isinstance(v, dict):
                    data.setdefault(sec, {}).setdefault(k, {}).update(v)
                else:
                    data.setdefault(sec, {})[k] = v
        else:
            data[sec] = kv
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(yaml.safe_dump(data))
    return str(dst)


def run_cli(main, argv: list, counts: dict | None = None):
    """Call a CLI's ``main(argv)`` in this process with the launch
    counters at 0 (their values after it go into ``counts``); give the
    root logger back to stdout afterwards (``create_logger`` took it)."""
    reset_counts()
    t0 = time.perf_counter()
    try:
        out = main(argv)
        torch.cuda.synchronize()
    finally:
        logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                            format="%(message)s", force=True)
    if counts is not None:
        counts.update(launch_counts())
        counts["wall_s"] = time.perf_counter() - t0
    return out


def log_rates(output_dir: str) -> tuple[list, list]:
    """The train steps' and validations' samples/s from a run's log."""
    import re
    text = "".join(p.read_text() for p in
                   sorted(pathlib.Path(output_dir).glob("*_train.log")))
    steps = [float(v) for v in re.findall(
        r"Epoch: \[\d+\]\[\d+\]\tTime [\d.]+s \(([\d.]+) samples/s\)", text)]
    evals = [float(v) for v in re.findall(
        r"validate: \d+ samples in [\d.]+s \(([\d.]+) samples/s\)", text)]
    return steps, evals


def check_png(path: str, size: tuple[int, int]) -> None:
    """The PNG decodes (signature, every CRC, IHDR) at (W, H) ``size``."""
    from epipolarpose_tpu_torch.utils.vis import read_png
    img = read_png(path)
    check(img.shape[:2] == (size[1], size[0]),
          f"{path}: {img.shape} is not {size[1]}x{size[0]}")


def same_state(a, b) -> list[str]:
    """Names of what differs between two train states: the model's
    entries, Adam's moments and step counts, the optimizer's groups, the
    schedule and the step."""
    diff = []
    sa, sb = a.model.state_dict(), b.model.state_dict()
    diff += [k for k in sa if not torch.equal(sa[k], sb[k])]
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i, st in oa["state"].items():
        diff += [f"optimizer.{i}.{k}" for k, v in st.items()
                 if not torch.equal(v.cpu(), ob["state"][i][k].cpu())]
    if oa["param_groups"] != ob["param_groups"]:
        diff.append("optimizer.param_groups")
    if (a.scheduler.last_epoch != b.scheduler.last_epoch
            or a.scheduler.get_last_lr() != b.scheduler.get_last_lr()):
        diff.append("scheduler")
    if a.step != b.step:
        diff.append("step")
    return diff


def phase_cli(res: dict) -> None:
    """The user's workflow through the CLIs' ``main(argv)``, at the
    ResNet-50@256 width, in a temporary directory that phase
    ``pseudo_gt`` reads too (``main`` deletes it at the end)."""
    import tempfile
    res["cli_dir"] = tmp = pathlib.Path(tempfile.mkdtemp(prefix="epk_cli_"))
    cli_workflow(res, tmp)


def cli_workflow(res: dict, tmp: pathlib.Path) -> None:
    import re

    import numpy as np
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.core import (create_train_state,
                                             make_eval_step, make_train_step,
                                             train, validate)
    from epipolarpose_tpu_torch.core.checkpoint import (CheckpointManager,
                                                        load_model_variables)
    from epipolarpose_tpu_torch.data import epoch_loader, get_dataset
    from epipolarpose_tpu_torch.models import get_model
    from epipolarpose_tpu_torch.scripts import (demo, train as train_cli,
                                                train_refiner, valid)
    paths, out = res["paths"], {}
    dirs = ["--modelDir", str(tmp / "out"), "--logDir", str(tmp / "log")]
    ss_src = "h36m/train_ss_r50_256_integral.yaml"
    fs_src = "h36m/train_fs_r50_256_integral.yaml"
    valid_src = "h36m/valid_r50_256_integral.yaml"

    # 1. the 2D teacher, as make_teacher_cfg derives it from the SS config
    teacher_yaml = cli_yaml(
        tmp / "cli_teacher.yaml", ss_src, PRINT_FREQ=1,
        DATASET={"LABEL_SOURCE": "gt"}, LOSS={"TYPE": "JointsMSELoss"},
        MODEL={"NAME": "pose_resnet", "EXTRA": {"TARGET_TYPE": "gaussian",
                                                "DEPTH_DIM": 1}},
        TRAIN={"LR": 0.003})
    c = paths["cli_teacher"] = {}
    teacher = run_cli(train_cli.main, ["--cfg", teacher_yaml, "--synthetic",
                                       "--samples", str(CLI_TEACHER_SAMPLES),
                                       "--epochs", "1"] + dirs, c)
    check(not any(c[k] for k in ("softargmax_fwd", "softargmax_bwd",
                                 "triangulate", "matmul_stats")),
          f"the 2D teacher's run launched {c}")
    check(math.isfinite(teacher["loss"]), f"teacher loss {teacher['loss']}")
    out["teacher"] = dict(wall_s=c["wall_s"], loss=teacher["loss"],
                          pckh=teacher["perf"])
    res["cli_teacher"] = teacher["final"]

    # 2. the FS 3D step: 2 epochs, then resume to the third
    fs_yaml = cli_yaml(tmp / "cli_fs.yaml", fs_src, PRINT_FREQ=1)
    argv = ["--cfg", fs_yaml, "--synthetic", "--samples",
            str(CLI_FS_SAMPLES)] + dirs
    c = paths["cli_fs"] = {}
    fs = run_cli(train_cli.main, argv + ["--epochs", "2"], c)
    # the rates of these two epochs alone: the resumed run logs beside them
    fs_steps, fs_evals = log_rates(fs["output_dir"])
    steps = CLI_FS_SAMPLES // 32
    check(fs["state"].step == 2 * steps, f"FS step {fs['state'].step}")
    # one forward a step and an eval batch (3 of 32 an epoch), one backward
    check(c["softargmax_fwd"] == 4 * steps and c["softargmax_bwd"]
          == 2 * steps and c["triangulate"] == c["matmul_stats"] == 0,
          f"FS run launched {c} in {2 * steps} steps")
    ckpt_dir = pathlib.Path(fs["output_dir"]) / "checkpoints"
    fcfg = load_config(fs_yaml)
    fresh = create_train_state(fcfg, get_model(fcfg, True), steps, "cuda")
    t0 = time.perf_counter()
    fresh, next_epoch = CheckpointManager(str(ckpt_dir), best_mode="min"
                                          ).restore(fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    diff = same_state(fs["state"], fresh)
    check(not diff and next_epoch == 2,
          f"restored state differs in {diff[:5]} (epoch {next_epoch})")
    t0 = time.perf_counter()
    CheckpointManager(str(tmp / "timed"), best_mode="min").save(
        fs["state"].step, fs["state"], 1, fs["perf"])
    save_s = time.perf_counter() - t0
    ckpt_bytes = (tmp / "timed" / f"{fs['state'].step}.pth.tar").stat(
        ).st_size
    final_bytes = pathlib.Path(fs["final"]).stat().st_size
    del fresh
    cli_yaml(tmp / "cli_fs.yaml", fs_src, PRINT_FREQ=1,
             TRAIN={"RESUME": True})
    c = paths["cli_fs_resume"] = {}
    resumed = run_cli(train_cli.main, argv + ["--epochs", "3"], c)
    check(resumed["state"].step == 3 * steps,
          f"resumed run ended at step {resumed['state'].step}")
    check(c["softargmax_fwd"] == 2 * steps and c["softargmax_bwd"] == steps,
          f"resumed epoch launched {c}")
    perfs = {}
    for f in ckpt_dir.glob("*.pth.tar"):
        if f.stem.split(".")[0].isdigit():
            perfs[int(f.stem.split(".")[0])] = float(torch.load(
                f, map_location="cpu", weights_only=True)["perf"])
    best = list((ckpt_dir / "best").glob("*.pth.tar"))
    check(sorted(perfs) == [steps, 2 * steps, 3 * steps] and len(best) == 1,
          f"checkpoints {sorted(perfs)}, best {best}")
    best_perf = float(torch.load(best[0], map_location="cpu",
                                 weights_only=True)["perf"])
    check(best_perf == min(perfs.values())
          and int(best[0].name.split(".")[0]) == min(perfs, key=perfs.get),
          f"best/ holds {best[0].name} perf {best_perf}, epochs {perfs}")
    out["fs"] = dict(perfs=perfs, best_perf=best_perf, save_s=save_s,
                     restore_s=restore_s, checkpoint_bytes=ckpt_bytes,
                     final_bytes=final_bytes, step_rates=fs_steps,
                     eval_rates=fs_evals, wall_s=paths["cli_fs"]["wall_s"])
    final = res["cli_fs_final"] = resumed["final"]
    del fs, resumed

    # 3. validate the saved weights: in this process, the CLI, a subprocess
    valid_argv = ["--cfg", str(ROOT / "experiments" / valid_src),
                  "--synthetic", "--samples", str(CLI_FS_SAMPLES),
                  "--model-file", final] + dirs
    c = paths["cli_valid"] = {}
    cli_perf = run_cli(valid.main, valid_argv, c)
    vcfg = load_config(ROOT / "experiments" / valid_src)
    vcfg.DATASET.DATASET = "synthetic_multiview"
    ds = get_dataset(vcfg, vcfg.DATASET.TEST_SET, False,
                     num_frames=CLI_FS_SAMPLES // 4)
    model = load_model_variables(get_model(vcfg, False), final)
    _, own_perf = validate(vcfg, epoch_loader(
        ds, int(vcfg.TEST.BATCH_SIZE), 0, is_train=False, device="cuda"),
        ds, make_eval_step(vcfg, model, (), device="cuda"))
    del model
    r = subprocess.run([sys.executable, "-m",
                        "epipolarpose_tpu_torch.scripts.valid"] + valid_argv,
                       capture_output=True, text=True, cwd=ROOT, timeout=240)
    found = re.findall(r"perf: ([-\d.]+)", r.stdout + r.stderr)
    check(r.returncode == 0 and found,
          f"valid subprocess rc {r.returncode}: {r.stderr[-2000:]}")
    sub_perf = float(found[-1])
    check(abs(cli_perf - own_perf) <= 0.01 and abs(sub_perf - own_perf)
          <= 0.01, f"valid perf {cli_perf} (in process), {sub_perf} "
          f"(subprocess) against validate {own_perf}")
    n_eval = -(-CLI_FS_SAMPLES // int(vcfg.TEST.BATCH_SIZE))
    check(c["softargmax_fwd"] == n_eval and c["softargmax_bwd"] == 0,
          f"valid launched {c}, expected {n_eval} forward launches")
    out["valid"] = dict(cli_perf=cli_perf, subprocess_perf=sub_perf,
                        validate_perf=own_perf)

    # 4. the SS step with the teacher the CLI wrote
    ss_yaml = cli_yaml(tmp / "cli_ss.yaml", ss_src, PRINT_FREQ=1,
                       MODEL={"PRETRAINED": teacher["final"]})
    c = paths["cli_ss"] = {}
    ss = run_cli(train_cli.main, ["--cfg", ss_yaml, "--synthetic",
                                  "--samples", str(CLI_SS_SAMPLES),
                                  "--epochs", "1"] + dirs, c)
    ss_steps = CLI_SS_SAMPLES // 4 // SS_GROUPS
    n_eval = CLI_SS_SAMPLES // 32
    check(ss["state"].step == ss_steps, f"SS step {ss['state'].step}")
    check(c["triangulate"] == c["softargmax_bwd"] == c["teacher_decode"]
          == ss_steps and c["softargmax_fwd"] == ss_steps + n_eval,
          f"SS run launched {c} in {ss_steps} steps and {n_eval} eval "
          f"batches")
    check(math.isfinite(ss["loss"]), f"SS loss {ss['loss']}")
    log_text = "".join(p.read_text() for p in pathlib.Path(
        ss["output_dir"]).glob("*_train.log"))
    check("pretrained: skipping final_layer.weight" in log_text,
          "the SS run did not log the skipped final_layer")
    teacher_sd = torch.load(teacher["final"], map_location="cpu",
                            weights_only=True)["state_dict"]
    moved = (ss["state"].model.conv1.weight.detach().float().cpu()
             - teacher_sd["conv1.weight"]).abs().max().item()
    check(moved < 0.01, f"student conv1 {moved:.3g} from the teacher's")
    ss_rates, ss_evals = log_rates(ss["output_dir"])
    out["ss"] = dict(loss=ss["loss"], perf=ss["perf"], conv1_moved=moved,
                     step_rates=ss_rates, eval_rates=ss_evals,
                     wall_s=c["wall_s"])
    del ss

    # 4b. the calibration-free SS config with the same teacher: the rig
    # estimated in every step (4 triangulations a step)
    nocam_yaml = cli_yaml(tmp / "cli_ss_nocam.yaml",
                          "h36m/train_ss_nocam_r50_256_integral.yaml",
                          PRINT_FREQ=1, MODEL={"PRETRAINED": teacher["final"]})
    c = paths["cli_ss_nocam"] = {}
    nocam = run_cli(train_cli.main, ["--cfg", nocam_yaml, "--synthetic",
                                     "--samples", str(CLI_SS_SAMPLES),
                                     "--epochs", "1"] + dirs, c)
    check(nocam["state"].step == ss_steps, f"nocam step {nocam['state'].step}")
    check(c["triangulate"] == c["triangulate_split"] == 4 * ss_steps
          and c["softargmax_bwd"] == c["teacher_decode"] == ss_steps
          and c["softargmax_fwd"] == ss_steps + n_eval,
          f"nocam SS run launched {c} in {ss_steps} steps and {n_eval} eval "
          f"batches")
    check(math.isfinite(nocam["loss"]), f"nocam SS loss {nocam['loss']}")
    out["ss_nocam"] = dict(loss=nocam["loss"], perf=nocam["perf"],
                           wall_s=c["wall_s"])
    del nocam

    # 5. the refiner and the demo
    c = paths["cli_refiner"] = {}
    ref = run_cli(train_refiner.main, [
        "--cfg", ss_yaml, "--synthetic", "--steps", str(CLI_REFINER_STEPS),
        "--out", str(tmp / "refiner")], c)
    check(c["triangulate"] == 1 and c["triangulate_split"] == 0,
          f"train_refiner launched {c}")
    check(math.isfinite(ref["after_mm"]), f"refiner {ref}")
    c = paths["cli_demo"] = {}
    shown = run_cli(demo.main, [
        "--cfg", str(ROOT / "experiments" / valid_src), "--model-file",
        final, "--refiner-file", ref["path"], "--out", str(tmp / "demo")], c)
    check(c["softargmax_fwd"] == 1, f"demo launched {c}")
    check_png(shown["files"][0], (258, 258))
    check_png(shown["files"][1], (512, 256))
    check(bool(np.isfinite(shown["pose3d"]).all()), "demo pose not finite")
    out["refiner"] = dict(before_mm=ref["before_mm"],
                          after_mm=ref["after_mm"])

    # 6. the debug dumps of one train call on the 2D config
    dcfg = load_config(ROOT / "experiments/mpii/"
                       "train_r50_256x256_d256x3_adam_lr1e-3.yaml")
    dcfg.DEBUG.DEBUG = dcfg.DEBUG.SAVE_BATCH_IMAGES_GT = True
    dcfg.PRINT_FREQ = 1
    dcfg.DATASET.DATASET = "synthetic"
    dds = get_dataset(dcfg, dcfg.DATASET.TRAIN_SET, True, num_samples=64)
    dmodel = get_model(dcfg, True, torch.Generator().manual_seed(61))
    dstate = create_train_state(dcfg, dmodel, 2, "cuda")
    reset_counts()
    train(dcfg, epoch_loader(dds, 32, 0, device="cuda"), dstate,
          make_train_step(dcfg, dmodel, device="cuda"), 0,
          output_dir=str(tmp / "debug"))
    paths["cli_debug"] = launch_counts()
    dumps = sorted(p.name for p in (tmp / "debug").iterdir())
    check(dumps == ["train_0_0_gt.png", "train_0_1_gt.png"],
          f"debug dumps {dumps}")
    for name in dumps:
        check_png(str(tmp / "debug" / name), (8 * 258, 4 * 258))
    loaded = [m for m in IMAGE_LIBS if m in sys.modules]
    check(not loaded, f"the CLIs imported {loaded}")
    res["cli"] = out
    med = (lambda v: sorted(v)[len(v) // 2] if v else float("nan"))
    log(f"[cli] teacher -> FS 2 epochs -> resume to 3 -> valid -> SS with "
        f"the teacher -> refiner -> demo -> debug dumps, ResNet-50@256: FS "
        f"checkpoint {ckpt_bytes / 1e6:.1f} MB saved in {save_s:.3f} s, "
        f"restored in {restore_s:.3f} s (bit-equal), final weights "
        f"{final_bytes / 1e6:.1f} MB; FS perfs {perfs} best {best_perf:.3f}"
        f"; valid {cli_perf:.4f} / subprocess {sub_perf:.4f} / validate "
        f"{own_perf:.4f} mm; CLI-fed steps: FS median "
        f"{med(fs_steps[1:]):.1f} samples/s, SS median "
        f"{med(ss_rates[1:]):.1f} samples/s; validation "
        + ", ".join(f"{v:.1f}" for v in fs_evals + ss_evals)
        + f" samples/s; SS loss {out['ss']['loss']:.4f} (nocam "
        f"{out['ss_nocam']['loss']:.4f}), student conv1 "
        f"{moved:.2e} from the teacher's; refiner {ref['before_mm']:.2f} -> "
        f"{ref['after_mm']:.2f} mm; launches " + json.dumps(
            {k: {n: v for n, v in paths[k].items() if n != "wall_s"}
             for k in paths if k.startswith("cli_")}))


def phase_ss_convergence(res: dict) -> None:
    """The port's SS convergence tool at the SS config's width (ResNet-50
    @256, D 64), at the JAX CI pin's operating point: noisy GT detections
    in the batch, a randomly initialized student, the curve on the
    training poses, LR 0.005."""
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.core.steps import configure_backends
    from epipolarpose_tpu_torch.tools.ss_convergence import run
    cfg = load_config(ROOT / "experiments/h36m/train_ss_r50_256_integral.yaml")
    configure_backends(cfg)
    cfg.TRAIN.LR = 0.005
    lines: list[str] = []
    reset_counts()
    t0 = time.perf_counter()
    curve, floor, losses = run(
        cfg, frames=CONV_FRAMES, val_frames=CONV_FRAMES, groups=CONV_FRAMES,
        teacher_steps=0, ss_steps=CONV_STEPS, eval_every=CONV_EVAL_EVERY,
        log=lines.append, detector="gt_noise", noise_px=2.0,
        merge_backbone=False, eval_on="train", device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = res["paths"]["ss_convergence"] = launch_counts()
    check(math.isfinite(floor), f"floor {floor}")
    check(all(math.isfinite(v) for _, v in curve + losses),
          f"curve {curve}, losses {losses}")
    check(c["triangulate"] == CONV_STEPS + 1
          and c["softargmax_bwd"] == CONV_STEPS,
          f"ss_convergence launched {c} in {CONV_STEPS} steps")
    check(curve[-1][1] < curve[0][1],
          f"train-pose MPJPE did not fall: {curve}")
    res["ss_convergence"] = dict(curve=curve, floor=floor, losses=losses,
                                 wall_s=wall)
    log(f"[ss_convergence] ResNet-50@256 D64, {CONV_FRAMES} frames x 4 "
        f"views, {CONV_STEPS} steps, gt_noise, random-init student, "
        f"train-pose MPJPE " + " -> ".join(f"{v:.1f}" for _, v in curve)
        + f" mm (steps {[s for s, _ in curve]}); losses " + ", ".join(
            f"{v:.4f}" for _, v in losses)
        + f"; pseudo-GT floor {floor:.2f} mm; {wall:.1f} s; launches {c}")
    loaded = [m for m in IMAGE_LIBS if m in sys.modules]
    check(not loaded, f"ss_convergence imported {loaded}")


def phase_pseudo_gt(res: dict) -> None:
    """The offline pseudo-GT CLI's ``main(argv)`` in this process on the
    SS config's synthetic rig: once with the 2D teacher phase ``cli``
    trained, once with ``--gt-detections`` merged into an annot json
    written from the same synthetic records."""
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.core import self_supervised as tss
    from epipolarpose_tpu_torch.data import get_dataset
    from epipolarpose_tpu_torch.kernels import triangulate as ktri
    from epipolarpose_tpu_torch.scripts import generate_pseudo_gt as pgt
    tmp = res["cli_dir"]
    ss_yaml = cli_yaml(tmp / "pgt_ss.yaml",
                       "h36m/train_ss_r50_256_integral.yaml",
                       MODEL={"PRETRAINED": res["cli_teacher"]})
    cfg = load_config(ss_yaml)
    cfg.DATASET.DATASET = "synthetic_multiview"
    ds = get_dataset(cfg, cfg.DATASET.TRAIN_SET, False,
                     num_frames=PGT_SAMPLES // 4)
    annot = tmp / "pgt_annot.json"
    annot.write_text(json.dumps([
        {"image": r.image, "center": r.center.tolist(),
         "scale": r.scale.tolist(), "joints_2d": r.joints.tolist(),
         "joints_vis": r.joints_vis.tolist(),
         "joints_3d": r.joints_3d.tolist()} for r in ds.records]))
    merged = tmp / "pgt_annot_pseudo.json"
    batches = PGT_SAMPLES // 4 // PGT_GROUPS
    out = {}
    # the kernel's inputs of each run's first batch, held to its plain
    # version after the run (the solver is looked up at each call)
    calls: list = []

    def capture(pts, P, w):
        if len(calls) == len(out):
            calls.append((pts.clone(), P.clone(),
                          None if w is None else w.clone()))
        return ktri.triangulate_fast(pts, P, w)
    for name, extra in (("teacher", []),
                        ("gt_detections", ["--gt-detections", "--merge-into",
                                           str(annot), "--merge-out",
                                           str(merged)])):
        c = res["paths"][f"pseudo_gt_{name}"] = {}
        tss.triangulate_fast = capture
        try:
            r = run_cli(pgt.main, [
                "--cfg", ss_yaml, "--synthetic", "--samples",
                str(PGT_SAMPLES), "--groups-per-batch", str(PGT_GROUPS),
                "--out", str(tmp / f"pgt_{name}.json")] + extra, c)
        finally:
            tss.triangulate_fast = ktri.triangulate_fast
        # records/s of the batch loop; set-up (config, dataset, teacher)
        # and the json after it apart
        out[name] = dict(r, wall_s=c["wall_s"],
                         setup_s=c["wall_s"] - r["loop_s"],
                         records_per_s=r["records"] / r["loop_s"],
                         wall_records_per_s=r["records"] / c["wall_s"])
        check(r["records"] == len(ds) == PGT_SAMPLES,
              f"{name}: {r['records']} records, expected {len(ds)}")
        check(c["triangulate"] == c["triangulate_split"] == batches
              and c["softargmax_fwd"] == c["softargmax_bwd"] == 0
              and c["teacher_decode"] == (batches if name == "teacher"
                                          else 0),
              f"{name}: launches {c} for {batches} batches")
        check(r["mpjpe"] is not None and math.isfinite(r["mpjpe"]),
              f"{name}: MPJPE {r['mpjpe']}")
    want = ((PGT_GROUPS, 4, int(cfg.MODEL.NUM_JOINTS), 2),
            (PGT_GROUPS, 4, 3, 4), True)
    for name, (pts, P, w) in zip(out, calls):
        check((tuple(pts.shape), tuple(P.shape), w is not None) == want,
              f"{name}: the kernel took {tuple(pts.shape)}, P "
              f"{tuple(P.shape)}, weights {w is not None}; expected {want}")
        tri_check(res, f"triangulate_pgt_{name}", pts, P, w, tag="pseudo_gt")
    check(len(calls) == len(out), f"{len(calls)} runs captured")
    gt = out["gt_detections"]
    check(gt["mpjpe"] < 5.0, f"pseudo-GT from the GT detections "
          f"{gt['mpjpe']:.3g} mm from the dataset's (limit 5)")
    rows = json.loads(merged.read_text())
    check(gt["merged"] == len(rows) == len(ds),
          f"merged {gt['merged']} of {len(rows)} records")
    res["pseudo_gt"] = out
    log(f"[pseudo_gt] scripts.generate_pseudo_gt on the SS config's "
        f"synthetic rig, {PGT_SAMPLES} records in batches of {PGT_GROUPS} "
        f"groups: " + "; ".join(
            f"{k}: {v['records']} records, batch loop {v['loop_s']:.3f} s "
            f"= {v['records_per_s']:.1f} records/s (with the set-up's "
            f"{v['setup_s']:.3f} s and the json: {v['wall_s']:.3f} s, "
            f"{v['wall_records_per_s']:.1f}), pseudo-GT MPJPE vs the "
            f"dataset {v['mpjpe']:.3f} mm, launches "
            + json.dumps({n: x for n, x in res["paths"][f"pseudo_gt_{k}"]
                          .items() if n != "wall_s"})
            for k, v in out.items())
        + f"; merged into {gt['merged']} annot records (limit: all "
        f"{len(ds)}); GT-detection MPJPE limit 5 mm")


def timed(batches, arrivals: list, kept: list | None = None):
    """Yield ``batches``, appending each one's arrival time
    (``time.perf_counter()``) to ``arrivals`` and the batch to ``kept``."""
    for b in batches:
        arrivals.append(time.perf_counter())
        if kept is not None:
            kept.append(b)
        yield b


def loader_rates(arrivals: list, t0: float, t_end: float, batch: int,
                 workers: int | None) -> dict:
    """Rates of one loader-fed epoch: all samples over all its time, the
    seconds to its first batch, and the rate from the loader's second
    round on. A ``DataLoader`` worker builds a whole batch, so the first
    ``workers`` batches are built side by side and each worker starts its
    round-2 batch as it hands over its first: the steady window runs from
    the arrival here of batch ``workers - 1`` (batch 0 without workers)
    to the end and counts the batches after it. Its head start is what
    ``epoch_loader``'s copy stages hold between a worker and this loop."""
    n = len(arrivals)
    k = max(workers or 0, 1) - 1
    return dict(samples_per_s=n * batch / (t_end - t0),
                first_batch_s=arrivals[0] - t0,
                steady_per_s=(n - 1 - k) * batch / (t_end - arrivals[k]),
                steady_batches=n - 1 - k, batches=n)


def phase_loader_workers(res: dict) -> None:
    """Loader-fed eval and FS-step rates on the port's synthetic
    multiview records with ``TPU.LOADER: grain`` at 0, 4 and 8 worker
    processes beside ``threads``; every eval batch of each route equal to
    the ``threads`` route's."""
    import os
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.core import (create_train_state,
                                             make_train_step)
    from epipolarpose_tpu_torch.core.function import validate
    from epipolarpose_tpu_torch.core.steps import (configure_backends,
                                                   make_eval_step)
    from epipolarpose_tpu_torch.data import epoch_loader, get_dataset
    from epipolarpose_tpu_torch.models import get_model
    dev = torch.device("cuda")
    ecfg = load_config(ROOT / "experiments/h36m/valid_r50_256_integral.yaml")
    fcfg = load_config(ROOT / "experiments/h36m/train_fs_r50_256_integral.yaml")
    configure_backends(fcfg)
    datasets = {}
    for key, cfg, train, frames in (("eval", ecfg, False, LOADER_EVAL_FRAMES),
                                    ("fs", fcfg, True, LOADER_FS_FRAMES)):
        cfg.DATASET.DATASET = "synthetic_multiview"
        datasets[key] = get_dataset(
            cfg, cfg.DATASET.TRAIN_SET if train else cfg.DATASET.TEST_SET,
            train, num_frames=frames, pose_mode="skeleton", seed=81)
    ebs, fbs = int(ecfg.TEST.BATCH_SIZE), int(fcfg.TRAIN.BATCH_SIZE)
    emodel = get_model(ecfg, False, torch.Generator().manual_seed(82))
    estep = make_eval_step(ecfg, emodel, (), device=dev)
    fmodel = get_model(fcfg, True, torch.Generator().manual_seed(83))
    state = create_train_state(fcfg, fmodel, steps_per_epoch=1000,
                               device=dev)
    fstep = make_train_step(fcfg, fmodel, device=dev)
    # cuDNN picks its algorithms before any route is timed
    warm = datasets["fs"].get_batch(list(range(fbs)), seed=0)
    state, _ = fstep(state, {k: torch.from_numpy(v).to(dev)
                             for k, v in warm.items()})
    estep({k: torch.from_numpy(v).to(dev) for k, v in datasets[
        "eval"].get_batch(list(range(ebs)), seed=0).items()})
    torch.cuda.synchronize()
    routes = [("threads", None)] + [("grain", n) for n in LOADER_WORKERS]
    rows, reference = {}, None
    for loader, workers in routes:
        name = loader if workers is None else f"grain_{workers}"
        for cfg in (ecfg, fcfg):
            cfg.TPU.LOADER = loader
            cfg.TPU.GRAIN_WORKERS = -1 if workers is None else workers
        kept: list = []
        eval_at, fs_at = [], []
        reset_counts()
        t0 = time.perf_counter()
        _, perf = validate(ecfg, timed(epoch_loader(
            datasets["eval"], ebs, 0, is_train=False, device=dev), eval_at,
            kept), datasets["eval"], estep)
        torch.cuda.synchronize()
        eval_end = time.perf_counter()
        if reference is None:
            reference = kept
        else:
            check(len(kept) == len(reference), f"{name}: {len(kept)} eval "
                  f"batches, threads {len(reference)}")
            for got, want in zip(kept, reference):
                check(sorted(got) == sorted(want)
                      and all(torch.equal(got[k], want[k]) for k in want),
                      f"{name}: an eval batch differs from threads'")
        del kept
        steps = 0
        t1 = time.perf_counter()
        for b in timed(epoch_loader(datasets["fs"], fbs, 0, is_train=True,
                                    device=dev), fs_at):
            state, m = fstep(state, b)
            steps += 1
        torch.cuda.synchronize()
        fs_end = time.perf_counter()
        counts = launch_counts()
        n_eval = -(-len(datasets["eval"]) // ebs)
        check(steps == len(datasets["fs"]) // fbs,
              f"{name}: {steps} FS steps")
        check(counts["softargmax_fwd"] == n_eval + steps
              and counts["softargmax_bwd"] == steps,
              f"{name}: launches {counts}")
        check(math.isfinite(perf) and math.isfinite(m["loss"].item()),
              f"{name}: perf {perf}, loss {m['loss']}")
        rows[name] = dict(
            eval=loader_rates(eval_at, t0, eval_end, ebs, workers),
            fs=loader_rates(fs_at, t1, fs_end, fbs, workers),
            eval_s=eval_end - t0, fs_s=fs_end - t1, workers=workers)
        res["paths"][f"loader_{name}"] = counts
    for cfg in (ecfg, fcfg):
        cfg.TPU.LOADER = "threads"
    res["loader_workers"] = dict(rows=rows, cpu_count=os.cpu_count())
    log(f"[loader_workers] {len(datasets['eval'])} eval records (batch "
        f"{ebs}, flip test) and {len(datasets['fs'])} FS records (batch "
        f"{fbs}) of the port's synthetic_multiview dataset (1024 px views) "
        f"through epoch_loader, os.cpu_count() {os.cpu_count()}; samples/s "
        f"of the whole epoch, seconds to its first batch, samples/s from "
        f"the loader's second round on (over that many batches): "
        + "; ".join(f"{k}: " + ", ".join(
            f"{part} {r['samples_per_s']:.1f}, first batch "
            f"{r['first_batch_s']:.2f} s, steady {r['steady_per_s']:.1f} "
            f"({r['steady_batches']} of {r['batches']} batches)"
            for part, r in (("eval", v["eval"]), ("FS", v["fs"])))
            for k, v in rows.items())
        + "; every route's eval batches equal to threads'")


# ------------------------------------------ JPEG data, 3DHP, the warp
JPEG_FIXTURES = ROOT / "tests" / "data" / "jpeg"
# the three frame fixtures: MPI-INF-3DHP studio and outdoor, H36M
JPEG_FRAMES = ("3dhp_studio_2048x2048.jpg", "3dhp_outdoor_1920x1080.jpg",
               "h36m_1000x1000.jpg")
JPEG_REPS, JPEG_THREADS, JPEG_ROUNDS = 10, (1, 2, 4, 8), 16
# the 3DHP tree: 2 sequences of 129 frames, the last of each invalid: 256
# records, 4 batches of 64
MPI3DHP_FRAMES = 129
WARP_CROPS = 64


def jpeg_manifest() -> dict:
    return json.loads((JPEG_FIXTURES / "manifest.json").read_text())


def phase_jpeg(res: dict) -> None:
    """The port's JPEG decoder on the card's host: every fixture's decode
    against the sha256 of libjpeg-turbo's (the manifest), the refused mode
    named, ms a frame at the three dataset sizes, the rate on 1-8
    threads, then ``demo --image`` on the 2048 x 2048 frame at full
    width."""
    import hashlib
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from epipolarpose_tpu_torch.data import fastloader, jpeg
    from epipolarpose_tpu_torch.scripts import demo
    t0 = time.perf_counter()
    check(jpeg.available(), f"JPEG decoder: {jpeg.build_error()}")
    build_s = time.perf_counter() - t0
    manifest = jpeg_manifest()
    refused = {}
    for name, entry in manifest.items():
        buf = (JPEG_FIXTURES / name).read_bytes()
        if entry["mode"].startswith("refused"):
            try:
                jpeg.decode(buf)
            except jpeg.UnsupportedJpeg as e:
                refused[name] = e.mode
                check(e.mode in entry["mode"], f"{name} refused as {e.mode}")
                continue
            check(False, f"{name} decoded; it should be refused")
        rgb = jpeg.decode(buf)
        check(hashlib.sha256(rgb.tobytes()).hexdigest() == entry["rgb_sha256"]
              and rgb.shape == (entry["height"], entry["width"], 3),
              f"{name}: the decode differs from libjpeg-turbo's")
    bufs = [(JPEG_FIXTURES / n).read_bytes() for n in JPEG_FRAMES]
    ms = {}
    for name, buf in zip(JPEG_FRAMES, bufs):
        jpeg.decode(buf)
        times = []
        for _ in range(JPEG_REPS):
            t = time.perf_counter()
            jpeg.decode(buf)
            times.append((time.perf_counter() - t) * 1e3)
        ms[name] = dict(median=sorted(times)[len(times) // 2],
                        min=min(times), bytes=len(buf))
    threads = {}
    work = bufs * JPEG_ROUNDS
    for n in JPEG_THREADS:
        with ThreadPoolExecutor(n) as pool:
            t = time.perf_counter()
            list(pool.map(jpeg.decode, work))
            dt = time.perf_counter() - t
        threads[n] = dict(frames_per_s=len(work) / dt,
                          mpix_per_s=sum(
                              manifest[f]["width"] * manifest[f]["height"]
                              for f in JPEG_FRAMES) * JPEG_ROUNDS / dt / 1e6)
    for n in JPEG_THREADS:
        threads[n]["speedup"] = (threads[n]["frames_per_s"]
                                 / threads[1]["frames_per_s"])
    check(not fastloader.available(),
          "the native loader is built here: imread would not take the "
          "port's decoder")
    with tempfile.TemporaryDirectory(prefix="epk_demo_") as tmp:
        jpeg.reset_count()
        c = res["paths"]["jpeg_demo"] = {}
        shown = run_cli(demo.main, [
            "--cfg", str(ROOT / "experiments/h36m/valid_r50_256_integral.yaml"),
            "--image", str(JPEG_FIXTURES / JPEG_FRAMES[0]), "--out", tmp], c)
        check(jpeg.decode_count() == 1, f"demo decoded "
              f"{jpeg.decode_count()} JPEGs with the port's decoder")
        check(c["softargmax_fwd"] == 1, f"demo launched {c}")
        check_png(shown["files"][0], (258, 258))
        check(bool(np.isfinite(shown["pose3d"]).all()), "demo pose")
    loaded = [m for m in IMAGE_LIBS if m in sys.modules]
    check(not loaded, f"the JPEG path imported {loaded}")
    res["jpeg"] = dict(build_s=build_s, ms=ms, threads=threads,
                       refused=refused, demo_wall_s=c["wall_s"])
    log(f"[jpeg] {len(manifest) - len(refused)} fixtures decode to "
        f"libjpeg-turbo's sha256 on this host, "
        + ", ".join(f"{k} refused ({v})" for k, v in refused.items())
        + f"; build {build_s:.2f} s; ms a decode (median / min of "
        f"{JPEG_REPS}): " + ", ".join(
            f"{k} {v['median']:.2f} / {v['min']:.2f} ({v['bytes']} bytes)"
            for k, v in ms.items())
        + f"; the three frames x {JPEG_ROUNDS} on threads: " + ", ".join(
            f"{n}: {v['frames_per_s']:.1f} frames/s, {v['mpix_per_s']:.1f} "
            f"Mpix/s (x{v['speedup']:.2f})" for n, v in threads.items())
        + f" ({os.cpu_count()} CPUs); demo --image {JPEG_FRAMES[0]} at "
        f"ResNet-50@256 in {c['wall_s']:.2f} s, one decode, one launch")


def phase_mpi3dhp(res: dict) -> None:
    """The H36M -> 3DHP transfer evaluation through the ``valid`` CLI at
    full width on a 3DHP tree (annotations from
    ``write_synthetic_3dhp``, the 2048 x 2048 fixture as every TS1 frame
    and the 1920 x 1080 one as every TS2 frame: the pixels do not match
    the poses; this checks the route and its rate), with phase 13's FS
    weights: every frame through the port's decoder, none through
    OpenCV."""
    import re
    import shutil
    import tempfile

    import numpy as np
    import epipolarpose_tpu_torch.data as data_pkg
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.data import fastloader, jpeg
    from epipolarpose_tpu_torch.data.mpi3dhp import (H36M_TO_3DHP,
                                                     MPI3DHPDataset,
                                                     write_synthetic_3dhp)
    from epipolarpose_tpu_torch.scripts import valid
    src = ROOT / "experiments/h36m/valid_3dhp_transfer.yaml"
    cfg = load_config(src)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="epk_3dhp_"))
    try:
        tree = tmp / cfg.DATASET.ROOT
        write_synthetic_3dhp(str(tree), num_frames=MPI3DHP_FRAMES, seed=7)
        for ts, frame in ((1, JPEG_FRAMES[0]), (2, JPEG_FRAMES[1])):
            seq = tree / f"TS{ts}" / "imageSequence"
            for f in range(MPI3DHP_FRAMES):
                shutil.copyfile(JPEG_FIXTURES / frame,
                                seq / f"img_{f + 1:06d}.jpg")
        cfg.DATASET.ROOT = str(tree)
        ds = MPI3DHPDataset(cfg, str(tree), "test", is_train=False)
        n = len(ds)
        check(n == 4 * EVAL_BATCH, f"{n} records")
        # perfect predictions in the model's H36M order
        inv = np.argsort(np.asarray(H36M_TO_3DHP))
        perfect = np.stack([np.concatenate([
            r.joints, (r.joints_3d[:, 2] - r.joints_3d[ds.root_idx, 2])[
                :, None]], -1)[inv] for r in ds.records]).astype(np.float32)
        nv, pck = ds.evaluate(cfg, perfect)
        check(pck == 100.0 and nv["AUC"] > 95.0 and nv["MPJPE"] < 0.5,
              f"evaluate on perfect predictions gave {nv}")

        check(not fastloader.available(), "the native loader is built here")
        stats = {}
        loader = data_pkg.epoch_loader

        def with_stats(*a, **k):             # the CLI's loader, measured
            return loader(*a, stats=stats, **k)
        data_pkg.epoch_loader = with_stats
        jpeg.reset_count()
        c = res["paths"]["mpi3dhp"] = {}
        try:
            perf = run_cli(valid.main, [
                "--cfg", str(src), "--dataDir", str(tmp), "--model-file",
                res["cli_fs_final"], "--modelDir", str(tmp / "out"),
                "--logDir", str(tmp / "log")], c)
        finally:
            data_pkg.epoch_loader = loader
        decoded = jpeg.decode_count()
        text = "".join(p.read_text() for p in
                       (tmp / "out").rglob("*_valid.log"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    m = re.search(r"validate: (\d+) samples in ([\d.]+)s \(([\d.]+) "
                  r"samples/s\)", text)
    check(m is not None, "the valid log has no validate line")
    seen, val_s, rate = int(m.group(1)), float(m.group(2)), float(m.group(3))
    check(math.isfinite(perf) and 0.0 <= perf <= 100.0,
          f"3DHP perf {perf}")
    check(seen == n and decoded == n,
          f"{seen} samples validated, {decoded} frames through the port's "
          f"decoder, {n} records")
    check(c["softargmax_fwd"] == n // EVAL_BATCH and c["softargmax_bwd"]
          == c["triangulate"] == c["matmul_stats"] == 0,
          f"3DHP valid launched {c}")
    loaded = [m for m in IMAGE_LIBS if m in sys.modules]
    check(not loaded, f"the 3DHP path imported {loaded}")
    shares = stats_shares(stats, val_s)
    res["mpi3dhp"] = dict(perf=perf, samples_per_s=rate, validate_s=val_s,
                          wall_s=c["wall_s"], decoded=decoded,
                          perfect=nv, shares=shares)
    log(f"[mpi3dhp] valid_3dhp_transfer.yaml through the valid CLI at "
        f"ResNet-50@256 (flip test, batch {EVAL_BATCH}) on {n} records of "
        f"a 3DHP tree (2048 x 2048 and 1920 x 1080 JPEG frames): PCK3D@150 "
        f"{perf:.3f} with phase 13's FS weights (pixels unrelated to the "
        f"poses); perfect predictions: " + ", ".join(
            f"{k} {v:.4g}" for k, v in nv.items())
        + f"; validation {rate:.1f} samples/s ({val_s:.3f} s; CLI call "
        f"{c['wall_s']:.2f} s); {decoded} frames through the port's "
        f"decoder, none through OpenCV; soft-argmax launches "
        f"{c['softargmax_fwd']}; {format_shares(shares)}")


def phase_warp(res: dict) -> None:
    """``ops/warp.py`` on the card: 64 rotation-free eval crops from 1000 x
    1000 frames against the same calls on the CPU and against
    ``imgproc``'s numpy crops (OpenCV's warp); the separable warp's bits
    with TF32 allowed and not; card ms (CUDA events) beside the host's
    numpy ms for the same batch."""
    import numpy as np
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.data import jpeg
    from epipolarpose_tpu_torch.data.imgproc import (warp_affine_f32,
                                                     warp_affine_u8)
    from epipolarpose_tpu_torch.geometry.affine import get_affine_transform_np
    from epipolarpose_tpu_torch.ops.warp import (warp_affine,
                                                 warp_affine_separable)
    cfg = load_config(ROOT / "experiments/h36m/valid_r50_256_integral.yaml")
    size = tuple(int(v) for v in cfg.MODEL.IMAGE_SIZE)
    frame = jpeg.decode((JPEG_FIXTURES / JPEG_FRAMES[2]).read_bytes())
    rng = np.random.default_rng(71)
    n = WARP_CROPS
    centers = rng.uniform(300, 700, (n, 2)).astype(np.float32)
    scales = np.repeat(rng.uniform(1.5, 3.5, (n, 1)), 2, 1).astype(np.float32)
    M = get_affine_transform_np(centers, scales, np.zeros(n, np.float32),
                                size)
    host_f32 = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        frame.astype(np.float32), (n,) + frame.shape)))
    card = host_f32.cuda()
    out, ms = {}, {}
    for name, fn in (("warp_affine", warp_affine),
                     ("warp_affine_separable", warp_affine_separable)):
        got = fn(card, M, size)
        torch.cuda.synchronize()
        cpu = fn(host_f32, M, size)
        d_cpu = (got.cpu() - cpu).abs().max().item()
        check(d_cpu <= 1e-3, f"{name}: card vs CPU {d_cpu:.3g}")
        begin, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        begin.record()
        for _ in range(5):
            fn(card, M, size)
        end.record()
        torch.cuda.synchronize()
        ms[name] = begin.elapsed_time(end) / 5
        out[name] = dict(card_vs_cpu=d_cpu, got=got.cpu().numpy())
    t = time.perf_counter()
    u8 = np.stack([warp_affine_u8(frame, M[i], size) for i in range(n)])
    ms["numpy_warp_affine_u8"] = (time.perf_counter() - t) * 1e3
    f32 = np.stack([warp_affine_f32(frame.astype(np.float32), M[i], size)
                    for i in range(n)])
    for name in out:
        got = out[name].pop("got")
        out[name]["vs_numpy_f32"] = float(np.abs(got - f32).max())
        out[name]["vs_numpy_u8"] = float(np.abs(got - u8).max())
        check(out[name]["vs_numpy_f32"] <= 2e-3
              and out[name]["vs_numpy_u8"] <= 0.51,
              f"{name} vs imgproc: {out[name]}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    runs = []
    try:
        for allow in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = allow
            runs.append(warp_affine_separable(card, M, size))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    check(torch.equal(runs[0], runs[1]),
          "the separable warp changed with TF32 allowed")
    res["warp"] = dict(ms=ms, checks=out)
    log(f"[warp] {n} rotation-free {size[0]} x {size[1]} crops from "
        f"{frame.shape[1]} x {frame.shape[0]} float32 frames on the card: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
        + " (card: CUDA events, 5 calls; numpy: the host's warp_affine_u8, "
        "64 serial calls); card vs CPU and vs imgproc's float32 / uint8 "
        "crops (limits 1e-3, 2e-3, 0.51 grey levels): " + ", ".join(
            f"{k} {v['card_vs_cpu']:.3g} / {v['vs_numpy_f32']:.3g} / "
            f"{v['vs_numpy_u8']:.3g}" for k, v in out.items())
        + "; separable bits equal with TF32 allowed and not")


def descendants() -> dict[int, str]:
    """pid -> state and command line of every process descended from
    this one, from ``/proc``."""
    import os
    parent, info = {}, {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            stat = pathlib.Path("/proc", d, "stat").read_text()
            cmd = pathlib.Path("/proc", d, "cmdline").read_bytes()
        except OSError:                         # ended while we looked
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        parent[int(d)] = int(fields[1])
        info[int(d)] = f"{fields[0]} {cmd.replace(b'\0', b' ')[:200]!r}"
    found, todo = {}, [os.getpid()]
    while todo:
        pid = todo.pop()
        for child, ppid in parent.items():
            if ppid == pid and child not in found:
                found[child] = info[child]
                todo.append(child)
    return found


def wait_for_no_processes(keep: set, seconds: float = 10.0) -> dict:
    """The descendants outside ``keep`` still there after up to
    ``seconds``."""
    end = time.perf_counter() + seconds
    while True:
        left = {p: c for p, c in descendants().items() if p not in keep}
        if not left or time.perf_counter() > end:
            return left
        time.sleep(0.1)


def phase_processes(res: dict) -> None:
    """Every process this script started has ended but the worker
    loader's server and resource tracker; ``stop_worker_server`` ends
    those two, so nothing outlives the script."""
    from multiprocessing import forkserver, resource_tracker
    from epipolarpose_tpu_torch.data.grain_pipeline import stop_worker_server
    server = forkserver._forkserver._forkserver_pid
    tracker = resource_tracker._resource_tracker._pid
    left = wait_for_no_processes({server, tracker})
    check(not left, f"processes still running: {left}")
    stop_worker_server()
    left = wait_for_no_processes(set())
    check(not left, f"processes still running after stop_worker_server: "
          f"{left}")
    res["processes"] = dict(server=server, tracker=tracker)
    log(f"[processes] none left; the worker server (pid {server}) and its "
        f"resource tracker (pid {tracker}) stopped")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr, flush=True)
        return 1
    torch.cuda.set_device(0)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(message)s")
    res: dict = {"paths": {}}
    phases = [("build", phase_env), ("softargmax", phase_softargmax),
              ("matmul_stats", phase_matmul_stats), ("eval", phase_eval),
              ("train", phase_train), ("ss", phase_ss),
              ("pose2d", phase_pose2d), ("tool", phase_tool),
              ("eval_data", phase_eval_data), ("ss_data", phase_ss_data),
              ("pose2d_data", phase_pose2d_data),
              ("image_libs", phase_image_libs), ("cli", phase_cli),
              ("ss_convergence", phase_ss_convergence),
              ("ss_nocam", phase_ss_nocam), ("pseudo_gt", phase_pseudo_gt),
              ("loader_workers", phase_loader_workers),
              ("jpeg", phase_jpeg), ("mpi3dhp", phase_mpi3dhp),
              ("warp", phase_warp), ("processes", phase_processes)]
    failed = []
    for i, (name, fn) in enumerate(phases, 1):
        if failed and failed[0] == "build":
            failed.append(name)
            log(f"[phase {i}/{len(phases)} {name}] skipped: the build "
                f"failed")
            continue
        log(f"[phase {i}/{len(phases)} {name}] start")
        t0 = time.perf_counter()
        try:
            fn(res)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            check(dt <= PHASE_LIMITS[name],
                  f"took {dt:.1f} s > limit {PHASE_LIMITS[name]:.0f} s")
            log(f"[phase {i}/{len(phases)} {name}] ok in {dt:.1f} s")
        except Exception:
            failed.append(name)
            log(f"[phase {i}/{len(phases)} {name}] FAILED after "
                f"{time.perf_counter() - t0:.1f} s")
            traceback.print_exc(file=sys.stdout)
            sys.stdout.flush()
    if "cli_dir" in res:
        import shutil
        shutil.rmtree(res["cli_dir"], ignore_errors=True)
    total = time.perf_counter() - t_start
    log(f"total wall time {total:.1f} s (build {res.get('build_s', 0):.1f} s)")
    if failed:
        log(f"chip_smoke FAILED: {', '.join(failed)}")
        return 1

    k1, k2 = res["softargmax"], res["matmul_stats"]
    pallas = ("epipolarpose_tpu/ops/pallas/softargmax.py:{} "
              "(fused_softmax_integral{}; git show f1b68e4)")
    paths = res["paths"]

    def by_path(counter):
        return {path: counts[counter] for path, counts in paths.items()}

    sa = "epipolarpose_tpu_torch/csrc/softargmax.cu"
    kernels = [
        dict(name="softargmax_fwd", route="cuda", source=sa,
             replaces=pallas.format(98, ""), path="eval",
             launches=res["eval_launches"],
             launches_by_path=by_path("softargmax_fwd"), **k1),
        dict(name="softargmax_fwd_stats", route="cuda", source=sa,
             replaces=pallas.format(98, ""), path="train",
             launches=res["train_launches"][0],
             launches_by_path=by_path("softargmax_fwd"),
             **res["softargmax_fwd_stats"]),
        dict(name="softargmax_bwd", route="cuda", source=sa,
             replaces=pallas.format(174, " backward, _bwd"), path="train",
             launches=res["train_launches"][1],
             launches_by_path=by_path("softargmax_bwd"),
             **res["softargmax_bwd"]),
        dict(name="softargmax_fwd_stats_ss", route="cuda", source=sa,
             replaces=pallas.format(98, ""), path="ss",
             launches=paths["ss"]["softargmax_fwd"],
             launches_by_path=by_path("softargmax_fwd"),
             **res["softargmax_fwd_stats_ss"]),
        dict(name="softargmax_bwd_ss", route="cuda", source=sa,
             replaces=pallas.format(174, " backward, _bwd"), path="ss",
             launches=paths["ss"]["softargmax_bwd"],
             launches_by_path=by_path("softargmax_bwd"),
             **res["softargmax_bwd_ss"]),
        dict(name="matmul_stats", route="cuda",
             source="epipolarpose_tpu_torch/csrc/matmul_stats.cu",
             replaces="tools/profile_step.py:152", path="tool",
             launches=res["tool_launches"][0],
             launches_wgmma=res["tool_launches"][1],
             launches_simt=res["tool_launches"][2], kernel_route="wgmma",
             launches_by_path=by_path("matmul_stats"),
             ragged_shape=res["matmul_stats_ragged"], **k2),
        # not a pl.pallas_call: the port's kernel for an op XLA fuses
        dict(name="triangulate", route="cuda",
             source="epipolarpose_tpu_torch/csrc/triangulate.cu",
             replaces="epipolarpose_tpu/geometry/triangulation.py:125 "
                      "(triangulate, method fast; XLA-fused, no "
                      "pl.pallas_call)", path="ss",
             launches=paths["ss"]["triangulate"],
             launches_by_path=by_path("triangulate"),
             at_1m_points=res["triangulate_1m"],
             at_rig_pair=res["triangulate_rig_pair"],
             at_rig_views=res["triangulate_rig_views"],
             at_pseudo_gt_teacher=res["triangulate_pgt_teacher"],
             at_pseudo_gt_gt_detections=res["triangulate_pgt_gt_detections"],
             **res["triangulate"]),
    ]
    log(f"ss path: {SS_GROUPS * SS_VIEWS} crops a step; perfect teacher: "
        f"samples/s per window " + ", ".join(
            f"{r:.1f}" for r in res["ss_samples_per_s"]) + ", ms a step "
        + ", ".join(f"{t:.2f}" for t in res["ss_step_ms"])
        + f"; random teacher: {res['ss_teacher_step_ms']:.2f} ms a step")
    log(f"loader-fed (the port's datasets through epoch_loader): eval "
        f"{res['eval_data']['samples_per_s']:.1f} samples/s (data on the "
        f"card {res['samples_per_s']:.1f}), ss "
        f"{res['ss_data']['samples_per_s']:.1f} samples/s, pose2d "
        f"{res['pose2d_data']['samples_per_s']:.1f} samples/s (one batch "
        f"on the card {res['pose2d_data']['on_card_samples_per_s']:.1f})")
    nc, lw = res["ss_nocam"], res["loader_workers"]
    log(f"ss_nocam path: " + ", ".join(f"{t:.2f}" for t in nc["step_ms"])
        + f" ms a step (calibrated " + ", ".join(
            f"{t:.2f}" for t in res["ss_step_ms"]) + f"), "
        f"{nc['syncs_per_step']} host synchronisations a step (calibrated "
        f"{nc['given_syncs_per_step']}); pseudo-GT CLI " + ", ".join(
            f"{k} {v['records_per_s']:.1f} records/s" for k, v in
            res["pseudo_gt"].items()) + f"; loader routes (eval, FS "
        f"samples/s, {lw['cpu_count']} CPUs): " + ", ".join(
            f"{k} {v['eval']['samples_per_s']:.1f} / "
            f"{v['fs']['samples_per_s']:.1f} (steady "
            f"{v['eval']['steady_per_s']:.1f} / {v['fs']['steady_per_s']:.1f})"
            for k, v in lw["rows"].items()))
    jp, hp, wp = res["jpeg"], res["mpi3dhp"], res["warp"]
    log(f"jpeg: ms a decode " + ", ".join(
        f"{k} {v['median']:.2f}" for k, v in jp["ms"].items())
        + f", 8 threads x{jp['threads'][8]['speedup']:.2f} of one; 3DHP "
        f"valid {hp['samples_per_s']:.1f} samples/s, PCK3D@150 "
        f"{hp['perf']:.3f}; warp ms " + ", ".join(
            f"{k} {v:.3f}" for k, v in wp["ms"].items()))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
