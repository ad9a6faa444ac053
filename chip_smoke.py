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
   timed calls of 20 steps each on one seeded batch; then train, eval,
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
   3 warm-up steps and 2 timed windows of 10 steps through
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
   and 8 worker processes beside ``threads`` over 16 batches each: the
   whole epoch, the seconds to its first batch and the rate from the
   loader's second round on; every eval batch equal to the ``threads``
   route's, ``os.cpu_count()``;
18. JPEG data: the port's own decoder (``native/jpegdec.cpp``, built by
   one ``g++`` call; the card's machine has neither libjpeg's headers nor
   OpenCV) on every fixture of ``tests/data/jpeg`` (progressive ones
   included) against the sha256 of libjpeg-turbo's decode in its
   manifest; ms a decode of the 2048 x 2048, 1920 x 1080 and 1000 x 1000
   frames, and the rate on 1, 2, 4 and 8 threads; ``demo --image`` on
   the 2048 x 2048 frame at ResNet-50@256, one decode through
   ``imread``'s decoder and none through the native loader; then every
   file of ``tests/data/jpeg/modes`` (arithmetic coding, unfinished
   progressive scans that libjpeg block-smooths, 4x4-subsampled chroma,
   CMYK and YCCK, truncated data, a lost restart marker, coefficients past
   16 bits, EXIF orientations 1-8) against its manifest's sha256 of
   libjpeg-turbo 2.1's decode at 8/8 and 1/8-4/8 and libjpeg's warning,
   ``imread`` against the JAX package's (OpenCV's) image from a path and
   from a zip member; lossless, hierarchical and 12-bit refused by name,
   nothing else; ms a decode of the arithmetic and block-smoothed twins
   of the 2048 x 2048 frame; ``demo --image`` on the orientation-6 photo
   (one decode, one soft-argmax launch, the crop upright);
19. the H36M -> MPI-INF-3DHP transfer evaluation through the ``valid``
   CLI (``experiments/h36m/valid_3dhp_transfer.yaml`` unchanged,
   ``--dataDir`` at a tree of 2 x 129 frames: 256 records, 4 batches of
   64) with phase 13's FS weights: ``evaluate`` on perfect predictions
   (PCK3D 100, AUC above 95, MPJPE under 0.5 mm), the CLI's perf in [0,
   100], every frame through the port's code (its decoder or its native
   loader, counted in both libraries; ``TPU.NATIVE_LOADER: auto``
   calibrates on the first batch, its decision logged) and none through
   OpenCV, validation samples/s and the loader's stage shares, one
   soft-argmax launch a batch;
20. ``ops/warp.py``: 64 rotation-free 256 x 256 crops of 1000 x 1000
   frames on the card against the CPU and ``imgproc``'s numpy crops,
   the separable warp's bits with TF32 allowed and not, card ms beside
   the host's numpy ms;
21. ``TPU.REMAT`` at ResNet-152@384 (``train_fs_r152_384_integral.yaml``:
   batch 24, bf16, Adam): one step without and one with from the same
   weights and batch (the loss and every BN buffer equal, the gradients
   held to a float64 evaluation), ms a step, peak memory and the
   device's busy time a step (a profiler trace) each way; in float32
   with deterministic cuDNN the same bits each way; the
   soft-argmax kernels against their plain versions at (24, 17*64, 96,
   96);
22. data parallelism at that config: two ranks sharing the card over
   ``gloo`` (``python3 chip_smoke.py --ddp-rank <dir>``, 24 crops each)
   against one process of 48 for a step in float32 with TF32 off and
   REMAT on (the ranks equal bit for bit; the losses and BN buffers
   against the one process, the gradients no further from a float64
   evaluation than the one process's), then their bf16 step timed
   beside phase 21's; the ``train`` and ``valid`` CLIs with
   ``--distributed`` under ``torch.distributed.run`` (one ``nccl`` rank)
   against the same runs without it (cuDNN deterministic: the same loss,
   perf, weights and predictions); two ``nccl`` ranks where the machine
   has two cards;
23. ``TPU.FUSED_STEPS``: K steps a call as one CUDA-graph replay. The
   soft-argmax kernels launched from a graph's replays against their
   plain versions at (32, 17*64, 64, 64), and the triangulation kernel's
   replay against its eager launch at 544 points, one launch each a
   replay; then each fused run against an eager loop of unfused steps
   from the same weights and batches (cuDNN deterministic): the flagship
   FS step (``train_fs_r50_256_integral.yaml``, batch 32, bf16) at K 4
   over 9 batches (the first super-batch the warm-up, then a graph of 4
   and one of 1) within the JAX package's fused-test bounds (losses
   relative 1e-5, parameters 3e-3), and in float32 at K 2 the same bits
   (losses, weights, BN buffers, Adam's moments); the SS step (32 groups
   x 4 views, noisy detections in the batch) at K 2 with ``given`` and
   ``estimated`` cameras (the latter's graph split around its 5 cuSOLVER
   calls a step), and with the random bf16 teacher inside the graph;
   ResNet-152@384 with REMAT at K 2; each call launching K x (its
   launches a step) of each kernel; samples/s through ``train`` at K 1
   and 4, ms a step of the SS and REMAT steps each way, capture seconds,
   and traces of 2 replays beside 2 x K unfused steps (the device's busy
   time and idle share); ``scripts.valid`` at K 4 against K 1 (576
   records: the same predictions), and ``scripts.train --distributed``
   on one ``nccl`` rank at K 2 (DDP's 11 eager warm-up steps, then
   graphs) against the same run in process;
24. the serving artifact (``tools/export_model.py``) at the flagship
   eval config (``valid_r50_256_integral.yaml``, bf16, seeded random
   weights, the head re-drawn so that the joints decode apart): exported
   with a symbolic batch on the card and saved (MB, specs, the program
   calling the registered op ``epipolarpose::softmax_integral`` once);
   loaded by a fresh process that imports only ``torch`` and
   ``load_exported`` (the op's module and nothing else of the port) and
   serves a batch of 8 with one kernel launch, equal to this process's
   under deterministic cuDNN; served here at batches 1, 8 and 64 with
   one ``epk_softargmax_fwd`` launch each, against the eager model and
   the plain decode within phase 4's bound in normalized units; ms a
   batch of 64 served against the eager forward and kernel decode, and
   the op's ms beside the wrapper's; then the eager eval step, after the
   export, gives real tensors equal to its predictions before it
   (``graphs.constant`` caches no traced tensor);
25. the user's tools: ``dualcrop_headroom --preset ci --device cuda``
   (parts A, B and C: the loader's route and bytes, finite floors, the
   triangulation and both soft-argmax kernels launched), ``export_torch``
   on a latest save of ``core/checkpoint.py`` loaded back ``strict``,
   ``prepare_h36m`` on fabricated json (and ``--cameras-h5``: converted
   where ``h5py`` is installed, else refused naming it), and
   ``demo_torch.ipynb``'s code cells at the flagship config on the card
   (one soft-argmax launch, two PNGs);
26. ``TPU.MESH.MODEL: 2`` at ResNet-152@384: the image rows of every
   crop split over two ranks sharing the card over ``gloo``
   (``python3 chip_smoke.py --spatial-rank <dir>``, 192 rows each, halo
   exchanges in every row-sensitive layer through the host, the
   soft-argmax kernels on the gathered volume) against one process on the
   same 4 crops: the float32 step with TF32 off and REMAT on (the loss
   relative 1e-5, the gradients and the BN buffers no further from a
   float64 evaluation than twice the one process's (the buffers: or 1e-4
   of each tensor's largest entry), the ranks equal bit for bit), the
   flip-test eval step (phase 4's bound; BN statistics calibrated on the
   crops, the head sharpened), then the ranks' bf16 step of 24 crops timed beside
   phase 21's; the kernels' launches on the ranks; one ``nccl`` pair
   where the machine has two cards;
27. no process left: every process this script started has ended but
   the worker loader's ``forkserver`` and its resource tracker, and those
   two end when ``stop_worker_server`` stops them; phases 22's and 26's
   rank processes are gone;
28. the native loader without libjpeg
   (``epipolarpose_tpu_torch/native/fastloader.cpp`` on the port's
   decoder): built on this host, where ``jpeglib.h`` is absent, with no
   libjpeg linked (a fresh build's seconds); every fixture's sha256 at
   8/8 and at each DCT scale of its manifest entry, the 3/8 ones also
   through the loader's exact 3/8 crop; ms a decode at 8, 4, 3, 2 and 1
   eighths of the three dataset frames and the progressive 2048 x 2048
   twin; phase 19's tree through the ``valid`` CLI with
   ``TPU.NATIVE_LOADER`` true, then false (samples/s, the decode's share,
   the ``scale_num`` histogram, every frame through the loader or the
   decoder as the flag says, one soft-argmax launch a batch), and the
   loader alone with the tree's boxes grown x3 (2/8); two SS steps of
   ``train_ss_r50_256_integral.yaml`` at each ``SS_TEACHER_SCALE``, 1.0
   and 0.5, fed by ``_dual_batch_native`` from the 1000 x 1000 frame
   (loader img/s, a soft-argmax forward and backward and a triangulation
   a step); then every file of ``tests/data/jpeg/modes`` through the
   loader at 8/8 to 1/8 against the JAX loader's crop hashes in its
   manifest, failing only on the CMYK/YCCK files as that loader does,
   the 4x4-subsampled frames at 3/8; the arithmetic-coded and
   block-smoothed twins of the 2048 x 2048 frame as that tree through
   ``valid`` (every frame through the loader, one soft-argmax launch a
   batch), and two SS steps fed from the arithmetic twin (both soft-argmax
   kernels and ``epk_triangulate_split`` a step);
29. images that are not JPEG, and lossless and 12-bit JPEGs, on the
   card's host (no OpenCV): every file of ``tests/data/images`` (PNG,
   PNM, BMP, TIFF, lossless and 12-bit JPEG) through ``imread`` from a
   path and a ``zip@`` member against its manifest's sha256 of OpenCV's
   image, IOError where OpenCV gives none, ImageTooLarge where it raises,
   NeedsOpenCV where the manifest says the port leaves the file to
   OpenCV; a 2048 x 2048 frame written here as PNG with filter types 0-4
   row by row (and all Paeth) decoded back to its bits, ms a decode split
   into the inflate and the native pass, on 1 and 8 threads; the same for
   a 2048 x 2048 TIFF (strips of 64 rows, one 64-row band repeated, so
   that writing it here costs one strip's LZW) as LZW with Predictor 2 and
   as Deflate; ``demo --image`` on an EXIF orientation-6 PNG portrait
   (upright, one soft-argmax launch); a synthetic H36M tree of the
   1000 x 1000 JPEG frame and its PNG and TIFF (LZW, Predictor 2) twins
   through ``valid`` on the pool route, whose predictions must be equal
   bit for bit, one soft-argmax launch each, every frame through the
   port's JPEG, PNG or TIFF decoder and none through OpenCV.

Kernel launch counters are set to 0 just before each path and read just
after it (phases 22's and 26's rank processes report their own). Each phase checks
its own time limit. Any failed phase makes the script exit 1 without a
result; without a CUDA card it exits 1 at once.
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

# seconds each phase may take; the whole run aims at under 700 s
PHASE_LIMITS = {"build": 120.0, "softargmax": 30.0, "matmul_stats": 60.0,
                "eval": 90.0, "train": 150.0, "ss": 150.0, "pose2d": 60.0,
                "tool": 30.0, "eval_data": 60.0, "ss_data": 90.0,
                "pose2d_data": 60.0, "image_libs": 1.0, "cli": 300.0,
                "ss_convergence": 120.0, "ss_nocam": 150.0,
                "pseudo_gt": 120.0, "loader_workers": 360.0,
                "jpeg": 25.0, "mpi3dhp": 30.0, "warp": 15.0,
                "remat": 150.0, "ddp": 420.0, "fused": 300.0,
                "export": 90.0, "user_tools": 90.0, "spatial": 150.0,
                "processes": 30.0, "native_loader": 65.0,
                "image_formats": 30.0}

# H36M left/right joint pairs (the JAX package's data/h36m.py FLIP_PAIRS)
H36M_FLIP_PAIRS = ((1, 4), (2, 5), (3, 6), (11, 14), (12, 15), (13, 16))
EVAL_BATCH, EVAL_BATCHES = 64, 3
# the train path: warm-up steps, then TRAIN_WINDOWS calls of train() of
# TRAIN_STEPS steps each, each timed on its own (about 1.3 s a window)
TRAIN_BATCH, TRAIN_STEPS, TRAIN_WINDOWS, TRAIN_WARMUP = 32, 20, 3, 3
# the SS path: groups x views, warm-up steps, timed windows of steps
SS_GROUPS, SS_VIEWS, SS_WARMUP, SS_WINDOWS, SS_STEPS = 32, 4, 3, 2, 10
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
# (16 eval batches of 64 and 16 FS batches of 32: a DataLoader worker
# builds whole batches, so 8 workers take 2 rounds an epoch; 32 each
# before the fused phase needed the time), worker counts
LOADER_EVAL_FRAMES, LOADER_FS_FRAMES = 256, 128
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
    hand-written kernel): ``tools/dualcrop_headroom.py::kernel_launches``."""
    from epipolarpose_tpu_torch.tools.dualcrop_headroom import kernel_launches
    return kernel_launches()


def reset_counts() -> None:
    """Set every launch counter to 0 (``telemetry.reset``)."""
    from epipolarpose_tpu_torch import telemetry
    telemetry.reset()


def matmul_routes():
    from epipolarpose_tpu_torch.kernels.matmul_stats import matmul_stats
    return (matmul_stats.launches, matmul_stats.launches_wgmma,
            matmul_stats.launches_simt)


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
    """Which route decodes ``ds``'s records: the native loader (the
    port's own decoder and warp, no libjpeg) where they are JPEGs and it
    is built, else the thread pool (numpy render or the port's decoder,
    numpy warp)."""
    from epipolarpose_tpu_torch.data import fastloader
    if ds._native_eligible([0]):
        return "native decode + warp (the port's loader, no libjpeg)"
    built = ("built" if fastloader.available()
             else f"not built ({fastloader.build_error()})")
    return f"numpy render + warp on the thread pool; native loader {built}"


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
# the files of the modes OpenCV and Pillow do not write and of the ways a
# file goes wrong (tests/jpeg_fixtures.py), with the arithmetic-coded and
# the block-smoothed twins of the 2048 x 2048 frame, and the EXIF
# orientation-6 photo that phase 18's second demo reads
JPEG_MODES = JPEG_FIXTURES / "modes"
MODE_TWINS = ("3dhp_studio_arith_2048x2048.jpg",
              "3dhp_studio_smoothed_2048x2048.jpg")
PORTRAIT = "exif_orientation6_40x24.jpg"
TWIN_REPS = 10
# the 3DHP tree: 2 sequences of 129 frames, the last of each invalid: 256
# records, 4 batches of 64
MPI3DHP_FRAMES = 129
WARP_CROPS = 64


def jpeg_manifest() -> dict:
    return json.loads((JPEG_FIXTURES / "manifest.json").read_text())


def modes_manifest() -> dict:
    return json.loads((JPEG_MODES / "manifest.json").read_text())


def rgb_sha(img) -> str:
    import hashlib

    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def jpeg_modes() -> dict:
    """Every file of ``tests/data/jpeg/modes`` through the port's decoder
    on this host (no libjpeg, no OpenCV): its manifest's sha256 of
    libjpeg-turbo 2.1's decode at 8/8 and at 1/8-4/8 and libjpeg's
    warning; ``imread``'s image against the JAX package's (OpenCV's,
    EXIF orientation applied) from a plain path and from a ``zip@`` path,
    whose truncated members it refuses; the refused set: lossless,
    hierarchical and 12-bit, named, and nothing of the modes; ms a
    decode (median of TWIN_REPS) of the arithmetic and block-smoothed
    twins of the 2048 x 2048 frame (phase 18 times the frame itself)."""
    import tempfile
    import zipfile

    from epipolarpose_tpu_torch.data import jpeg, zipreader
    manifest = modes_manifest()
    kinds: dict = {}
    with tempfile.TemporaryDirectory(prefix="epk_modes_") as tmp:
        archive = pathlib.Path(tmp) / "modes.zip"
        with zipfile.ZipFile(archive, "w") as z:
            for name in manifest:
                z.write(JPEG_MODES / name, name)
        for name, e in manifest.items():
            buf = (JPEG_MODES / name).read_bytes()
            for s in (8, 1, 2, 3, 4):
                want = (e["rgb_sha256"] if s == 8
                        else e["scaled_rgb_sha256"][str(s)])
                try:
                    img, kind = jpeg.decode(buf, s), None
                except jpeg.JpegWarning as w:
                    img, kind = w.image, "ended" if w.ended else "warned"
                check(rgb_sha(img) == want, f"{name} at {s}/8: the decode "
                      f"differs from libjpeg-turbo 2.1's")
                if s == 8:
                    check(kind == e["warning"], f"{name}: warning {kind}, "
                          f"libjpeg gives {e['warning']}")
                    kinds[str(kind)] = kinds.get(str(kind), 0) + 1
            for path, key in ((str(JPEG_MODES / name), "imread_sha256"),
                              (f"{archive}@/{name}", "imdecode_sha256")):
                try:
                    got = rgb_sha(zipreader.imread(path, rgb=True))
                except IOError:
                    got = None
                check(got == e[key], f"{name}: imread of {path} differs "
                      f"from the JAX package's")
    base = (JPEG_FIXTURES / "s420_37x29.jpg").read_bytes()
    sof = base.index(b"\xff\xc0")
    refused = []
    for mode, bad in (
            ("lossless (SOF3)", base[:sof + 1] + b"\xc3" + base[sof + 2:]),
            ("hierarchical (SOF5)", base[:sof + 1] + b"\xc5" + base[sof + 2:]),
            ("12-bit samples", base[:sof + 4] + b"\x0c" + base[sof + 5:])):
        try:
            jpeg.decode(bad)
            check(False, f"{mode} decoded; libjpeg refuses it")
        except jpeg.UnsupportedJpeg as e:
            check(e.mode == mode, f"refused as {e.mode}, not {mode}")
            refused.append(mode)
    ms = {}
    for name in MODE_TWINS:
        buf = (JPEG_MODES / name).read_bytes()
        jpeg.decode(buf)
        times = []
        for _ in range(TWIN_REPS):
            t = time.perf_counter()
            jpeg.decode(buf)
            times.append((time.perf_counter() - t) * 1e3)
        ms[name] = dict(median=sorted(times)[len(times) // 2],
                        min=min(times), bytes=len(buf))
    return dict(files=len(manifest), warnings=kinds, refused=refused, ms=ms)


def portrait_demo(res: dict, tmp: str, path: str | None = None,
                  key: str = "jpeg_portrait_demo") -> dict:
    """``demo --image`` on an EXIF orientation-6 photo at ResNet-50@256
    (phase 18's JPEG, or the PNG at ``path``): one decode through imread
    (the port's JPEG or PNG decoder, never OpenCV), one soft-argmax
    launch, and the crop upright: the photo stands 40 high and 24 wide
    once turned, so the square crop's left and right eighths are padding
    (black) and its top and bottom eighths are not (the other way round
    without the turn)."""
    import numpy as np
    from epipolarpose_tpu_torch.data import png, zipreader
    from epipolarpose_tpu_torch.scripts import demo
    from epipolarpose_tpu_torch.utils.vis import read_png
    path = str(path or JPEG_MODES / PORTRAIT)
    check(zipreader.imread(path).shape == (40, 24, 3),
          f"imread did not turn the orientation-6 photo {path} upright")
    reset_decodes()
    png.reset_count()
    zipreader.reset_route_counts()
    c = res["paths"][key] = {}
    shown = run_cli(demo.main, [
        "--cfg", str(ROOT / "experiments/h36m/valid_r50_256_integral.yaml"),
        "--image", path, "--out", tmp], c)
    d, routes = decodes_by_library(), zipreader.route_counts()
    if path.endswith(".png"):
        check(png.decode_count() == 1 and d["total"] == 0
              and routes["png"] == 1 and sum(routes.values()) == 1,
              f"the PNG portrait demo decoded {d}, routes {routes}")
    else:
        check(d["jpeg"] == d["total"] == 1 and not d["failed"]
              and routes["opencv"] == 0,
              f"the portrait demo decoded {d}, routes {routes}")
    check(c["softargmax_fwd"] == 1, f"the portrait demo launched {c}")
    png_out = shown["files"][0]
    check_png(png_out, (258, 258))
    img = read_png(png_out)
    dark = img[1:-1, 1:-1, :3].max(-1) < 8          # inside the 1 px frame
    band = dark.shape[1] // 8
    sides = float(np.concatenate([dark[:, :band], dark[:, -band:]], 1).mean())
    ends = float(np.concatenate([dark[:band], dark[-band:]], 0).mean())
    check(sides > 0.8 and ends < 0.6, f"the crop is not upright: dark "
          f"share {sides:.2f} at the sides, {ends:.2f} at the ends")
    return dict(wall_s=c["wall_s"], dark_sides=sides, dark_ends=ends)


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
    from epipolarpose_tpu_torch.data import jpeg
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
    with tempfile.TemporaryDirectory(prefix="epk_demo_") as tmp:
        reset_decodes()
        c = res["paths"]["jpeg_demo"] = {}
        shown = run_cli(demo.main, [
            "--cfg", str(ROOT / "experiments/h36m/valid_r50_256_integral.yaml"),
            "--image", str(JPEG_FIXTURES / JPEG_FRAMES[0]), "--out", tmp], c)
        d = decodes_by_library()
        check(d["jpeg"] == d["total"] == 1 and not d["failed"],
              f"demo decoded {d}: imread takes the port's decoder, not "
              f"its loader")
        check(c["softargmax_fwd"] == 1, f"demo launched {c}")
        check_png(shown["files"][0], (258, 258))
        check(bool(np.isfinite(shown["pose3d"]).all()), "demo pose")
    modes = jpeg_modes()
    with tempfile.TemporaryDirectory(prefix="epk_demo_") as tmp:
        portrait = portrait_demo(res, tmp)
    loaded = [m for m in IMAGE_LIBS if m in sys.modules]
    check(not loaded, f"the JPEG path imported {loaded}")
    res["jpeg"] = dict(build_s=build_s, ms=ms, threads=threads,
                       refused=refused, demo_wall_s=c["wall_s"],
                       modes=modes, portrait=portrait)
    log(f"[jpeg] {len(manifest) - len(refused)} fixtures decode to "
        f"libjpeg-turbo's sha256 on this host"
        + "".join(f", {k} refused ({v})" for k, v in refused.items())
        + f"; build {build_s:.2f} s; ms a decode (median / min of "
        f"{JPEG_REPS}): " + ", ".join(
            f"{k} {v['median']:.2f} / {v['min']:.2f} ({v['bytes']} bytes)"
            for k, v in ms.items())
        + f"; the three frames x {JPEG_ROUNDS} on threads: " + ", ".join(
            f"{n}: {v['frames_per_s']:.1f} frames/s, {v['mpix_per_s']:.1f} "
            f"Mpix/s (x{v['speedup']:.2f})" for n, v in threads.items())
        + f" ({os.cpu_count()} CPUs); demo --image {JPEG_FRAMES[0]} at "
        f"ResNet-50@256 in {c['wall_s']:.2f} s, one decode, one launch")
    log(f"[jpeg] modes: {modes['files']} files of tests/data/jpeg/modes "
        f"decode to libjpeg-turbo 2.1's sha256 at 8/8 and 1/8-4/8 (warnings "
        f"{modes['warnings']}), imread gives the JAX package's image from a "
        f"path and a zip member; refused only "
        + ", ".join(modes["refused"]) + "; ms a decode (median / min of "
        f"{TWIN_REPS}): " + ", ".join(
            f"{k} {v['median']:.2f} / {v['min']:.2f} ({v['bytes']} bytes)"
            for k, v in modes["ms"].items())
        + f"; demo --image {PORTRAIT} upright (dark share "
        f"{portrait['dark_sides']:.2f} at the sides, "
        f"{portrait['dark_ends']:.2f} at the ends) in "
        f"{portrait['wall_s']:.2f} s, one decode, one launch")


def make_3dhp_tree(tmp: pathlib.Path, cfg, frames=None):
    """Phase 19's 3DHP tree under ``tmp``: annotations from
    ``write_synthetic_3dhp``, the 2048 x 2048 fixture as every TS1 frame
    and the 1920 x 1080 one as every TS2 frame, or the two files of
    ``frames`` (the pixels do not match the poses; the route and its rate
    are what is checked). Returns its dataset."""
    import shutil
    from epipolarpose_tpu_torch.data.mpi3dhp import (MPI3DHPDataset,
                                                     write_synthetic_3dhp)
    tree = tmp / cfg.DATASET.ROOT
    write_synthetic_3dhp(str(tree), num_frames=MPI3DHP_FRAMES, seed=7)
    frames = frames or (JPEG_FIXTURES / JPEG_FRAMES[0],
                        JPEG_FIXTURES / JPEG_FRAMES[1])
    for ts, frame in ((1, frames[0]), (2, frames[1])):
        seq = tree / f"TS{ts}" / "imageSequence"
        for f in range(MPI3DHP_FRAMES):
            shutil.copyfile(frame, seq / f"img_{f + 1:06d}.jpg")
    cfg.DATASET.ROOT = str(tree)
    ds = MPI3DHPDataset(cfg, str(tree), "test", is_train=False)
    check(len(ds) == 4 * EVAL_BATCH, f"{len(ds)} records")
    return ds


def decodes_by_library() -> dict:
    """The decodes of the port's code since the counters' last reset:
    ``jpeg`` through ``data/jpeg.py`` (imread, the pool route),
    ``native`` through the loader's library by ``scale_num``, and the
    loader's failures."""
    from epipolarpose_tpu_torch.data import fastloader, jpeg
    native = fastloader.decode_counts()
    return dict(jpeg=jpeg.decode_count(), native=native["scale"],
                failed=native["failed"],
                total=jpeg.decode_count() + sum(native["scale"].values()))


def reset_decodes() -> None:
    from epipolarpose_tpu_torch.data import fastloader, jpeg
    jpeg.reset_count()
    fastloader.reset_counts()


def valid_3dhp(res: dict, tmp: pathlib.Path, cfg_file: str, key: str,
               weights: str) -> dict:
    """The ``valid`` CLI on ``cfg_file`` over the tree under ``tmp`` (its
    launches in ``res["paths"][key]``): perf, samples/s and seconds of
    the validation (from its log), the loader's stage shares, the decodes
    of each library, and the log's loader calibration line if any."""
    import re
    import epipolarpose_tpu_torch.data as data_pkg
    from epipolarpose_tpu_torch.scripts import valid
    stats = {}
    loader = data_pkg.epoch_loader

    def with_stats(*a, **k):                 # the CLI's loader, measured
        return loader(*a, stats=stats, **k)
    data_pkg.epoch_loader = with_stats
    reset_decodes()
    c = res["paths"][key] = {}
    out = tmp / f"out_{key}"
    try:
        perf = run_cli(valid.main, [
            "--cfg", cfg_file, "--dataDir", str(tmp), "--model-file",
            weights, "--modelDir", str(out), "--logDir",
            str(tmp / f"log_{key}")], c)
    finally:
        data_pkg.epoch_loader = loader
    decoded = decodes_by_library()
    text = "".join(p.read_text() for p in out.rglob("*_valid.log"))
    m = re.search(r"validate: (\d+) samples in ([\d.]+)s \(([\d.]+) "
                  r"samples/s\)", text)
    check(m is not None, f"{key}: the valid log has no validate line")
    seen, val_s = int(m.group(1)), float(m.group(2))
    check(math.isfinite(perf) and 0.0 <= perf <= 100.0,
          f"{key}: 3DHP perf {perf}")
    calib = re.search(r"loader calibration .*-> (native|pool)", text)
    return dict(perf=perf, seen=seen, validate_s=val_s,
                samples_per_s=float(m.group(3)), wall_s=c["wall_s"],
                decoded=decoded, shares=stats_shares(stats, val_s),
                calibration=calib.group(0) if calib else None,
                counts=dict(c))


def phase_mpi3dhp(res: dict) -> None:
    """The H36M -> 3DHP transfer evaluation through the ``valid`` CLI at
    full width on :func:`make_3dhp_tree`'s tree, with phase 13's FS
    weights and the config as shipped (``TPU.NATIVE_LOADER: auto``,
    which calibrates on the first batch now that the native loader builds
    on the card): every frame through the port's code (its decoder, or
    its native loader), none through OpenCV."""
    import shutil
    import tempfile

    import numpy as np
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.data import fastloader
    from epipolarpose_tpu_torch.data.joints_dataset import JointsDataset
    from epipolarpose_tpu_torch.data.mpi3dhp import H36M_TO_3DHP
    src = ROOT / "experiments/h36m/valid_3dhp_transfer.yaml"
    cfg = load_config(src)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="epk_3dhp_"))
    try:
        ds = make_3dhp_tree(tmp, cfg)
        n = len(ds)
        # perfect predictions in the model's H36M order
        inv = np.argsort(np.asarray(H36M_TO_3DHP))
        perfect = np.stack([np.concatenate([
            r.joints, (r.joints_3d[:, 2] - r.joints_3d[ds.root_idx, 2])[
                :, None]], -1)[inv] for r in ds.records]).astype(np.float32)
        nv, pck = ds.evaluate(cfg, perfect)
        check(pck == 100.0 and nv["AUC"] > 95.0 and nv["MPJPE"] < 0.5,
              f"evaluate on perfect predictions gave {nv}")
        out = valid_3dhp(res, tmp, str(src), "mpi3dhp", res["cli_fs_final"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    c, d = out["counts"], out["decoded"]
    # 'auto' times both routes on the first batch, each CALIBRATION_REPS
    # times, before the run
    calib = (2 * JointsDataset.CALIBRATION_REPS * EVAL_BATCH
             if fastloader.available() else 0)
    check(out["seen"] == n and d["total"] == n + calib and not d["failed"],
          f"{out['seen']} samples validated, {d} frames through the port's "
          f"decoder and loader, {n} records and {calib} calibration decodes")
    check((out["calibration"] is not None) == bool(calib),
          f"calibration line {out['calibration']!r}")
    check(c["softargmax_fwd"] == n // EVAL_BATCH and c["softargmax_bwd"]
          == c["triangulate"] == c["matmul_stats"] == 0,
          f"3DHP valid launched {c}")
    loaded = [m for m in IMAGE_LIBS if m in sys.modules]
    check(not loaded, f"the 3DHP path imported {loaded}")
    res["mpi3dhp"] = dict(perf=out["perf"], samples_per_s=out["samples_per_s"],
                          validate_s=out["validate_s"], wall_s=c["wall_s"],
                          decoded=d, calibration=out["calibration"],
                          perfect=nv, shares=out["shares"])
    log(f"[mpi3dhp] valid_3dhp_transfer.yaml through the valid CLI at "
        f"ResNet-50@256 (flip test, batch {EVAL_BATCH}) on {n} records of "
        f"a 3DHP tree (2048 x 2048 and 1920 x 1080 JPEG frames): PCK3D@150 "
        f"{out['perf']:.3f} with phase 13's FS weights (pixels unrelated to "
        f"the poses); perfect predictions: " + ", ".join(
            f"{k} {v:.4g}" for k, v in nv.items())
        + f"; validation {out['samples_per_s']:.1f} samples/s "
        f"({out['validate_s']:.3f} s; CLI call {c['wall_s']:.2f} s); "
        f"{out['calibration'] or 'no calibration'}; decodes {d} (the "
        f"port's decoder, its loader by scale_num), none through OpenCV; "
        f"soft-argmax launches {c['softargmax_fwd']}; "
        f"{format_shares(out['shares'])}")


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


R152_CONFIG = "h36m/train_fs_r152_384_integral.yaml"
# the remat phase: each mode's first step compared, then REMAT_TIMED
# steps timed after REMAT_WARMUP, then REMAT_TRACED traced; the ddp
# phase: DDP_RANKS ranks of R152_BATCH crops against one process of
# their global batch for DDP_STEPS steps, then DDP_TIMED bf16 steps
# timed after DDP_WARMUP (1 after 1: the smoke's time; 3 after 2 before;
# one step compared, two before, to make room for phases 18 and 28)
R152_BATCH, REMAT_WARMUP, REMAT_TIMED, REMAT_TRACED = 24, 2, 3, 2
DDP_RANKS, DDP_STEPS, DDP_WARMUP, DDP_TIMED = 2, 1, 1, 1
# the CLIs at r152@384 with and without --distributed: 48 records, two
# train steps of 24 and two eval batches
DDP_CLI_SAMPLES = 48
# where phases 21 and 22 run their models and ranks (a CPU rehearsal of
# their control flow sets "cpu")
DEVICE = "cuda"
R152_SIZE = 384


def r152_config(**tpu):
    """``train_fs_r152_384_integral.yaml`` with ``TPU`` overrides."""
    from epipolarpose_tpu_torch.config import load_config
    cfg = load_config(ROOT / "experiments" / R152_CONFIG)
    for k, v in tpu.items():
        cfg.TPU[k] = v
    return cfg


_R152_WEIGHTS: dict = {}


def r152_weights(cfg) -> dict:
    """ResNet-152@384 weights from a seed, the head re-drawn so that the
    joints decode apart and gradients reach the backbone (on the CPU:
    the same bits in every process). Made once a process (its 7-8 s CPU
    init): ``TPU.COMPUTE_DTYPE`` and ``TPU.REMAT`` change no weight."""
    from epipolarpose_tpu_torch.models import get_model
    if not _R152_WEIGHTS:
        model = get_model(cfg, True, torch.Generator().manual_seed(21))
        redraw_head(model, seed=22)
        _R152_WEIGHTS.update(model.state_dict())
    return _R152_WEIGHTS


def r152_batch(n: int) -> dict:
    """A seeded train batch of ``n`` crops at 384 on the card (the same
    bits in every process on the card)."""
    from epipolarpose_tpu_torch.tools.profile_step import seeded_train_batch
    return seeded_train_batch(n, R152_SIZE, 17, 1000.0,
                              torch.Generator(DEVICE).manual_seed(23),
                              DEVICE)


def grads_cpu(model) -> dict:
    return {n: p.grad.detach().cpu() for n, p in model.named_parameters()}


def state_cpu(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def worst_share(got: dict, want: dict, names=None) -> tuple[float, str]:
    """Largest gap over the tensors, each relative to its largest entry."""
    gaps = {k: ((got[k].double() - want[k].double()).abs().max()
                / want[k].double().abs().max().clamp_min(1e-30)).item()
            for k in (names or want)}
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def rel_l2(got: dict, want: dict) -> float:
    """||got - want|| / ||want|| over every tensor of ``want`` at once."""
    num = sum(float((got[k].double() - v.double()).square().sum())
              for k, v in want.items())
    den = sum(float(v.double().square().sum()) for v in want.values())
    return math.sqrt(num / max(den, 1e-300))


def r152_grads_f64(cfg, weights, batch, buffers: dict | None = None
                   ) -> dict:
    """The gradients of one FS step of ``cfg`` on ``batch`` with the model
    in float64 (REMAT on for memory: it changes no value), on the host:
    the oracle a float32 or bf16 step is held to. ``buffers``, when given,
    receives the BN running buffers after that forward (float64)."""
    import warnings
    from epipolarpose_tpu_torch.core.steps import normalize_images
    from epipolarpose_tpu_torch.kernels.softargmax import (
        softmax_integral_plain)
    from epipolarpose_tpu_torch.models import get_model
    from epipolarpose_tpu_torch.ops.integral import generate_integral_target
    from epipolarpose_tpu_torch.ops.losses import integral_l1_loss
    with torch.device(DEVICE):     # its own init on the card: discarded
        model = get_model(cfg, True)
    model.load_state_dict(weights, strict=True)
    model.to(DEVICE).double().train()
    model.dtype, model.remat = torch.float64, True
    x = normalize_images(batch["input"]).permute(0, 3, 1, 2).double()
    z = batch["joints_3d"][..., 2]
    target, tw = generate_integral_target(
        batch["joints"].float(), batch["joints_vis"],
        tuple(float(v) for v in cfg.MODEL.IMAGE_SIZE),
        depth_bound=float(cfg.MODEL.EXTRA.DEPTH_BOUND),
        joints_depth=(z - z[:, :1]).float())
    with warnings.catch_warnings():       # autocast has no float64
        warnings.simplefilter("ignore", UserWarning)
        vol = model(x.contiguous())
    coords = softmax_integral_plain(vol, int(cfg.MODEL.NUM_JOINTS),
                                    int(cfg.MODEL.EXTRA.DEPTH_DIM))
    integral_l1_loss(coords, target.double(), tw.double()).backward()
    out = grads_cpu(model)
    if buffers is not None:
        buffers.update({k: v for k, v in state_cpu(model).items()
                        if "running" in k})
    del model, vol, coords, x
    torch.cuda.empty_cache()
    return out


def traced_steps(step, state, batch, n: int) -> dict:
    """``n`` calls of ``step`` under ``torch.profiler``: the device's busy
    ms a step and idle share (``tools/trace_summary.py``)."""
    import tempfile
    from epipolarpose_tpu_torch.tools.trace_summary import summarize
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            step(state, batch)
        torch.cuda.synchronize()
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        summary = summarize(f.name, 3)
    return {"busy_ms": summary["device_busy_ms"] / n,
            "idle_share": summary["idle_share"]}


def r152_steps(cfg, weights, batch, steps: int, wrap=None,
               timed: int = 0, warmup: int = 0, trace: int = 0) -> dict:
    """``steps`` FS steps of ``cfg`` from ``weights`` on ``batch`` through
    ``make_train_step`` (the forward through ``wrap(model)`` when given):
    the losses, step 1's gradients and the state after it and after the
    last, on the host; then ``warmup`` more steps and ``timed`` steps
    timed (ms a step, peak GB of those), then ``trace`` steps traced
    (the device's busy ms a step and idle share)."""
    from epipolarpose_tpu_torch.core import (create_train_state,
                                             make_train_step)
    from epipolarpose_tpu_torch.models import get_model
    with torch.device(DEVICE):     # its own init on the card: discarded
        model = get_model(cfg, True)
    model.load_state_dict(weights, strict=True)
    state = create_train_state(cfg, model, steps_per_epoch=1000,
                               device=DEVICE)
    step = make_train_step(cfg, wrap(model) if wrap else model, DEVICE)
    out = {"loss": []}
    for k in range(steps):
        _, metrics = step(state, batch)
        out["loss"].append(metrics["loss"].item())
        if k == 0:
            out["grads"], out["state_1"] = grads_cpu(model), state_cpu(model)
    out["state"] = state_cpu(model)
    if timed:
        for _ in range(warmup):
            step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(timed):
            step(state, batch)
        torch.cuda.synchronize()
        out["ms"] = (time.perf_counter() - t0) * 1e3 / timed
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if trace:
        out.update(traced_steps(step, state, batch, trace))
    del step, state, model
    torch.cuda.empty_cache()
    return out


def phase_remat(res: dict) -> None:
    """``TPU.REMAT`` at ResNet-152@384 (batch 24, bf16, Adam): one step
    without and one with, from the same weights on the same batch (the
    loss and BN buffers equal, the gradients no further from a float64
    evaluation than bf16's own distance allows), ms a step and peak
    memory each way; the same step in float32 with deterministic cuDNN
    gives the same bits each way; the soft-argmax kernels against their
    plain versions at this config's shape (24, 17*64, 96, 96)."""
    from epipolarpose_tpu_torch.core.steps import configure_backends
    from epipolarpose_tpu_torch.kernels import softargmax as ksa
    cfg = r152_config()
    check(cfg.TRAIN.BATCH_SIZE == R152_BATCH and not cfg.TPU.REMAT
          and cfg.MODEL.IMAGE_SIZE == [R152_SIZE] * 2
          and cfg.TPU.COMPUTE_DTYPE == "bfloat16"
          and cfg.TRAIN.OPTIMIZER == "adam", "unexpected r152 config")
    configure_backends(cfg)
    weights = r152_weights(cfg)
    batch = r152_batch(R152_BATCH)
    torch.cuda.empty_cache()
    reset_counts()
    runs = {remat: r152_steps(r152_config(REMAT=remat), weights, batch, 1,
                              timed=REMAT_TIMED, warmup=REMAT_WARMUP,
                              trace=REMAT_TRACED)
            for remat in (False, True)}
    res["paths"]["remat"] = launch_counts()
    steps = 2 * (1 + REMAT_WARMUP + REMAT_TIMED + REMAT_TRACED)
    fwd, bwd = ksa.softmax_integral.launches, ksa.softmax_integral_bwd.launches
    exact = r152_grads_f64(cfg, weights, batch)
    # float32, TF32 off, cuDNN deterministic: the recomputed blocks
    # repeat the forward's arithmetic, so one step gives the same bits
    f32 = {}
    for remat in (False, True):
        c32 = r152_config(COMPUTE_DTYPE="float32", REMAT=remat)
        c32.CUDNN.BENCHMARK, c32.CUDNN.DETERMINISTIC = False, True
        configure_backends(c32)
        f32[remat] = r152_steps(c32, weights, batch, 1)
    configure_backends(cfg)
    same32 = [k for k, v in f32[False]["grads"].items()
              if not torch.equal(v, f32[True]["grads"][k])]
    same32 += [k for k, v in f32[False]["state_1"].items()
               if not torch.equal(v, f32[True]["state_1"][k])]
    log(f"[remat] float32, TF32 off, deterministic cuDNN, one step each "
        f"way: loss {f32[False]['loss'][0]:.6f} / {f32[True]['loss'][0]:.6f}"
        f", gradients and state that differ: {len(same32)} "
        f"{same32[:3]}")
    check(f32[False]["loss"] == f32[True]["loss"] and not same32,
          "REMAT changed the float32 step")
    del f32
    check(fwd == steps and bwd == steps, f"soft-argmax kernels launched "
          f"{fwd} / {bwd} times in {steps} steps")
    off, on = runs[False], runs[True]
    dloss = abs(on["loss"][0] - off["loss"][0])
    # in bf16 with cuDNN's autotuned algorithms the recomputation may
    # round otherwise, and this random network's backward amplifies any
    # rounding (bf16 lands far from a float64 evaluation): the gradient
    # with REMAT must be no further from float64 than twice the one
    # without; the exact check is the float32 one above
    gap = rel_l2(on["grads"], off["grads"])
    floor, on_exact = (rel_l2(off["grads"], exact),
                       rel_l2(on["grads"], exact))
    worst, name = worst_share(on["grads"], off["grads"])
    limit = 2 * floor
    moved = [k for k, v in off["state_1"].items()
             if not torch.equal(on["state_1"][k], v)
             and ("running" in k or "num_batches" in k)]
    log(f"[remat] ResNet-152@384 batch {R152_BATCH} bf16 Adam, one step "
        f"each way: loss {off['loss'][0]:.6f} / {on['loss'][0]:.6f} (|d| "
        f"{dloss:.3g}, limit 1e-3 x loss); gradients |d| / |g| {gap:.3g} "
        f"between the two, worst tensor {name} at {worst:.3g} of its "
        f"largest entry; from a float64 evaluation {floor:.3g} without, "
        f"{on_exact:.3g} with (limit {limit:.3g}, twice without); BN "
        f"buffers that differ: {len(moved)}")
    check(math.isfinite(off["loss"][0]) and dloss <= 1e-3 * off["loss"][0],
          "REMAT changed the loss")
    check(on_exact <= limit, "REMAT moved the gradients away from float64")
    check(not moved, f"REMAT changed BN buffers: {moved[:3]}")
    res["remat"] = {str(k): dict(ms=v["ms"], peak_gb=v["peak_gb"],
                                 loss=v["loss"][0], busy_ms=v["busy_ms"],
                                 idle_share=v["idle_share"])
                    for k, v in runs.items()}
    res["remat"].update(grad_gap=gap, grad_f64_without=floor,
                        grad_f64_with=on_exact, worst=worst)
    log(f"[remat] ms a step (mean of {REMAT_TIMED} after "
        f"{1 + REMAT_WARMUP}): without {off['ms']:.2f}, with {on['ms']:.2f} "
        f"(x{on['ms'] / off['ms']:.3f}); peak memory {off['peak_gb']:.2f} "
        f"GB / {on['peak_gb']:.2f} GB; the device busy {off['busy_ms']:.2f}"
        f" / {on['busy_ms']:.2f} ms a step, idle {off['idle_share']:.1%} / "
        f"{on['idle_share']:.1%} ({REMAT_TRACED} steps traced); {fwd} "
        f"forward and {bwd} backward soft-argmax launches")
    del runs, weights, batch
    torch.cuda.empty_cache()
    train_kernels_vs_plain(res, R152_BATCH, 17, 64, 96, 96, path="r152")


def ddp_rank(directory: str) -> int:
    """One rank of phase ``ddp``'s two processes on the one card (``gloo``:
    ``nccl`` refuses two ranks on one device): its slice of the float32
    check's global batch, then the timed bf16 steps; writes
    ``rank<r>.pt`` into ``directory``."""
    from epipolarpose_tpu_torch.core.steps import configure_backends
    from epipolarpose_tpu_torch.data.joints_dataset import host_shard_indices
    from epipolarpose_tpu_torch.parallel import (init_distributed,
                                                 pod_sync, process_index,
                                                 wrap_model)
    import numpy as np
    directory = pathlib.Path(directory)
    init_distributed(DEVICE, init_method=f"file://{directory}/rendezvous",
                     backend="gloo")
    rank = process_index()
    cfg = r152_config(COMPUTE_DTYPE="float32", REMAT=True)
    configure_backends(cfg)
    # the first process's r152_weights, written before the ranks start
    weights = torch.load(directory / "weights.pt", weights_only=True)
    mine = torch.as_tensor(host_shard_indices(
        np.arange(2 * R152_BATCH), rank, DDP_RANKS), device=DEVICE)
    batch = {k: v[mine] for k, v in r152_batch(2 * R152_BATCH).items()}
    reset_counts()
    out = r152_steps(cfg, weights, batch, DDP_STEPS, wrap_model)
    cfg16 = r152_config()
    configure_backends(cfg16)
    pod_sync("timing")
    timed = r152_steps(cfg16, weights, batch, 1, wrap_model,
                       timed=DDP_TIMED, warmup=DDP_WARMUP)
    out.update(ms=timed["ms"], peak_gb=timed["peak_gb"],
               counts=launch_counts())
    torch.save(out, directory / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def phase_ddp(res: dict) -> None:
    """Data parallelism at ResNet-152@384: two ranks sharing the card over
    ``gloo`` against one process on their global batch (float32, TF32 off,
    ``TPU.REMAT`` on for memory), then their bf16 step timed; the
    ``train`` and ``valid`` CLIs with ``--distributed`` under
    ``torch.distributed.run`` (one ``nccl`` rank) against the same runs
    without it; two ``nccl`` ranks where the machine has two cards."""
    import shutil
    import tempfile
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="epk_ddp_"))
    try:
        res["ddp"] = {}
        ddp_ranks_on_one_card(res, tmp)
        ddp_clis(res, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def ddp_ranks_on_one_card(res: dict, tmp: pathlib.Path) -> None:
    import os
    from epipolarpose_tpu_torch.core.steps import configure_backends
    cfg = r152_config(COMPUTE_DTYPE="float32", REMAT=True)
    configure_backends(cfg)
    weights = r152_weights(cfg)
    batch = r152_batch(DDP_RANKS * R152_BATCH)
    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    one = r152_steps(cfg, weights, batch, DDP_STEPS)
    res["paths"]["ddp"] = launch_counts()
    t1 = time.perf_counter()
    exact = r152_grads_f64(cfg, weights, batch)
    t2 = time.perf_counter()
    torch.save(weights, tmp / "weights.pt")
    del batch, weights
    torch.cuda.empty_cache()
    env = dict(os.environ, WORLD_SIZE=str(DDP_RANKS), LOCAL_RANK="0")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--ddp-rank",
         str(tmp)], env=dict(env, RANK=str(r)), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(DDP_RANKS)]
    res["ddp_pids"] = [p.pid for p in procs]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        check(p.returncode == 0,
              f"rank {r} exited {p.returncode}:\n{logs[r][-3000:]}")
    log(f"[ddp] seconds: one process's {DDP_STEPS} steps {t1 - t0:.1f}, "
        f"the float64 gradients {t2 - t1:.1f}, the two rank processes "
        f"{time.perf_counter() - t2:.1f}")
    a, b = (torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(DDP_RANKS))
    differ = [k for k, v in a["state"].items()
              if not torch.equal(v, b["state"][k])]
    check(a["loss"] == b["loss"] and not differ,
          f"the ranks differ: losses {a['loss']} / {b['loss']}, "
          f"{differ[:3]}")
    dloss = abs(a["loss"][0] - one["loss"][0]) / abs(one["loss"][0])
    dloss2 = abs(a["loss"][-1] - one["loss"][-1]) / abs(one["loss"][-1])
    # float32 gradients of this random network are themselves far from a
    # float64 evaluation (torch's batch norm and the global one round
    # differently, and the backward amplifies it): the two ranks' must be
    # no further from it than twice the one process's; a fault of the
    # mean over ranks is O(1) off
    ggap = rel_l2(a["grads"], one["grads"])
    one_exact, two_exact = (rel_l2(one["grads"], exact),
                            rel_l2(a["grads"], exact))
    glimit = 2 * one_exact
    gworst, gname = worst_share(a["grads"], one["grads"])
    bufs = [k for k in one["state_1"] if "running" in k]
    bgap, bname = worst_share(a["state_1"], one["state_1"], bufs)
    pmax = max((a["state"][k] - one["state"][k]).abs().max().item()
               for k in one["grads"])
    lr = float(cfg.TRAIN.LR)
    counts = {k: a["counts"][k] + b["counts"][k] for k in a["counts"]}
    res["paths"]["ddp_ranks"] = counts
    log(f"[ddp] ResNet-152@384 float32 (TF32 off, REMAT on), {DDP_RANKS} "
        f"ranks x {R152_BATCH} on one card over gloo vs one process x "
        f"{DDP_RANKS * R152_BATCH}, {DDP_STEPS} steps: losses "
        + ", ".join(f"{x:.6f}/{y:.6f}" for x, y in zip(a["loss"],
                                                       one["loss"]))
        + f" (relative gap {dloss:.3g} at step 1, limit 1e-5; {dloss2:.3g}"
        f" at step {DDP_STEPS}, limit 1e-3: the weights moved apart by "
        f"Adam's sign on those gradients); step-1 gradients |d| / |g| "
        f"{ggap:.3g} between them (worst tensor {gname} at {gworst:.3g} of "
        f"its largest entry), from a float64 evaluation one process "
        f"{one_exact:.3g}, two ranks {two_exact:.3g} (limit {glimit:.3g}, "
        f"twice the one process's); BN buffers after "
        f"step 1 worst {bname} at {bgap:.3g} of its largest entry (limit "
        f"1e-4); parameters after step {DDP_STEPS} max |d| {pmax:.3g} "
        f"({2 * lr * DDP_STEPS:g} is {DDP_STEPS} Adam step(s) of lr each "
        f"way: the "
        f"sign of near-zero gradients); the ranks equal bit for "
        f"bit; launches {counts['softargmax_fwd']} forward, "
        f"{counts['softargmax_bwd']} backward on the ranks")
    check(dloss <= 1e-5 and dloss2 <= 1e-3,
          "two ranks' losses differ from one process's")
    check(two_exact <= glimit,
          "two ranks' gradients are further from float64 than one's")
    check(bgap <= 1e-4, "two ranks' BN buffers differ from one process's")
    want = DDP_RANKS * (DDP_STEPS + 1 + DDP_WARMUP + DDP_TIMED)
    check(counts["softargmax_fwd"] == want
          and counts["softargmax_bwd"] == want,
          f"rank launches {counts}, expected {want} each")
    single = res["remat"]["False"]
    res["ddp"]["gloo_one_card"] = dict(
        loss_gap=dloss, loss_gap_last=dloss2, grad_gap=ggap,
        grad_f64_one=one_exact, grad_f64_two=two_exact, buffer_gap=bgap,
        param_max=pmax,
        ms=[a["ms"], b["ms"]], peak_gb=[a["peak_gb"], b["peak_gb"]],
        one_rank_ms=single["ms"])
    log(f"[ddp] bf16 step of {R152_BATCH} crops a rank: two ranks sharing "
        f"the card over gloo {a['ms']:.2f} / {b['ms']:.2f} ms (peak "
        f"{a['peak_gb']:.2f} GB a rank) against one process "
        f"{single['ms']:.2f} ms (phase remat): x{a['ms'] / single['ms']:.3f}"
        f" of one rank's step, {a['ms'] - 2 * single['ms']:.2f} ms over "
        f"two such steps")


def torchrun(module: str, argv: list, nproc: int, timeout: float = 300):
    """``python -m torch.distributed.run --standalone`` of a CLI module;
    returns the completed process."""
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", module] + argv,
        capture_output=True, text=True, cwd=ROOT, timeout=timeout)


def ddp_clis(res: dict, tmp: pathlib.Path) -> None:
    import re

    import numpy as np
    from epipolarpose_tpu_torch.scripts import train as train_cli, valid
    paths = res["paths"]
    yaml_path = cli_yaml(tmp / "ddp_r152.yaml", R152_CONFIG, PRINT_FREQ=1,
                         CUDNN={"BENCHMARK": False, "DETERMINISTIC": True})
    common = ["--cfg", yaml_path, "--synthetic", "--samples",
              str(DDP_CLI_SAMPLES), "--device", DEVICE]

    def dirs(name):
        return ["--modelDir", str(tmp / name), "--logDir",
                str(tmp / name / "log")]

    def run_dir(name) -> pathlib.Path:
        found = sorted((tmp / name).glob("*/*/ddp_r152"))
        check(len(found) == 1, f"no single run directory under {name}")
        return found[0]

    c = paths["ddp_cli_train"] = {}
    plain = run_cli(train_cli.main, common + ["--epochs", "1"]
                    + dirs("plain"), c)
    steps = DDP_CLI_SAMPLES // R152_BATCH
    check(plain["state"].step == steps and c["softargmax_bwd"] == steps,
          f"train ran {plain['state'].step} steps, launches {c}")
    t0 = time.perf_counter()
    r = torchrun("epipolarpose_tpu_torch.scripts.train",
                 common + ["--epochs", "1", "--distributed"] + dirs("ddp"), 1)
    train_s = time.perf_counter() - t0
    check(r.returncode == 0, f"train --distributed rc {r.returncode}: "
          f"{r.stderr[-3000:]}")
    text = r.stdout + r.stderr
    check("1 process(es)" in text, "the run did not log its processes")
    found = re.findall(r"epoch 0: loss ([-\d.]+) perf ([-\d.]+)", text)
    check(bool(found), "train --distributed logged no epoch line")
    ddp_ckpt = run_dir("ddp") / "checkpoints"
    plain_ckpt = pathlib.Path(plain["output_dir"]) / "checkpoints"

    def load(path):
        return torch.load(path, map_location="cpu", weights_only=True)

    wd, wp = (load(d / "final_state.pth.tar")["state_dict"]
              for d in (ddp_ckpt, plain_ckpt))
    wmax = max((wd[k].double() - v.double()).abs().max().item()
               for k, v in wp.items())
    pd, pp = (load(d / f"{steps}.pth.tar")["perf"]
              for d in (ddp_ckpt, plain_ckpt))
    log(f"[ddp] train CLI at r152@384, {DDP_CLI_SAMPLES} records, "
        f"{steps} steps, with --distributed (one nccl rank, "
        f"{train_s:.1f} s) and without: loss {found[0][0]} / "
        f"{plain['loss']:.5f}, perf {pd!r} / {pp!r}, final weights max "
        f"|d| {wmax:.3g}")
    check(found[0][0] == f"{plain['loss']:.5f}"
          and abs(pd - pp) <= 1e-5 * abs(pp) and wmax <= 1e-6,
          "train with --distributed differs from the run without")

    c = paths["ddp_cli_valid"] = {}
    vfile = str(plain_ckpt / "final_state.pth.tar")
    vplain = run_cli(valid.main, common + ["--model-file", vfile]
                     + dirs("vplain"), c)
    r = torchrun("epipolarpose_tpu_torch.scripts.valid",
                 common + ["--model-file", vfile, "--distributed"]
                 + dirs("vddp"), 1)
    check(r.returncode == 0, f"valid --distributed rc {r.returncode}: "
          f"{r.stderr[-3000:]}")
    vfound = re.findall(r"perf: ([-\d.]+)", r.stdout + r.stderr)
    check(bool(vfound), "valid --distributed logged no perf")
    preds = [np.load(run_dir(d) / "pred.npz")["preds"]
             for d in ("vddp", "vplain")]
    dpred = float(np.abs(preds[0] - preds[1]).max())
    log(f"[ddp] valid CLI: perf {vfound[-1]} (--distributed) / "
        f"{vplain:.6f}; predictions max |d| {dpred:.3g}; "
        f"{c['softargmax_fwd']} forward launches in process")
    check(vfound[-1] == f"{vplain:.6f}" and dpred <= 1e-4,
          "valid with --distributed differs from the run without")
    res["ddp"]["cli"] = dict(train_loss=plain["loss"], train_perf=pp,
                             weights_max_diff=wmax, valid_perf=vplain,
                             preds_max_diff=dpred)

    cards = torch.cuda.device_count()
    if cards < 2:
        res["ddp"]["nccl_two_ranks"] = f"not run: {cards} card"
        log(f"[ddp] two nccl ranks: not run ({cards} card on this machine)")
        return
    r = torchrun("epipolarpose_tpu_torch.scripts.train",
                 common + ["--epochs", "1", "--distributed"] + dirs("nccl2"),
                 2)
    check(r.returncode == 0, f"two nccl ranks rc {r.returncode}: "
          f"{r.stderr[-3000:]}")
    found = re.findall(r"epoch 0: loss ([-\d.]+) perf ([-\d.]+)",
                       r.stdout + r.stderr)
    check(bool(found) and math.isfinite(float(found[0][0])),
          "two nccl ranks logged no finite loss")
    res["ddp"]["nccl_two_ranks"] = dict(loss=float(found[0][0]),
                                        perf=float(found[0][1]))
    log(f"[ddp] two nccl ranks on two cards ({DDP_CLI_SAMPLES} records, "
        f"global batch {2 * R152_BATCH}): loss {found[0][0]} perf "
        f"{found[0][1]}")


# the spatial phase: a model axis of SPATIAL_RANKS ranks on the one card
# (384 / 2 = 192 rows each) against one process: SPATIAL_BATCH crops in
# the float32 step and the eval step, then the bf16 step of R152_BATCH
# crops (phase remat's) timed after DDP_WARMUP
SPATIAL_RANKS, SPATIAL_BATCH, SPATIAL_TIMED = 2, 4, 2


def spatial_config(**tpu):
    """``train_fs_r152_384_integral.yaml`` on a 1 x SPATIAL_RANKS mesh,
    with ``valid``'s flip test and heatmap shift."""
    cfg = r152_config(**tpu)
    cfg.TPU.MESH.DATA, cfg.TPU.MESH.MODEL = 1, SPATIAL_RANKS
    cfg.TEST.FLIP_TEST = cfg.TEST.SHIFT_HEATMAP = True
    return cfg


def r152_eval_batch(n: int) -> dict:
    """``n`` seeded crops at 384 with boxes, on the card."""
    g = torch.Generator(DEVICE).manual_seed(24)
    return {"input": r152_batch(n)["input"],
            "center": 200 + 600 * torch.rand((n, 2), generator=g,
                                             device=DEVICE),
            "scale": 0.8 + 0.4 * torch.rand((n, 2), generator=g,
                                            device=DEVICE)}


# the final layer's weights times this after the BN calibration: logits
# of std ~7 rather than ~0.5, so that the joints decode apart
EVAL_HEAD_GAIN = 16.0


def r152_eval_weights(cfg, weights, images) -> dict:
    """``weights`` with every batch norm's running statistics set to one
    train-mode forward's batch statistics on ``images`` (momentum 1), and
    the final layer times :data:`EVAL_HEAD_GAIN`. On the init's mean 0
    and variance 1 a random ResNet-152's eval forward grows through its 50
    residual blocks to logits of 1e9 and more, whose decode is one-hot:
    no eval comparison within a tolerance holds on that (a trained
    network's statistics are its data's); calibrated, its volumes are
    near uniform, every joint at the crop centre, until the head is
    sharpened."""
    from epipolarpose_tpu_torch.core.steps import local_crops
    from epipolarpose_tpu_torch.models import get_model
    with torch.device(DEVICE):     # its own init on the card: discarded
        model = get_model(cfg, True)
    model.load_state_dict(weights, strict=True)
    model.train()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    with torch.no_grad():
        model(local_crops(images))
        model.final_layer.weight.mul_(EVAL_HEAD_GAIN)
    out = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    return out


def r152_eval(cfg, weights, batch, prepare=None) -> torch.Tensor:
    """The flip-test eval step's predictions on the host."""
    from epipolarpose_tpu_torch.core import make_eval_step
    from epipolarpose_tpu_torch.models import get_model
    with torch.device(DEVICE):     # its own init on the card: discarded
        model = get_model(cfg, False)
    model.load_state_dict(weights, strict=True)
    if prepare is not None:
        prepare(model)
    preds = make_eval_step(cfg, model, H36M_FLIP_PAIRS, device=DEVICE)(
        batch)["preds"].cpu()
    del model
    torch.cuda.empty_cache()
    return preds


def spatial_rank(directory: str) -> int:
    """One rank of phase ``spatial``: its rows of every crop of the float32
    step (REMAT on, TF32 off) and of the eval step, then the bf16 step of
    R152_BATCH crops timed; writes ``rank<r>.pt`` into ``directory``.
    ``spec.json`` there names the backend (``gloo``: two ranks on the one
    card; ``nccl``: one a card, the float32 step alone)."""
    import os
    from epipolarpose_tpu_torch.core.steps import configure_backends
    from epipolarpose_tpu_torch.models import partition_rows
    from epipolarpose_tpu_torch.parallel import (init_distributed, make_mesh,
                                                 pod_sync, process_index,
                                                 wrap_model)
    directory = pathlib.Path(directory)
    spec = json.loads((directory / "spec.json").read_text())
    init_distributed(DEVICE, init_method=f"file://{directory}/rendezvous",
                     backend=spec["backend"])
    cfg = spatial_config(COMPUTE_DTYPE="float32", REMAT=True)
    make_mesh(cfg)
    configure_backends(cfg)

    def split(model):
        return wrap_model(partition_rows(model))

    # the first process's r152_weights and r152_eval_weights, written
    # before the ranks start
    weights = torch.load(directory / "weights.pt", weights_only=True)
    reset_counts()
    out = r152_steps(cfg, weights, r152_batch(SPATIAL_BATCH), 1, split)
    if spec["backend"] == "gloo":
        out["preds"] = r152_eval(
            cfg, torch.load(directory / "eval_weights.pt", weights_only=True),
            r152_eval_batch(SPATIAL_BATCH), partition_rows)
        cfg16 = spatial_config()
        configure_backends(cfg16)
        pod_sync("timing")
        timed = r152_steps(cfg16, weights, r152_batch(R152_BATCH), 1, split,
                           timed=SPATIAL_TIMED, warmup=DDP_WARMUP)
        out.update(ms=timed["ms"], peak_gb=timed["peak_gb"])
    out.update(counts=launch_counts(), pid=os.getpid())
    torch.save(out, directory / f"rank{process_index()}.pt")
    torch.distributed.destroy_process_group()
    return 0


def spatial_ranks(tmp: pathlib.Path, backend: str, cards: bool) -> list:
    """Run SPATIAL_RANKS ``--spatial-rank`` processes (on one card, or one
    a card) and return their results."""
    import os
    tmp.mkdir()
    (tmp / "spec.json").write_text(json.dumps({"backend": backend}))
    for name in ("weights.pt", "eval_weights.pt"):
        os.link(tmp.parent / name, tmp / name)
    env = dict(os.environ, WORLD_SIZE=str(SPATIAL_RANKS))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--spatial-rank",
         str(tmp)], env=dict(env, RANK=str(r),
                             LOCAL_RANK=str(r if cards else 0)), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(SPATIAL_RANKS)]
    try:
        logs = [p.communicate(timeout=PHASE_LIMITS["spatial"])[0]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        check(p.returncode == 0,
              f"{backend} rank {r} exited {p.returncode}:\n"
              f"{logs[r][-3000:]}")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(SPATIAL_RANKS)]


def phase_spatial(res: dict) -> None:
    """``TPU.MESH.MODEL: 2`` at ResNet-152@384: the image rows of every
    crop split over two ranks sharing the card over ``gloo`` (192 rows
    each, halo exchanges through the host) against one process on the
    same crops: the float32 step (TF32 off, REMAT on), the flip-test eval
    step (the weights' BN statistics calibrated on the eval crops and the
    head sharpened: :func:`r152_eval_weights`), then the ranks' bf16 step timed beside phase
    remat's; one ``nccl`` pair where the machine has two cards."""
    import shutil
    import tempfile
    from epipolarpose_tpu_torch.core.steps import configure_backends
    cfg = spatial_config(COMPUTE_DTYPE="float32", REMAT=True)
    configure_backends(cfg)
    weights = r152_weights(cfg)
    batch = r152_batch(SPATIAL_BATCH)
    one = r152_steps(cfg, weights, batch, 1)
    exact_bufs: dict = {}
    exact = r152_grads_f64(cfg, weights, batch, exact_bufs)
    eval_batch = r152_eval_batch(SPATIAL_BATCH)
    eval_weights = r152_eval_weights(cfg, weights, eval_batch["input"])
    want = r152_eval(cfg, eval_weights, eval_batch)
    del batch, eval_batch
    torch.cuda.empty_cache()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="epk_spatial_"))
    try:
        torch.save(weights, tmp / "weights.pt")
        torch.save(eval_weights, tmp / "eval_weights.pt")
        t0 = time.perf_counter()
        a, b = spatial_ranks(tmp / "gloo", "gloo", cards=False)
        ranks_s = time.perf_counter() - t0
        res["spatial_pids"] = [a["pid"], b["pid"]]
        cards = torch.cuda.device_count()
        nccl = None
        if cards >= SPATIAL_RANKS:
            nccl = spatial_ranks(tmp / "nccl", "nccl", cards=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    differ = [k for k, v in a["state"].items()
              if not torch.equal(v, b["state"][k])]
    differ += [k for k, v in a["grads"].items()
               if not torch.equal(v, b["grads"][k])]
    check(a["loss"] == b["loss"] and not differ
          and torch.equal(a["preds"], b["preds"]),
          f"the ranks differ: losses {a['loss']} / {b['loss']}, "
          f"{differ[:3]}")
    dloss = abs(a["loss"][0] - one["loss"][0]) / abs(one["loss"][0])
    one_exact, two_exact = (rel_l2(one["grads"], exact),
                            rel_l2(a["grads"], exact))
    glimit = 2 * one_exact
    gworst, gname = worst_share(a["grads"], one["grads"])
    # BN buffers: the split convolutions round otherwise, and this random
    # network carries the rounding through 150 layers (its float32
    # gradients are ~10% from float64): held to the float64 forward's
    # buffers, no further than twice the one process's distance or 1e-4
    bufs = sorted(exact_bufs)
    bgap, bname = worst_share(a["state_1"], one["state_1"], bufs)
    b_one, _ = worst_share(one["state_1"], exact_bufs, bufs)
    b_split, b_split_name = worst_share(a["state_1"], exact_bufs, bufs)
    blimit = max(2 * b_one, 1e-4)
    dxy = (a["preds"][..., :2] - want[..., :2]).abs().max().item()
    dz = (a["preds"][..., 2] - want[..., 2]).abs().max().item()
    spread = (want.amax(1) - want.amin(1)).mean(0).tolist()
    # each rank set its counts to 0 before its steps and read them after
    counts = {k: a["counts"][k] + b["counts"][k] for k in a["counts"]}
    res["paths"]["spatial"] = counts
    # a rank: the float32 step, the eval call, then the bf16 steps
    steps = 1 + 1 + DDP_WARMUP + SPATIAL_TIMED
    want_fwd, want_bwd = SPATIAL_RANKS * (steps + 1), SPATIAL_RANKS * steps
    log(f"[spatial] ResNet-152@384 float32 (TF32 off, REMAT on), "
        f"{SPATIAL_BATCH} crops, rows split over {SPATIAL_RANKS} gloo ranks "
        f"on one card ({R152_SIZE // SPATIAL_RANKS} each) vs one process: "
        f"loss {a['loss'][0]:.6f} / {one['loss'][0]:.6f} (relative gap "
        f"{dloss:.3g}, limit 1e-5); gradients from a float64 evaluation: "
        f"one process {one_exact:.3g}, the ranks {two_exact:.3g} (limit "
        f"{glimit:.3g}), worst tensor against one process {gname} at "
        f"{gworst:.3g} of its largest entry; BN buffers against one "
        f"process worst {bname} at {bgap:.3g} of its largest entry, from "
        f"the float64 forward's: one process {b_one:.3g}, the ranks "
        f"{b_split:.3g} ({b_split_name}; limit {blimit:.3g}, twice the one "
        f"process's or 1e-4); the ranks equal bit for bit; "
        f"{ranks_s:.1f} s for the rank processes")
    log(f"[spatial] flip-test eval, {SPATIAL_BATCH} crops: predictions max "
        f"|dxy| {dxy:.3g} px (limit 0.05), |dz| {dz:.3g} mm (limit 0.5) "
        f"against one process; joints spread {spread[0]:.2f} px, "
        f"{spread[1]:.2f} px, {spread[2]:.1f} mm (need ten times the "
        f"limits: 0.5 px, 0.5 px, 5 mm)")
    check(dloss <= 1e-5, "the split step's loss differs from one process's")
    check(two_exact <= glimit,
          "the split step's gradients are further from float64 than one's")
    check(b_split <= blimit,
          "the split step's BN buffers are further from float64 than one's")
    check(spread[0] >= 0.5 and spread[1] >= 0.5 and spread[2] >= 5,
          "joints do not spread; the eval comparison would test nothing")
    check(dxy <= 0.05 and dz <= 0.5, "the split eval step disagrees")
    check(counts["softargmax_fwd"] == want_fwd
          and counts["softargmax_bwd"] == want_bwd,
          f"rank launches {counts}, expected {want_fwd} forward and "
          f"{want_bwd} backward")
    single = res["remat"]["False"]
    res["spatial"] = dict(
        loss_gap=dloss, grad_f64_one=one_exact, grad_f64_split=two_exact,
        grad_worst=gworst, buffer_gap=bgap, buffer_f64_one=b_one,
        buffer_f64_split=b_split, eval_dxy=dxy, eval_dz=dz,
        ms=[a["ms"], b["ms"]], peak_gb=[a["peak_gb"], b["peak_gb"]],
        one_process_ms=single["ms"], ranks_s=ranks_s)
    log(f"[spatial] bf16 step of {R152_BATCH} crops, their rows split over "
        f"two gloo ranks on the card: {a['ms']:.2f} / {b['ms']:.2f} ms (peak "
        f"{a['peak_gb']:.2f} / {b['peak_gb']:.2f} GB a rank) against one "
        f"process's {single['ms']:.2f} ms, {single['peak_gb']:.2f} GB (phase "
        f"remat): x{a['ms'] / single['ms']:.3f}; launches "
        f"{counts['softargmax_fwd']} forward, {counts['softargmax_bwd']} "
        f"backward on the ranks")
    if nccl is None:
        res["spatial"]["nccl_pair"] = f"not run: {cards} card"
        log(f"[spatial] a nccl pair: not run ({cards} card on this machine)")
        return
    n_gap = abs(nccl[0]["loss"][0] - one["loss"][0]) / abs(one["loss"][0])
    n_exact = rel_l2(nccl[0]["grads"], exact)
    res["spatial"]["nccl_pair"] = dict(loss_gap=n_gap, grad_f64=n_exact)
    log(f"[spatial] a nccl pair on two cards: loss relative gap {n_gap:.3g},"
        f" gradients from float64 {n_exact:.3g} (limit {glimit:.3g})")
    check(nccl[0]["loss"] == nccl[1]["loss"] and n_gap <= 1e-5
          and n_exact <= glimit, "the nccl pair differs from one process")


# the fused phase: K and the batches of its checks (two super-batches and
# a tail of one at K 4); its timed windows of super-batches
FUSED_K, FUSED_BATCHES, FUSED_SS_K, FUSED_SS_BATCHES = 4, 9, 2, 5
FUSED_TIMED, FUSED_TRACED = 10, 2
# scripts.train --distributed at K 2: DDP's 11 eager warm-up steps (6
# super-batches), then a graph (14 batches of 32 synthetic records of the
# FS config)
FUSED_DDP_SAMPLES = 448


def deterministic(on: bool) -> None:
    """cuDNN's deterministic algorithms, and no autotuning, or the
    config's own settings back (``configure_backends`` keeps TF32 off)."""
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = not on


def fused_pair(build, template, batches: list, k: int) -> dict:
    """The same steps two ways from the same weights, each on a copy of
    the model ``template``: an eager loop of unfused steps
    (``build(template, 1)``), then the fused step (``build(template,
    k)``) over the batches stacked k at a time (a ragged
    tail as it is). Per step losses, the final model and optimizer state
    on the host, and for the fused run each call's kernel launches and
    the graphs' figures. The launch counters are 0 before the fused run:
    ``launch_counts()`` after it is that path's."""
    from epipolarpose_tpu_torch.data import stack_batches
    out = {}
    for name, kk in (("eager", 1), ("fused", k)):
        model, state, step = build(template, kk)
        losses, calls = [], []
        if kk == 1:
            groups = [b for b in batches]
        else:
            groups = list(stack_batches(iter(batches), kk))
            reset_counts()
        for b in groups:
            before = launch_counts()
            state, metrics = step(state, b)
            loss = metrics["loss"].reshape(-1)
            losses.append(loss)
            if kk > 1:
                after = launch_counts()
                calls.append({c: after[c] - before[c] for c in after})
        torch.cuda.synchronize()
        run = {"loss": torch.cat(losses).float().cpu(),
               "state": state_cpu(model), "step": state.step,
               "moments": {i: {n: v.detach().cpu().clone()
                               for n, v in st.items()}
                           for i, st in
                           state.optimizer.state_dict()["state"].items()}}
        if kk > 1:
            run.update(calls=calls, counts=launch_counts(),
                       graphs=len(step.graphs), replays=step.replays,
                       capture_s=step.capture_s, host_ops=step.host_ops,
                       sizes=[int(g["input"].shape[0]) for g in groups])
        out[name] = run
        del model, state, step
        torch.cuda.empty_cache()
    return out


def check_pair(pair: dict, tag: str, exact: bool) -> dict:
    """The fused run against the eager loop: ``exact`` (float32, TF32 off,
    deterministic cuDNN) the same bits in the losses, the weights and BN
    buffers and Adam's moments; else (bf16) the bounds of the JAX
    package's ``test_fused_matches_k_single_steps``: losses relative
    1e-5, parameters within 3e-3."""
    e, f = pair["eager"], pair["fused"]
    check(e["step"] == f["step"] == len(e["loss"]) == len(f["loss"]),
          f"[{tag}] step counts {e['step']} / {f['step']}")
    check(bool(torch.isfinite(f["loss"]).all()), f"[{tag}] loss not finite")
    loss_rel = ((f["loss"] - e["loss"]).abs()
                / e["loss"].abs().clamp_min(1e-30)).max().item()
    gaps = {k: (f["state"][k].double() - v.double()).abs().max().item()
            for k, v in e["state"].items()}
    worst = max(gaps, key=gaps.get)
    moment_same = all(torch.equal(v, f["moments"][i][n])
                      for i, st in e["moments"].items()
                      for n, v in st.items())
    log(f"[fused] {tag}: {len(f['loss'])} steps in calls of "
        f"{f['sizes']}, {f['graphs']} graphs, {f['host_ops']} host ops, "
        f"capture {f['capture_s']:.2f} s; against the eager loop: losses "
        f"{loss_rel:.3g} relative, weights and buffers max |d| "
        f"{gaps[worst]:.3g} ({worst}), Adam's moments "
        f"{'equal' if moment_same else 'differ'}")
    if exact:
        check(loss_rel == 0.0 and gaps[worst] == 0.0 and moment_same,
              f"[{tag}] float32 fused run is not the eager loop's bits")
    else:
        params = [k for k in e["state"] if "running" not in k
                  and "num_batches" not in k]
        check(loss_rel <= 1e-5, f"[{tag}] losses {loss_rel:.3g} apart")
        check(max(gaps[k] for k in params) <= 3e-3,
              f"[{tag}] parameters {gaps[worst]:.3g} apart")
    return {"loss_rel": loss_rel, "max_abs_diff": gaps[worst],
            "moments_equal": moment_same, "graphs": f["graphs"],
            "host_ops": f["host_ops"], "capture_s": f["capture_s"]}


def check_calls(pair: dict, tag: str, per_step: dict) -> None:
    """Each fused call launched K x (launches a step) of each kernel."""
    f = pair["fused"]
    for size, calls in zip(f["sizes"], f["calls"]):
        for name, n in per_step.items():
            check(calls[name] == size * n,
                  f"[{tag}] a call of {size} steps launched {calls[name]} "
                  f"{name}, not {size} x {n}")


def graph_kernels_vs_plain(res: dict) -> None:
    """The soft-argmax forward (with statistics) and backward kernels and
    the triangulation kernel launched from a CUDA graph's replay, against
    their plain versions on the same inputs (the limits of the train and
    ss phases), and their launch counts a replay."""
    from epipolarpose_tpu_torch.graphs import StepGraph
    from epipolarpose_tpu_torch.kernels import softargmax as ksa
    from epipolarpose_tpu_torch.kernels import triangulate as ktri
    dev = torch.device("cuda")
    n, j, d, h = TRAIN_BATCH, 17, 64, 64
    vol = spread_volume(n, j, d, h, h, seed=81, dtype=torch.bfloat16)
    grad = torch.randn((n, j, 3), generator=torch.Generator(dev)
                       .manual_seed(82), device=dev)
    gmax = grad.abs().max().item()
    ksa.softmax_integral_fwd(vol, j, d)          # warm-up, outside
    graph = StepGraph()
    reset_counts()

    def run():
        coords, stats = ksa.softmax_integral_fwd(vol, j, d)
        return coords, stats, ksa.softmax_integral_bwd(vol, stats, grad)
    coords, stats, dl = graph.capture(run)
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts["softargmax_fwd"] == 3 and counts["softargmax_bwd"] == 3,
          f"graph launches {counts}: not one each for the capture's run "
          f"and each of 2 replays")
    ref_stats = ksa.softmax_integral_stats_plain(vol, j, d)
    fwd_err = (coords - ksa.softmax_integral_plain(vol, j, d)).abs().max()
    size = torch.tensor([h, h, d], device=dev, dtype=torch.float32)
    lse_err = (stats[..., 0] - ref_stats[..., 0]).abs().max().item()
    e_err = ((stats[..., 1:] - ref_stats[..., 1:]).abs() / size).max().item()
    want = ksa.softmax_integral_bwd_plain(vol, stats, grad)
    ratio = ((dl.float() - want.float()).abs()
             / (bf16_spacing(want) + 1e-6 * gmax)).max().item()
    check(fwd_err.item() <= 1e-4 and lse_err <= 1e-3 and e_err <= 1e-4,
          "soft-argmax forward in a graph disagrees with the plain version")
    check(ratio <= 1.0, "soft-argmax backward in a graph disagrees")
    del graph, coords, stats, dl

    # the triangulation kernel at the SS step's 544 points (the rig of
    # phase 6, noisy detections): a replay gives the eager launch's bits
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.geometry.camera import undistort_points
    cfg = load_config(ROOT / "experiments/h36m/train_ss_r50_256_integral.yaml")
    _, _, px = ss_rig_batch(cfg, SS_GROUPS, SS_VIEWS, seed=83)
    cam = ss_rig_batch(cfg, SS_GROUPS, SS_VIEWS, seed=83)[0]["camera"]
    det, w = noisy_detections(px, seed=84)
    pts = undistort_points(det, cam).contiguous()
    P = cam.P.contiguous()
    xe, re_ = ktri.triangulate_fast(pts, P, w)
    graph = StepGraph()
    reset_counts()
    x, r = graph.capture(lambda: ktri.triangulate_fast(pts, P, w))
    graph.replay()
    torch.cuda.synchronize()
    tri_n = launch_counts()["triangulate"]
    tri_same = torch.equal(x, xe) and torch.equal(r, re_)
    tri_err = (x - ktri.triangulate_fast_plain(pts, P, w)[0]).abs().max()
    tri_err = tri_err.item()
    check(tri_n == 2, f"triangulation launches in a graph: {tri_n}, not 2")
    check(tri_same, "triangulation from a graph differs from its eager "
          "launch")
    res["fused_in_graph"] = dict(
        softargmax_fwd_max_abs_err=fwd_err.item(), lse_err=lse_err,
        e_err=e_err, softargmax_bwd_share_of_limit=ratio,
        triangulate_same_bits_as_eager=tri_same,
        triangulate_max_abs_err_plain_mm=tri_err, launches_per_replay=dict(
            softargmax_fwd=1, softargmax_bwd=1, triangulate=1))
    log(f"[fused] kernels from a graph's replays vs plain: soft-argmax "
        f"forward {fwd_err.item():.3g} (limit 1e-4), lse {lse_err:.3g}, "
        f"E {e_err:.3g}; backward at {ratio:.3g} of its limit; "
        f"triangulation the eager launch's bits ({tri_err:.3g} mm from "
        f"plain); one launch each a replay")


def fused_fs(res: dict) -> None:
    """The flagship FS step at K 4: the checks (bf16 and float32) and the
    timed windows through ``train`` at K 1 and K 4, with traces."""
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.core import (create_train_state,
                                             make_train_step, train)
    from epipolarpose_tpu_torch.core.steps import configure_backends
    from epipolarpose_tpu_torch.data import stack_batches
    from epipolarpose_tpu_torch.models import get_model
    from epipolarpose_tpu_torch.tools.profile_step import seeded_train_batch

    cfg = load_config(ROOT / "experiments/h36m/train_fs_r50_256_integral.yaml")
    size, joints = int(cfg.MODEL.IMAGE_SIZE[0]), int(cfg.MODEL.NUM_JOINTS)
    g = torch.Generator("cuda").manual_seed(91)
    batches = [seeded_train_batch(TRAIN_BATCH, size, joints, 1000.0, g,
                                  "cuda") for _ in range(FUSED_BATCHES)]
    paths = res["paths"]

    def template_of(c):
        m = get_model(c, True, torch.Generator().manual_seed(92))
        redraw_head(m, seed=93)
        return m

    def builder(c):
        def build(template, k):
            model = copy.deepcopy(template)
            state = create_train_state(c, model, steps_per_epoch=1000,
                                       device="cuda")
            return model, state, make_train_step(c, model, "cuda",
                                                 fused_steps=k)
        return build

    configure_backends(cfg)
    deterministic(True)
    template = template_of(cfg)
    pair = fused_pair(builder(cfg), template, batches, FUSED_K)
    paths["fused_fs"] = pair["fused"]["counts"]
    out = {"bf16": check_pair(pair, "FS r50@256 bf16 K 4", exact=False)}
    check_calls(pair, "FS", {"softargmax_fwd": 1, "softargmax_bwd": 1})
    f32 = load_config(ROOT / "experiments/h36m/train_fs_r50_256_integral.yaml")
    f32.TPU.COMPUTE_DTYPE = "float32"
    template.dtype = torch.float32       # the same weights, in float32
    pair = fused_pair(builder(f32), template, batches[:5], 2)
    template.dtype = torch.bfloat16
    out["f32"] = check_pair(pair, "FS r50@256 float32 K 2", exact=True)
    del pair

    # timed: train() at K 1 and K 4 with the config's cuDNN settings
    configure_backends(cfg)
    rates = {}
    for k in (1, FUSED_K):
        model, state, step = builder(cfg)(template, k)
        feed = (batches[:1] if k == 1 else
                [next(stack_batches(iter(batches[:k]), k))])
        steps = FUSED_TIMED * FUSED_K
        for _ in range(2):                    # warm-up, then the capture
            state, _ = step(state, feed[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = train(cfg, feed * (steps // k), state, step, 0)
        torch.cuda.synchronize()
        rates[k] = TRAIN_BATCH * steps / (time.perf_counter() - t0)
        trace = traced_steps(step, state, feed[0], FUSED_TRACED * FUSED_K // k)
        rates[f"trace_{k}"] = dict(busy_ms_a_step=trace["busy_ms"] / k,
                                   idle_share=trace["idle_share"])
        if k > 1:
            rates["capture_s"] = step.capture_s
        del model, state, step
        torch.cuda.empty_cache()
    out["samples_per_s"] = {1: rates[1], FUSED_K: rates[FUSED_K]}
    out["trace"] = {1: rates["trace_1"], FUSED_K: rates[f"trace_{FUSED_K}"]}
    out["capture_s"] = rates["capture_s"]
    log(f"[fused] FS r50@256 batch {TRAIN_BATCH} through train(): "
        f"{rates[1]:.1f} samples/s at K 1, {rates[FUSED_K]:.1f} at K "
        f"{FUSED_K} (capture {rates['capture_s']:.2f} s); device busy "
        f"{rates['trace_1']['busy_ms_a_step']:.2f} / "
        f"{rates[f'trace_{FUSED_K}']['busy_ms_a_step']:.2f} ms a step, idle "
        f"{rates['trace_1']['idle_share']:.1%} / "
        f"{rates[f'trace_{FUSED_K}']['idle_share']:.1%} (2 x {FUSED_K} "
        f"unfused steps / 2 replays)")
    res["fused"]["fs"] = out


def fused_ss(res: dict) -> None:
    """The SS step at K 2, ``given`` and ``estimated`` cameras, 32 groups
    x 4 views, noisy detections in the batch; then the given route with
    the random bf16 teacher in the graph; timed steps each way."""
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.core import create_train_state
    from epipolarpose_tpu_torch.core import self_supervised as tss
    from epipolarpose_tpu_torch.core.steps import configure_backends
    from epipolarpose_tpu_torch.data import stack_batches
    from epipolarpose_tpu_torch.models import get_model

    paths = res["paths"]

    def builder(c, teacher):
        def build(template, k):
            model = copy.deepcopy(template)
            state = create_train_state(c, model, steps_per_epoch=1000,
                                       device="cuda")
            return model, state, tss.make_ss_train_step(
                c, model, teacher, device="cuda", fused_steps=k,
                flip_pairs=H36M_FLIP_PAIRS)
        return build

    for cameras in ("given", "estimated"):
        cfg = load_config(ROOT / "experiments/h36m/"
                          "train_ss_r50_256_integral.yaml")
        cfg.TPU.SS_CAMERAS = cameras
        configure_backends(cfg)
        deterministic(True)
        batches = []
        for i in range(FUSED_SS_BATCHES):
            b, _, px = ss_rig_batch(cfg, SS_GROUPS, SS_VIEWS, seed=100 + i,
                                    distortion=cameras == "given")
            det, conf = noisy_detections(px, seed=120 + i, corrupt=False)
            b.update(det_src=det, det_conf=conf)
            batches.append(b)
        if cameras == "given":
            template = get_model(cfg, True, torch.Generator().manual_seed(95))
        build = builder(cfg, None)
        pair = fused_pair(build, template, batches, FUSED_SS_K)
        paths[f"fused_ss_{cameras}"] = pair["fused"]["counts"]
        tag = f"SS {cameras} 32x4 bf16 K {FUSED_SS_K}"
        out = check_pair(pair, tag, exact=False)
        check_calls(pair, tag, {"softargmax_fwd": 1, "softargmax_bwd": 1,
                                "triangulate": 1 if cameras == "given"
                                else 4})
        host_ops = pair["fused"]["host_ops"]
        # estimated: 5 cuSOLVER calls a step run between graph segments
        want_ops = 0 if cameras == "given" else 5 * (FUSED_SS_K + 1)
        check(host_ops == want_ops, f"[{tag}] {host_ops} host ops in the "
              f"graphs, not {want_ops}")
        configure_backends(cfg)
        # timed: 4 replays against 8 eager steps
        times = {}
        for k in (1, FUSED_SS_K):
            model, state, step = build(template, k)
            feed = (batches[0] if k == 1 else
                    next(stack_batches(iter(batches[:k]), k)))
            for _ in range(2):
                state, _ = step(state, feed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(8 // k):
                state, _ = step(state, feed)
            torch.cuda.synchronize()
            times[k] = (time.perf_counter() - t0) * 1e3 / 8
            del model, state, step
            torch.cuda.empty_cache()
        out["ms_a_step"] = times
        log(f"[fused] {tag}: {times[1]:.2f} ms a step eager, "
            f"{times[FUSED_SS_K]:.2f} fused")
        res["fused"][f"ss_{cameras}"] = out

    # the frozen teacher's forward inside the graph (random bf16 weights:
    # every joint under SS_CONF_MIN, so the loss is 0 both ways)
    cfg = load_config(ROOT / "experiments/h36m/train_ss_r50_256_integral.yaml")
    configure_backends(cfg)
    deterministic(True)
    teacher = tss.load_teacher(cfg, "cuda", torch.Generator().manual_seed(96))
    batches = [ss_rig_batch(cfg, SS_GROUPS, SS_VIEWS, seed=130 + i)[0]
               for i in range(3)]
    pair = fused_pair(builder(cfg, teacher), template, batches, FUSED_SS_K)
    paths["fused_ss_teacher"] = pair["fused"]["counts"]
    out = check_pair(pair, "SS given, random teacher in the graph",
                     exact=False)
    check_calls(pair, "SS teacher", {"teacher_decode": 1,
                                     "softargmax_fwd": 1})
    res["fused"]["ss_teacher"] = out
    configure_backends(cfg)


def fused_remat(res: dict) -> None:
    """ResNet-152@384 with REMAT at K 2 (batch 24): the checks, then 4
    replays against 8 eager steps and a trace of 2 replays."""
    cfg = r152_config(REMAT=True)
    from epipolarpose_tpu_torch.core import (create_train_state,
                                             make_train_step)
    from epipolarpose_tpu_torch.core.steps import configure_backends
    from epipolarpose_tpu_torch.data import stack_batches
    from epipolarpose_tpu_torch.models import get_model
    from epipolarpose_tpu_torch.tools.profile_step import seeded_train_batch
    configure_backends(cfg)
    deterministic(True)
    with torch.device("cuda"):     # its own init on the card: discarded
        template = get_model(cfg, True)
    template.load_state_dict(r152_weights(cfg), strict=True)
    g = torch.Generator("cuda").manual_seed(97)
    batches = [seeded_train_batch(R152_BATCH, R152_SIZE, 17, 1000.0, g,
                                  "cuda") for _ in range(FUSED_SS_BATCHES)]

    def build(t, k):
        model = copy.deepcopy(t)
        state = create_train_state(cfg, model, steps_per_epoch=1000,
                                   device="cuda")
        return model, state, make_train_step(cfg, model, "cuda",
                                             fused_steps=k)
    pair = fused_pair(build, template, batches, FUSED_SS_K)
    res["paths"]["fused_remat"] = pair["fused"]["counts"]
    out = check_pair(pair, "r152@384 REMAT bf16 K 2", exact=False)
    check_calls(pair, "REMAT", {"softargmax_fwd": 1, "softargmax_bwd": 1})
    configure_backends(cfg)
    for k in (1, FUSED_SS_K):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()    # the graph's pool included
        model, state, step = build(template, k)
        feed = (batches[0] if k == 1 else
                next(stack_batches(iter(batches[:k]), k)))
        for _ in range(2):
            state, _ = step(state, feed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(8 // k):
            state, _ = step(state, feed)
        torch.cuda.synchronize()
        out[f"ms_a_step_{k}"] = (time.perf_counter() - t0) * 1e3 / 8
        out[f"peak_gb_{k}"] = torch.cuda.max_memory_allocated() / 1e9
        trace = traced_steps(step, state, feed, FUSED_TRACED * FUSED_SS_K // k)
        out[f"busy_ms_{k}"] = trace["busy_ms"] / k
        out[f"idle_share_{k}"] = trace["idle_share"]
        del model, state, step
        torch.cuda.empty_cache()
    log(f"[fused] r152@384 REMAT batch {R152_BATCH}: "
        f"{out['ms_a_step_1']:.2f} ms a step eager, "
        f"{out[f'ms_a_step_{FUSED_SS_K}']:.2f} fused; peak "
        f"{out['peak_gb_1']:.2f} / {out[f'peak_gb_{FUSED_SS_K}']:.2f} GB; "
        f"device busy {out['busy_ms_1']:.2f} / "
        f"{out[f'busy_ms_{FUSED_SS_K}']:.2f} ms a step, idle "
        f"{out['idle_share_1']:.1%} / {out[f'idle_share_{FUSED_SS_K}']:.1%}")
    res["fused"]["remat"] = out


def fused_clis(res: dict, tmp: pathlib.Path) -> None:
    """``scripts.valid`` at K 4 against K 1 (the same predictions), and
    ``scripts.train --distributed`` on one ``nccl`` rank at K 2 against
    the same run in process (the same loss, perf and weights)."""
    import re

    import numpy as np
    from epipolarpose_tpu_torch.scripts import train as train_cli, valid
    paths = res["paths"]
    out = {}
    runs = {}
    for k in (1, FUSED_K):
        y = cli_yaml(tmp / f"valid_k{k}.yaml", "h36m/valid_r50_256_integral"
                     ".yaml", TPU={"FUSED_STEPS": k},
                     CUDNN={"BENCHMARK": False, "DETERMINISTIC": True})
        c = paths["fused_valid" if k > 1 else "fused_valid_eager"] = {}
        perf = run_cli(valid.main, ["--cfg", y, "--synthetic", "--samples",
                                    str(EVAL_BATCH * FUSED_BATCHES),
                                    "--modelDir", str(tmp / f"v{k}"),
                                    "--logDir", str(tmp / f"v{k}" / "log")],
                       c)
        found = sorted((tmp / f"v{k}").glob("*/*/*/pred.npz"))
        check(len(found) == 1, f"no single pred.npz under v{k}")
        runs[k] = (perf, np.load(found[0])["preds"], c)
    dpred = float(np.abs(runs[1][1] - runs[FUSED_K][1]).max())
    c = runs[FUSED_K][2]
    log(f"[fused] valid CLI, {EVAL_BATCH * FUSED_BATCHES} records in "
        f"batches of {EVAL_BATCH} at K {FUSED_K} / 1: perf "
        f"{runs[FUSED_K][0]:.6f} / {runs[1][0]:.6f}, predictions max |d| "
        f"{dpred:.3g}; {c['softargmax_fwd']} forward launches, "
        f"{c['wall_s']:.1f} s / {runs[1][2]['wall_s']:.1f} s")
    check(runs[FUSED_K][1].shape == runs[1][1].shape and dpred <= 1e-4
          and abs(runs[FUSED_K][0] - runs[1][0]) <= 1e-5 * abs(runs[1][0]),
          "fused valid differs from the unfused run")
    check(c["softargmax_fwd"] == FUSED_BATCHES,
          f"fused valid launched {c['softargmax_fwd']} forwards")
    out["valid"] = dict(perf=runs[FUSED_K][0], preds_max_diff=dpred)

    y = cli_yaml(tmp / "ddp_fused.yaml", "h36m/train_fs_r50_256_integral"
                 ".yaml", TPU={"FUSED_STEPS": FUSED_SS_K}, PRINT_FREQ=1,
                 CUDNN={"BENCHMARK": False, "DETERMINISTIC": True})
    common = ["--cfg", y, "--synthetic", "--samples",
              str(FUSED_DDP_SAMPLES), "--epochs", "1"]
    c = paths["fused_cli_train"] = {}
    plain = run_cli(train_cli.main, common + [
        "--modelDir", str(tmp / "tp"), "--logDir", str(tmp / "tp" / "log")],
        c)
    steps = FUSED_DDP_SAMPLES // TRAIN_BATCH
    check(plain["state"].step == steps and c["softargmax_bwd"] == steps,
          f"fused train CLI ran {plain['state'].step} steps, launches {c}")
    r = torchrun("epipolarpose_tpu_torch.scripts.train", common + [
        "--distributed", "--modelDir", str(tmp / "td"), "--logDir",
        str(tmp / "td" / "log")], 1)
    check(r.returncode == 0, f"fused train --distributed rc {r.returncode}: "
          f"{r.stderr[-3000:]}")
    text = r.stdout + r.stderr
    found = re.findall(r"epoch 0: loss ([-\d.]+) perf ([-\d.]+)", text)
    check(bool(found), "fused train --distributed logged no epoch line")
    wd = torch.load(sorted((tmp / "td").glob(
        "*/*/*/checkpoints/final_state.pth.tar"))[0], map_location="cpu",
        weights_only=True)["state_dict"]
    wp = torch.load(pathlib.Path(plain["output_dir"]) / "checkpoints" /
                    "final_state.pth.tar", map_location="cpu",
                    weights_only=True)["state_dict"]
    wmax = max((wd[k].double() - v.double()).abs().max().item()
               for k, v in wp.items())
    log(f"[fused] train CLI at K {FUSED_SS_K}, {FUSED_DDP_SAMPLES} records, "
        f"{steps} steps, with --distributed (one nccl rank, DDP: 11 eager "
        f"steps, then graphs) and without: loss {found[0][0]} / "
        f"{plain['loss']:.5f}, perf {found[0][1]} / {plain['perf']:.3f}, "
        f"final weights max |d| {wmax:.3g}")
    check(abs(float(found[0][0]) - plain["loss"]) <= 1e-5 * abs(plain["loss"])
          + 1e-5 and wmax <= 3e-3,
          "fused train with --distributed differs from the run without")
    out["ddp_cli"] = dict(loss=plain["loss"], ddp_loss=float(found[0][0]),
                          weights_max_diff=wmax)
    res["fused"]["clis"] = out


def phase_fused(res: dict) -> None:
    """``TPU.FUSED_STEPS``: K steps a call as one CUDA-graph replay, held
    against the eager loop (module docstring, phase 23)."""
    import shutil
    import tempfile
    res["fused"] = {}
    graph_kernels_vs_plain(res)
    fused_fs(res)
    fused_ss(res)
    fused_remat(res)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_fused_"))
    try:
        fused_clis(res, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        deterministic(False)


# export and user-tool phases: the serving artifact, then the user's tools
EXPORT_BATCHES = (1, 8, 64)
# the eval phase's bound (0.05 px in x, y and 0.5 mm in z at source scale)
# in normalized units: over the largest un-crop factor, 256 px x
# 1.2 * 200 / 256, and over z's 2000 mm a unit
EXPORT_XY_TOL = 0.05 / (256 * 1.2 * 200 / 256)
EXPORT_Z_TOL = 0.5 / 2000.0
SERVE_CODE = """
import json, sys, torch
from epipolarpose_tpu_torch.tools.export_model import load_exported
from epipolarpose_tpu_torch.kernels import softargmax as ksa
# cuDNN's deterministic algorithms and no TF32, as the smoke's process
# serves the same batch: the same bits
torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
artifact = load_exported(sys.argv[1])
x = torch.load(sys.argv[2]).cuda()
y = artifact(x)
torch.cuda.synchronize()
torch.save(y.cpu(), sys.argv[3])
print(json.dumps({"modules": sorted(m for m in sys.modules
                                    if m.startswith("epipolarpose")),
                  "launches": ksa.softmax_integral.launches,
                  "device": str(artifact.device)}))
"""
# the modules a process that serves an artifact may import: the op's
# module (and its packages, build helper and counters' registry) and the
# loader's
SERVE_MODULES = ["epipolarpose_tpu_torch", "epipolarpose_tpu_torch.kernels",
                 "epipolarpose_tpu_torch.kernels._build",
                 "epipolarpose_tpu_torch.kernels.softargmax",
                 "epipolarpose_tpu_torch.telemetry",
                 "epipolarpose_tpu_torch.tools",
                 "epipolarpose_tpu_torch.tools.export_model"]


def phase_export(res: dict) -> None:
    """The serving artifact (``tools/export_model.py``) at the flagship
    eval config (module docstring, phase 24)."""
    import shutil
    import tempfile
    from epipolarpose_tpu_torch import graphs
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.core.steps import (configure_backends,
                                                   make_eval_step,
                                                   normalize_images)
    from epipolarpose_tpu_torch.kernels.softargmax import (
        softmax_integral, softmax_integral_plain)
    from epipolarpose_tpu_torch.models import get_model
    from epipolarpose_tpu_torch.tools import export_model as tex
    from epipolarpose_tpu_torch.tools.profile_step import time_ms

    dev = torch.device("cuda")
    cfg = load_config(ROOT / "experiments/h36m/valid_r50_256_integral.yaml")
    check(cfg.TPU.COMPUTE_DTYPE == "bfloat16"
          and cfg.MODEL.EXTRA.DEPTH_DIM == 64, "unexpected flagship config")
    configure_backends(cfg)
    j, d = int(cfg.MODEL.NUM_JOINTS), int(cfg.MODEL.EXTRA.DEPTH_DIM)
    model = get_model(cfg, False, torch.Generator().manual_seed(0)).to(dev)
    redraw_head(model, seed=5)       # joints decode apart (phase eval)
    data = SmokeH36M(1, 8, 256, j, seed=6)
    step = make_eval_step(cfg, model, H36M_FLIP_PAIRS, device="cuda")
    before = step(data.batches[0])["preds"].clone()
    # as in a process whose first use of ImageNet's statistics is the
    # export: graphs.constant must not cache the fake tensors it traces
    graphs._constants.clear()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="epk_export_"))
    try:
        t0 = time.perf_counter()
        program = tex.export_model(cfg, model, batch_size=-1, device=dev)
        export_s = time.perf_counter() - t0
        path = tmp / "model.pt2"
        mb = tex.save_exported(program, str(path), dev, cfg)
        ins, outs = tex.specs(program)
        check(ins[0].endswith(", 256, 256, 3]") and outs[0].endswith(
            f", {j}, 3]"), f"specs {ins} -> {outs}")
        ops = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
        check(ops.count("epipolarpose.softmax_integral.default") == 1,
              "the program does not call the registered soft-argmax op "
              "once")
        log(f"[export] ResNet-50@256 J=17 D=64 bf16, symbolic batch: "
            f"exported in {export_s:.1f} s, {mb:.1f} MB, in {ins}, out "
            f"{outs}")

        # a fresh process that imports torch and the op's module only
        x8 = torch.rand((8, 256, 256, 3),
                        generator=torch.Generator().manual_seed(7))
        torch.save(x8, tmp / "x.pt")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", SERVE_CODE, str(path),
                            str(tmp / "x.pt"), str(tmp / "y.pt")],
                           capture_output=True, text=True, cwd=ROOT,
                           timeout=180)
        sub_s = time.perf_counter() - t0
        check(r.returncode == 0, f"serving process failed:\n"
              f"{r.stderr[-3000:]}")
        sub = json.loads(r.stdout.strip().splitlines()[-1])
        check(sub["modules"] == SERVE_MODULES,
              f"the serving process imported {sub['modules']}")
        check(sub["launches"] == 1 and sub["device"] == "cuda",
              f"serving process: {sub}")
        log(f"[export] a fresh process loaded and served batch 8 in "
            f"{sub_s:.1f} s (one kernel launch), importing only "
            f"{sub['modules']}")

        artifact = tex.load_exported(str(path))
        g = torch.Generator(dev).manual_seed(8)
        inputs = {n: torch.rand((n, 256, 256, 3), generator=g, device=dev)
                  for n in EXPORT_BATCHES}
        inputs[8] = x8.to(dev)
        reset_counts()
        served = {n: artifact(x) for n, x in inputs.items()}
        torch.cuda.synchronize()
        res["paths"]["export"] = counts = launch_counts()
        check(counts["softargmax_fwd"] == len(EXPORT_BATCHES)
              and counts["softargmax_bwd"] == 0,
              f"{len(EXPORT_BATCHES)} served calls launched {counts}")

        def eager(x, decode):
            with torch.inference_mode():
                out = model(normalize_images(x).permute(0, 3, 1, 2)
                            .contiguous())
                return decode(out, j, d)
        worst = {"xy": 0.0, "z": 0.0}
        for n, x in inputs.items():
            got = served[n]
            check(tuple(got.shape) == (n, j, 3)
                  and bool(torch.isfinite(got).all()),
                  f"batch {n}: served {tuple(got.shape)}, not finite")
            ref = eager(x, softmax_integral_plain)
            worst["xy"] = max(worst["xy"], (got[..., :2] - ref[..., :2])
                              .abs().max().item())
            worst["z"] = max(worst["z"],
                             (got[..., 2] - ref[..., 2]).abs().max().item())
        spread = (ref.amax(1) - ref.amin(1)).mean(0).tolist()
        # the other process's batch 8 against this one's with the same
        # cuDNN settings: with the head re-drawn the volumes are sharp, so
        # another conv algorithm's bf16 rounding moves a joint by cells
        deterministic(True)
        try:
            served_det = artifact(inputs[8])
        finally:
            deterministic(False)
        sub_y = torch.load(tmp / "y.pt").to(dev)
        sub_err = (sub_y - served_det).abs().max().item()
        log(f"[export] served batches {list(EXPORT_BATCHES)} vs the eager "
            f"model + plain decode: max |dxy| {worst['xy']:.3g}, |dz| "
            f"{worst['z']:.3g} normalized (limits {EXPORT_XY_TOL:.3g}, "
            f"{EXPORT_Z_TOL:.3g}: phase eval's 0.05 px and 0.5 mm); the "
            f"other process's batch 8 within {sub_err:.3g} of this one's "
            f"(deterministic cuDNN both); joints spread "
            f"{spread[0]:.3f} / {spread[1]:.3f} / {spread[2]:.3f}")
        check(min(spread) > 0.02, "joints do not spread: the comparison "
              "would test nothing")
        check(worst["xy"] <= EXPORT_XY_TOL and worst["z"] <= EXPORT_Z_TOL,
              "the served program and the eager path disagree")
        check(sub_err <= EXPORT_XY_TOL,
              "the other process's served batch differs from this one's")

        x64 = inputs[64]
        served_ms = time_ms(lambda: artifact(x64), dev)
        eager_ms = time_ms(lambda: eager(x64, softmax_integral), dev)
        with torch.inference_mode():
            vol = model(normalize_images(x64).permute(0, 3, 1, 2)
                        .contiguous())
        op_ms = time_ms(lambda: torch.ops.epipolarpose.softmax_integral(
            vol, j, d), dev)
        direct_ms = time_ms(lambda: softmax_integral(vol, j, d), dev)
        log(f"[export] batch 64: served {served_ms:.3f} ms, eager forward + "
            f"kernel decode {eager_ms:.3f} ms; the soft-argmax at "
            f"{tuple(vol.shape)}: as the registered op {op_ms:.4f} ms, "
            f"through softmax_integral {direct_ms:.4f} ms")

        # the eager eval step after the export: real tensors, as before
        after = step(data.batches[0])["preds"]
        check(type(after) is torch.Tensor and after.device.type == "cuda",
              f"eval step after the export gave {type(after).__name__}")
        check(torch.equal(after, before),
              "eval step after the export differs from before it")
        res["export"] = dict(
            mb=mb, export_s=export_s, subprocess_s=sub_s, inputs=ins,
            outputs=outs, max_dxy=worst["xy"], max_dz=worst["z"],
            served_ms_b64=served_ms, eager_ms_b64=eager_ms,
            op_ms=op_ms, direct_ms=direct_ms,
            launches=counts["softargmax_fwd"])
        log("[export] the eager eval step after the export: real tensors, "
            "equal to its predictions before it")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_user_tools(res: dict) -> None:
    """The user's tools on the card (module docstring, phase 25)."""
    import shutil
    import tempfile
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="epk_tools_"))
    try:
        user_dualcrop(res)
        user_export_torch(res, tmp)
        user_prepare_h36m(res, tmp)
        user_notebook(res, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loaded = [m for m in IMAGE_LIBS if m in sys.modules]
    check(not loaded, f"the user's tools imported {loaded}")


def user_dualcrop(res: dict) -> None:
    from epipolarpose_tpu_torch.tools import dualcrop_headroom
    reset_counts()
    t0 = time.perf_counter()
    out = dualcrop_headroom.main([
        "--preset", "ci", "--device", "cuda", "--cfg",
        str(ROOT / "experiments/h36m/train_ss_r50_256_integral.yaml")])
    wall = time.perf_counter() - t0
    A, B = out["A"], out["B"]
    lb, lc = B["launches"]["B"], B["launches"]["C"]
    res["paths"]["dualcrop_B"], res["paths"]["dualcrop_C"] = lb, lc
    floors = (B["floor_full"], B["floor_half"], B["floor_half_ft"])
    check(all(math.isfinite(f) for f in floors), f"floors {floors}")
    check(all(B["device"][s] > 0 and math.isfinite(B["loss"][s])
              for s in (1.0, 0.5)), f"SS steps {B}")
    check(lb["triangulate"] == lb["teacher_decode"] == 3
          and lb["softargmax_fwd"] == lb["matmul_stats"] == 0,
          f"part B launched {lb}")
    # C: 1 + 2 SS steps at each scale, a teacher decode, a triangulation
    # and a soft-argmax forward and backward each
    check(lc["triangulate"] == lc["softargmax_fwd"] == lc["softargmax_bwd"]
          == lc["teacher_decode"] == 6 and lc["matmul_stats"] == 0,
          f"part C launched {lc}")
    total = launch_counts()
    check(all(total[k] == lb[k] + lc[k] for k in total),
          f"the tool launched {total} in all, parts B and C {lb}, {lc}")
    check(A[1.0]["bytes_per_img"] == 2 * 64 * 64 * 3
          and A[0.5]["bytes_per_img"] == (32 * 32 + 64 * 64) * 3,
          f"part A shipped {A}")
    check("native loader: one" in A["route"] or A["decodes"] > 0,
          f"part A: route {A['route']}, {A['decodes']} port decodes")
    res["dualcrop_ci"] = dict(A=A, B={k: v for k, v in B.items()},
                              wall_s=wall)
    log(f"[user_tools] dualcrop_headroom --preset ci in {wall:.1f} s; part "
        f"A route: {A['route']} ({A['decodes']} port decodes); launches B "
        f"{lb}, C {lc}\n{out['table']}")


def user_export_torch(res: dict, tmp: pathlib.Path) -> None:
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.core import create_train_state
    from epipolarpose_tpu_torch.core.checkpoint import CheckpointManager
    from epipolarpose_tpu_torch.models import get_model
    from epipolarpose_tpu_torch.tools import export_torch
    yaml = ROOT / "experiments/h36m/valid_r50_256_integral.yaml"
    cfg = load_config(yaml)
    model = get_model(cfg, False, torch.Generator().manual_seed(3))
    state = create_train_state(cfg, model, 10, "cuda")
    CheckpointManager(str(tmp / "checkpoints"), best_mode="min").save(
        5, state, 0, 50.0)
    out = tmp / "reference.pth.tar"
    t0 = time.perf_counter()
    written = export_torch.main(["--cfg", str(yaml), "--model-file",
                                 str(tmp / "checkpoints" / "latest"),
                                 "--out", str(out)])
    wall = time.perf_counter() - t0
    fresh = get_model(cfg, False, torch.Generator().manual_seed(4))
    sd = torch.load(out, map_location="cpu", weights_only=True)["state_dict"]
    fresh.load_state_dict(sd, strict=True)
    want = state.model.state_dict()
    bad = [k for k, v in fresh.state_dict().items()
           if not torch.equal(v, want[k].cpu())]
    check(not bad and sorted(written) == sorted(want),
          f"export_torch: entries differ {bad[:5]}")
    log(f"[user_tools] export_torch: a latest save (model, Adam, schedule) "
        f"-> {out.stat().st_size / 1e6:.1f} MB reference .pth.tar in "
        f"{wall:.1f} s, loaded back strict, {len(sd)} entries equal")


def user_prepare_h36m(res: dict, tmp: pathlib.Path) -> None:
    from epipolarpose_tpu_torch.tools import prepare_h36m
    raw = [{"img_path": f"S9/img_{i:06d}.jpg", "c": [500.0, 400.0],
            "s": 2.1, "joint_img": [[10.0 + i, 20.0, 0.5]] * 17,
            "joint_cam": [[1.0, 2.0, 3000.0]] * 17, "s_id": 9,
            "act_id": 2, "subact_id": 1, "cam_id": "54138969",
            "image_id": i} for i in range(4)]
    (tmp / "raw.json").write_text(json.dumps(raw))
    written = prepare_h36m.main(["--train-annot", str(tmp / "raw.json"),
                                 "--valid-annot", str(tmp / "raw.json"),
                                 "--out", str(tmp / "annot")])
    annots = json.loads(pathlib.Path(written["train.json"]).read_text())
    check(sorted(written) == ["train.json", "valid.json"] and len(annots) == 4
          and annots[3]["frame"] == 3 and annots[0]["scale"] == [2.1, 2.1],
          f"prepare_h36m wrote {written}: {annots[:1]}")
    try:
        import h5py  # noqa: F401
        have_h5py = True
    except ImportError:
        have_h5py = False
    if have_h5py:
        import numpy as np
        with h5py.File(tmp / "cameras.h5", "w") as f:
            g = f.create_group("subject9/camera1")
            g["Name"] = np.frombuffer("54138969".encode("utf-16-le"),
                                      np.uint16)
            for k, v in dict(R=np.eye(3), T=np.zeros(3), f=np.ones(2),
                             c=np.ones(2), k=np.zeros(3),
                             p=np.zeros(2)).items():
                g[k] = v
        cams = prepare_h36m.main(["--cameras-h5", str(tmp / "cameras.h5"),
                                  "--out", str(tmp / "annot")])
        got = json.loads(pathlib.Path(cams["cameras.json"]).read_text())
        check(list(got) == ["9:54138969"], f"cameras.json {got}")
        h5 = "cameras.h5 converted"
    else:
        try:
            prepare_h36m.main(["--cameras-h5", str(tmp / "cameras.h5"),
                               "--out", str(tmp / "annot")])
            check(False, "--cameras-h5 ran without h5py")
        except ImportError as exc:
            check("h5py" in str(exc), f"the refusal does not name h5py: "
                  f"{exc}")
        h5 = "no h5py here: --cameras-h5 refused, naming it"
    log(f"[user_tools] prepare_h36m: train/valid json of 4 records; {h5}")


def user_notebook(res: dict, tmp: pathlib.Path) -> None:
    cells = [c for c in json.loads((ROOT / "demo_torch.ipynb").read_text())
             ["cells"] if c["cell_type"] == "code"]
    out_dir = tmp / "demo_out"
    sources = ["".join(c["source"]).replace(
        "OUT = 'demo_out'", f"OUT = {str(out_dir)!r}") for c in cells]
    check("DEVICE = 'cuda'" in sources[0]
          and "valid_r50_256_integral.yaml" in sources[0],
          "the notebook's first cell does not set the card and the flagship")
    scope: dict = {"__name__": "demo_torch"}
    reset_counts()
    t0 = time.perf_counter()
    for i, src in enumerate(sources):
        exec(compile(src, f"demo_torch.ipynb cell {i + 1}", "exec"), scope)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res["paths"]["notebook"] = counts = launch_counts()
    preds = scope["preds"]
    check(preds.shape == (17, 3) and bool(torch.isfinite(
        torch.as_tensor(preds)).all()), f"notebook preds {preds.shape}")
    check(counts["softargmax_fwd"] == 1, f"the notebook launched {counts}")
    sizes = [pathlib.Path(f).stat().st_size for f in scope["figures"]]
    check(len(sizes) == 2 and min(sizes) > 0, f"figures {sizes}")
    log(f"[user_tools] demo_torch.ipynb: 3 code cells on cuda at the "
        f"flagship config in {wall:.1f} s, one soft-argmax launch, PNGs "
        f"{sizes} bytes")


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
    ranks = res.get("ddp_pids", []) + res.get("spatial_pids", [])
    alive = [pid for pid in ranks if pathlib.Path(f"/proc/{pid}").exists()]
    check(len(ranks) == DDP_RANKS + SPATIAL_RANKS and not alive,
          f"phases ddp's and spatial's rank processes {ranks}: still "
          f"there {alive}")
    stop_worker_server()
    left = wait_for_no_processes(set())
    check(not left, f"processes still running after stop_worker_server: "
          f"{left}")
    res["processes"] = dict(server=server, tracker=tracker)
    log(f"[processes] none left, phases ddp's and spatial's ranks (pids "
        f"{ranks}) among them; the worker server (pid {server}) and its resource "
        f"tracker (pid {tracker}) stopped")


# ------------------------------------------- the native loader (phase 28)
# the frames timed: the three dataset sizes and the progressive twin of
# the 2048 x 2048 frame
NATIVE_FRAMES = JPEG_FRAMES + ("3dhp_studio_progressive_2048x2048.jpg",)
NATIVE_SCALES, NATIVE_REPS = (8, 4, 3, 2, 1), 5
# the loader alone on the 3DHP tree with its boxes grown x3 (a shrink
# past 4: 2/8), batches timed
NATIVE_BOX_GAIN, NATIVE_BOX_BATCHES = 3.0, 4
# the SS dual crop: H36M frames (each the 1000 x 1000 fixture), 4 views,
# two batches of 32 groups at each teacher scale, the loader timed over
# NATIVE_SS_PASSES passes of them (the median's rate)
NATIVE_SS_FRAMES, NATIVE_SS_SCALES = 2 * SS_GROUPS, (1.0, 0.5)
NATIVE_SS_PASSES = 3


def native_build(res: dict) -> dict:
    """The port's native loader built on this host with no libjpeg:
    ``jpeglib.h`` is not on the compiler's path, the source and flags
    name no libjpeg, the library links none; the build is not allowed to
    fail (the datasets would quietly take the pool route). Its seconds
    are those of a fresh build of the same command (phase 19 built the
    library in use)."""
    import subprocess
    import tempfile
    from epipolarpose_tpu_torch.data import fastloader
    probe = subprocess.run(["g++", "-x", "c++", "-fsyntax-only", "-"],
                           input="#include <cstdio>\n#include <jpeglib.h>\n",
                           text=True, capture_output=True)
    check(fastloader.available(), f"native loader: {fastloader.build_error()}")
    with tempfile.TemporaryDirectory(prefix="epk_loader_build_") as tmp:
        t0 = time.perf_counter()
        fresh = subprocess.run(fastloader._LIB.command(
            "g++", pathlib.Path(tmp) / "libfastloader.so"),
            capture_output=True, text=True)
        build_s = time.perf_counter() - t0
    check(fresh.returncode == 0, f"a fresh build failed: {fresh.stderr}")
    lib = fastloader.library_path()
    check(lib.is_relative_to(ROOT / "epipolarpose_tpu_torch"),
          f"the loader was built at {lib}")
    flags = " ".join(fastloader.CXX_FLAGS + fastloader.LD_FLAGS)
    sources = fastloader.SOURCE.read_text() + "".join(
        p.read_text() for p in fastloader._LIB.includes)
    check("jpeg" not in flags and "jpeglib" not in sources,
          f"the loader's build names libjpeg: {flags}")
    ldd = subprocess.run(["ldd", str(lib)], capture_output=True,
                         text=True).stdout
    check("libjpeg" not in ldd, f"the loader links libjpeg: {ldd}")
    return dict(build_s=build_s, jpeglib_h=probe.returncode == 0,
                links=sorted(ln.split()[0] for ln in ldd.splitlines()
                             if ln.strip()))


def native_fixtures() -> dict:
    """Every fixture at 8/8 and at each scale of its manifest entry
    through the port's decoder against libjpeg-turbo's sha256, and the
    3/8 ones through the loader's exact 3/8 crop as well."""
    import hashlib

    import numpy as np
    from epipolarpose_tpu_torch.data import fastloader, jpeg
    checked = 0
    third = np.array([[[0.375, 0.0, -0.3125], [0.0, 0.375, -0.3125]]],
                     np.float32)
    for name, entry in jpeg_manifest().items():
        buf = (JPEG_FIXTURES / name).read_bytes()
        want = {"8": entry["rgb_sha256"], **entry["scaled_rgb_sha256"]}
        for s, digest in want.items():
            rgb = jpeg.decode(buf, int(s))
            check(hashlib.sha256(rgb.tobytes()).hexdigest() == digest,
                  f"{name} at {s}/8: the decode differs from "
                  f"libjpeg-turbo's")
            checked += 1
            if s == "3":
                crop = fastloader.decode_warp_batch(
                    [buf], third, (rgb.shape[1], rgb.shape[0]))[0]
                check(np.array_equal(crop, rgb),
                      f"{name}: the loader's 3/8 crop is not the 3/8 decode")
    return dict(files=len(jpeg_manifest()), hashes=checked)


def native_frame_ms() -> dict:
    """ms a decode (median of NATIVE_REPS after one) of each frame at each
    scale, one thread."""
    from epipolarpose_tpu_torch.data import jpeg
    out = {}
    for name in NATIVE_FRAMES:
        buf = (JPEG_FIXTURES / name).read_bytes()
        out[name] = {}
        for s in NATIVE_SCALES:
            jpeg.decode(buf, s)
            times = []
            for _ in range(NATIVE_REPS):
                t = time.perf_counter()
                jpeg.decode(buf, s)
                times.append((time.perf_counter() - t) * 1e3)
            out[name][s] = sorted(times)[len(times) // 2]
    return out


def native_valid(res: dict) -> dict:
    """Phase 19's tree through the ``valid`` CLI with ``TPU.NATIVE_LOADER``
    true, then false (the pool route), in this run; then the loader alone
    on that tree with its boxes grown NATIVE_BOX_GAIN times."""
    import shutil
    import tempfile

    import numpy as np
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.data import fastloader
    src = "h36m/valid_3dhp_transfer.yaml"
    cfg = load_config(ROOT / "experiments" / src)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="epk_native_"))
    out = {}
    try:
        ds = make_3dhp_tree(tmp, cfg)
        n = len(ds)
        for key, native in (("native_valid", True), ("pool_valid", False)):
            cfg_file = cli_yaml(tmp / f"{key}_3dhp.yaml", src,
                                TPU={"NATIVE_LOADER": native})
            r = out[key] = valid_3dhp(res, tmp, cfg_file, key,
                                      res["cli_fs_final"])
            d, c = r["decoded"], r["counts"]
            want = (dict(jpeg=0, native_total=n) if native
                    else dict(jpeg=n, native_total=0))
            check(r["seen"] == n and d["jpeg"] == want["jpeg"]
                  and sum(d["native"].values()) == want["native_total"]
                  and not d["failed"] and r["calibration"] is None,
                  f"{key}: {r['seen']} samples, decodes {d}, expected "
                  f"{want}")
            check(c["softargmax_fwd"] == n // EVAL_BATCH
                  and c["softargmax_bwd"] == c["triangulate"] == 0,
                  f"{key} launched {c}")
        # the loader alone, larger boxes: a scaled decode
        ds.cfg.TPU.NATIVE_LOADER = True
        for rec in ds.records:
            rec.scale = rec.scale * np.float32(NATIVE_BOX_GAIN)
        idx = list(range(EVAL_BATCH))
        ds.get_batch(idx)
        fastloader.reset_counts()
        t0 = time.perf_counter()
        for b in range(NATIVE_BOX_BATCHES):
            batch = ds.get_batch(list(range(b * EVAL_BATCH,
                                            (b + 1) * EVAL_BATCH)))
        dt = time.perf_counter() - t0
        scales = fastloader.decode_counts()
        check(batch["input"].shape == (EVAL_BATCH, 256, 256, 3)
              and not scales["failed"]
              and sum(scales["scale"].values()) == NATIVE_BOX_BATCHES
              * EVAL_BATCH and 8 not in scales["scale"],
              f"boxes x{NATIVE_BOX_GAIN}: decodes {scales}")
        out["boxes_x3"] = dict(img_s=NATIVE_BOX_BATCHES * EVAL_BATCH / dt,
                               scales=scales["scale"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def native_ss(res: dict, runs) -> dict:
    """A few SS steps of ``train_ss_r50_256_integral.yaml`` (a random
    bf16 teacher, its confidence gate ``TPU.SS_CONF_MIN`` at 0 so that
    its detections are trained on) fed by
    ``H36MDataset._dual_batch_native`` through ``view_batches``: for each
    ``(frame, scales, key, passes)`` of ``runs``, a tree whose frames are
    that file, at each teacher scale of ``scales``, the loader's rate the
    median of ``passes`` passes: loader img/s (student images counted),
    the steps' launches (path ``<key>_<scale>``) and losses, every decode
    through the loader. One model, teacher and state serve every run."""
    import shutil
    import tempfile

    import epipolarpose_tpu_torch.data.h36m as h36m_mod
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.core import create_train_state
    from epipolarpose_tpu_torch.core import self_supervised as tss
    from epipolarpose_tpu_torch.core.steps import configure_backends
    from epipolarpose_tpu_torch.data.synthetic import write_synthetic_h36m
    from epipolarpose_tpu_torch.models import get_model
    from epipolarpose_tpu_torch.tools.dualcrop_headroom import _to_device
    cfg = load_config(ROOT / "experiments/h36m/train_ss_r50_256_integral.yaml")
    check(int(cfg.TRAIN.BATCH_SIZE) == SS_GROUPS, "unexpected SS config")
    configure_backends(cfg)
    cfg.DATASET.SUBSAMPLE = 1
    cfg.TPU.NATIVE_LOADER = True
    cfg.MODEL.PRETRAINED = ""              # a random teacher
    cfg.TPU.SS_CONF_MIN = 0.0
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="epk_native_ss_"))
    orig = h36m_mod.CAMERA_IDS
    out = {}
    try:
        h36m_mod.CAMERA_IDS = ("0", "1", "2", "3")
        gen = torch.Generator().manual_seed(71)
        model = get_model(cfg, True, gen)
        teacher = tss.load_teacher(cfg, "cuda", gen)
        state = create_train_state(cfg, model, steps_per_epoch=100,
                                   device=torch.device("cuda"))
        for frame, scales, key, passes in runs:
            tree = tmp / key
            write_synthetic_h36m(str(tree), cfg, num_frames=NATIVE_SS_FRAMES,
                                 jpeg=frame.read_bytes())
            ds = h36m_mod.H36MDataset(cfg, str(tree), "train", is_train=True)
            for scale in scales:
                cfg.TPU.SS_TEACHER_SCALE = scale
                step = tss.make_ss_train_step(cfg, state.model, teacher,
                                              device=torch.device("cuda"),
                                              flip_pairs=ds.flip_pairs)
                reset_decodes()
                times = []
                for _ in range(passes):
                    t0 = time.perf_counter()
                    batches = list(ds.view_batches(SS_GROUPS, seed=3,
                                                   augment=True))
                    times.append(time.perf_counter() - t0)
                load_s = sorted(times)[len(times) // 2]
                d = decodes_by_library()
                views = len(h36m_mod.CAMERA_IDS)
                check(len(batches) == NATIVE_SS_FRAMES // SS_GROUPS
                      and d["jpeg"] == 0 and not d["failed"]
                      and d["total"] == passes * NATIVE_SS_FRAMES * views,
                      f"{key} at teacher scale {scale}: {len(batches)} "
                      f"batches, decodes {d}")
                side = int(cfg.MODEL.IMAGE_SIZE[0] * scale)
                check(batches[0]["input"].shape[-3:-1] == (side, side)
                      and batches[0]["input_aug"].shape[-3:-1] == (256, 256),
                      f"crops {batches[0]['input'].shape}, "
                      f"{batches[0]['input_aug'].shape}")
                path_key = f"{key}_{scale}"
                reset_counts()
                losses = []
                for b in batches:
                    b.pop("joints_3d", None)
                    state, m = step(state, _to_device(b, torch.device("cuda")))
                    losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                c = res["paths"][path_key] = launch_counts()
                steps = len(batches)
                check(c["softargmax_fwd"] == c["softargmax_bwd"]
                      == c["triangulate"] == c["teacher_decode"] == steps
                      and c["matmul_stats"] == 0,
                      f"{path_key}: {steps} steps launched {c}")
                check(all(math.isfinite(v) and v > 0 for v in losses),
                      f"losses {losses}")
                out[path_key] = dict(
                    frame=frame.name, scale=scale,
                    img_s=steps * SS_GROUPS * views / load_s,
                    scales=d["native"], losses=losses, launches=dict(c))
    finally:
        h36m_mod.CAMERA_IDS = orig
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def native_modes(res: dict, ss: dict) -> dict:
    """The files of ``tests/data/jpeg/modes`` through the port's loader on
    this host: each through its manifest's affines (8/8 to 1/8) against
    the JAX loader's crop hashes recorded there, failing only where that
    loader failed (the CMYK/YCCK files, a mode its libjpeg refuses, named
    as such), the truncated ones decoded with libjpeg's fill, the
    4x4-subsampled frames counted at 3/8; then the arithmetic-coded and
    block-smoothed twins of the 2048 x 2048 frame as phase 19's tree
    through the ``valid`` CLI with ``TPU.NATIVE_LOADER`` true; and of
    :func:`native_ss`'s runs ``ss``, the two SS steps fed from the
    arithmetic twin (both soft-argmax kernels and
    ``epk_triangulate_split`` a step)."""
    import shutil
    import tempfile

    import numpy as np
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.data import fastloader
    manifest = modes_manifest()
    crops = fails = warned = 0
    third = {}
    for name, e in manifest.items():
        affines = np.asarray(e["loader_affines"], np.float32)
        fastloader.reset_counts()
        out = fastloader.decode_warp_batch(
            [(JPEG_MODES / name).read_bytes()] * len(affines), affines,
            (24, 24))
        got = [rgb_sha(c) for c in out]
        check(got == e["loader_crop_sha256"],
              f"{name}: the loader's crops differ from the JAX loader's")
        d = fastloader.decode_counts()
        want_fail = len(affines) if e["loader"] == "fails" else 0
        check(d["failed"] == d["unsupported"] == want_fail,
              f"{name}: failures {d}")
        crops += len(affines)
        fails += d["failed"]
        warned += d["warned"]
        if name.startswith("s4x4_"):
            third[name] = d["scale"].get(3, 0)
            check(third[name] == 1, f"{name}: scales {d['scale']}")
    src = "h36m/valid_3dhp_transfer.yaml"
    cfg = load_config(ROOT / "experiments" / src)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="epk_modes_valid_"))
    try:
        ds = make_3dhp_tree(tmp, cfg, [JPEG_MODES / f for f in MODE_TWINS])
        n = len(ds)
        cfg_file = cli_yaml(tmp / "modes_3dhp.yaml", src,
                            TPU={"NATIVE_LOADER": True})
        valid = valid_3dhp(res, tmp, cfg_file, "modes_valid",
                           res["cli_fs_final"])
        d, c = valid["decoded"], valid["counts"]
        check(valid["seen"] == n and d["jpeg"] == 0 and not d["failed"]
              and sum(d["native"].values()) == n,
              f"modes valid: {valid['seen']} samples, decodes {d}")
        check(c["softargmax_fwd"] == n // EVAL_BATCH, f"modes valid "
              f"launched {c}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    twin = ss["native_ss_arith_1.0"]
    c = twin["launches"]
    check(c["triangulate_split"] == c["softargmax_bwd"] > 0,
          f"the SS steps on the arithmetic twin launched {c}")
    return dict(files=len(manifest), crops=crops, failed=fails,
                warned=warned, third=third,
                valid={f: valid[f] for f in ("samples_per_s", "validate_s",
                                            "perf", "decoded", "shares")},
                ss=twin)


def phase_native_loader(res: dict) -> None:
    """The port's native loader on the card's host (module docstring,
    phase 28)."""
    import os
    build = native_build(res)
    fixtures = native_fixtures()
    ms = native_frame_ms()
    valid = native_valid(res)
    ss = native_ss(res, [
        (JPEG_FIXTURES / JPEG_FRAMES[2], NATIVE_SS_SCALES, "native_ss",
         NATIVE_SS_PASSES),
        (JPEG_MODES / MODE_TWINS[0], (1.0,), "native_ss_arith", 1)])
    modes = native_modes(res, ss)
    loaded = [m for m in IMAGE_LIBS if m in sys.modules]
    check(not loaded, f"the native loader's paths imported {loaded}")
    left = wait_for_no_processes(set(), seconds=5.0)
    check(not left, f"processes still running: {left}")
    nv, pv = valid["native_valid"], valid["pool_valid"]
    res["native_loader"] = dict(build=build, fixtures=fixtures, ms=ms,
                                valid={k: {f: v[f] for f in (
                                    "samples_per_s", "validate_s", "perf",
                                    "decoded", "shares")} for k, v in
                                    (("native", nv), ("pool", pv))},
                                boxes_x3=valid["boxes_x3"], ss=ss,
                                modes=modes)
    log(f"[native_loader] built in {build['build_s']:.2f} s with no "
        f"libjpeg (jpeglib.h {'found' if build['jpeglib_h'] else 'absent'} "
        f"on this host; links {', '.join(build['links'])}); "
        f"{fixtures['hashes']} hashes of {fixtures['files']} fixtures met "
        f"at 8/8 and their scales; ms a decode, one thread, at "
        f"{'/'.join(map(str, NATIVE_SCALES))} eighths: " + "; ".join(
            f"{k} " + " / ".join(f"{v[s]:.2f}" for s in NATIVE_SCALES)
            for k, v in ms.items())
        + f" ({os.cpu_count()} CPUs)")
    for key, r in (("native", nv), ("pool", pv)):
        log(f"[native_loader] 3DHP valid, TPU.NATIVE_LOADER "
            f"{key == 'native'}: {r['samples_per_s']:.1f} samples/s "
            f"({r['validate_s']:.3f} s), PCK3D@150 {r['perf']:.3f}; decodes "
            f"{r['decoded']}; the decode (host upstream_wait_s) "
            f"{r['shares']['host']['upstream_wait_s']:.1%} of the "
            f"validation; {format_shares(r['shares'])}")
    log(f"[native_loader] the loader alone, boxes x{NATIVE_BOX_GAIN}: "
        f"{valid['boxes_x3']['img_s']:.1f} img/s, scale_num histogram "
        f"{valid['boxes_x3']['scales']}")
    mv = modes["valid"]
    log(f"[native_loader] modes: {modes['crops']} crops of {modes['files']} "
        f"files of tests/data/jpeg/modes equal the JAX loader's ("
        f"{modes['failed']} failures, all CMYK/YCCK, as there; "
        f"{modes['warned']} decodes with libjpeg's fill of truncated data; "
        f"the 4x4-subsampled frames at 3/8 {modes['third']}); the "
        f"arithmetic and block-smoothed 2048 x 2048 twins as the 3DHP tree "
        f"through valid: {mv['samples_per_s']:.1f} samples/s, decodes "
        f"{mv['decoded']}; SS on the arithmetic twin: loader "
        f"{modes['ss']['img_s']:.1f} img/s, scale_num histogram "
        f"{modes['ss']['scales']}, launches {modes['ss']['launches']}")
    for key, r in ss.items():
        log(f"[native_loader] {key}: SS dual crop at teacher scale "
            f"{r['scale']} from {r['frame']}: loader {r['img_s']:.1f} img/s (student "
            f"images), scale_num histogram {r['scales']}; "
            f"{len(r['losses'])} SS steps, losses " + ", ".join(
                f"{v:.4f}" for v in r["losses"]) + f"; launches "
            f"{r['launches']}")


# ---------------------------------- images that are not JPEG (phase 29)
IMAGE_FIXTURES = ROOT / "tests" / "data" / "images"
PNG_FRAME, PNG_REPS, PNG_THREADS = 2048, 5, (1, 8)
# the TIFF frame's strips: this many rows, one band repeated
TIFF_STRIP_ROWS = 64
# the H36M trees: frames x 4 views = one eval batch of 64
IMAGE_H36M_FRAMES = 16


def image_fixture_reads() -> dict:
    """Every file of ``tests/data/images`` through ``imread`` from a path
    and from a ``zip@`` member: the manifest's sha256 of OpenCV's BGR
    image (``cv2.imread`` and ``cv2.imdecode``), IOError where OpenCV
    gives none, ImageTooLarge where it raises; the files the port leaves
    to OpenCV raise NeedsOpenCV with the manifest's reason (not read:
    this host has no OpenCV). Returns the outcomes counted."""
    import tempfile
    import zipfile

    sys.path.insert(0, str(ROOT / "tests"))
    import image_fixtures

    from epipolarpose_tpu_torch.data import imgformats, zipreader
    manifest = json.loads((IMAGE_FIXTURES / "manifest.json").read_text())
    outcomes = {"image": 0, "none": 0, "too_large": 0, "needs_opencv": 0}
    kinds: dict = {}
    with tempfile.TemporaryDirectory(prefix="epk_images_") as tmp:
        archive = pathlib.Path(tmp) / "images.zip"
        with zipfile.ZipFile(archive, "w") as z:
            for name in manifest:
                z.write(IMAGE_FIXTURES / name, name)
        for name, e in manifest.items():
            buf = (IMAGE_FIXTURES / name).read_bytes()
            kind = imgformats.sniff(buf)
            kinds[kind] = kinds.get(kind, 0) + 1
            if e["needs_opencv"]:
                what = image_fixtures.needs_opencv(buf)
                check(what == e["needs_opencv"], f"{name}: {what}")
                outcomes["needs_opencv"] += 1
                continue
            for path, key in ((str(IMAGE_FIXTURES / name), "imread_sha256"),
                              (f"{archive}@/{name}", "imdecode_sha256")):
                try:
                    got = rgb_sha(zipreader.imread(path))
                except imgformats.ImageTooLarge:
                    got = "raises"
                except IOError:
                    got = None
                check(got == e[key], f"{path}: {got} is not OpenCV's "
                      f"{e[key]}")
                outcomes[{None: "none", "raises": "too_large"}.get(
                    got, "image")] += 1
    check(kinds.keys() == {"png", "pnm", "bmp", "tiff", "jpeg"},
          f"the fixtures' formats {kinds}")
    return dict(outcomes, files_by_format=kinds)


def png_frame_ms() -> dict:
    """The 2048 x 2048 frame, written here as PNG with filter types 0-4 row
    by row and with Paeth on every row: its bits back, ms a decode
    (median and min of PNG_REPS, split into the inflate and the native
    pass), and frames/s on PNG_THREADS threads."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    sys.path.insert(0, str(ROOT / "tests"))
    import image_fixtures
    from epipolarpose_tpu_torch.data import png
    img = image_fixtures.smooth_frame(PNG_FRAME, PNG_FRAME, seed=29)
    out = {}
    for key, filters in (("filters_0_4", (0, 1, 2, 3, 4)), ("paeth", (4,))):
        buf = image_fixtures.png_bytes(img, 2, 8, filters=filters)
        got, orientation = png.decode(buf)
        check(orientation == 1 and np.array_equal(got, img),
              f"the {key} PNG frame does not decode to its pixels")
        runs = []
        for _ in range(PNG_REPS):
            times = {}
            t = time.perf_counter()
            png.decode(buf, times=times)
            runs.append(((time.perf_counter() - t) * 1e3,
                         times["inflate_ms"], times["native_ms"]))
        runs.sort()
        r = out[key] = dict(bytes=len(buf), ms=runs[len(runs) // 2][0],
                            min_ms=runs[0][0],
                            inflate_ms=runs[len(runs) // 2][1],
                            native_ms=runs[len(runs) // 2][2])
        if key == "filters_0_4":
            work = [buf] * 16
            for n in PNG_THREADS:
                with ThreadPoolExecutor(n) as pool:
                    t = time.perf_counter()
                    list(pool.map(png.decode, work))
                    r[f"frames_per_s_{n}"] = len(work) / (
                        time.perf_counter() - t)
    return out


def tiff_frame_ms() -> dict:
    """A 2048 x 2048 TIFF in strips of TIFF_STRIP_ROWS rows, each the
    same band of the smooth frame (so that the LZW writer here codes one
    strip), as LZW with Predictor 2 and as Deflate (Adobe) with Predictor
    2: its bits back, ms a decode (median and min of PNG_REPS, split into
    the directory walk and the strips), and frames/s on PNG_THREADS
    threads."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    sys.path.insert(0, str(ROOT / "tests"))
    import image_fixtures
    from epipolarpose_tpu_torch.data import tiff
    band = image_fixtures.smooth_frame(TIFF_STRIP_ROWS, PNG_FRAME, seed=29)
    img = np.tile(band, (PNG_FRAME // TIFF_STRIP_ROWS, 1, 1))
    out = {}
    for key, compression in (("lzw_predictor2", 5),
                              ("deflate_predictor2", 32946)):
        one = image_fixtures.tiff_bytes(band, 8, 2, compression=compression,
                                        predictor=2)
        strip = one[8:8 + image_fixtures._strip_counts(one)[0]]
        buf = image_fixtures.tiff_bytes(
            img, 8, 2, compression=compression, predictor=2,
            rows_per_strip=TIFF_STRIP_ROWS,
            chunks=[strip] * (PNG_FRAME // TIFF_STRIP_ROWS))
        got, orientation = tiff.decode(buf)
        check(orientation == 1 and np.array_equal(got, img),
              f"the {key} TIFF frame does not decode to its pixels")
        runs = []
        for _ in range(PNG_REPS):
            times = {}
            t = time.perf_counter()
            tiff.decode(buf, times=times)
            runs.append(((time.perf_counter() - t) * 1e3,
                         times["directory_ms"], times["decode_ms"]))
        runs.sort()
        r = out[key] = dict(bytes=len(buf), strips=PNG_FRAME
                            // TIFF_STRIP_ROWS, ms=runs[len(runs) // 2][0],
                            min_ms=runs[0][0],
                            directory_ms=runs[len(runs) // 2][1],
                            decode_ms=runs[len(runs) // 2][2])
        work = [buf] * 8
        for n in PNG_THREADS:
            with ThreadPoolExecutor(n) as pool:
                t = time.perf_counter()
                list(pool.map(tiff.decode, work))
                r[f"frames_per_s_{n}"] = len(work) / (time.perf_counter() - t)
    return out


def png_portrait(tmp: pathlib.Path) -> str:
    """Phase 18's orientation-6 photo (40 x 24 as stored) as a PNG with
    an eXIf chunk of orientation 6."""
    sys.path.insert(0, str(ROOT / "tests"))
    import image_fixtures
    from epipolarpose_tpu_torch.data import jpeg
    rgb = jpeg.decode((JPEG_MODES / PORTRAIT).read_bytes(), flavour="opencv")
    exif = image_fixtures.png_chunk(
        b"eXIf", image_fixtures.tiff_orientation_block(6, "II"))
    path = tmp / "portrait_exif6_40x24.png"
    path.write_bytes(image_fixtures.png_bytes(rgb, 2, 8, filters=(1, 4),
                                              before_idat=[exif]))
    return str(path)


def h36m_png_valid(res: dict, tmp: pathlib.Path) -> dict:
    """A synthetic H36M tree whose frames are the 1000 x 1000 JPEG and
    its twins whose frames are that JPEG's pixels as PNG (written by
    ``utils/vis.py::write_png``) and as TIFF (LZW, Predictor 2, strips of
    16 rows; the fixtures' writer), each through the ``valid`` CLI on the
    pool route (``TPU.NATIVE_LOADER`` false) with phase 13's FS weights:
    the predictions equal bit for bit; every frame through the port's
    JPEG, PNG or TIFF decoder, none through OpenCV."""
    import numpy as np
    import epipolarpose_tpu_torch.data.h36m as h36m_mod
    sys.path.insert(0, str(ROOT / "tests"))
    import image_fixtures
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.data import jpeg, png, tiff, zipreader
    from epipolarpose_tpu_torch.data.synthetic import write_synthetic_h36m
    from epipolarpose_tpu_torch.scripts import valid
    from epipolarpose_tpu_torch.utils.vis import write_png
    src = "h36m/valid_r50_256_integral.yaml"
    cfg = load_config(ROOT / "experiments" / src)
    frame = (JPEG_FIXTURES / JPEG_FRAMES[2]).read_bytes()
    png_file = tmp / "frame.png"
    pixels = jpeg.decode(frame, flavour="opencv")
    write_png(str(png_file), pixels)
    tiff_bytes = image_fixtures.tiff_bytes(pixels, 8, 2, compression=5,
                                           predictor=2, rows_per_strip=16)
    out, preds = {}, {}
    evaluate = h36m_mod.H36MDataset.evaluate

    def keep(self, cfg, p, *a, **k):                # the CLI's predictions
        preds[key] = np.array(p)
        return evaluate(self, cfg, p, *a, **k)
    h36m_mod.H36MDataset.evaluate = keep
    try:
        for key, kind in (("image_formats_jpeg", "jpeg"),
                          ("image_formats_png", "png"),
                          ("image_formats_tiff", "tiff")):
            data = tmp / key
            tree = data / cfg.DATASET.ROOT
            write_synthetic_h36m(str(tree), cfg,
                                 num_frames=IMAGE_H36M_FRAMES,
                                 camera_ids=h36m_mod.CAMERA_IDS, jpeg=frame)
            if kind == "png":
                _replace_frames(tree, png_file.read_bytes())
            if kind == "tiff":
                _replace_frames(tree, tiff_bytes, ".tif")
            cfg_file = cli_yaml(data / "valid.yaml", src,
                                DATASET={"SUBSAMPLE": 1},
                                TPU={"NATIVE_LOADER": False})
            reset_decodes()
            png.reset_count()
            tiff.reset_count()
            zipreader.reset_route_counts()
            c = res["paths"][key] = {}
            t0 = time.perf_counter()
            perf = run_cli(valid.main, [
                "--cfg", cfg_file, "--dataDir", str(data), "--model-file",
                res["cli_fs_final"], "--modelDir", str(data / "out"),
                "--logDir", str(data / "log")], c)
            n = len(preds[key])
            out[key] = dict(perf=perf, records=n, wall_s=time.perf_counter()
                            - t0, routes=zipreader.route_counts(),
                            jpeg=jpeg.decode_count(), png=png.decode_count(),
                            tiff=tiff.decode_count(),
                            launches=c["softargmax_fwd"])
            want = {"jpeg": 0, "png": 0, "pnm": 0, "bmp": 0, "tiff": 0,
                    "opencv": 0}
            want[kind] = n
            # a TIFF's strips are not JPEGs: no JPEG decode for them
            decodes = {k: (n if k == kind else 0)
                       for k in ("jpeg", "png", "tiff")}
            check(n == 4 * IMAGE_H36M_FRAMES and out[key]["routes"] == want
                  and all(out[key][k] == v for k, v in decodes.items()),
                  f"{key}: {n} records, decodes {out[key]}")
            check(c["softargmax_fwd"] == n // EVAL_BATCH and
                  c["softargmax_bwd"] == c["triangulate"] == 0,
                  f"{key} launched {c}")
    finally:
        h36m_mod.H36MDataset.evaluate = evaluate
    a = preds["image_formats_jpeg"]
    check(np.isfinite(a).all(), "the JPEG tree's predictions")
    for key in ("image_formats_png", "image_formats_tiff"):
        b = preds[key]
        check(a.shape == b.shape and np.array_equal(a, b),
              f"the {key} tree's predictions differ from the JPEG tree's")
    return out


def _replace_frames(tree: pathlib.Path, frame_bytes: bytes,
                 suffix: str = ".png") -> None:
    """Replace every frame of a synthetic H36M tree's zip with the given
    bytes (a PNG or a TIFF), named with ``suffix``, and point the
    annotations at them."""
    import zipfile
    zpath = tree / "images" / "S1.zip"
    with zipfile.ZipFile(zpath) as z:
        names = z.namelist()
    with zipfile.ZipFile(zpath, "w") as z:
        for name in names:
            z.writestr(name[:-4] + suffix, frame_bytes)
    for annot in (tree / "annot").glob("*.json"):
        text = annot.read_text()
        if ".jpg" in text:
            annot.write_text(text.replace(".jpg\"", suffix + "\""))


def phase_image_formats(res: dict) -> None:
    """Images that are not JPEG on the card's host (module docstring,
    phase 29)."""
    import shutil
    import tempfile

    from epipolarpose_tpu_torch.data import png
    t0 = time.perf_counter()
    check(png.available(), f"PNG decoder: {png.build_error()}")
    load_s = time.perf_counter() - t0          # built at its first use
    reads = image_fixture_reads()
    ms = png_frame_ms()
    tiff_ms = tiff_frame_ms()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="epk_image_formats_"))
    try:
        portrait = portrait_demo(res, str(tmp), png_portrait(tmp),
                                 "png_portrait_demo")
        trees = h36m_png_valid(res, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loaded = [m for m in IMAGE_LIBS if m in sys.modules]
    check(not loaded, f"the image formats' paths imported {loaded}")
    res["image_formats"] = dict(load_s=load_s, reads=reads, ms=ms,
                                tiff_ms=tiff_ms, portrait=portrait,
                                trees=trees)
    log(f"[image_formats] tests/data/images through imread from a path "
        f"and a zip member: {reads} (OpenCV's image or refusal each time, "
        f"no OpenCV on this host); PNG decoder {png.LIBRARY.library_path()} "
        f"ready in {load_s:.2f} s")
    for key, r in ms.items():
        log(f"[image_formats] {PNG_FRAME} x {PNG_FRAME} PNG, {key} "
            f"({r['bytes']} bytes): {r['ms']:.2f} ms a decode (min "
            f"{r['min_ms']:.2f}; inflate {r['inflate_ms']:.2f}, native pass "
            f"{r['native_ms']:.2f})" + "".join(
                f", {n} threads {r[f'frames_per_s_{n}']:.2f} frames/s"
                for n in PNG_THREADS if f"frames_per_s_{n}" in r))
    for key, r in tiff_ms.items():
        log(f"[image_formats] {PNG_FRAME} x {PNG_FRAME} TIFF, {key} "
            f"({r['bytes']} bytes, {r['strips']} strips): {r['ms']:.2f} ms "
            f"a decode (min {r['min_ms']:.2f}; directory "
            f"{r['directory_ms']:.2f}, strips {r['decode_ms']:.2f})"
            + "".join(f", {n} threads {r[f'frames_per_s_{n}']:.2f} frames/s"
                      for n in PNG_THREADS))
    log(f"[image_formats] demo --image on the orientation-6 PNG portrait "
        f"upright (dark share {portrait['dark_sides']:.2f} at the sides, "
        f"{portrait['dark_ends']:.2f} at the ends) in "
        f"{portrait['wall_s']:.2f} s, one PNG decode, one launch")
    for key, r in trees.items():
        log(f"[image_formats] {key}: valid on {r['records']} records in "
            f"{r['wall_s']:.2f} s, perf {r['perf']:.4f}, routes "
            f"{r['routes']}, soft-argmax launches {r['launches']}")
    log("[image_formats] the PNG and TIFF trees' predictions equal the JPEG "
        "tree's bit for bit")


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
              ("warp", phase_warp), ("remat", phase_remat),
              ("ddp", phase_ddp), ("fused", phase_fused),
              ("export", phase_export), ("user_tools", phase_user_tools),
              ("spatial", phase_spatial), ("processes", phase_processes),
              ("native_loader", phase_native_loader),
              ("image_formats", phase_image_formats)]
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
    # the kernels launched from CUDA-graph replays (phase fused)
    in_graph = res["fused_in_graph"]
    kernels = [
        dict(name="softargmax_fwd", route="cuda", source=sa,
             replaces=pallas.format(98, ""), path="eval",
             launches=res["eval_launches"],
             launches_by_path=by_path("softargmax_fwd"),
             from_export=res["export"], **k1),
        dict(name="softargmax_fwd_stats", route="cuda", source=sa,
             replaces=pallas.format(98, ""), path="train",
             launches=res["train_launches"][0],
             launches_by_path=by_path("softargmax_fwd"),
             in_graph=in_graph, **res["softargmax_fwd_stats"]),
        dict(name="softargmax_bwd", route="cuda", source=sa,
             replaces=pallas.format(174, " backward, _bwd"), path="train",
             launches=res["train_launches"][1],
             launches_by_path=by_path("softargmax_bwd"),
             in_graph=in_graph, **res["softargmax_bwd"]),
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
        dict(name="softargmax_fwd_stats_r152", route="cuda", source=sa,
             replaces=pallas.format(98, ""), path="remat",
             launches=paths["remat"]["softargmax_fwd"],
             launches_by_path=by_path("softargmax_fwd"),
             **res["softargmax_fwd_stats_r152"]),
        dict(name="softargmax_bwd_r152", route="cuda", source=sa,
             replaces=pallas.format(174, " backward, _bwd"), path="remat",
             launches=paths["remat"]["softargmax_bwd"],
             launches_by_path=by_path("softargmax_bwd"),
             **res["softargmax_bwd_r152"]),
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
             in_graph=in_graph, **res["triangulate"]),
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
    nl = res["native_loader"]
    log(f"native loader (no libjpeg): 3DHP valid "
        f"{nl['valid']['native']['samples_per_s']:.1f} samples/s against "
        f"the pool route's {nl['valid']['pool']['samples_per_s']:.1f}; the "
        f"loader alone at boxes x{NATIVE_BOX_GAIN} "
        f"{nl['boxes_x3']['img_s']:.1f} img/s; SS dual crop loader img/s "
        + " / ".join(f"{nl['ss'][f'native_ss_{s}']['img_s']:.1f}"
                     for s in NATIVE_SS_SCALES)
        + " at teacher scale " + " / ".join(map(str, NATIVE_SS_SCALES)))
    rm, dp = res["remat"], res["ddp"]
    log(f"r152@384 batch {R152_BATCH} bf16: ms a step {rm['False']['ms']:.2f}"
        f" / {rm['True']['ms']:.2f} with REMAT, peak GB "
        f"{rm['False']['peak_gb']:.2f} / {rm['True']['peak_gb']:.2f}; two "
        f"gloo ranks on one card " + ", ".join(
            f"{t:.2f}" for t in dp["gloo_one_card"]["ms"]) + " ms a step; "
        f"two nccl ranks: {dp['nccl_two_ranks']}")
    fu = res["fused"]
    log(f"fused (TPU.FUSED_STEPS): FS batch {TRAIN_BATCH} "
        f"{fu['fs']['samples_per_s'][1]:.1f} samples/s at K 1, "
        f"{fu['fs']['samples_per_s'][FUSED_K]:.1f} at K {FUSED_K}, device "
        f"idle {fu['fs']['trace'][1]['idle_share']:.1%} / "
        f"{fu['fs']['trace'][FUSED_K]['idle_share']:.1%}; SS given / "
        f"estimated ms a step eager " + ", ".join(
            f"{fu[f'ss_{c}']['ms_a_step'][1]:.2f} / fused "
            f"{fu[f'ss_{c}']['ms_a_step'][FUSED_SS_K]:.2f}"
            for c in ("given", "estimated"))
        + f"; r152@384 REMAT {fu['remat']['ms_a_step_1']:.2f} / "
        f"{fu['remat'][f'ms_a_step_{FUSED_SS_K}']:.2f} ms a step")
    ex, dc = res["export"], res["dualcrop_ci"]
    log(f"export: {ex['mb']:.1f} MB artifact, batch 64 served "
        f"{ex['served_ms_b64']:.3f} ms vs eager {ex['eager_ms_b64']:.3f} ms; "
        f"dualcrop ci: SS step img/s " + " / ".join(
            f"{dc['B']['device'][s]}" for s in (1.0, 0.5))
        + " at teacher scale 1.0 / 0.5")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-rank"]:
        sys.exit(ddp_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--spatial-rank"]:
        sys.exit(spatial_rank(sys.argv[2]))
    sys.exit(main())
