#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``epipolarpose_tpu_torch/csrc`` (one
``nvcc`` call), holds each kernel against its plain PyTorch version on the
card, then drives the port's two paths through their entry points:

1. environment and build: the card, torch/CUDA versions, build seconds;
2. soft-argmax kernel vs its plain version on a flagship-shaped bf16
   volume (64, 17*64, 64, 64);
3. matmul+stats kernel vs its plain version on the 15 ResNet-50 1x1-conv
   shapes, beside ``torch.matmul`` as the library yardstick;
4. the H36M 3D eval path (``experiments/h36m/valid_r50_256_integral.yaml``:
   ResNet-50 at 256x256, 17 joints, DEPTH_DIM 64, flip test, batch 64) via
   ``validate`` over 3 seeded random batches; then, with the head re-drawn
   so that the joints decode apart, the step through the kernel against
   the same step through the plain decode on one batch;
5. the tool path: ``tools.profile_step.bench_conv1x1()``.

Kernel launch counters are set to 0 just before each path and read just
after it. Each phase checks its own time limit. Any failed phase makes the
script exit 1 without a result; without a CUDA card it exits 1 at once.
On success the line before the last is the kernels' JSON record and the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import logging
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

# seconds each phase may take; the whole run aims at under 300 s
PHASE_LIMITS = {"build": 120.0, "softargmax": 30.0, "matmul_stats": 60.0,
                "eval": 90.0, "tool": 30.0}

# H36M left/right joint pairs (the JAX package's data/h36m.py FLIP_PAIRS)
H36M_FLIP_PAIRS = ((1, 4), (2, 5), (3, 6), (11, 14), (12, 15), (13, 16))
EVAL_BATCH, EVAL_BATCHES = 64, 3


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


def phase_matmul_stats(res: dict) -> None:
    from epipolarpose_tpu_torch.kernels.matmul_stats import (
        matmul_stats, matmul_stats_plain)
    from epipolarpose_tpu_torch.tools.profile_step import (CONV1X1_SHAPES,
                                                           time_ms)
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(2)
    rows = []
    for (m, k, n) in CONV1X1_SHAPES:
        x = torch.randn((m, k), generator=g, device=dev, dtype=torch.bfloat16)
        w = torch.randn((k, n), generator=g, device=dev, dtype=torch.bfloat16)
        y, st = matmul_stats(x, w)
        y_ref, st_ref = matmul_stats_plain(x, w)
        torch.cuda.synchronize()
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
        ms = time_ms(lambda: matmul_stats(x, w), dev)
        plain_ms = time_ms(lambda: matmul_stats_plain(x, w), dev)
        lib_ms = time_ms(lambda: torch.matmul(x, w), dev)
        b_ms, b_by = bound((m * k + k * n + m * n) * 2 + 2 * n * 4,
                           2.0 * m * k * n, BF16_TENSOR_FLOPS)
        rows.append(dict(shape=[m, k, n], y_max_abs_err=diff.max().item(),
                         y_max_ulp=ulps, y_max_ulp_raw=raw_ulps,
                         stats_rel_err=rel, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by))
        log(f"[matmul_stats] {(m, k, n)}: y {ulps:.2f} ulp ({raw_ulps:.1f} "
            f"without the floor), max |dy| {diff.max().item():.3g}, stats rel "
            f"{rel:.2e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.matmul {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        del x, w, y, y_ref, yk, yr, diff
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


def phase_eval(res: dict) -> None:
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.core.function import validate
    from epipolarpose_tpu_torch.core.steps import (configure_backends,
                                                   make_eval_step)
    from epipolarpose_tpu_torch.kernels.matmul_stats import matmul_stats
    from epipolarpose_tpu_torch.kernels.softargmax import (
        softmax_integral, softmax_integral_plain)
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

    softmax_integral.launches = matmul_stats.launches = 0
    t0 = time.perf_counter()
    name_values, _ = validate(cfg, data.batches, data, step)
    wall = time.perf_counter() - t0
    launches = softmax_integral.launches
    check(matmul_stats.launches == 0, "eval path launched matmul_stats")
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
    g = torch.Generator("cuda").manual_seed(5)
    with torch.no_grad():
        for mod in (*model.deconv_layers, model.final_layer):
            if getattr(mod, "weight", None) is not None and mod.weight.ndim == 4:
                mod.weight.normal_(0.0, 0.05, generator=g)
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


def phase_tool(res: dict) -> None:
    from epipolarpose_tpu_torch.kernels.matmul_stats import matmul_stats
    from epipolarpose_tpu_torch.kernels.softargmax import softmax_integral
    from epipolarpose_tpu_torch.tools.profile_step import (CONV1X1_SHAPES,
                                                           bench_conv1x1)
    softmax_integral.launches = matmul_stats.launches = 0
    rows = bench_conv1x1(iters=5)
    launches = matmul_stats.launches
    check(len(rows) == len(CONV1X1_SHAPES), "bench skipped shapes")
    check(launches > 0, "tool path never launched the matmul_stats kernel")
    check(softmax_integral.launches == 0, "tool path launched softargmax")
    res["tool_launches"] = launches
    log(f"[tool] bench_conv1x1: {len(rows)} shapes, matmul_stats "
        f"launches {launches}")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr, flush=True)
        return 1
    torch.cuda.set_device(0)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(message)s")
    res: dict = {}
    phases = [("build", phase_env), ("softargmax", phase_softargmax),
              ("matmul_stats", phase_matmul_stats), ("eval", phase_eval),
              ("tool", phase_tool)]
    failed = []
    for i, (name, fn) in enumerate(phases, 1):
        if failed and failed[0] == "build":
            failed.append(name)
            log(f"[phase {i}/5 {name}] skipped: the build failed")
            continue
        log(f"[phase {i}/5 {name}] start")
        t0 = time.perf_counter()
        try:
            fn(res)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            check(dt <= PHASE_LIMITS[name],
                  f"took {dt:.1f} s > limit {PHASE_LIMITS[name]:.0f} s")
            log(f"[phase {i}/5 {name}] ok in {dt:.1f} s")
        except Exception:
            failed.append(name)
            log(f"[phase {i}/5 {name}] FAILED after "
                f"{time.perf_counter() - t0:.1f} s")
            traceback.print_exc(file=sys.stdout)
            sys.stdout.flush()
    total = time.perf_counter() - t_start
    log(f"total wall time {total:.1f} s (build {res.get('build_s', 0):.1f} s)")
    if failed:
        log(f"chip_smoke FAILED: {', '.join(failed)}")
        return 1

    k1, k2 = res["softargmax"], res["matmul_stats"]
    kernels = [
        dict(name="softargmax_fwd", route="cuda",
             source="epipolarpose_tpu_torch/csrc/softargmax.cu",
             replaces="epipolarpose_tpu/ops/pallas/softargmax.py:98 "
                      "(fused_softmax_integral; git show f1b68e4)",
             launches=res["eval_launches"], **k1),
        dict(name="matmul_stats", route="cuda",
             source="epipolarpose_tpu_torch/csrc/matmul_stats.cu",
             replaces="tools/profile_step.py:152",
             launches=res["tool_launches"], **k2),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
