"""Train-step breakdown, and the matmul + BN-stats bench.

    python -m epipolarpose_tpu_torch.tools.profile_step --step
    python -m epipolarpose_tpu_torch.tools.profile_step --conv1x1

Counterparts of the JAX package's ``tools/profile_step.py``. Times are
CUDA-event times per call on the card; both modes need one.

``--step`` (:func:`bench_step`): the flagship train step
(``experiments/h36m/train_fs_r50_256_integral.yaml``, batch 128) in ms
and samples/s; the model forward with BN on running statistics against
BN on batch statistics; and the soft-argmax + L1 loss, forward and
forward + backward, through the CUDA kernels and through the plain
versions. XLA's cost analysis, which the JAX tool prints beside the step,
has no counterpart here: the tool prints the soft-argmax kernels' bytes
bound instead.

``--conv1x1`` (:func:`bench_conv1x1`): the hand-written kernel that emits
``(y, sum y, sum y^2)`` in one pass (``kernels/matmul_stats.py``; every
shape here takes its ``wgmma`` route) against the unfused PyTorch
counterpart of ``xla_matmul_stats``, a matmul followed by separate stats
reductions, over the 15 ResNet-50 1x1-conv shapes.
"""

from __future__ import annotations

import argparse
import pathlib
import time
from typing import Callable

import torch

from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.core import (create_train_state, make_train_step,
                                         normalize_images)
from epipolarpose_tpu_torch.core.steps import configure_backends
from epipolarpose_tpu_torch.kernels import softargmax as ksa
from epipolarpose_tpu_torch.kernels.matmul_stats import matmul_stats, route
from epipolarpose_tpu_torch.models import get_model
from epipolarpose_tpu_torch.ops import (generate_integral_target,
                                        integral_l1_loss)

TRAIN_CONFIG = (pathlib.Path(__file__).resolve().parents[2]
                / "experiments/h36m/train_fs_r50_256_integral.yaml")
# H100 SXM HBM3 rate (NVIDIA data sheet), for the soft-argmax bytes bound
HBM_BYTES_PER_S = 3.35e12

# ResNet-50 @ 256^2 bs128: all 15 distinct (M, K, N) 1x1-conv shapes.
# M = batch * H * W per stage (64^2, 32^2, 16^2, 8^2 feature maps).
CONV1X1_SHAPES = [
    (524288, 64, 64), (524288, 64, 256), (524288, 256, 64),
    (131072, 256, 128), (131072, 128, 512), (131072, 256, 512),
    (131072, 512, 128),
    (32768, 512, 256), (32768, 256, 1024), (32768, 512, 1024),
    (32768, 1024, 256),
    (8192, 1024, 512), (8192, 512, 2048), (8192, 1024, 2048),
    (8192, 2048, 512),
]


def plain_matmul_stats(x: torch.Tensor, w: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unfused counterpart of ``xla_matmul_stats``: y in x's dtype, then the
    stats of the ROUNDED y in float32."""
    y = torch.matmul(x, w)
    yf = y.float()
    return y, torch.stack([yf.sum(0), (yf * yf).sum(0)])


def time_ms(fn: Callable[[], object], device: torch.device, iters: int = 10,
            warmup: int = 2) -> float:
    """Milliseconds per call of ``fn``: CUDA events on a CUDA device (the
    host clock elsewhere), after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def card_time_ms(fn: Callable[[], object], iters: int = 10) -> float:
    """Milliseconds per call of ``fn`` on the card alone: CUDA events
    around ``iters`` calls queued behind a sleep kernel of 2e7 clock
    cycles (about 10 ms), so the host has issued them all before the
    first one starts. :func:`time_ms` includes the host's time per call
    where that is the longer."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e7))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bench_conv1x1(shapes=CONV1X1_SHAPES, device: str | torch.device = "cuda",
                  iters: int = 10, seed: int = 0) -> list[dict]:
    """Time the fused kernel against the unfused version on each shape.

    Operands are bf16 standard normals from a seeded generator on
    ``device``. Prints a table and returns one dict per shape with
    ``shape``, ``route`` (the kernel route the wrapper takes on a card,
    ``"plain"`` on the CPU), ``kernel_ms`` and ``plain_ms``.
    """
    device = torch.device(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"conv1x1 matmul+stats on {name}, ms per call", flush=True)
    print(f"{'(M, K, N)':>22} | {'route':>6} | {'unfused ms':>10} | "
          f"{'kernel ms':>9}")
    rows = []
    gen = torch.Generator(device).manual_seed(seed)
    for (m, k, n) in shapes:
        x = torch.randn((m, k), generator=gen, device=device,
                        dtype=torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=device,
                        dtype=torch.bfloat16)
        way = (route(m, k, n, x.data_ptr(), w.data_ptr())
               if device.type == "cuda" else "plain")
        t_plain = time_ms(lambda: plain_matmul_stats(x, w), device, iters)
        t_kernel = time_ms(lambda: matmul_stats(x, w), device, iters)
        rows.append({"shape": (m, k, n), "route": way, "kernel_ms": t_kernel,
                     "plain_ms": t_plain})
        print(f"{str((m, k, n)):>22} | {way:>6} | {t_plain:10.4f} | "
              f"{t_kernel:9.4f}", flush=True)
        del x, w
    total_k = sum(r["kernel_ms"] for r in rows)
    total_p = sum(r["plain_ms"] for r in rows)
    print(f"aggregate over {len(rows)} shapes: unfused {total_p:.4f} ms vs "
          f"kernel {total_k:.4f} ms", flush=True)
    return rows


def seeded_train_batch(n: int, size: int, joints: int, depth_bound: float,
                       generator: torch.Generator, device) -> dict:
    """A random train batch on ``device``: uint8 crops (n, size, size, 3),
    ``joints`` inside the crop, all visible, ``joints_3d`` within
    +-``depth_bound`` of the root."""
    g, dev = generator, torch.device(device)
    return {
        "input": torch.randint(0, 256, (n, size, size, 3), generator=g,
                               device=dev, dtype=torch.uint8),
        "joints": size * torch.rand((n, joints, 2), generator=g, device=dev),
        "joints_vis": torch.ones((n, joints), device=dev),
        "joints_3d": depth_bound * (2 * torch.rand(
            (n, joints, 3), generator=g, device=dev) - 1),
    }


def bench_step(config=TRAIN_CONFIG, batch: int = 128,
               device: str | torch.device = "cuda", iters: int = 10,
               seed: int = 0) -> dict:
    """Time the train step of ``config`` and its parts at ``batch``.

    Random weights and a random batch, both from ``seed``. Prints a table
    and returns the times (ms) with the soft-argmax bytes bounds.
    """
    device = torch.device(device)
    cfg = load_config(config)
    configure_backends(cfg)
    joints = int(cfg.MODEL.NUM_JOINTS)
    depth = int(cfg.MODEL.EXTRA.DEPTH_DIM)
    size = int(cfg.MODEL.IMAGE_SIZE[0])
    bound_mm = float(cfg.MODEL.EXTRA.DEPTH_BOUND)
    model = get_model(cfg, True, torch.Generator().manual_seed(seed))
    state = create_train_state(cfg, model, steps_per_epoch=10 ** 6,
                               device=device)
    step = make_train_step(cfg, model, device=device)
    gen = torch.Generator(device).manual_seed(seed)
    b = seeded_train_batch(batch, size, joints, bound_mm, gen, device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    res = {"device": name, "batch": batch}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    res["step_ms"] = time_ms(lambda: step(state, b), device, iters)
    res["samples_per_s"] = batch / res["step_ms"] * 1e3
    if device.type == "cuda":
        res["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9

    x = normalize_images(b["input"]).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        model.eval()
        res["fwd_eval_bn_ms"] = time_ms(lambda: model(x), device, iters)
        model.train()
        res["fwd_train_bn_ms"] = time_ms(lambda: model(x), device, iters)
        logits = model(x)
    target, tw = generate_integral_target(
        b["joints"], b["joints_vis"], cfg.MODEL.IMAGE_SIZE, bound_mm,
        b["joints_3d"][..., 2] - b["joints_3d"][..., :1, 2])
    logits.requires_grad_(True)

    def loss_of(decode):
        return integral_l1_loss(decode(logits, joints, depth), target, tw)

    for label, decode in (("kernel", ksa.softmax_integral),
                          ("plain", ksa.softmax_integral_plain)):
        res[f"softargmax_l1_fwd_{label}_ms"] = time_ms(
            lambda: loss_of(decode), device, iters)
        res[f"softargmax_l1_fwd_bwd_{label}_ms"] = time_ms(
            lambda: torch.autograd.grad(loss_of(decode), logits), device,
            iters)
    elems = logits.numel() * logits.element_size()
    rows = batch * joints
    res["softargmax_fwd_bound_ms"] = (elems + rows * 7 * 4) \
        / HBM_BYTES_PER_S * 1e3
    res["softargmax_bwd_bound_ms"] = (2 * elems + rows * 7 * 4) \
        / HBM_BYTES_PER_S * 1e3
    print(f"train step of {pathlib.Path(config).name} on {name}, batch "
          f"{batch}, ms per call (CUDA events)", flush=True)
    for k, v in res.items():
        if k.endswith("_ms") or k in ("samples_per_s", "peak_gb"):
            print(f"{k:>32} | {v:10.4f}", flush=True)
    return res


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--step", action="store_true",
                      help="time the flagship train step and its parts")
    mode.add_argument("--conv1x1", action="store_true",
                      help="time the matmul+stats kernel on the 1x1-conv "
                           "shapes")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        p.error("the benches time the CUDA card and there is none")
    if args.step:
        bench_step()
    else:
        bench_conv1x1()


if __name__ == "__main__":
    main()
