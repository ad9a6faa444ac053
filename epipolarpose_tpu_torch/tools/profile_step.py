"""Matmul + BN-stats bench over the 15 ResNet-50 1x1-conv shapes.

    python -m epipolarpose_tpu_torch.tools.profile_step --conv1x1

Counterpart of the JAX package's ``tools/profile_step.py --conv1x1``: the
hand-written kernel that emits ``(y, sum y, sum y^2)`` in one pass
(``kernels/matmul_stats.py``) against the unfused PyTorch counterpart of
``xla_matmul_stats``, a matmul followed by separate stats reductions.
Times are CUDA-event times per call on the card. ``--step`` (the
train-step roofline) comes with the training slice.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable

import torch

from epipolarpose_tpu_torch.kernels.matmul_stats import matmul_stats

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


def bench_conv1x1(shapes=CONV1X1_SHAPES, device: str | torch.device = "cuda",
                  iters: int = 10, seed: int = 0) -> list[dict]:
    """Time the fused kernel against the unfused version on each shape.

    Operands are bf16 standard normals from a seeded generator on
    ``device``. Prints a table and returns one dict per shape with
    ``shape``, ``kernel_ms`` and ``plain_ms``.
    """
    device = torch.device(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"conv1x1 matmul+stats on {name}, ms per call", flush=True)
    print(f"{'(M, K, N)':>22} | {'unfused ms':>10} | {'kernel ms':>9}")
    rows = []
    gen = torch.Generator(device).manual_seed(seed)
    for (m, k, n) in shapes:
        x = torch.randn((m, k), generator=gen, device=device,
                        dtype=torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=device,
                        dtype=torch.bfloat16)
        t_plain = time_ms(lambda: plain_matmul_stats(x, w), device, iters)
        t_kernel = time_ms(lambda: matmul_stats(x, w), device, iters)
        rows.append({"shape": (m, k, n), "kernel_ms": t_kernel,
                     "plain_ms": t_plain})
        print(f"{str((m, k, n)):>22} | {t_plain:10.4f} | {t_kernel:9.4f}",
              flush=True)
        del x, w
    total_k = sum(r["kernel_ms"] for r in rows)
    total_p = sum(r["plain_ms"] for r in rows)
    print(f"aggregate over {len(rows)} shapes: unfused {total_p:.4f} ms vs "
          f"kernel {total_k:.4f} ms", flush=True)
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--conv1x1", action="store_true",
                   help="time the matmul+stats kernel on the 1x1-conv shapes")
    p.add_argument("--step", action="store_true",
                   help="train-step roofline (comes with the training slice)")
    args = p.parse_args(argv)
    if args.step or not args.conv1x1:
        p.error("only --conv1x1 is ported; --step comes with the training "
                "slice")
    bench_conv1x1()


if __name__ == "__main__":
    main()
