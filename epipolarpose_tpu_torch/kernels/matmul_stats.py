"""1x1-conv matmul with a BN-statistics epilogue: ``csrc/matmul_stats.cu``.

Replaces the TPU kernel ``tools/profile_step.py::fused_matmul_stats``:
``y = x @ w`` (bf16 in, f32 accumulation, y stored in bf16) plus a (2, N)
float32 array of per-column ``sum(y)`` and ``sum(y*y)``, both taken over
the f32 ACCUMULATOR as the Pallas kernel takes them (the JAX package's
``xla_matmul_stats`` sums the bf16-rounded y instead).
"""

from __future__ import annotations

import torch

from epipolarpose_tpu_torch.kernels import _build

_BM = 128                 # rows of y per block (csrc/matmul_stats.cu)
_MAX_GRID_Y = 65535


def matmul_stats_plain(x: torch.Tensor, w: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin: f32 product, y in x's dtype, stats of the f32."""
    y32 = torch.matmul(x.float(), w.float())
    return y32.to(x.dtype), torch.stack([y32.sum(0), (y32 * y32).sum(0)])


def check_kernel_args(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise on what the CUDA kernel does not take."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"matmul_stats kernel takes bfloat16, got "
                        f"{x.dtype} and {w.dtype}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"expected x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("matmul_stats kernel needs contiguous operands")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    m, k = x.shape
    n = w.shape[1]
    if max(m * k, k * n, m * n) >= 2 ** 31 or -(-m // _BM) > _MAX_GRID_Y:
        raise ValueError(f"matmul_stats kernel: shape {(m, k, n)} too large")


def matmul_stats(x: torch.Tensor, w: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``y = x @ w`` and per-column (sum y, sum y^2) of the f32 product.

    A CPU tensor goes to :func:`matmul_stats_plain`; CUDA tensors launch
    the kernel on the current stream, or raise.
    """
    if x.device.type == "cpu":
        return matmul_stats_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no matmul_stats kernel for {x.device}")
    check_kernel_args(x, w)
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stats = torch.zeros((2, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y, stats
    lib = _build.library()
    code = lib.epk_matmul_stats(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                stats.data_ptr(), m, k, n,
                                *_build.launch_args(x.device))
    _build.check(lib, code, "epk_matmul_stats")
    matmul_stats.launches += 1
    return y, stats


# launches of the CUDA kernel; the CPU path does not count
matmul_stats.launches = 0
