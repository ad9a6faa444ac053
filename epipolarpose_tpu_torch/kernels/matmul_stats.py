"""1x1-conv matmul with a BN-statistics epilogue: ``csrc/matmul_stats.cu``.

Replaces the TPU kernel ``tools/profile_step.py::fused_matmul_stats``:
``y = x @ w`` (bf16 in, f32 accumulation, y stored in bf16) plus a (2, N)
float32 array of per-column ``sum(y)`` and ``sum(y*y)``, both taken over
the f32 ACCUMULATOR as the Pallas kernel takes them (the JAX package's
``xla_matmul_stats`` sums the bf16-rounded y instead).

Two CUDA routes, chosen by :func:`route` from the shape and the operands'
alignment alone: ``wgmma`` (TMA, a pipelined ring of shared-memory
stages, wgmma, per-block stats finished by a second kernel in a fixed
order) for what TMA can describe, ``simt`` (WMMA tiles, atomics) for the
rest. ``matmul_stats.launches`` counts the calls that launched either;
``launches_wgmma`` and ``launches_simt`` count each route.
"""

from __future__ import annotations

import functools

import torch

from epipolarpose_tpu_torch import telemetry
from epipolarpose_tpu_torch.kernels import _build

_BM = 128                 # rows of y per block tile, both routes
_MAX_GRID_Y = 65535       # the simt route's grid of M tiles


def matmul_stats_plain(x: torch.Tensor, w: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin: f32 product, y in x's dtype, stats of the f32."""
    y32 = torch.matmul(x.float(), w.float())
    return y32.to(x.dtype), torch.stack([y32.sum(0), (y32 * y32).sum(0)])


def route(m: int, k: int, n: int, x_ptr: int, w_ptr: int) -> str:
    """``"wgmma"`` where TMA can describe x (M, K) and w (K, N): rows of a
    multiple of 16 bytes (K and N multiples of 8) and base addresses
    16-byte aligned; else ``"simt"`` (and for K = 0, which no tensor map
    describes)."""
    if k == 0 or k % 8 or n % 8 or x_ptr % 16 or w_ptr % 16:
        return "simt"
    return "wgmma"


def wgmma_plan(m: int, k: int, n: int, num_sms: int) -> tuple[int, int]:
    """(column tile ``bn``, number of persistent blocks) of the wgmma
    route. ``bn`` is 64 columns up to N = 128, else 128 (the faster of
    the two on the card for most of the tool's shapes). A block owns one
    column tile and walks M tiles; the grid is a multiple of the column
    tiles, at most one block per SM (more only where the column tiles
    outnumber the SMs) and no more blocks than tiles."""
    bn = 64 if n <= 128 else 128
    n_tiles = -(-n // bn)
    m_tiles = -(-m // _BM)
    return bn, max(1, min(num_sms // n_tiles, m_tiles)) * n_tiles


def partials_numel(bn: int, grid: int) -> int:
    """Floats of the wgmma route's scratch: a (2, bn) partial per block."""
    return grid * 2 * bn


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_kernel_args(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise on what the CUDA kernels do not take."""
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
    the route :func:`route` picks on the current stream, or raise.
    """
    if x.device.type == "cpu":
        return matmul_stats_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no matmul_stats kernel for {x.device}")
    check_kernel_args(x, w)
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y, torch.zeros((2, n), dtype=torch.float32, device=x.device)
    if route(m, k, n, x.data_ptr(), w.data_ptr()) == "wgmma":
        return y, _wgmma(x, w, y)
    lib = _build.library()
    stats = torch.zeros((2, n), dtype=torch.float32, device=x.device)
    code = lib.epk_matmul_stats_simt(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                     stats.data_ptr(), m, k, n,
                                     *_build.launch_args(x.device))
    _build.check(lib, code, "epk_matmul_stats_simt")
    telemetry.count(matmul_stats, "launches", "launches_simt")
    return y, stats


def _wgmma(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor
           ) -> torch.Tensor:
    """Launch the wgmma route into ``y`` and return the stats; counts the
    launch."""
    m, k = x.shape
    n = w.shape[1]
    lib = _build.library()
    index, stream = _build.launch_args(x.device)
    bn, grid = wgmma_plan(m, k, n, _num_sms(index))
    # one allocation: stats, then the blocks' partials
    buf = torch.empty(2 * n + partials_numel(bn, grid), dtype=torch.float32,
                      device=x.device)
    code = lib.epk_matmul_stats(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                buf.data_ptr(), buf.data_ptr() + 8 * n, m, k,
                                n, bn, grid, index, stream)
    _build.check(lib, code, "epk_matmul_stats")
    telemetry.count(matmul_stats, "launches", "launches_wgmma")
    return buf[:2 * n].view(2, n)


# launches of the CUDA kernels, all and per route; the CPU path does not
# count
telemetry.counter(matmul_stats, "launches", "launches_wgmma",
                  "launches_simt")
