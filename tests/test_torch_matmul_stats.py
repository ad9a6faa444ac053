"""The matmul+stats kernel's plain twin vs the JAX package's Pallas kernel.

The Pallas kernel runs in interpret mode on the CPU, at the tile sizes
tests/test_tools.py uses. Tolerances: float32 operands, sums of 16-32
products (y: 1e-5) and of 64 rows of those (stats: 1e-4). Against
``xla_matmul_stats``, which sums the ROUNDED y, bf16 operands make the
stats differ by the rounding of y: relative 1e-2 of the largest stat.
"""

import ctypes
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from epipolarpose_tpu_torch.kernels import _build
from epipolarpose_tpu_torch.kernels import matmul_stats as kms
from epipolarpose_tpu_torch.tools import profile_step as tps

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_profile_step():
    spec = importlib.util.spec_from_file_location(
        "jax_profile_step", ROOT / "tools" / "profile_step.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_within_one_bf16_ulp(a, b):
    """|a - b| <= one bf16 spacing (8 significant bits) at max(|a|, |b|)."""
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    assert np.all(np.abs(a - b) <= ulp), np.max(np.abs(a - b) / ulp)


@pytest.fixture(scope="module")
def jps():
    return _jax_profile_step()



@pytest.mark.parametrize("shape,tiles", [((64, 16, 32), (16, 16)),
                                         ((128, 32, 64), (32, 32))])
def test_plain_matches_pallas_kernel(rng, jps, shape, tiles):
    m, k, n = shape
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    y_p, s_p = jps.fused_matmul_stats(x, w, tile_m=tiles[0],
                                      tile_n=tiles[1], interpret=True)
    y, s = kms.matmul_stats_plain(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_p), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_p), rtol=1e-4,
                               atol=1e-4)


def test_tool_plain_matches_xla_version(rng, jps):
    x = rng.standard_normal((64, 16)).astype(np.float32)
    w = rng.standard_normal((16, 32)).astype(np.float32)
    y_x, s_x = jps.xla_matmul_stats(x, w)
    y, s = tps.plain_matmul_stats(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_x), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_x), rtol=1e-4,
                               atol=1e-4)


def test_bf16_stats_of_accumulator_vs_rounded_y(rng, jps):
    """In bf16 the kernel's stats (f32 accumulator) and xla_matmul_stats's
    (rounded y) differ by y's rounding only."""
    import jax.numpy as jnp
    x = rng.standard_normal((256, 64)).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    xb, wb = x.astype(jnp.bfloat16), w.astype(jnp.bfloat16)
    y_x, s_x = jps.xla_matmul_stats(xb, wb)
    tx = torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16)
    tw = torch.from_numpy(np.asarray(wb, np.float32)).to(torch.bfloat16)
    y, s = kms.matmul_stats_plain(tx, tw)
    _assert_within_one_bf16_ulp(y.float().numpy(),
                                np.asarray(y_x, np.float32))
    s_x = np.asarray(s_x)
    scale = np.abs(s_x).max(axis=1, keepdims=True)
    assert np.all(np.abs(s.numpy() - s_x) <= 1e-2 * scale)


def test_plain_handles_ragged_shapes(rng):
    x = torch.from_numpy(rng.standard_normal((37, 13)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((13, 11)).astype(np.float32))
    y, s = kms.matmul_stats(x, w)            # CPU: the plain version
    y64 = x.double() @ w.double()
    torch.testing.assert_close(y.double(), y64, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s.double(), torch.stack(
        [y64.sum(0), (y64 * y64).sum(0)]), rtol=1e-5, atol=1e-4)


def test_kernel_argument_checks():
    x = torch.zeros((64, 16), dtype=torch.bfloat16)
    w = torch.zeros((16, 32), dtype=torch.bfloat16)
    kms.check_kernel_args(x, w)
    with pytest.raises(TypeError):
        kms.check_kernel_args(x.float(), w)
    with pytest.raises(ValueError, match="expected"):
        kms.check_kernel_args(x, w.t())
    with pytest.raises(ValueError, match="contiguous"):
        kms.check_kernel_args(x, w.t().contiguous().t())
    with pytest.raises(ValueError, match="too large"):
        kms.check_kernel_args(torch.empty((2 ** 24, 1), dtype=torch.bfloat16),
                              torch.empty((1, 1), dtype=torch.bfloat16))


def test_conv1x1_shapes_match_jax_tool(jps):
    assert tps.CONV1X1_SHAPES == jps.CONV1X1_SHAPES


def test_bench_conv1x1_runs_small_on_cpu(capsys):
    rows = tps.bench_conv1x1([(64, 16, 32), (100, 24, 40)], device="cpu",
                             iters=1)
    assert [r["shape"] for r in rows] == [(64, 16, 32), (100, 24, 40)]
    assert all(r["kernel_ms"] > 0 and r["plain_ms"] > 0 for r in rows)
    assert "on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("argv,says", [
    ([], "one of the arguments"), (["--step"], "CUDA card"),
    (["--conv1x1", "--step"], "not allowed with")])
def test_profile_step_cli_runs_only_the_ported_bench(argv, says, capsys):
    """One mode at a time, and only on a card: without one (as here) the
    CLI exits 2 before it times anything."""
    with pytest.raises(SystemExit) as exc:
        tps.main(argv)
    assert exc.value.code == 2
    assert says in capsys.readouterr().err


# ------------------------------------------------ the wrapper's route rule
@pytest.mark.parametrize("shape", tps.CONV1X1_SHAPES, ids=str)
def test_every_tool_shape_takes_the_wgmma_route(shape):
    assert kms.route(*shape, 0, 1024) == "wgmma"


@pytest.mark.parametrize("shape,ptrs,want", [
    ((131, 13, 70), (0, 0), "simt"),      # K and N not multiples of 8
    ((64, 13, 64), (0, 0), "simt"),       # K
    ((64, 64, 70), (0, 0), "simt"),       # N
    ((64, 0, 64), (0, 0), "simt"),        # K = 0: no tensor map
    ((64, 64, 64), (2, 0), "simt"),       # x's base not 16-byte aligned
    ((64, 64, 64), (0, 8), "simt"),       # w's base
    ((300, 72, 200), (0, 0), "wgmma"),    # ragged M and tiles, TMA rows
    ((1, 8, 8), (16, 32), "wgmma"),
])
def test_route_rule(shape, ptrs, want):
    assert kms.route(*shape, *ptrs) == want


def test_a_misaligned_view_takes_the_simt_route():
    """A contiguous view that starts one element into its storage."""
    buf = torch.zeros(1 + 64 * 16, dtype=torch.bfloat16)
    x = buf[1:].view(64, 16)
    w = torch.zeros((16, 32), dtype=torch.bfloat16)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    kms.check_kernel_args(x, w)
    assert kms.route(64, 16, 32, x.data_ptr(), w.data_ptr()) == "simt"
    assert kms.route(64, 16, 32, buf[8:8 + 64 * 16].data_ptr(),
                     w.data_ptr()) == "wgmma"


# (M, K, N) -> (bn, grid) on 132 SMs: a column tile of 64 up to N = 128,
# else 128, per block; the grid in whole rounds of the column tiles; no
# more blocks than tiles
PLANS_132 = {
    (524288, 64, 64): (64, 132), (524288, 64, 256): (128, 132),
    (524288, 256, 64): (64, 132), (131072, 256, 128): (64, 132),
    (131072, 128, 512): (128, 132), (131072, 256, 512): (128, 132),
    (131072, 512, 128): (64, 132), (32768, 512, 256): (128, 132),
    (32768, 256, 1024): (128, 128), (32768, 512, 1024): (128, 128),
    (32768, 1024, 256): (128, 132), (8192, 1024, 512): (128, 132),
    (8192, 512, 2048): (128, 128), (8192, 1024, 2048): (128, 128),
    (8192, 2048, 512): (128, 132), (300, 72, 200): (128, 6),
    (131, 64, 70): (64, 4), (64, 64, 40000): (128, 313),
}


@pytest.mark.parametrize("shape", sorted(PLANS_132), ids=str)
def test_wgmma_plan(shape):
    m, k, n = shape
    bn, grid = kms.wgmma_plan(m, k, n, 132)
    assert (bn, grid) == PLANS_132[shape]
    n_tiles, m_tiles = -(-n // bn), -(-m // 128)
    assert grid % n_tiles == 0
    assert grid <= max(132, n_tiles) and grid <= m_tiles * n_tiles
    # the scratch holds one (2, bn) float32 partial per block
    assert kms.partials_numel(bn, grid) == grid * 2 * bn


def test_partials_scratch_size():
    assert kms.partials_numel(64, 132) == 16896
    assert kms.partials_numel(128, 128) == 32768


def test_kernel_library_signatures():
    p, i = ctypes.c_void_p, ctypes.c_int
    # x, w, y, stats, partials, M, K, N, bn, grid, device, stream
    assert _build.SIGNATURES["epk_matmul_stats"] == (
        p, p, p, p, p, i, i, i, i, i, i, p)
    # x, w, y, stats, M, K, N, device, stream
    assert _build.SIGNATURES["epk_matmul_stats_simt"] == (
        p, p, p, p, i, i, i, i, p)


def test_route_counters_start_at_zero_and_skip_the_cpu():
    before = (kms.matmul_stats.launches, kms.matmul_stats.launches_wgmma,
              kms.matmul_stats.launches_simt)
    kms.matmul_stats(torch.zeros((8, 8), dtype=torch.bfloat16),
                     torch.zeros((8, 8), dtype=torch.bfloat16))
    assert (kms.matmul_stats.launches, kms.matmul_stats.launches_wgmma,
            kms.matmul_stats.launches_simt) == before


@pytest.mark.parametrize("num_sms", [1, 66, 114, 132])
def test_wgmma_plan_on_any_sm_count(num_sms):
    """On every tool shape: whole rounds of the column tiles, at most one
    block per SM unless the column tiles outnumber the SMs, no more
    blocks than tiles, and the width independent of the SM count."""
    for (m, k, n) in tps.CONV1X1_SHAPES:
        bn, grid = kms.wgmma_plan(m, k, n, num_sms)
        n_tiles = -(-n // bn)
        assert bn == (64 if n <= 128 else 128)
        assert grid % n_tiles == 0
        assert grid <= max(num_sms, n_tiles)
        assert grid <= -(-m // 128) * n_tiles
