"""The matmul+stats kernel's plain twin vs the JAX package's Pallas kernel.

The Pallas kernel runs in interpret mode on the CPU, at the tile sizes
tests/test_tools.py uses. Tolerances: float32 operands, sums of 16-32
products (y: 1e-5) and of 64 rows of those (stats: 1e-4). Against
``xla_matmul_stats``, which sums the ROUNDED y, bf16 operands make the
stats differ by the rounding of y: relative 1e-2 of the largest stat.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("argv", [[], ["--step"], ["--conv1x1", "--step"]])
def test_profile_step_cli_runs_only_the_ported_bench(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        tps.main(argv)
    assert exc.value.code == 2
    assert "training slice" in capsys.readouterr().err
