"""The port's eval slice vs the JAX package's make_eval_step, end to end.

Config: experiments/debug/synth_smoke_3d.yaml (ResNet-18 at 64x64, 17
joints, D=8) with FLIP_TEST and SHIFT_HEATMAP on and float32 compute on
both sides; H36M flip pairs so the flip-back permutes joints. Tolerance
1e-3 px for (x, y) in source pixels and 1e-2 mm for z: float32 forwards
in different summation orders, then the affine un-crop (x ~5) and the
z scale (2000 mm per unit).
"""

import ast
import os
import pathlib
import subprocess
import sys
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from epipolarpose_tpu.config import load_config as jax_load_config
from epipolarpose_tpu.core.steps import make_eval_step as jax_make_eval_step
from epipolarpose_tpu.data.h36m import FLIP_PAIRS as H36M_FLIP_PAIRS
from epipolarpose_tpu.models import get_model as jax_get_model
from epipolarpose_tpu.models import init_pose_net
from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.core import function as tfunction
from epipolarpose_tpu_torch.core.steps import make_eval_step, normalize_images
from epipolarpose_tpu_torch.kernels import _build
from epipolarpose_tpu_torch.kernels import softargmax as ksa
from epipolarpose_tpu_torch.models import from_jax_variables, get_pose_net

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEBUG_3D = ROOT / "experiments/debug/synth_smoke_3d.yaml"


def _configs():
    cfgs = []
    for load in (jax_load_config, load_config):
        cfg = load(DEBUG_3D)
        cfg.TPU.COMPUTE_DTYPE = "float32"
        cfg.TEST.FLIP_TEST = True
        cfg.TEST.SHIFT_HEATMAP = True
        cfgs.append(cfg)
    return cfgs


def _batch(rng, n=4, size=64):
    return {"input": rng.integers(0, 256, (n, size, size, 3), np.uint8),
            "center": rng.uniform(80, 400, (n, 2)).astype(np.float32),
            "scale": rng.uniform(0.2, 0.6, (n, 2)).astype(np.float32)}


class _State(NamedTuple):
    """The two fields of the JAX train state that its eval step reads."""
    params: dict
    batch_stats: dict


def _port_model(cfg):
    return get_pose_net(cfg)          # weights come from the bridge


@pytest.fixture(scope="module")
def pair():
    """JAX eval step and the port's, on the same (perturbed) weights."""
    rng = np.random.default_rng(7)
    jcfg, tcfg = _configs()
    jmodel = jax_get_model(jcfg)
    params, stats = init_pose_net(jmodel, jax.random.PRNGKey(0), (64, 64))
    params = jax.tree.map(np.asarray, params)
    stats = jax.tree.map(np.asarray, stats)
    # head weights at std 0.05 (init: 0.001) so decoded joints spread out
    for name in ("deconv1", "deconv2", "deconv3", "final_layer"):
        k = params[name]["kernel"]
        params[name]["kernel"] = rng.normal(0, 0.05, k.shape).astype(
            np.float32)
    variables = {"params": params, "batch_stats": stats}
    state = _State(params, stats)
    jstep = jax_make_eval_step(jcfg, jmodel, flip_pairs=H36M_FLIP_PAIRS)
    state_dict = from_jax_variables(variables)
    model = _port_model(tcfg)
    model.load_state_dict(state_dict, strict=True)
    tstep = make_eval_step(tcfg, model, H36M_FLIP_PAIRS, device="cpu")
    return ((lambda b: np.asarray(jstep(state, b)["preds"])), tstep, tcfg,
            state_dict)


def test_eval_step_matches_jax(pair):
    jstep, tstep, _, _ = pair
    batch = _batch(np.random.default_rng(0))
    want = jstep(batch)
    got = tstep(batch)["preds"]
    assert got.dtype == torch.float32 and got.shape == (4, 17, 3)
    got = got.numpy()
    assert np.ptp(want[..., 0]) > 1.0, "joints should not all coincide"
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0, atol=1e-2)


def test_eval_step_takes_tensor_batches_and_a_decode(pair):
    _, tstep, tcfg, state_dict = pair
    batch = _batch(np.random.default_rng(1))
    as_tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    a = tstep(batch)["preds"]
    torch.testing.assert_close(tstep(as_tensors)["preds"], a)
    seen = []

    def decode(out, j, d):
        seen.append((tuple(out.shape), j, d))
        return ksa.softmax_integral_plain(out, j, d)

    model = _port_model(tcfg)
    model.load_state_dict(state_dict, strict=True)
    step = make_eval_step(tcfg, model, H36M_FLIP_PAIRS, device="cpu",
                          decode=decode)
    torch.testing.assert_close(step(batch)["preds"], a)
    assert seen == [((4, 17 * 8, 16, 16), 17, 8)]


def test_validate_scores_with_dataset_evaluate(pair, tmp_path):
    _, tstep, tcfg, _ = pair
    rng = np.random.default_rng(2)
    batches = [_batch(rng, n=3), _batch(rng, n=3)]

    class Dataset:
        def __len__(self):
            return 5                      # validate trims the padding

        def evaluate(self, cfg, preds, output_dir):
            self.preds = preds
            return {"MPJPE": 1.5}, 1.5

    ds = Dataset()
    name_values, perf = tfunction.validate(tcfg, batches, ds, tstep,
                                           output_dir=str(tmp_path))
    assert perf == 1.5 and name_values == {"MPJPE": 1.5}
    assert ds.preds.shape == (5, 17, 3)
    saved = np.load(tmp_path / "pred.npz")
    np.testing.assert_array_equal(saved["preds"], ds.preds)
    assert saved["boxes"].shape == (5, 5)


def test_normalize_images_matches_jax(rng):
    from epipolarpose_tpu.core.steps import normalize_images as jax_norm
    x = rng.integers(0, 256, (2, 4, 4, 3), np.uint8)
    np.testing.assert_allclose(normalize_images(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_norm(x)), rtol=1e-6, atol=1e-6)


def test_gaussian_target_type_not_ported():
    cfg = load_config(ROOT / "experiments/debug/synth_smoke.yaml")
    with pytest.raises(NotImplementedError):
        make_eval_step(cfg, torch.nn.Identity(), device="cpu")


def test_average_meter():
    m = tfunction.AverageMeter()
    m.update(2.0, n=3)
    m.update(4.0)
    assert m.count == 4 and m.avg == 2.5 and m.val == 4.0


# ----------------------------------------------------- port hygiene
def _imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


PORT_FILES = sorted((ROOT / "epipolarpose_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax",
                           "epipolarpose_tpu"), f"{path.name} imports {mod}"


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA here: exit non-zero and print no result line. Run alone in an
    empty directory it fails too."""
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    r = subprocess.run([sys.executable, str(alone)], capture_output=True,
                       text=True, env=env, cwd=tmp_path, timeout=120)
    assert r.returncode != 0 and '"ok": true' not in r.stdout


def test_cpu_tensor_never_reaches_the_kernel_library():
    """A CPU tensor takes the plain version: no build, no launch count."""
    before = ksa.softmax_integral.launches
    x = torch.zeros((1, 2, 8, 8))
    ksa.softmax_integral(x, 2, 1)
    assert ksa.softmax_integral.launches == before
    assert _build.library.cache_info().currsize == 0


def test_build_key_and_command(tmp_path):
    a = tmp_path / "a.cu"
    a.write_text("// one")
    k1 = _build.build_key([a], "nvcc 12.4")
    assert k1 == _build.build_key([a], "nvcc 12.4")
    assert k1 != _build.build_key([a], "nvcc 12.8")
    a.write_text("// two")
    assert k1 != _build.build_key([a], "nvcc 12.4")
    cmd = _build.nvcc_command("nvcc", [a], tmp_path / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert not any("torch" in c for c in cmd)
    names = [s.name for s in _build.sources()]
    assert {"softargmax.cu", "matmul_stats.cu", "errors.cu"} <= set(names)
    for src in _build.CSRC_DIR.iterdir():
        text = src.read_text()
        assert "torch/extension.h" not in text and "ATen" not in text
    for name in _build.SIGNATURES:
        assert any(f'"C" int {name}(' in s.read_text()
                   for s in _build.sources())


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build.os, "access", lambda p, m: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


# ------------------------------------------------ chip_smoke helpers (CPU)
@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_smoke_bound_takes_the_larger_time(smoke):
    ms, by = smoke.bound(3.35e9, 1.0, 989e12)          # 1 ms of bytes
    assert by == "bytes" and abs(ms - 1.0) < 1e-9
    ms, by = smoke.bound(1.0, 2 * 989e9, 989e12)       # 2 ms of operations
    assert by == "operations" and abs(ms - 2.0) < 1e-9


def test_smoke_bf16_ulps(smoke):
    a = torch.tensor([1.0, 1.0 + 2 ** -7, 1e-4])
    b = torch.tensor([1.0, 1.0, 2e-4])
    u = smoke.bf16_ulps(a, b, 0.0)
    assert u[0] == 0 and u[1] == 1.0 and u[2] > 1.0
    assert smoke.bf16_ulps(a, b, 1.0)[2] < 1.0          # counted at the floor


def test_smoke_dataset_scores_root_relative_mpjpe(smoke):
    ds = smoke.SmokeH36M(2, 3, 16, 17, seed=0, device="cpu")
    assert len(ds) == 6 and ds.batches[0]["input"].dtype == torch.uint8
    gt = ds.gt.numpy()
    name_values, perf = ds.evaluate(None, gt + 5.0)    # a shift is free
    assert perf < 1e-3 and name_values["MPJPE"] == perf
