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
    """The gaussian eval step is ported now (held against JAX in
    tests/test_torch_heatmap.py): on the debug 2D config it returns preds
    and maxvals; a target type that neither package has still raises."""
    cfg = load_config(ROOT / "experiments/debug/synth_smoke.yaml")
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model = get_pose_net(cfg, generator=torch.Generator().manual_seed(0))
    out = make_eval_step(cfg, model, device="cpu")(
        _batch(np.random.default_rng(1), n=2))
    assert out["preds"].shape == (2, 16, 2) and out["maxvals"].shape == (
        2, 16)
    cfg.MODEL.EXTRA.TARGET_TYPE = "nope"
    with pytest.raises(ValueError, match="TARGET_TYPE"):
        make_eval_step(cfg, torch.nn.Identity(), device="cpu")


def test_average_meter():
    m = tfunction.AverageMeter()
    m.update(2.0, n=3)
    m.update(4.0)
    assert m.count == 4 and m.avg == 2.5 and m.val == 4.0


# ----------------------------------------------------- port hygiene
def _imported_modules(path):
    """(enclosing function or None, module) for every import in a file."""
    tree = ast.parse(path.read_text())

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from visit(child, child.name)
                continue
            if isinstance(child, ast.Import):
                yield from ((func, a.name) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.module:
                yield func, child.module
            yield from visit(child, func)
    yield from visit(tree, None)


PORT_FILES = sorted((ROOT / "epipolarpose_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
# image libraries the card's machine does not have: the port may import
# OpenCV only lazily, in these functions, none of them on a card path
IMAGE_LIBS = ("cv2", "PIL", "torchvision", "matplotlib")
LAZY_IMAGE_IMPORTS = {
    ("epipolarpose_tpu_torch/data/zipreader.py", "imread", "cv2"),
    ("epipolarpose_tpu_torch/data/synthetic.py", "write_synthetic_mpii",
     "cv2"),
    ("epipolarpose_tpu_torch/data/synthetic.py", "write_synthetic_h36m",
     "cv2"),
}


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_the_jax_package(path):
    """No JAX and no JAX package anywhere; no OpenCV, PIL or torchvision
    outside the named lazy imports."""
    rel = str(path.relative_to(ROOT))
    for func, mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax",
                           "epipolarpose_tpu"), f"{rel} imports {mod}"
        if top in IMAGE_LIBS:
            assert (rel, func, top) in LAZY_IMAGE_IMPORTS, \
                f"{rel} imports {mod} in {func or 'the module'}"


def test_lazy_image_imports_are_where_the_list_says():
    """Each allowed lazy import exists (the list stays short and true)."""
    found = {(str(p.relative_to(ROOT)), func, mod.split(".")[0])
             for p in PORT_FILES for func, mod in _imported_modules(p)
             if mod.split(".")[0] in IMAGE_LIBS}
    assert found == LAZY_IMAGE_IMPORTS


def test_port_data_path_runs_without_image_libraries(tmp_path):
    """The port's datasets, loader and evaluation import and run with
    cv2, PIL, torchvision and matplotlib unimportable; so does the
    data-free demo, which writes its PNGs."""
    code = (
        "import sys\n"
        "for m in ('cv2', 'PIL', 'torchvision', 'matplotlib'): "
        "sys.modules[m] = None\n"
        "from epipolarpose_tpu_torch.config import load_config\n"
        "from epipolarpose_tpu_torch.data import get_dataset, epoch_loader\n"
        f"cfg = load_config({str(DEBUG_3D)!r})\n"
        "cfg.DATASET.DATASET = 'synthetic_multiview'\n"
        "ds = get_dataset(cfg, 'valid', True, num_frames=2)\n"
        "b = next(iter(epoch_loader(ds, 1, 0, device='cpu', "
        "multiview=True)))\n"
        "assert b['input_aug'].shape == (1, 4, 64, 64, 3)\n"
        "import numpy as np\n"
        "p = np.stack([r.joints_3d for r in ds.records])\n"
        "print(ds.evaluate(cfg, p)[1])\n"
        "from epipolarpose_tpu_torch.scripts import demo\n"
        f"out = demo.main(['--cfg', {str(DEBUG_3D)!r}, '--device', 'cpu', "
        f"'--out', {str(tmp_path)!r}])\n"
        "assert len(out['files']) == 2\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "pose_2d.png", "pose_3d.png"]


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
    """A CPU tensor takes the plain twins, forward and backward: no build,
    no launch count."""
    before = ksa.softmax_integral.launches
    before_bwd = ksa.softmax_integral_bwd.launches
    x = torch.zeros((1, 2, 8, 8))
    ksa.softmax_integral(x, 2, 1)
    ksa.softmax_integral(x.requires_grad_(True), 2, 1).sum().backward()
    assert x.grad is not None
    assert ksa.softmax_integral.launches == before
    assert ksa.softmax_integral_bwd.launches == before_bwd
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


def test_kernel_resources_reads_the_ptxas_report():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118triangulate_kernelILi4ELi1EEEvPKfS2_iS2_PfS3_ji' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118triangulate_kernelILi4ELi1EEEvPKfS2_iS2_PfS3_ji
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 1920 bytes smem, 408 bytes cmem[0]
ptxas info    : Compiling entry function 'k2' for 'sm_90a'
ptxas info    : Function properties for k2
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, 400 bytes cmem[0]
"""
    got = _build.kernel_resources(log)
    assert got == {
        "_ZN12_GLOBAL__N_118triangulate_kernelILi4ELi1EEEvPKfS2_iS2_PfS3_ji":
            {"registers": 72, "spill_stores": 0, "spill_loads": 0},
        "k2": {"registers": 255, "spill_stores": 4, "spill_loads": 12}}


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


def test_smoke_tri_resources_picks_the_layouts_instance(smoke):
    def name(v, lanes, per_frame):
        return (f"_ZN12_GLOBAL__N_118triangulate_kernelILi{v}ELi{lanes}ELb"
                f"{per_frame}EEEvPKfS2_S2_PfS3_ji")
    ptxas = {name(4, 1, 0): {"registers": 62, "spill_stores": 0,
                             "spill_loads": 0},
             name(4, 1, 1): {"registers": 64, "spill_stores": 0,
                             "spill_loads": 0},
             name(4, 4, 1): {"registers": 53, "spill_stores": 0,
                             "spill_loads": 0}}
    assert smoke.tri_resources(ptxas, 4, "thread", False)["registers"] == 62
    assert smoke.tri_resources(ptxas, 4, "thread", True)["registers"] == 64
    assert smoke.tri_resources(ptxas, 4, "split", True)["registers"] == 53
    with pytest.raises(smoke.PhaseFailed):
        smoke.tri_resources(ptxas, 4, "split", False)


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


def test_smoke_bf16_spacing(smoke):
    x = torch.tensor([1.0, 1.5, -3.0, 2 ** -7, 0.0, 1.0 - 2 ** -8])
    want = torch.tensor([2 ** -7, 2 ** -7, 2 ** -6, 2 ** -14, 0.0, 2 ** -8])
    assert torch.equal(smoke.bf16_spacing(x), want)
    bf = x.to(torch.bfloat16)                    # exact: 8 significant bits
    up = (bf.float() + smoke.bf16_spacing(x)).to(torch.bfloat16)
    assert torch.all((up.float() - bf.float())[:4] > 0)
    assert torch.equal(smoke.bf16_spacing(x.to(torch.bfloat16)), want)


def test_smoke_dataset_scores_root_relative_mpjpe(smoke):
    ds = smoke.SmokeH36M(2, 3, 16, 17, seed=0, device="cpu")
    assert len(ds) == 6 and ds.batches[0]["input"].dtype == torch.uint8
    gt = ds.gt.numpy()
    name_values, perf = ds.evaluate(None, gt + 5.0)    # a shift is free
    assert perf < 1e-3 and name_values["MPJPE"] == perf


def test_smoke_train_eval_train_on_cpu(smoke):
    """The smoke's train -> eval -> train check, on the CPU at the debug
    config's size (ResNet-18 at 64x64, float32, batch 2)."""
    from epipolarpose_tpu_torch.tools.profile_step import seeded_train_batch
    cfg = load_config(DEBUG_3D)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    batch = seeded_train_batch(2, 64, 17, 1000.0,
                               torch.Generator().manual_seed(0), "cpu")
    out = smoke.train_eval_train(cfg, batch, device="cpu")
    assert out["moved"] == [] and out["steps"] == 2
    assert out["dxy"] <= 1e-5 and out["dz"] <= 1e-5


def test_smoke_ss_batch_on_cpu(smoke):
    """The smoke's SS batch at a small crop size on the CPU: shapes, the
    perfect-teacher pseudo-GT, and the flip folded into ``aug_M`` (the
    box centre lands on the crop centre, mirrored when flipped)."""
    from epipolarpose_tpu_torch.core.self_supervised import generate_pseudo_gt
    from epipolarpose_tpu_torch.geometry.affine import affine_transform
    cfg = load_config(ROOT / "experiments/h36m/train_ss_r50_256_integral.yaml")
    cfg.MODEL.IMAGE_SIZE = [32, 32]
    batch, world, px = smoke.ss_rig_batch(cfg, 3, 4, seed=1, device="cpu")
    assert batch["input"].shape == batch["input_aug"].shape == (3, 4, 32,
                                                                 32, 3)
    assert batch["aug_M"].shape == (3, 4, 2, 3) and px.shape == (3, 4, 17, 2)
    flips = batch["aug_flip"]
    assert 0 < flips.sum() < flips.numel()
    x, res = generate_pseudo_gt(cfg, px, torch.ones(3, 4, 17),
                                batch["camera"])
    assert (x - world).norm(dim=-1).max().item() < 1.0
    assert res.max().item() < 1e-3
    centre = affine_transform(batch["center"], batch["aug_M"])
    want_x = torch.where(flips > 0.5, 31.0 - 16.0, 16.0)
    assert torch.allclose(centre[..., 0], want_x, atol=1e-3)
    assert torch.allclose(centre[..., 1], torch.full_like(want_x, 16.0),
                          atol=1e-3)


@pytest.mark.parametrize("path", ["eval", "ss", "pose2d"])
def test_smoke_loader_fed_paths_on_cpu(smoke, path):
    """The smoke's loader-fed paths on the CPU at the debug configs' size:
    the port's datasets through epoch_loader, scored by their evaluate;
    the checks inside them (first batch bits, keys, falling SS losses,
    pseudo-GT within 1 mm of the world poses) hold."""
    cfg = load_config(ROOT / "experiments/debug/synth_smoke.yaml"
                      if path == "pose2d" else DEBUG_3D)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    if path == "eval":
        cfg.TEST.FLIP_TEST = True
        model = get_pose_net(cfg, generator=torch.Generator().manual_seed(0))
        step = make_eval_step(cfg, model, (), device="cpu")
        out = smoke.eval_on_data(cfg, model, step, 8, seed=41, device="cpu")
        assert out["records"] == 32 and "PA-MPJPE" in out["name_values"]
    elif path == "ss":
        cfg.TRAIN.BATCH_SIZE = 2
        out = smoke.ss_on_data(cfg, 4, 2, seed=43, device="cpu")
        assert out["steps"] == 4 and out["pgt_err_mm"] < 1.0
    else:
        cfg.TRAIN.BATCH_SIZE = 4
        out = smoke.pose2d_on_data(cfg, 12, 8, seed=51, device="cpu")
        assert len(out["losses"]) == 3 and 0 <= out["pckh"] <= 100
    assert not any(out["counts"].values())       # no kernel on the CPU
    assert set(out["shares"]) == {"host", "device"}
    assert "numpy render" in out["route"]


def test_smoke_triangulation_helpers(smoke):
    from epipolarpose_tpu_torch.geometry import triangulation as ttri
    from test_torch_kernels import _rig_points
    smoke_chunk = smoke.EIGH_CHUNK
    try:
        smoke.EIGH_CHUNK = 40
        for per_frame in (False, True):
            pts, P, w, _ = _rig_points(4, 9, 17, 2, "cpu", per_frame)
            for method in ("eigh", "svd"):
                got = smoke.triangulate_in_chunks(pts, P, w, method)
                want = ttri.triangulate(pts, P, w, method=method)[0]
                assert torch.equal(got, want)
            ata = torch.randn(5, 7, 4, 4)
            ata = ata @ ata.transpose(-1, -2)
            vals, vecs = smoke.eigh_chunked(ata)
            ref = torch.linalg.eigh(ata)
            assert torch.allclose(vals, ref[0]) and vecs.shape == ata.shape
    finally:
        smoke.EIGH_CHUNK = smoke_chunk
    assert smoke.tri_flops(4) == 130 * 4 + 590
    det, conf = smoke.noisy_detections(torch.zeros(2, 4, 17, 2), seed=0)
    assert (conf[:, 0] == 1e-3).all() and (det[:, 0].mean() > 50)
    det, conf = smoke.noisy_detections(torch.zeros(2, 4, 17, 2), seed=0,
                                       corrupt=False)
    assert conf.min() >= 0.5 and det.abs().max() < 20
