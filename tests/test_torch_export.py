"""The port's serving artifact (``tools/export_model.py``) against the JAX
package's ``tools/export_model.py::build_predict_fn``, on the CPU.

Models: ``experiments/debug/synth_smoke_3d.yaml`` (integral: ResNet-18 at
64x64, 17 joints, D = 8) and ``experiments/debug/synth_smoke.yaml``
(gaussian: 16 joints, 16x16 heatmaps), each at float32 and bfloat16. The
weights are the JAX init with BN statistics and head re-drawn
(``test_torch_models._perturbed_variables``) and the final conv's kernel
times 10, so that the soft-argmax is sharp and the joints decode apart
(over 0.38 of the crop in x, 0.8 in z), bridged through
``models/convert.py::from_jax_variables``. The port's program is exported
with a symbolic batch, saved, loaded with ``load_exported`` and served at
batches 1, 2 and 5: the first 1, 2 and 5 images of one seeded batch,
against JAX's predict on all 5 (BN in eval mode: an image's output does
not depend on its batch).

Tolerances. float32: atol 1e-3 on the normalized (x, y, z), the eval
step's 1e-3 taken in normalized units (measured: 2.5e-6); heatmaps 1e-4
of their largest magnitude (``test_torch_models.py``; measured 1.2e-6). bfloat16: both packages run the convolutions
in bf16 and round each layer's output to bf16 (8 significant bits), in
other places, so the outputs differ by a few bf16 steps: 3e-2 of the
heatmaps' largest magnitude, and 3e-2 on the normalized coordinates
(1.9 px of the 64-pixel crop), twice what was measured (1.6e-2 on the
coordinates, 1.5e-2 of the largest heatmap).
"""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epipolarpose_tpu.config import load_config as jax_load_config
from epipolarpose_tpu.models import get_model as jax_get_model
from epipolarpose_tpu_torch import graphs
from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.core.steps import make_eval_step
from epipolarpose_tpu_torch.kernels import softargmax as ksa
from epipolarpose_tpu_torch.models import from_jax_variables, get_model
from epipolarpose_tpu_torch.tools import export_model as tex
from test_torch_models import _perturbed_variables

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
from export_model import build_predict_fn as jax_build_predict_fn  # noqa: E402

CONFIGS = {"integral": "experiments/debug/synth_smoke_3d.yaml",
           "gaussian": "experiments/debug/synth_smoke.yaml"}
BATCHES = (1, 2, 5)
# (atol on normalized coords, heatmap tolerance relative to the largest)
TOLERANCE = {"float32": (1e-3, 1e-4), "bfloat16": (3e-2, 3e-2)}
# the final conv's kernel scale: a sharp soft-argmax
HEAD_GAIN = 10.0


def _configs(target: str, dtype: str):
    out = []
    for load in (jax_load_config, load_config):
        cfg = load(ROOT / CONFIGS[target])
        cfg.TPU.COMPUTE_DTYPE = dtype
        out.append(cfg)
    return out


def _images(n: int = 5) -> np.ndarray:
    return np.random.default_rng(3).uniform(0, 1, (n, 64, 64, 3)).astype(
        np.float32)


@pytest.fixture(scope="module", params=[
    ("integral", "float32"), ("integral", "bfloat16"),
    ("gaussian", "float32"), ("gaussian", "bfloat16")],
    ids=lambda p: "-".join(p))
def served(request, tmp_path_factory):
    """JAX predict on 5 images, and the port's saved-and-loaded artifact
    on the same weights."""
    target, dtype = request.param
    jcfg, tcfg = _configs(target, dtype)
    variables = _perturbed_variables(jax_get_model(jcfg),
                                     np.random.default_rng(0))
    head = variables["params"]["final_layer"]
    head["kernel"] = head["kernel"] * np.float32(HEAD_GAIN)
    want = np.asarray(jax.jit(jax_build_predict_fn(
        jcfg, (variables["params"], variables["batch_stats"])))(
            jnp.asarray(_images())))
    model = get_model(tcfg, False)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    program = tex.export_model(tcfg, model, batch_size=-1, device="cpu")
    path = str(tmp_path_factory.mktemp("export") / "model.pt2")
    tex.save_exported(program, path, "cpu", tcfg)
    return target, dtype, want, tex.load_exported(path), model


@pytest.mark.parametrize("n", BATCHES)
def test_exported_program_matches_jax_predict(served, n):
    target, dtype, want, artifact, _ = served
    got = artifact(torch.from_numpy(_images()[:n]))
    coord_tol, hm_tol = TOLERANCE[dtype]
    assert got.dtype == torch.float32
    if target == "integral":
        assert got.shape == (n, 17, 3)
        assert np.ptp(want[..., 0], axis=1).min() > 0.2, \
            "joints should not coincide"
        np.testing.assert_allclose(got.numpy(), want[:n], rtol=0,
                                   atol=coord_tol)
    else:
        # the port's heatmaps are NCHW, JAX's NHWC
        assert got.shape == (n, 16, 16, 16)
        ref = np.moveaxis(want[:n], -1, 1)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=hm_tol * np.abs(want).max())


def test_artifact_records_device_and_config(served):
    target, dtype, _, artifact, _ = served
    assert artifact.device == torch.device("cpu")
    assert artifact.config["TPU"]["COMPUTE_DTYPE"] == dtype
    assert artifact.config["MODEL"]["EXTRA"]["TARGET_TYPE"] == target
    with pytest.raises(ValueError, match="exported on cpu.*meta"):
        artifact(torch.empty((1, 64, 64, 3), device="meta"))


def test_integral_program_calls_the_registered_op(served):
    target, _, _, artifact, _ = served
    targets = [str(n.target) for n in artifact.program.graph.nodes
               if n.op == "call_function"]
    want = int(target == "integral")
    assert targets.count("epipolarpose.softmax_integral.default") == want


@pytest.fixture(scope="module")
def cli_export(tmp_path_factory):
    """The CLI's export (``main``, symbolic batch) between two runs of an
    eager eval step on one batch. ``graphs.constant`` caches ImageNet's
    mean and std for ``normalize_images``; the cache is emptied before the
    export, as in a process whose first use of them is the export, where
    ``torch.export`` traces with fake tensors (no data)."""
    _, tcfg = _configs("integral", "float32")
    model = get_model(tcfg, False, torch.Generator().manual_seed(0))
    step = make_eval_step(tcfg, model, device="cpu")
    rng = np.random.default_rng(1)
    batch = {"input": rng.integers(0, 256, (2, 64, 64, 3), np.uint8),
             "center": rng.uniform(80, 400, (2, 2)).astype(np.float32),
             "scale": rng.uniform(0.2, 0.6, (2, 2)).astype(np.float32)}
    before = step(batch)["preds"]
    graphs._constants.clear()
    path = str(tmp_path_factory.mktemp("cli") / "m.pt2")
    out = tex.main(["--cfg", str(ROOT / CONFIGS["integral"]), "--device",
                    "cpu", "--batch-size", "-1", "--out", path])
    return path, out, before, step(batch)["preds"]


def test_eval_step_after_export_gives_real_tensors(cli_export):
    """The eval step after the export gives real tensors, equal to its
    predictions before it."""
    _, _, before, after = cli_export
    assert type(after) is torch.Tensor
    torch.testing.assert_close(after, before, rtol=0, atol=0)


def test_cli_reports_symbolic_batch_specs(cli_export):
    path, out, _, _ = cli_export
    assert out["path"] == path and out["mb"] > 1.0
    (spec_in,), (spec_out,) = out["inputs"], out["outputs"]
    assert spec_in.startswith("float32[s") and spec_in.endswith(
        ", 64, 64, 3]")
    assert spec_out.startswith("float32[s") and spec_out.endswith(
        ", 17, 3]")


def test_load_in_a_process_with_only_torch_and_the_op(cli_export,
                                                      tmp_path):
    """The artifact serves in a fresh process that imports ``torch`` and
    ``load_exported`` (which imports the op's module, and the counters'
    registry it declares its launches in, and nothing else of the port: no
    model, config or step code), as it serves here."""
    path = cli_export[0]
    x = torch.from_numpy(_images()[:3])
    torch.save(x, tmp_path / "x.pt")
    code = (
        "import sys, torch\n"
        "from epipolarpose_tpu_torch.tools.export_model import "
        "load_exported\n"
        f"m = load_exported({path!r})\n"
        f"y = m(torch.load({str(tmp_path / 'x.pt')!r}))\n"
        f"torch.save(y, {str(tmp_path / 'y.pt')!r})\n"
        "print(sorted(n for n in sys.modules "
        "if n.startswith('epipolarpose')))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert eval(r.stdout.strip().splitlines()[-1]) == [
        "epipolarpose_tpu_torch", "epipolarpose_tpu_torch.kernels",
        "epipolarpose_tpu_torch.kernels._build",
        "epipolarpose_tpu_torch.kernels.softargmax",
        "epipolarpose_tpu_torch.telemetry", "epipolarpose_tpu_torch.tools",
        "epipolarpose_tpu_torch.tools.export_model"]
    # the same program in two processes: oneDNN may split a sum another
    # way on another thread count
    torch.testing.assert_close(torch.load(tmp_path / "y.pt"),
                               tex.load_exported(path)(x), rtol=0, atol=1e-6)


def test_op_fake_shape_cpu_route_and_no_backward():
    logits = torch.randn((3, 17 * 4, 8, 16), generator=torch.Generator()
                         .manual_seed(0)).to(torch.bfloat16)
    op = torch.ops.epipolarpose.softmax_integral
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = op(mode.from_tensor(logits), 17, 4)
        assert fake.shape == (3, 17, 3) and fake.dtype == torch.float32
    launches = ksa.softmax_integral.launches
    got = op(logits, 17, 4)
    assert ksa.softmax_integral.launches == launches     # the plain twin
    torch.testing.assert_close(got, ksa.softmax_integral_plain(logits, 17, 4),
                               rtol=0, atol=0)
    x = logits.float().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no autograd formula"):
        op(x, 17, 4).sum().backward()
