"""The port's checkpoints (``core/checkpoint.py``) against the JAX package.

- Twins of the seven cases of ``tests/test_checkpoint.py`` (save/restore,
  best tracking in both directions, an empty directory, a metric
  plateau, the best perf read back from the best file, every path
  layout), on a tiny ResNet-18.
- The weight bridge both ways at ``experiments/debug/synth_smoke_3d.yaml``
  (ResNet-18 at 64x64, 17 joints, D = 8, float32): a port
  ``final_state.pth.tar`` read by the JAX package's
  ``load_torch_checkpoint``, and a JAX ``save_torch_checkpoint`` file read
  by the port with ``strict=True``, give eval predictions within 1e-4 of
  each other on one batch, relative to the largest prediction (source
  pixels ~300 and mm: float32 forwards in two summation orders differ by
  about 2e-3 px or mm there, 7e-6 of it).
- Resume: 2 epochs straight and 1 epoch + save + restore into a fresh
  state + 1 epoch give bit-equal parameters, buffers and Adam state.
- ``weights_only=True`` reads every file the port writes; an orbax
  directory raises with the export hint; ``merge_matching`` copies every
  matching entry and skips the head whose shape differs.
"""

import contextlib
import logging
import os
import pathlib
import sys
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch
import yaml

from epipolarpose_tpu.config import load_config as jax_load_config
from epipolarpose_tpu.core.steps import make_eval_step as jax_make_eval_step
from epipolarpose_tpu.models import get_model as jax_get_model
from epipolarpose_tpu.models import init_pose_net
from epipolarpose_tpu.models.torch_convert import (load_torch_checkpoint,
                                                   save_torch_checkpoint)
from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.core import create_train_state
from epipolarpose_tpu_torch.core.checkpoint import (CheckpointManager,
                                                    load_model_variables,
                                                    merge_matching,
                                                    resolve_checkpoint_path)
from epipolarpose_tpu_torch.core.steps import make_eval_step
from epipolarpose_tpu_torch.models import get_pose_net
from epipolarpose_tpu_torch.scripts import train as train_cli

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEBUG_3D = ROOT / "experiments/debug/synth_smoke_3d.yaml"
PRED_TOL = 1e-4


def _assert_preds_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=PRED_TOL * np.abs(want).max())


def _tiny_state(seed=0):
    cfg = load_config(DEBUG_3D)
    cfg.MODEL.EXTRA.NUM_LAYERS = 18
    cfg.MODEL.NUM_JOINTS = 2
    cfg.MODEL.IMAGE_SIZE = [32, 32]
    cfg.MODEL.EXTRA.NUM_DECONV_FILTERS = [8, 8, 8]
    cfg.MODEL.EXTRA.DEPTH_DIM = 1
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model = get_pose_net(cfg, generator=torch.Generator().manual_seed(seed))
    return create_train_state(cfg, model, steps_per_epoch=5, device="cpu")


def _first_param(state):
    return next(iter(state.model.parameters())).detach().clone()


def _bump(state, by=1.0):
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(by)
    return state


# ------------------------------------------------- twins of test_checkpoint
def test_save_restore_roundtrip(tmp_path):
    state = _tiny_state()
    want = _first_param(state)
    mngr = CheckpointManager(str(tmp_path / "ckpt"))
    mngr.save(1, state, epoch=0, perf=10.0)
    restored, next_epoch = mngr.restore(_bump(state))
    assert next_epoch == 1
    assert torch.equal(_first_param(restored), want)
    mngr.close()


def test_best_tracking_and_final(tmp_path):
    state = _tiny_state()
    mngr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for step, perf in ((1, 10.0), (2, 30.0), (3, 20.0)):
        state.step = step
        mngr.save(step, state, epoch=step - 1, perf=perf)
    mngr.wait()
    assert mngr.best_step == 2
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "2.pth.tar", "3.pth.tar", "best"]
    path = mngr.save_final(state)
    assert os.path.exists(path) and path.endswith("final_state.pth.tar")
    assert set(torch.load(path, weights_only=True)) == {"state_dict"}
    mngr.close()


def test_restore_empty_dir(tmp_path):
    state = _tiny_state()
    mngr = CheckpointManager(str(tmp_path / "empty"))
    restored, epoch = mngr.restore(state)
    assert epoch == 0 and restored is state
    mngr.close()


def test_latest_survives_metric_plateau(tmp_path):
    """The newest save is never deleted because the metric stopped
    improving: resume continues from it, not from the old best."""
    state = _tiny_state()
    mngr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2,
                             best_mode="min")
    mngr.save(1, state, epoch=0, perf=40.0)
    for i, perf in enumerate((50.0, 55.0, 60.0), start=2):
        state.step = i
        mngr.save(i, state, epoch=i - 1, perf=perf)
    assert mngr.best_step == 1
    restored, next_epoch = mngr.restore(state)
    assert next_epoch == 4 and restored.step == 4
    mngr.close()


def test_best_tracking_min_mode(tmp_path):
    """MPJPE-style metrics (lower is better) keep the lowest perf."""
    state = _tiny_state()
    mngr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2,
                             best_mode="min")
    for step, perf in ((1, 60.0), (2, 45.0), (3, 52.0)):
        mngr.save(step, state, epoch=step - 1, perf=perf)
    assert mngr.best_step == 2
    assert os.listdir(tmp_path / "ckpt" / "best") == ["2.pth.tar"]
    mngr.close()


def test_best_perf_recovered_from_payload_on_resume(tmp_path):
    """A reopened manager reads the best perf from the best file's own
    ``perf`` entry, so a worse save cannot replace the best."""
    state = _tiny_state()
    mngr = CheckpointManager(str(tmp_path / "ckpt"), best_mode="min")
    mngr.save(1, state, epoch=0, perf=42.0)
    mngr.close()
    reopened = CheckpointManager(str(tmp_path / "ckpt"), best_mode="min")
    assert reopened._best_perf == 42.0
    assert not reopened._improved(60.0)
    assert reopened._improved(40.0)
    reopened.save(2, state, epoch=1, perf=60.0)
    assert reopened.best_step == 1
    reopened.close()


def test_resolve_and_load_variables_all_layouts(tmp_path):
    """``load_model_variables`` takes every layout the trainer writes: the
    ``checkpoints`` root, ``latest``, ``best``, a step file and
    ``final_state``."""
    state = _tiny_state()
    root = str(tmp_path / "ckpt")
    mngr = CheckpointManager(root, best_mode="min")
    mngr.save(1, state, epoch=0, perf=9.0)
    _bump(state)
    want = _first_param(state)
    mngr.save(2, state, epoch=1, perf=7.0)
    final = mngr.save_final(state)
    mngr.close()
    for path in (root, os.path.join(root, "latest"),
                 os.path.join(root, "best"),
                 os.path.join(root, "2.pth.tar"), final):
        fresh = _tiny_state(seed=1)
        load_model_variables(fresh.model, path)
        assert torch.equal(_first_param(fresh), want), path
    with pytest.raises(FileNotFoundError):
        resolve_checkpoint_path(str(tmp_path / "nonexistent"))


# ------------------------------------------------ the bridge with the JAX
class _State(NamedTuple):
    params: dict
    batch_stats: dict


def _configs():
    cfgs = []
    for load in (jax_load_config, load_config):
        cfg = load(DEBUG_3D)
        cfg.TPU.COMPUTE_DTYPE = "float32"
        cfgs.append(cfg)
    return cfgs


def _batch(seed=0, n=4):
    rng = np.random.default_rng(seed)
    return {"input": rng.integers(0, 256, (n, 64, 64, 3), np.uint8),
            "center": rng.uniform(80, 400, (n, 2)).astype(np.float32),
            "scale": rng.uniform(0.2, 0.6, (n, 2)).astype(np.float32)}


def _jax_preds(jcfg, variables, batch):
    step = jax_make_eval_step(jcfg, jax_get_model(jcfg))
    return np.asarray(step(_State(variables["params"],
                                  variables["batch_stats"]), batch)["preds"])


def _port_preds(tcfg, path, batch):
    model = get_pose_net(tcfg)
    load_model_variables(model, path)
    return make_eval_step(tcfg, model, device="cpu")(batch)["preds"].numpy()


def _write_cfg(dst: pathlib.Path, **train) -> str:
    """The debug 3D yaml with ``TRAIN`` overrides, float32, written as
    ``dst`` (the run directory takes its file name)."""
    data = yaml.safe_load(DEBUG_3D.read_text())
    data.setdefault("TPU", {})["COMPUTE_DTYPE"] = "float32"
    data["TRAIN"].update(train)
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(yaml.safe_dump(data))
    return str(dst)


@contextlib.contextmanager
def quiet_cli():
    """Run a CLI without tensorboard (no metric writer) and give the root
    logger back its handlers afterwards: ``create_logger`` replaces them."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorboard", None)
        try:
            yield
        finally:
            for h in root.handlers:
                if h not in handlers:
                    h.close()
            root.handlers[:] = handlers
            root.setLevel(level)


def _cli_train(cfg_path, out, epochs):
    with quiet_cli():
            return train_cli.main(["--cfg", cfg_path, "--synthetic",
                               "--device", "cpu", "--samples", "32",
                               "--epochs", str(epochs), "--modelDir",
                               str(out), "--logDir", str(out / "log")])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two epochs of the train CLI straight, and one epoch then a resume
    to the second, in two run directories."""
    tmp = tmp_path_factory.mktemp("runs")
    straight = _cli_train(_write_cfg(tmp / "a" / "run.yaml"), tmp / "a", 2)
    _cli_train(_write_cfg(tmp / "b" / "run.yaml"), tmp / "b", 1)
    resumed = _cli_train(_write_cfg(tmp / "b" / "run.yaml", RESUME=True),
                         tmp / "b", 2)
    return straight, resumed


def test_port_checkpoint_read_by_jax(trained):
    jcfg, tcfg = _configs()
    final = trained[0]["final"]
    batch = _batch(0)
    want = _port_preds(tcfg, final, batch)
    got = _jax_preds(jcfg, load_torch_checkpoint(final, 18), batch)
    assert np.ptp(want[..., 0]) > 0.1
    _assert_preds_close(got, want)


def test_jax_checkpoint_read_by_port(tmp_path):
    jcfg, tcfg = _configs()
    params, stats = init_pose_net(jax_get_model(jcfg),
                                  jax.random.PRNGKey(3), (64, 64))
    variables = {"params": jax.tree.map(np.asarray, params),
                 "batch_stats": jax.tree.map(np.asarray, stats)}
    path = str(tmp_path / "jax.pth.tar")
    save_torch_checkpoint(path, variables)
    batch = _batch(1)
    want = _jax_preds(jcfg, variables, batch)
    got = _port_preds(tcfg, path, batch)      # strict=True inside
    _assert_preds_close(got, want)


def test_resume_is_bit_equal_to_a_straight_run(trained):
    straight, resumed = trained
    a, b = straight["state"], resumed["state"]
    assert a.step == b.step == 4
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert a.scheduler.state_dict() == b.scheduler.state_dict()
    assert a.scheduler.get_last_lr() == b.scheduler.get_last_lr()
    assert straight["perf"] == resumed["perf"]


def test_weights_only_reads_every_file_the_port_writes(trained, tmp_path):
    from epipolarpose_tpu_torch.scripts import train_refiner
    ckpt_dir = pathlib.Path(trained[1]["final"]).parent
    files = sorted(ckpt_dir.rglob("*.pth.tar"))
    assert {f.name for f in files} >= {"final_state.pth.tar", "2.pth.tar",
                                       "4.pth.tar"}
    out = train_refiner.main([
        "--cfg", str(DEBUG_3D), "--synthetic", "--device", "cpu",
        "--steps", "2", "--poses", "16", "--hidden", "16", "--out",
        str(tmp_path)])
    for f in files + [pathlib.Path(out["path"])]:
        ckpt = torch.load(f, map_location="cpu", weights_only=True)
        assert "state_dict" in ckpt, f


def test_orbax_directory_raises_with_the_hint(tmp_path):
    from epipolarpose_tpu.core import CheckpointManager as JaxManager
    from epipolarpose_tpu.core import create_train_state as jax_state
    jcfg, tcfg = _configs()
    jmodel = jax_get_model(jcfg)
    mngr = JaxManager(str(tmp_path / "orbax"))
    final = mngr.save_final(jax_state(jcfg, jmodel, jax.random.PRNGKey(0),
                                      1))
    mngr.close()
    model = get_pose_net(tcfg)
    for path in (final, str(tmp_path / "orbax")):
        with pytest.raises(ValueError, match="save_torch_checkpoint"):
            load_model_variables(model, path)


def test_merge_matching_skips_the_head(caplog):
    cfg2d = load_config(DEBUG_3D)
    cfg2d.MODEL.EXTRA.DEPTH_DIM = 1
    teacher = get_pose_net(cfg2d, generator=torch.Generator().manual_seed(1))
    student = get_pose_net(load_config(DEBUG_3D),
                           generator=torch.Generator().manual_seed(2))
    before = {k: v.clone() for k, v in student.state_dict().items()}
    src = teacher.state_dict()
    with caplog.at_level("INFO"):
        skipped = merge_matching(student, src)
    assert skipped == ["final_layer.weight", "final_layer.bias"]
    assert "skipping final_layer.weight" in caplog.text
    after = student.state_dict()
    for k, v in after.items():
        want = before[k] if k in skipped else src[k]
        assert torch.equal(v, want), k
