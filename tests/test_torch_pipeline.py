"""The port's loader (``data/pipeline.py``) and ``validate`` over it.

- ``epoch_loader(device="cpu")`` yields exactly ``dataset.batches`` /
  ``view_batches`` as tensors (equal bits), with the stages' figures.
- The prefetch stages pass an error on to the consumer and release an
  abandoned producer, as ``tests/test_data.py`` holds the JAX ones.
- End to end on ``experiments/debug/synth_smoke_3d.yaml`` (ResNet-18 at
  64x64, 17 joints, D = 8, float32, flip test): the port's
  ``validate(epoch_loader(ds))`` against the JAX package's ``validate``
  over its own ``epoch_loader``, with the same weights (the bridge
  ``from_jax_variables``), on both synthetic datasets. The crops are
  equal bits (64 px wide); the forwards differ by float32 summation
  order, so each metric is held at rtol 1e-4 (MPJPE-family, in mm) or
  to within one joint's share (PCKh, in percent).
"""

import pathlib
import threading
import time
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from epipolarpose_tpu.config import load_config as jax_load_config
from epipolarpose_tpu.core import function as jfunction
from epipolarpose_tpu.core.steps import make_eval_step as jax_make_eval_step
from epipolarpose_tpu.data import get_dataset as jax_get_dataset
from epipolarpose_tpu.data.h36m import FLIP_PAIRS
from epipolarpose_tpu.data.pipeline import epoch_loader as jax_epoch_loader
from epipolarpose_tpu.models import get_model as jax_get_model
from epipolarpose_tpu.models import init_pose_net
from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.core import function as tfunction
from epipolarpose_tpu_torch.core.steps import make_eval_step
from epipolarpose_tpu_torch.data import get_dataset
from epipolarpose_tpu_torch.data.pipeline import (device_prefetch,
                                                  epoch_loader, host_prefetch)
from epipolarpose_tpu_torch.geometry.camera import Camera
from epipolarpose_tpu_torch.models import from_jax_variables, get_pose_net

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEBUG_3D = ROOT / "experiments/debug/synth_smoke_3d.yaml"


def _cfg(name="synthetic", load=load_config):
    cfg = load(DEBUG_3D)
    cfg.DATASET.DATASET = name
    cfg.DATASET.FLIP = True
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TEST.FLIP_TEST = True
    return cfg


def _dataset(name, load=load_config, getter=get_dataset):
    kw = (dict(num_samples=20, image_shape=(96, 96)) if name == "synthetic"
          else dict(num_frames=6, image_shape=(64, 64), pose_mode="skeleton"))
    return getter(_cfg(name, load), "valid", False, seed=1, **kw)


def _assert_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k == "camera":
            for f in ("R", "T", "f", "c", "k", "p"):
                assert torch.equal(getattr(got[k], f), getattr(v, f))
        else:
            assert torch.is_tensor(got[k]) and got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("mode", ["eval", "train", "multiview"])
def test_epoch_loader_on_cpu_equals_the_dataset(mode):
    name = "synthetic_multiview" if mode == "multiview" else "synthetic"
    ds = _dataset(name)
    is_train = mode != "eval"
    stats = {}
    got = list(epoch_loader(ds, 3 if mode == "multiview" else 8, epoch=2,
                            is_train=is_train, device="cpu",
                            multiview=mode == "multiview", stats=stats))
    if mode == "multiview":
        want = list(ds.view_batches(3, seed=2, shuffle=True, augment=True))
        assert isinstance(got[0]["camera"], Camera)
        assert got[0]["input_aug"].shape == (3, 4, 64, 64, 3)
    else:
        want = list(ds.batches(8, seed=2, shuffle=is_train,
                               drop_last=is_train))
    # 20 records: 2 training batches (remainder dropped), 3 eval batches
    # (remainder padded); 6 frames: 2 view batches of 3 groups
    assert len(got) == len(want) == {"eval": 3, "train": 2,
                                     "multiview": 2}[mode]
    for g, w in zip(got, want):
        _assert_equal(g, w)
    for stage in ("host", "device"):
        assert stats[stage]["items"] == len(want)
        assert stats[stage]["transform_s"] >= 0.0
    assert stats["device"]["bytes"] > 0


def test_epoch_loader_refuses_grain():
    ds = _dataset("synthetic")
    ds.cfg.TPU.LOADER = "grain"
    with pytest.raises(NotImplementedError, match="item 9"):
        epoch_loader(ds, 8, epoch=0, device="cpu")


@pytest.mark.parametrize("stage", ["host", "device"])
def test_prefetch_propagates_errors(stage):
    def gen():
        yield {"x": np.zeros(3)}
        raise RuntimeError("boom")

    it = (host_prefetch(gen(), size=1) if stage == "host"
          else device_prefetch(gen(), size=1, device="cpu"))
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_prefetch_releases_producer_on_abandon():
    """Closing the loader early stops both stages' producers (bounded
    puts and a stop flag) instead of leaving them blocked on a full
    queue."""
    started = threading.Event()
    produced = []

    def gen():
        for i in range(100):
            started.set()
            produced.append(i)
            yield {"x": np.full(3, i)}

    n_threads = threading.active_count()
    it = device_prefetch(host_prefetch(gen(), size=1), size=1, device="cpu")
    next(it)
    started.wait(5)
    it.close()
    deadline = time.time() + 10
    while time.time() < deadline:
        n = len(produced)
        time.sleep(0.8)
        if len(produced) == n:           # the producer stopped
            break
    stalled_at = len(produced)
    time.sleep(1.2)
    assert len(produced) == stalled_at < 100, \
        "producer kept running after the consumer abandoned the loader"
    deadline = time.time() + 5
    while threading.active_count() > n_threads and time.time() < deadline:
        time.sleep(0.1)
    assert threading.active_count() <= n_threads


class _State(NamedTuple):
    """The two fields of the JAX train state that its eval step reads."""
    params: dict
    batch_stats: dict


@pytest.fixture(scope="module")
def steps():
    """The JAX eval step and the port's on the same weights (head at std
    0.05 so that the joints decode apart); one JAX compile serves both
    datasets (the same batch shape)."""
    rng = np.random.default_rng(3)
    jcfg, tcfg = _cfg(load=jax_load_config), _cfg()
    jmodel = jax_get_model(jcfg)
    params, stats = init_pose_net(jmodel, jax.random.PRNGKey(0), (64, 64))
    params = jax.tree.map(np.asarray, params)
    stats = jax.tree.map(np.asarray, stats)
    for name in ("deconv1", "deconv2", "deconv3", "final_layer"):
        k = params[name]["kernel"]
        params[name]["kernel"] = rng.normal(0, 0.05, k.shape).astype(
            np.float32)
    state = _State(params, stats)
    jstep = jax_make_eval_step(jcfg, jmodel, flip_pairs=FLIP_PAIRS)
    model = get_pose_net(tcfg)
    model.load_state_dict(from_jax_variables(
        {"params": params, "batch_stats": stats}), strict=True)
    tstep = make_eval_step(tcfg, model, FLIP_PAIRS, device="cpu")
    return state, jstep, tstep


@pytest.mark.parametrize("name", ["synthetic", "synthetic_multiview"])
def test_validate_over_epoch_loader_matches_jax(name, steps):
    state, jstep, tstep = steps
    jds = _dataset(name, jax_load_config, jax_get_dataset)
    tds = _dataset(name)
    bs = int(tds.cfg.TEST.BATCH_SIZE)
    jn, jperf = jfunction.validate(
        jds.cfg, jax_epoch_loader(jds, bs, 0, is_train=False), jds, state,
        jstep)
    tn, tperf = tfunction.validate(
        tds.cfg, epoch_loader(tds, bs, 0, is_train=False, device="cpu"),
        tds, tstep)
    assert list(tn) == list(jn)
    if name == "synthetic":
        # PCKh in percent: one joint of the 340 may cross the threshold
        assert tperf == pytest.approx(jperf, abs=100 / (20 * 17) + 1e-6)
        assert 0.0 < tperf < 100.0
    else:
        assert set(tn) == {"Synth", "MPJPE", "NMPJPE", "PA-MPJPE"}
        for k in jn:
            assert tn[k] == pytest.approx(jn[k], rel=1e-4), k
        assert tperf == pytest.approx(jperf, rel=1e-4)
