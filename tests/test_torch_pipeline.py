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
from epipolarpose_tpu_torch.data.grain_pipeline import grain_epoch_loader
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
    """(The name is historical: the port used to refuse the setting.)
    ``TPU.LOADER: grain`` now feeds ``epoch_loader`` from the worker
    loader: an eval epoch gives the ``threads`` loader's bits."""
    ds = _dataset("synthetic")
    want = list(ds.batches(8, seed=0, shuffle=False, drop_last=False))
    ds.cfg.TPU.LOADER = "grain"
    ds.cfg.TPU.GRAIN_WORKERS = 0
    got = list(epoch_loader(ds, 8, epoch=0, is_train=False, device="cpu"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_equal(g, w)


# ------------------------------------------------- the worker-process loader
def _numpy_batches(batches):
    return [{k: np.asarray(v) for k, v in b.items()} for b in batches]


@pytest.mark.parametrize("workers", [0, 2])
def test_grain_eval_batches_equal_jax_grain(workers):
    """Eval: the records in order, the tail padded with the last one, bit
    for bit the JAX package's grain loader (``worker_count=0``), with the
    port's loader in this process or in two worker processes."""
    from epipolarpose_tpu.data.grain_pipeline import (
        grain_epoch_loader as jax_grain)
    jds = _dataset("synthetic", jax_load_config, jax_get_dataset)
    ds = _dataset("synthetic")
    want = _numpy_batches(jax_grain(jds, 8, 3, is_train=False,
                                    worker_count=0))
    got = list(grain_epoch_loader(ds, 8, 3, is_train=False,
                                  worker_count=workers))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    np.testing.assert_array_equal(got[-1]["index"],
                                  [16, 17, 18, 19, 19, 19, 19, 19])


_WORKER_RUN = """
import sys
from multiprocessing import forkserver, resource_tracker
from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.data import get_dataset
from epipolarpose_tpu_torch.data.grain_pipeline import grain_epoch_loader
if __name__ == "__main__":
    cfg = load_config(sys.argv[1])
    ds = get_dataset(cfg, "valid", False, num_samples=8,
                     image_shape=(64, 64))
    assert len(list(grain_epoch_loader(ds, 4, 0, False, 2))) == 2
    print(forkserver._forkserver._forkserver_pid,
          resource_tracker._resource_tracker._pid)
"""


def test_grain_workers_leave_no_process_behind(tmp_path):
    """A process that ran an epoch with workers leaves none of the
    loader's processes behind when it exits: the ``forkserver`` and its
    resource tracker are stopped at exit and waited for (left alone, the
    server outlived its parent by seconds)."""
    import os
    import subprocess
    import sys
    script = tmp_path / "run.py"
    script.write_text(_WORKER_RUN)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, str(script), str(DEBUG_3D)],
                       capture_output=True, text=True, timeout=240, env=env,
                       cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    pids = [int(p) for p in r.stdout.split()]
    assert len(pids) == 2 and all(p > 0 for p in pids), r.stdout
    left = [p for p in pids if pathlib.Path(f"/proc/{p}").exists()]
    assert not left, f"still running after the run exited: {left}"


def test_grain_train_samples_equal_jax_per_record():
    """Train: each side shuffles its own way (grain's index sampler, a
    torch generator seeded by the epoch) and drops the tail; a record's
    sample is the same bits wherever it lands, and another epoch draws
    other augmentations."""
    from epipolarpose_tpu.data.grain_pipeline import (
        grain_epoch_loader as jax_grain)
    jds = _dataset("synthetic", jax_load_config, jax_get_dataset)
    ds = _dataset("synthetic")
    for d in (jds, ds):
        d.is_train = True

    def by_record(batches):
        out = {}
        for b in batches:
            for r, i in enumerate(b["index"]):
                out[int(i)] = {k: v[r] for k, v in b.items()}
        return out

    want = by_record(_numpy_batches(jax_grain(jds, 8, 5, is_train=True)))
    got_batches = list(grain_epoch_loader(ds, 8, 5, is_train=True))
    assert len(got_batches) == 2 and all(len(b["index"]) == 8
                                         for b in got_batches)
    got = by_record(got_batches)
    assert len(got) == len(want) == 16
    shared = sorted(set(got) & set(want))
    assert len(shared) >= 12
    for i in shared:
        for k in want[i]:
            np.testing.assert_array_equal(got[i][k], want[i][k],
                                          err_msg=f"record {i} {k}")
    again = list(grain_epoch_loader(ds, 8, 5, is_train=True))
    other = by_record(grain_epoch_loader(ds, 8, 6, is_train=True))
    for a, b in zip(again, got_batches):
        np.testing.assert_array_equal(a["index"], b["index"])
    i = sorted(set(got) & set(other))[0]
    assert not np.array_equal(got[i]["input"], other[i]["input"])


@pytest.mark.parametrize("grain_workers,workers,want", [(-1, 3, 2),
                                                        (-1, 0, 0),
                                                        (4, 3, 4), (0, 8, 0)])
def test_grain_worker_count_rule(monkeypatch, grain_workers, workers, want):
    """``TPU.GRAIN_WORKERS`` -1 means ``WORKERS - 1`` (at least 0), as in
    the JAX ``epoch_loader``."""
    from epipolarpose_tpu_torch.data import pipeline
    seen = []

    def fake(dataset, batch_size, epoch, is_train=True, worker_count=0):
        seen.append(worker_count)
        return iter(())
    monkeypatch.setattr(pipeline, "grain_epoch_loader", fake)
    ds = _dataset("synthetic")
    ds.cfg.TPU.LOADER = "grain"
    ds.cfg.TPU.GRAIN_WORKERS = grain_workers
    ds.cfg.WORKERS = workers
    assert list(epoch_loader(ds, 8, 0, device="cpu")) == []
    assert seen == [want]


@pytest.mark.parametrize("route", ["multiview", "two_processes"])
def test_grain_falls_through_as_in_jax(monkeypatch, route):
    """Multiview batches and multi-process runs keep the dataset's own
    batches under ``TPU.LOADER: grain`` (JAX ``pipeline.py:205-223``)."""
    from epipolarpose_tpu_torch.data import pipeline

    def refuse(*args, **kwargs):
        raise AssertionError("took the grain route")
    monkeypatch.setattr(pipeline, "grain_epoch_loader", refuse)
    if route == "multiview":
        ds = _dataset("synthetic_multiview")
        ds.cfg.TPU.LOADER = "grain"
        got = list(epoch_loader(ds, 3, 2, is_train=False, device="cpu",
                                multiview=True))
        want = list(ds.view_batches(3, seed=2, shuffle=False))
    else:
        ds = _dataset("synthetic")
        ds.cfg.TPU.LOADER = "grain"
        got = list(epoch_loader(ds, 8, 2, is_train=True, device="cpu",
                                process_index=1, process_count=2))
        want = list(ds.batches(8, seed=2, shuffle=True, drop_last=True,
                               process_index=1, process_count=2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_equal(g, w)


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
