"""The multi-process host loader (``TPU.LOADER: grain``).

Counterpart of the JAX package's ``data/grain_pipeline.py``, built on
``torch.utils.data.DataLoader`` (the reference's own loader) in place of
``grain``, which the port does not import. Worker processes each decode,
augment and warp single samples (``JointsDataset._load_one``, seeded
``seed * 1_000_003 + index`` as every loader of the repo seeds them);
the batches feed ``epoch_loader``'s copy stage, which pins them. This is
the route for hosts where the Python side of the decode would serialize
on the interpreter lock.

Workers start with ``forkserver``, a start method CUDA allows once the
card is initialised in the parent (``fork`` copies a process whose CUDA
context and loader threads the child cannot use safely). The server is
a fresh single-threaded interpreter that imports this module (and with
it ``torch`` and the datasets) once per process; each epoch's workers
are forked from it and receive the pickled dataset (its thread pool
dropped, ``JointsDataset.__getstate__``). With ``spawn`` every worker
imported ``torch`` anew, and the parent's pickled dataset waited in the
pipe until it had: on an H100 host, 36 s before the first batch with 4
workers and 69 s with 8 (``chip_smoke.py`` phase ``loader_workers``).
Workers run numpy only and never touch CUDA. A worker that sends nothing
for :data:`WORKER_TIMEOUT_S` raises in place of hanging the run.

The server lives from the first epoch with workers to the end of the
process, and :func:`stop_worker_server` ends it then (registered at
exit): left to itself it outlives its parent by the seconds its preload
of ``torch`` takes, because it reads the end of its pipe only after.
"""

from __future__ import annotations

import atexit
import multiprocessing
from typing import Iterator

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset

from epipolarpose_tpu_torch.data.joints_dataset import record_seed

# seconds a batch from a worker process may take before the loader raises
WORKER_TIMEOUT_S = 300.0


class _SampleSource(Dataset):
    """Map-style view of a ``JointsDataset``: one decoded, augmented sample
    an index. The dataset's own thread pool and native batching are not
    used: the worker processes are the parallelism."""

    def __init__(self, dataset, seed: int):
        self._ds = dataset
        self._seed = seed

    def __len__(self) -> int:
        return len(self._ds.records)

    def __getitem__(self, idx: int) -> dict:
        return self._ds._load_one(int(idx), record_seed(self._seed, idx))


def _worker_context():
    """The workers' start method: ``forkserver``, its server preloading
    this module and stopped at exit."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    atexit.unregister(stop_worker_server)       # registered once
    atexit.register(stop_worker_server)
    return ctx


def stop_worker_server() -> None:
    """Stop the workers' server and the resource tracker it started, and
    wait for both to exit; a later epoch with workers starts them anew.
    No-op when neither runs. Call it only between epochs: the tracker
    exits once every worker has. The stop methods are the standard
    library's own (``ForkServer._stop``, ``ResourceTracker._stop``),
    which it has no public name for."""
    from multiprocessing import forkserver, resource_tracker
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def _stack(samples: list[dict]) -> dict:
    """Samples -> one batch of stacked numpy arrays."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def grain_epoch_loader(dataset, batch_size: int, epoch: int,
                       is_train: bool = True, worker_count: int = 0
                       ) -> Iterator[dict]:
    """One epoch of host batches (dicts of numpy arrays, the keys of
    ``JointsDataset.get_batch``) from ``worker_count`` worker processes;
    0 runs in this process.

    Training shuffles with a ``torch.Generator`` seeded by ``epoch`` and
    drops the tail; evaluation keeps the records' order and pads its tail
    by repeating the last sample, so every batch has ``batch_size`` rows,
    as ``JointsDataset.batches`` does. Memory is not pinned here.
    """
    workers = int(worker_count)
    loader = DataLoader(
        _SampleSource(dataset, seed=epoch), batch_size=batch_size,
        shuffle=bool(is_train),
        generator=torch.Generator().manual_seed(epoch) if is_train else None,
        drop_last=bool(is_train), num_workers=workers, collate_fn=_stack,
        pin_memory=False,
        multiprocessing_context=_worker_context() if workers > 0 else None,
        timeout=WORKER_TIMEOUT_S if workers > 0 else 0)
    for out in loader:
        short = len(out["index"])
        if short < batch_size:                  # pad the eval remainder
            out = {k: np.concatenate(
                [v, np.repeat(v[-1:], batch_size - short, axis=0)])
                for k, v in out.items()}
        yield out
