"""Host -> card feeding: background stages and a prefetching copy.

The port's copy of the JAX package's ``data/pipeline.py``. Two stages run
ahead of the step, each on its own thread with a bounded queue: the
dataset's batch iterator (decode and warp, itself over a thread pool),
then the copy to the card. The copy goes from pinned memory with
``non_blocking=True`` on a side CUDA stream; the consumer's stream waits
on the copy's event before it reads a batch, and every tensor is marked
with ``record_stream`` so its memory is not reused while the consumer's
stream may still read it.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Iterator

import numpy as np
import torch

from epipolarpose_tpu_torch.data.grain_pipeline import grain_epoch_loader
from epipolarpose_tpu_torch.geometry.camera import Camera


def _pipeline_stage(batches: Iterator, size: int, transform: Callable,
                    stats: dict | None = None) -> Iterator:
    """``transform`` over ``batches`` on a background thread, with a
    bounded queue of ``size`` results. An exception reaches the consumer;
    a consumer that stops early releases the producer (and what it
    queued) promptly.

    ``stats``: a dict filled in place with ``items``, ``upstream_wait_s``
    (blocked on the previous stage), ``transform_s`` (this stage's own
    work), ``queue_full_s`` (blocked on the consumer) and ``queue`` (the
    live queue).
    """
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    stop = threading.Event()
    if stats is not None:
        stats.update(items=0, upstream_wait_s=0.0, transform_s=0.0,
                     queue_full_s=0.0, queue=q)

    def enqueue(item) -> bool:
        # bounded put, so an abandoned consumer does not leave this thread
        # blocked forever holding batches
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            it = iter(batches)
            while True:
                t0 = time.perf_counter()
                b = next(it, sentinel)
                t1 = time.perf_counter()
                if b is sentinel:
                    break
                out = transform(b)
                t2 = time.perf_counter()
                if stats is not None:
                    stats["upstream_wait_s"] += t1 - t0
                    stats["transform_s"] += t2 - t1
                    stats["items"] += 1
                if not enqueue(out):
                    return
                if stats is not None:
                    stats["queue_full_s"] += time.perf_counter() - t2
        except BaseException as e:          # passed on to the consumer
            enqueue(e)
            return
        finally:
            # release an upstream stage (its thread and queued batches) as
            # soon as this stage stops pulling
            close = getattr(batches, "close", None)
            if close is not None:
                try:
                    close()
                except Exception as e:     # the consumer raises it
                    enqueue(e)
        enqueue(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break


def host_prefetch(batches: Iterator, size: int = 2,
                  stats: dict | None = None) -> Iterator:
    """Stage 1: pull batches ahead on a background thread, so decoding
    overlaps the copy stage."""
    return _pipeline_stage(batches, size, lambda b: b, stats=stats)


def map_batch(fn: Callable, batch: dict) -> dict:
    """``fn`` over every array of a batch (a :class:`Camera` field by
    field)."""
    return {k: (v.map(fn) if isinstance(v, Camera) else fn(v))
            for k, v in batch.items()}


def _leaves(batch: dict) -> list[torch.Tensor]:
    out = []
    for v in batch.values():
        if isinstance(v, Camera):
            out += [getattr(v, f.name) for f in dataclasses.fields(v)]
        else:
            out.append(v)
    return out


def _tensor(a) -> torch.Tensor:
    return a if torch.is_tensor(a) else torch.from_numpy(
        np.ascontiguousarray(a))


def device_prefetch(batches: Iterator[dict], size: int = 2,
                    device: str | torch.device = "cuda",
                    stats: dict | None = None) -> Iterator[dict]:
    """Stage 2: batches as tensors on ``device``, ``size`` ahead.

    On a CUDA device each batch is copied from pinned memory on a side
    stream; the consumer's current stream waits for the copy before the
    batch is handed over. ``stats`` (see :func:`_pipeline_stage`) also
    gets ``bytes``; with it each copy is waited for on its own thread, so
    ``transform_s`` is the copy's real time (for measurement only).
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        copy_stream = torch.cuda.Stream(device)
    if stats is not None:
        stats["bytes"] = 0

    def put(b):
        if stats is not None:
            stats["bytes"] += sum(_tensor(a).nbytes for a in _leaves(b))
        if not cuda:
            return map_batch(lambda a: _tensor(a).to(device), b), None
        with torch.cuda.stream(copy_stream):
            out = map_batch(lambda a: _tensor(a).pin_memory().to(
                device, non_blocking=True), b)
            done = torch.cuda.Event()
            done.record(copy_stream)
        if stats is not None:
            done.synchronize()
        return out, done

    def consume():
        it = _pipeline_stage(batches, size, put, stats=stats)
        try:
            for out, done in it:
                if done is not None:
                    stream = torch.cuda.current_stream(device)
                    stream.wait_event(done)
                    for t in _leaves(out):
                        t.record_stream(stream)
                yield out
        finally:
            it.close()

    return consume()


def epoch_loader(dataset, batch_size: int, epoch: int, is_train: bool = True,
                 prefetch: int = 2, device: str | torch.device = "cuda",
                 multiview: bool = False, process_index: int = 0,
                 process_count: int = 1,
                 stats: dict | None = None) -> Iterator[dict]:
    """One epoch of batches on ``device``, seeded by ``epoch``.

    ``multiview``: the dataset's ``view_batches`` of ``batch_size`` view
    groups (with the dual crop when training); else its ``batches``
    (shuffled and the remainder dropped when training; in order, the
    remainder padded, otherwise), or with ``TPU.LOADER: grain`` in one
    process the worker processes of
    :func:`grain_pipeline.grain_epoch_loader` (``TPU.GRAIN_WORKERS``, -1
    for ``WORKERS - 1``). Multiview and multi-process runs keep their
    batches: a worker pool's shuffle would change which records a batch
    holds with the process count. ``batch_size`` is global; with
    ``process_count`` > 1 this process decodes its slice of each batch.
    ``stats``: a dict that gets each stage's figures under ``host`` and
    ``device``.
    """
    loader = str(getattr(dataset.cfg.TPU, "LOADER", "threads"))
    if multiview:
        it = dataset.view_batches(batch_size, seed=epoch, shuffle=is_train,
                                  augment=is_train,
                                  process_index=process_index,
                                  process_count=process_count)
    elif loader == "grain" and process_count == 1:
        workers = int(getattr(dataset.cfg.TPU, "GRAIN_WORKERS", -1))
        if workers < 0:
            workers = max(int(dataset.cfg.WORKERS) - 1, 0)
        it = grain_epoch_loader(dataset, batch_size, epoch,
                                is_train=is_train, worker_count=workers)
    else:
        it = dataset.batches(batch_size, seed=epoch, shuffle=is_train,
                             drop_last=is_train, process_index=process_index,
                             process_count=process_count)
    host_stats = device_stats = None
    if stats is not None:
        host_stats = stats.setdefault("host", {})
        device_stats = stats.setdefault("device", {})
    it = host_prefetch(it, size=max(1, prefetch), stats=host_stats)
    return device_prefetch(it, size=max(1, prefetch), device=device,
                           stats=device_stats)
