"""Data parallelism over processes: ``torch.distributed`` in place of the
JAX package's device mesh.

Counterpart of ``epipolarpose_tpu/parallel/mesh.py``. The JAX package
runs one program over a mesh whose ``data`` axis shards the batch; XLA
then reduces the gradients and flax's BatchNorm statistics over the whole
logical batch. The port runs one process per card under
``python -m torch.distributed.run``: each process decodes its slice of
every global batch (the loaders' ``process_index``/``process_count``),
``wrap_model`` gives the model batch norm over the global batch
(``models.pose_resnet.GlobalBatchNorm2d``) and DDP's mean of the
gradients, and ``process_allgather`` brings per-process results together
where the JAX package gathers its sharded arrays.

Every helper here is a no-op in a process without a process group, so
the single-card path runs the same code.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

# the variables torch.distributed.run sets for each process it starts
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
RENDEZVOUS_ENV = ("MASTER_ADDR", "MASTER_PORT")
MESH_MODEL_ITEM = "ROADMAP Queue A item 14"


def init_distributed(device: str | torch.device = "cuda",
                     init_method: str | None = None,
                     backend: str | None = None) -> torch.device:
    """Join the process group that ``torch.distributed.run`` launched (the
    counterpart of ``jax.distributed.initialize()``) and return this
    process's device.

    The rank, world size and local rank come from ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK``; the rendezvous from
    ``MASTER_ADDR``/``MASTER_PORT`` unless ``init_method`` (``file://...``
    or ``tcp://host:port``) is given. On the card the backend is ``nccl``
    and the device ``cuda:LOCAL_RANK``; on the CPU ``gloo``. ``backend``
    overrides that choice: ranks that share one card need ``gloo``, since
    ``nccl`` refuses two ranks on one device. A missing variable raises: a
    run never drops quietly to one process.
    """
    need = LAUNCH_ENV + (RENDEZVOUS_ENV if init_method is None else ())
    missing = [k for k in need if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed needs {', '.join(missing)} in the environment: "
            "launch with python -m torch.distributed.run --nproc-per-node "
            "<cards> -m <module> ... --distributed")
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--distributed on cuda: no CUDA device is "
                               "available; pass --device cpu")
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local}: this host has "
                               f"{torch.cuda.device_count()} cards")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = backend or "nccl"
    elif device.type == "cpu":
        backend = backend or "gloo"
    else:
        raise ValueError(f"device must be cuda or cpu, got {device}")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world)
    return device


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def refuse_model_axis(cfg) -> None:
    """``TPU.MESH.MODEL > 1`` is the JAX package's spatial partitioning of
    image rows (``image_sharding``); the port has no counterpart yet."""
    if int(cfg.TPU.MESH.MODEL) > 1:
        raise NotImplementedError(
            f"TPU.MESH.MODEL = {cfg.TPU.MESH.MODEL}: spatial partitioning of "
            f"image rows over a model axis is not ported ({MESH_MODEL_ITEM});"
            " set it to 1")


def make_mesh(cfg=None) -> int:
    """The size of the data axis: the number of processes.

    ``TPU.MESH.DATA`` of -1 (or 0: every device, as in the JAX package)
    or equal to the number of processes is accepted, any other value
    raises; ``TPU.MESH.MODEL > 1`` raises :class:`NotImplementedError`.
    """
    world = process_count()
    if cfg is not None:
        refuse_model_axis(cfg)
        data = int(cfg.TPU.MESH.DATA)
        if data > 0 and data != world:
            raise ValueError(f"TPU.MESH.DATA = {data} but {world} processes "
                             "run: set it to -1 or launch that many")
    return world


def _comm_device() -> torch.device:
    """Where the backend's collectives take their tensors."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the processes, on ``t``'s device and dtype
    (``t`` itself without a process group)."""
    if process_count() == 1:
        return t
    buf = t.to(_comm_device(), copy=True)
    dist.all_reduce(buf)
    return buf.to(t.device)


def process_allgather(x):
    """Every process's ``x`` concatenated along axis 0 in rank order (a
    tiled gather, as JAX's ``process_allgather(x, tiled=True)``): a numpy
    array for a numpy array, else a tensor on ``x``'s device. The shapes
    must agree; ``x`` itself comes back without a process group."""
    if process_count() == 1:
        return x
    as_numpy = not torch.is_tensor(x)
    t = torch.from_numpy(np.ascontiguousarray(x)) if as_numpy else x
    buf = t.to(_comm_device()).contiguous()
    parts = [torch.empty_like(buf) for _ in range(process_count())]
    dist.all_gather(parts, buf)
    out = torch.cat(parts)
    return out.cpu().numpy() if as_numpy else out.to(t.device)


def mean_over_processes(metrics: dict) -> dict:
    """Scalar metrics averaged over the processes with one all-reduce (the
    JAX step's metrics are means over the global batch; each process's
    are means over its equal slice)."""
    if process_count() == 1:
        return metrics
    keys = sorted(metrics)
    v = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    v = all_reduce_sum(v) / process_count()
    return dict(zip(keys, v.unbind()))


def pod_sync(name: str) -> None:
    """A barrier of every process (``name`` labels it in errors); nothing
    without a process group."""
    if process_count() == 1:
        return
    kw = {}
    if dist.get_backend() == "nccl":
        kw["device_ids"] = [torch.cuda.current_device()]
    try:
        dist.barrier(**kw)
    except RuntimeError as e:
        raise RuntimeError(f"pod_sync({name!r}) failed: {e}") from e


def wrap_model(model: torch.nn.Module) -> DistributedDataParallel:
    """The model for the train step's forward under a process group: its
    batch norms switched to :class:`GlobalBatchNorm2d` (statistics over
    the global batch, the same state-dict names), then wrapped in DDP.

    ``broadcast_buffers`` is off: the global statistics give every
    process the same running buffers by construction, and the running
    variance is written in place. Parameters and buffers are broadcast
    from rank 0 once, when the wrapper is built. The train state keeps
    ``model`` itself (:func:`unwrap`). On a card the wrapper is built on a
    side stream, as PyTorch's notes on CUDA graphs ask of a DDP model
    whose steps a graph will capture (``TPU.FUSED_STEPS``)."""
    from epipolarpose_tpu_torch.models.pose_resnet import (BatchNorm2d,
                                                           GlobalBatchNorm2d)
    if not dist.is_initialized():
        raise RuntimeError("wrap_model needs a process group: call "
                           "init_distributed first")
    for mod in model.modules():
        if type(mod) is BatchNorm2d:
            mod.__class__ = GlobalBatchNorm2d
    device = next(model.parameters()).device
    if device.type != "cuda":
        return DistributedDataParallel(model, broadcast_buffers=False)
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        ddp = DistributedDataParallel(model, device_ids=[device.index],
                                      broadcast_buffers=False)
    current.wait_stream(side)
    return ddp


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The module inside a DDP wrapper (``model`` when it is not one)."""
    return model.module if isinstance(model, DistributedDataParallel) \
        else model
