"""Data parallelism and the model axis over processes: ``torch.distributed``
in place of the JAX package's device mesh.

Counterpart of ``epipolarpose_tpu/parallel/mesh.py``. The JAX package
runs one program over a ``(data, model)`` mesh: ``data`` shards the
batch, ``model`` (``TPU.MESH.MODEL > 1``) the image rows of ``"input"``;
XLA then adds each convolution's halo exchange and reduces the gradients
and flax's BatchNorm statistics over the whole logical batch. The port
runs one process per card under ``python -m torch.distributed.run``,
``D * M`` of them: rank ``r`` is data index ``r // M`` and model index
``r % M`` (JAX's ``reshape(data, model)``). :func:`make_mesh` builds the
two axis groups once. Each data group of ``M`` consecutive ranks decodes
the same slice of every global batch (the loaders take
:func:`data_index`/:func:`data_count`), each of its ranks runs the
network on its own rows with halo exchanges (``parallel/spatial.py``,
``models.pose_resnet.partition_rows``); ``wrap_model`` gives the model
batch norm over every process (``models.pose_resnet.GlobalBatchNorm2d``)
and DDP's mean of the gradients, and ``process_allgather`` brings
per-process results together where the JAX package gathers its sharded
arrays.

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
# rows a process must hold under a model axis: ResNet's five stride-2
# layers (stem, max pool, layers 2-4) keep every stage's first local row
# even only when each process's rows are a multiple of 2**5
ROW_ALIGN = 32

# the axis groups :func:`make_mesh` built, for the process group it built
# them in (``dist.group.WORLD`` then)
_AXES: dict = {}


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


def check_row_split(image_size, model: int) -> None:
    """Refuse a model axis whose row split leaves a process a number of
    rows that is not a multiple of :data:`ROW_ALIGN`. ``image_size`` is
    ``MODEL.IMAGE_SIZE`` (width, height). The JAX package falls back to
    data-only sharding when ``H % M`` is not 0 and lets GSPMD pad uneven
    stages; the port refuses such shapes by name."""
    rows, model = int(image_size[1]), int(model)
    if model > 1 and (rows % model or rows // model % ROW_ALIGN):
        raise ValueError(
            f"TPU.MESH.MODEL = {model}: {rows} image rows split {model} ways"
            f" is not {ROW_ALIGN}-aligned; each process's rows must be a "
            f"multiple of {ROW_ALIGN} (ResNet's five stride-2 layers)")


def make_mesh(cfg=None) -> tuple[int, int]:
    """The sizes ``(data, model)`` of the mesh over the processes, and its
    axis groups, built once for this process group: a model group of
    ``M`` consecutive ranks and a data group of the ranks with one model
    index.

    ``TPU.MESH.MODEL`` is ``M`` (1 without ``cfg``); ``TPU.MESH.DATA`` of
    -1 (or 0: every process, as in the JAX package) or ``world / M`` is
    accepted. Any layout whose ``DATA x MODEL`` is not the number of
    processes raises, and so does a row split :func:`check_row_split`
    refuses.
    """
    world = process_count()
    model = max(1, int(cfg.TPU.MESH.MODEL)) if cfg is not None else 1
    data = int(cfg.TPU.MESH.DATA) if cfg is not None else -1
    if world % model or (data > 0 and data * model != world):
        raise ValueError(
            f"TPU.MESH.DATA = {data} x TPU.MESH.MODEL = {model} does not "
            f"match {world} processes: launch DATA x MODEL processes "
            "(DATA -1 takes world / MODEL)")
    if model > 1:
        check_row_split(cfg.MODEL.IMAGE_SIZE, model)
    if dist.is_initialized() and not (_axes() and _AXES["model"] == model):
        _build_axes(model)
    return world // model, model


def _build_axes(model: int) -> None:
    """Every rank creates every group, in the same order, as
    ``dist.new_group`` asks; each keeps its own two."""
    _AXES.clear()
    world, rank = process_count(), process_index()
    groups = {"model_group": None, "data_group": None}
    if model > 1:
        for d in range(world // model):
            ranks = list(range(d * model, (d + 1) * model))
            g = dist.new_group(ranks)
            if rank in ranks:
                groups["model_group"] = g
        for m in range(model):
            ranks = list(range(m, world, model))
            g = dist.new_group(ranks)
            if rank in ranks:
                groups["data_group"] = g
    _AXES.update(groups, model=model, world=dist.group.WORLD)


def _axes() -> dict | None:
    """The axis groups, when they belong to the live process group."""
    if dist.is_initialized() and _AXES.get("world") is dist.group.WORLD:
        return _AXES
    return None


def model_count() -> int:
    """The size of the model axis: the processes that split one batch's
    image rows (1 without a process group or a model axis)."""
    axes = _axes()
    return axes["model"] if axes else 1


def model_index() -> int:
    """This process's place on the model axis: which rows it holds."""
    return process_index() % model_count()


def data_count() -> int:
    """The size of the data axis: the slices of each global batch."""
    return process_count() // model_count()


def data_index() -> int:
    """Which slice of each global batch this process's group holds."""
    return process_index() // model_count()


def model_group():
    """This process's model group (``None`` without a model axis)."""
    axes = _axes()
    return axes["model_group"] if axes else None


def data_group():
    """This process's data group: the ranks of its model index (``None``,
    the default group, without a model axis)."""
    axes = _axes()
    return axes["data_group"] if axes else None


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


def group_allgather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every member's ``t`` of ``group`` (the default group for ``None``)
    stacked on a new leading axis in group-rank order, on ``t``'s device.
    The shapes and dtypes must agree. Under ``gloo`` the bytes go through
    the host; they travel as ``uint8``, so any dtype does, bf16 too."""
    n = dist.get_world_size(group)
    buf = t.detach().to(_comm_device()).contiguous().reshape(-1)
    raw = buf.view(torch.uint8)
    parts = torch.empty((n,) + raw.shape, dtype=torch.uint8,
                        device=raw.device)
    dist.all_gather(list(parts.unbind()), raw, group=group)
    return parts.to(t.device).view(t.dtype).reshape((n,) + t.shape)


def process_allgather(x, group=None):
    """Every process's ``x`` (of ``group``: the default group for ``None``)
    concatenated along axis 0 in rank order (a tiled gather, as JAX's
    ``process_allgather(x, tiled=True)``): a numpy array for a numpy
    array, else a tensor on ``x``'s device. The shapes must agree; ``x``
    itself comes back without a process group or from a group of one."""
    if process_count() == 1 or dist.get_world_size(group) == 1:
        return x
    as_numpy = not torch.is_tensor(x)
    t = torch.from_numpy(np.ascontiguousarray(x)) if as_numpy else x
    out = group_allgather(t, group).flatten(0, 1)
    return out.numpy() if as_numpy else out


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
