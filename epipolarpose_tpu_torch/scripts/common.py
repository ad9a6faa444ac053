"""What the port's CLIs share: the device argument and ``--distributed``
(the ``(data, model)`` mesh over the processes), the ``--synthetic``
dataset rules, and the settings refused in the port."""

from __future__ import annotations

import logging

import torch

from epipolarpose_tpu_torch.parallel.mesh import (check_row_split,
                                                  init_distributed,
                                                  make_mesh)


def resolve_device(name: str) -> torch.device:
    """``--device``: ``cuda`` needs a card (no quiet fall back to the
    CPU); ``cpu`` runs only when asked for."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    return device


def use_synthetic(cfg, train: bool) -> None:
    """Point ``cfg`` at a synthetic dataset, as the JAX CLIs do: the SS
    route (training with ``LABEL_SOURCE: triangulated``) needs the
    multi-view rig; an integral model trains and evaluates on the rig (its
    records carry camera-frame 3D); a gaussian model on the single-view
    set. A config that names a synthetic dataset keeps it, but for SS."""
    if train and cfg.DATASET.LABEL_SOURCE == "triangulated":
        cfg.DATASET.DATASET = "synthetic_multiview"
    elif not str(cfg.DATASET.DATASET).startswith("synthetic"):
        cfg.DATASET.DATASET = (
            "synthetic_multiview"
            if str(cfg.MODEL.EXTRA.get("TARGET_TYPE")) == "integral"
            else "synthetic")


def dataset_kwargs(cfg, samples: int) -> dict:
    """The synthetic datasets' sizes for ``--samples``: that many samples,
    or ``samples // 4`` frames of 4 views (at least 4)."""
    if cfg.DATASET.DATASET == "synthetic":
        return {"num_samples": samples}
    if cfg.DATASET.DATASET == "synthetic_multiview":
        return {"num_frames": max(samples // 4, 4)}
    return {}


def setup_processes(cfg, device: torch.device, distributed: bool
                    ) -> tuple[torch.device, tuple[int, int]]:
    """``--distributed``: join the process group ``torch.distributed.run``
    launched, one process per card (:func:`parallel.init_distributed`),
    and build the mesh's axis groups (:func:`parallel.make_mesh`).
    Returns (this process's device, the mesh's ``(data, model)`` sizes).
    Without it one process runs on one card (see :func:`log_processes`)."""
    if distributed:
        device = init_distributed(device)
    return device, make_mesh(cfg)


def log_processes(logger: logging.Logger, device: torch.device,
                  mesh: tuple[int, int], distributed: bool) -> None:
    """Log the device, the number of processes and their ``data x model``
    layout. Unlike the JAX package, which spreads one process over every
    local chip, a run without ``--distributed`` uses one card: the count
    it leaves unused is logged."""
    data, model = mesh
    name = (f" ({torch.cuda.get_device_name(device)})"
            if device.type == "cuda" else "")
    logger.info(f"device: {device}{name}; {data * model} process(es): "
                f"data {data} x model {model}")
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if not distributed and cards > 1:
        logger.warning(
            f"one process on one card: {cards - 1} cards left unused; "
            "launch with python -m torch.distributed.run --nproc-per-node "
            "<cards> ... --distributed to use them")


def refuse_unported(cfg) -> None:
    """Raise, before any process group is joined, on what the port does
    not run: a model axis (``TPU.MESH.MODEL > 1``) whose row split
    :func:`parallel.check_row_split` refuses. A model axis otherwise runs
    (``parallel/spatial.py``), and so does ``TPU.FUSED_STEPS``: K steps a
    call, one CUDA-graph replay on the card
    (``core/steps.py::FusedSteps``)."""
    check_row_split(cfg.MODEL.IMAGE_SIZE, int(cfg.TPU.MESH.MODEL))
