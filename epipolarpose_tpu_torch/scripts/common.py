"""What the port's CLIs share: the device argument, the ``--synthetic``
dataset rules, and the flags refused in the port."""

from __future__ import annotations

import torch


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


def refuse_unported(cfg, distributed: bool = False) -> None:
    """Raise on what the port does not run: multi-process training and
    fused steps."""
    if distributed:
        raise NotImplementedError(
            "--distributed: multi-GPU training with torch DDP is not ported "
            "yet (ROADMAP Queue A item 9)")
    if int(cfg.TPU.FUSED_STEPS) > 1:
        raise NotImplementedError(
            "TPU.FUSED_STEPS > 1 has no counterpart in the PyTorch port "
            "(one batch a step); set it to 1")
