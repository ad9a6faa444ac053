"""Checkpoints: latest, best and final saves as reference-format torch files.

Counterpart of the JAX package's ``core/checkpoint.py``. Orbax is a JAX
library, so the port writes the reference PyTorch layout instead:

- ``checkpoints/<step>.pth.tar``: the latest saves, the 3 newest kept.
  Each holds ``state_dict`` (the model, under the reference names),
  ``optimizer``, ``scheduler``, ``step``, ``epoch`` and ``perf``.
- ``checkpoints/best/<step>.pth.tar``: one save, replaced only when the
  metric improves. Latest and best are kept apart on purpose: retention by
  metric would delete the newest save whenever the metric plateaus, and
  ``TRAIN.RESUME`` would then roll back to an old best step.
- ``checkpoints/final_state.pth.tar``: ``{"state_dict": ...}`` only.

``state_dict`` carries the reference names, so the JAX package's
``models/torch_convert.py::load_torch_checkpoint`` reads every file
written here. Files hold tensors and plain containers only, so
``torch.load(..., weights_only=True)`` reads them; each is written to a
temporary file and renamed into place, so a killed run never leaves a
truncated newest file. Under data parallelism the first process alone
writes, and every process restores, after a barrier, the same file.
"""

from __future__ import annotations

import collections
import logging
import math
import os

import torch

from epipolarpose_tpu_torch.parallel.mesh import pod_sync, process_index

logger = logging.getLogger(__name__)

SUFFIX = ".pth.tar"
ORBAX_HINT = ("the PyTorch port cannot read it without JAX: export it to "
              "a .pth state_dict with the JAX package's "
              "models/torch_convert.py::save_torch_checkpoint first")


def atomic_save(obj, path: str) -> None:
    """``torch.save`` to a temporary file, renamed onto ``path``."""
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _steps(directory: str) -> list[int]:
    """The step numbers of the ``<step>.pth.tar`` files in ``directory``,
    in increasing order."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(n[:-len(SUFFIX)]) for n in os.listdir(directory)
                  if n.endswith(SUFFIX) and n[:-len(SUFFIX)].isdigit())


def resolve_checkpoint_path(path: str) -> str:
    """A user's checkpoint argument -> one ``.pth`` / ``.pth.tar`` file.

    Accepts a file; a ``checkpoints`` root or its ``best`` directory (the
    newest step in it); and ``.../checkpoints/latest`` (the root's newest
    step). Any other directory, an orbax checkpoint among them, raises
    ValueError with the export hint; a missing path FileNotFoundError.
    """
    p = os.path.abspath(path)
    if os.path.isfile(p):
        return p
    if os.path.basename(p) == "latest" and not os.path.exists(p):
        p = os.path.dirname(p)
    steps = _steps(p)
    if steps:
        return os.path.join(p, f"{steps[-1]}{SUFFIX}")
    if os.path.isdir(p):
        raise ValueError(f"{path!r} holds no <step>{SUFFIX} file; if it is "
                         f"an orbax checkpoint, {ORBAX_HINT}")
    raise FileNotFoundError(f"no .pth checkpoint under {path!r}")


def read_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The model entries of a checkpoint: its ``state_dict`` entry when it
    has one (else the whole file), with any ``module.`` prefix dropped.

    Reference files may hold more than tensors, so this reads with
    ``weights_only=False``: load only files you trust.
    """
    resolved = resolve_checkpoint_path(path)
    if not resolved.endswith((".pth", SUFFIX)):
        raise ValueError(f"{path!r}: expected a .pth or .pth.tar file")
    ckpt = torch.load(resolved, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k[len("module."):] if k.startswith("module.") else k:
            torch.as_tensor(v) for k, v in sd.items()}


def load_model_variables(model: torch.nn.Module, path: str,
                         strict: bool = True) -> torch.nn.Module:
    """Load a checkpoint (any path :func:`resolve_checkpoint_path` takes)
    into ``model`` with ``strict`` names and shapes. Returns ``model``."""
    model.load_state_dict(read_state_dict(path), strict=strict)
    return model


def merge_matching(model: torch.nn.Module,
                   state_dict: dict[str, torch.Tensor]) -> list[str]:
    """Copy the entries of ``state_dict`` whose name and shape match
    ``model``'s into it: a 2D teacher's checkpoint initializes a 3D
    student's backbone and deconvolutions, while its J-channel
    ``final_layer`` does not overwrite the J*D-channel head. Logs each
    entry it skips and returns their names."""
    own = model.state_dict()
    skipped, take = [], {}
    for k, v in state_dict.items():
        if k not in own:
            continue
        if tuple(v.shape) == tuple(own[k].shape):
            take[k] = v
        else:
            skipped.append(k)
            logger.info(f"pretrained: skipping {k} {tuple(v.shape)} != "
                        f"{tuple(own[k].shape)}")
    own.update(take)
    model.load_state_dict(own, strict=True)
    return skipped


def _plain(sched_state: dict) -> dict:
    """A scheduler's state with its ``Counter`` (the milestones) made a
    dict, which any ``weights_only`` loader reads."""
    return {k: dict(v) if isinstance(v, collections.Counter) else v
            for k, v in sched_state.items()}


class CheckpointManager:
    """Latest saves kept ``max_to_keep`` deep by recency, one best save
    kept apart, and the final weights (module docstring).

    ``best_mode``: ``"max"`` for PCKh-style perf, ``"min"`` for MPJPE, as
    the dataset's metric direction says. Saves are synchronous, so
    :meth:`wait` and :meth:`close` do nothing; they keep the JAX
    manager's calls. Only the first process makes the directories and
    writes.
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 best_mode: str = "max"):
        if best_mode not in ("max", "min"):
            raise ValueError(f"best_mode must be max or min: {best_mode!r}")
        self.directory = os.path.abspath(directory)
        self.best_dir = os.path.join(self.directory, "best")
        self.writes = process_index() == 0
        if self.writes:
            os.makedirs(self.best_dir, exist_ok=True)
        pod_sync("checkpoint_dirs")
        self.max_to_keep = int(max_to_keep)
        self._best_mode = best_mode
        self._best_perf: float | None = None
        if self.best_step is not None:
            # the best file's own perf: a None here would let the next
            # save replace the best with a worse one
            best = torch.load(self._path(self.best_dir, self.best_step),
                              map_location="cpu", weights_only=True)
            self._best_perf = float(best["perf"])

    @staticmethod
    def _path(directory: str, step: int) -> str:
        return os.path.join(directory, f"{int(step)}{SUFFIX}")

    def _improved(self, perf: float) -> bool:
        if self._best_perf is None or not math.isfinite(self._best_perf):
            return True
        return (perf > self._best_perf if self._best_mode == "max"
                else perf < self._best_perf)

    def save(self, step: int, state, epoch: int, perf: float) -> None:
        """Save the model, optimizer, schedule and progress as the newest
        latest file; copy it to ``best/`` when the metric improved."""
        payload = {
            "state_dict": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "scheduler": _plain(state.scheduler.state_dict()),
            "step": int(state.step), "epoch": int(epoch),
            "perf": float(perf)}
        if not self.writes:
            return
        atomic_save(payload, self._path(self.directory, step))
        for old in _steps(self.directory)[:-self.max_to_keep]:
            os.remove(self._path(self.directory, old))
        if self._improved(perf):
            self._best_perf = float(perf)
            atomic_save(payload, self._path(self.best_dir, step))
            for old in _steps(self.best_dir):
                if old != int(step):
                    os.remove(self._path(self.best_dir, old))

    def restore(self, state, step: int | None = None):
        """Load the newest latest save (or ``step``'s) into ``state``: the
        model, the optimizer's moments and rate, the schedule's position
        and the step count. Returns (state, epoch + 1), or (state, 0)
        when there is nothing to restore. Every process waits at a
        barrier first, so it reads what the first process wrote."""
        pod_sync("checkpoint_restore")
        steps = _steps(self.directory)
        if step is None and not steps:
            return state, 0
        step = steps[-1] if step is None else step
        ckpt = torch.load(self._path(self.directory, step),
                          map_location="cpu", weights_only=True)
        state.model.load_state_dict(ckpt["state_dict"], strict=True)
        state.optimizer.load_state_dict(ckpt["optimizer"])
        sched = dict(ckpt["scheduler"])
        for k, v in state.scheduler.state_dict().items():
            if isinstance(v, collections.Counter):
                sched[k] = collections.Counter(sched[k])
        state.scheduler.load_state_dict(sched)
        state.step = int(ckpt["step"])
        return state, int(ckpt["epoch"]) + 1

    @property
    def best_step(self) -> int | None:
        steps = _steps(self.best_dir)
        return steps[-1] if steps else None

    def save_final(self, state) -> str:
        """The model's weights alone, ``final_state.pth.tar``; returns its
        path (on every process, once the first has written it)."""
        path = os.path.join(self.directory, f"final_state{SUFFIX}")
        if self.writes:
            atomic_save({"state_dict": state.model.state_dict()}, path)
        pod_sync("checkpoint_final")
        return path

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open."""
