"""One rank of the two-process data-parallel runs of
``tests/test_torch_parallel.py``, and the runs themselves, which the test
also makes in one process on the global batches.

    python tests/torch_parallel_worker.py <directory>

with ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set: joins the ``gloo``
group through ``file://<directory>/rendezvous``, reads
``<directory>/inputs.pt`` (weights and global batches), takes this rank's
slice of each batch through ``host_shard_indices``, runs every case and
writes ``<directory>/rank<r>.pt``. Imports the port only.
"""

from __future__ import annotations

import os
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from epipolarpose_tpu_torch.config import load_config  # noqa: E402
from epipolarpose_tpu_torch.core import (CheckpointManager,  # noqa: E402
                                         create_train_state,
                                         make_eval_step, make_train_step,
                                         validate)
from epipolarpose_tpu_torch.core.self_supervised import (  # noqa: E402
    make_ss_train_step)
from epipolarpose_tpu_torch.data import epoch_loader  # noqa: E402
from epipolarpose_tpu_torch.data.joints_dataset import (  # noqa: E402
    host_shard_indices)
from epipolarpose_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticMultiviewDataset)
from epipolarpose_tpu_torch.geometry.camera import Camera  # noqa: E402
from epipolarpose_tpu_torch.kernels.triangulate import (  # noqa: E402
    triangulate_fast)
from epipolarpose_tpu_torch.models import get_pose_net  # noqa: E402
from epipolarpose_tpu_torch.parallel import (init_distributed,  # noqa: E402
                                             process_count, process_index,
                                             wrap_model)

DEBUG_3D = ROOT / "experiments/debug/synth_smoke_3d.yaml"
WORLD = 2
FS_STEPS = 2
EVAL_FRAMES, EVAL_BATCH = 3, 8      # 12 records: a full batch, a padded one


def fs_config():
    """ResNet-18 at 64x64, 17 joints, D 8, float32, Adam."""
    cfg = load_config(DEBUG_3D)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def ss_config(cameras: str):
    """The SS tests' size: 32-wide deconvs, D 4; no confidence gate."""
    cfg = load_config(DEBUG_3D)
    cfg.MODEL.EXTRA.NUM_DECONV_FILTERS = [32, 32, 32]
    cfg.MODEL.EXTRA.DEPTH_DIM = 4
    cfg.DATASET.LABEL_SOURCE = "triangulated"
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.SS_CAMERAS = cameras
    cfg.TPU.SS_CONF_MIN = -1.0
    if cameras == "estimated":
        cfg.TPU.SS_BONE_LENGTH_MM = 250.0
    return cfg


def shard(batch: dict, rank: int, world: int) -> dict:
    """This rank's contiguous slice of every leading axis of a global
    batch (the loaders' slicing)."""
    n = len(batch["input"])
    idx = torch.as_tensor(host_shard_indices(np.arange(n), rank, world))
    return {k: (v.map(lambda t: t[idx]) if isinstance(v, Camera)
                else np.asarray(v)[idx.numpy()]) for k, v in batch.items()}


def _model(cfg, state_dict):
    model = get_pose_net(cfg)
    model.load_state_dict(state_dict, strict=True)
    return model


def _clone(tensors: dict) -> dict:
    return {k: v.detach().clone() for k, v in tensors.items()}


def run_fs(cfg, state_dict, batches, wrap=None) -> dict:
    """``make_train_step`` over ``batches`` through ``wrap(model)``:
    each step's loss, gradients and state dict, and the final state."""
    model = _model(cfg, state_dict)
    state = create_train_state(cfg, model, steps_per_epoch=10, device="cpu")
    step = make_train_step(cfg, wrap(model) if wrap else model, "cpu")
    out = {"loss": [], "grads": [], "state_dict": []}
    for batch in batches:
        state, metrics = step(state, batch)
        out["loss"].append(float(metrics["loss"]))
        out["grads"].append(_clone({n: p.grad for n, p in
                                    model.named_parameters()}))
        out["state_dict"].append(_clone(model.state_dict()))
    out["state"] = state
    return out


def run_ss(cfg, state_dict, batch, wrap=None) -> dict:
    """One SS step (detections in the batch) through ``wrap(model)``: the
    loss, the gradients, the state dict, and every triangulation's
    projection matrices and points (the estimated rig among them)."""
    solves = []

    def solve(pts, P, w):
        X, res = triangulate_fast(pts, P, w)
        solves.append((P.clone(), X.clone()))
        return X, res

    model = _model(cfg, state_dict)
    state = create_train_state(cfg, model, steps_per_epoch=10, device="cpu")
    step = make_ss_train_step(cfg, wrap(model) if wrap else model, None,
                              device="cpu", solve=solve)
    _, metrics = step(state, batch)
    return {"loss": float(metrics["loss"]),
            "tri_residual": float(metrics["tri_residual"]),
            "grads": _clone({n: p.grad for n, p in model.named_parameters()}),
            "state_dict": _clone(model.state_dict()), "solves": solves}


def run_validate(cfg, state_dict) -> dict:
    """``validate`` over ``epoch_loader`` of 12 synthetic records in
    global batches of 8 (the second padded), this process's slice of
    each: the dataset's ``evaluate`` numbers."""
    ds = SyntheticMultiviewDataset(cfg, num_frames=EVAL_FRAMES,
                                   is_train=False, image_shape=(64, 64))
    step = make_eval_step(cfg, _model(cfg, state_dict), device="cpu")
    loader = epoch_loader(ds, EVAL_BATCH, 0, is_train=False, device="cpu",
                          process_index=process_index(),
                          process_count=process_count())
    name_values, perf = validate(cfg, loader, ds, step)
    return {"name_values": dict(name_values), "perf": float(perf)}


def run_checkpoint(cfg, state, directory: str) -> dict:
    """Save through ``CheckpointManager`` (the first process writes), then
    restore into a fresh state on every process."""
    ckpt = CheckpointManager(directory, best_mode="min")
    ckpt.save(int(state.step), state, 0, 1.0)
    final = ckpt.save_final(state)
    fresh = create_train_state(cfg, get_pose_net(cfg), steps_per_epoch=10,
                               device="cpu")
    fresh, epoch = ckpt.restore(fresh)
    want, got = state.model.state_dict(), fresh.model.state_dict()
    return {"final": final, "epoch": epoch, "step": fresh.step,
            "restored_equal": all(torch.equal(want[k], got[k])
                                  for k in want)}


def main(directory: str) -> None:
    directory = pathlib.Path(directory)
    init_distributed("cpu", init_method=f"file://{directory}/rendezvous")
    rank, world = process_index(), process_count()
    inp = torch.load(directory / "inputs.pt", weights_only=False)
    out = {"pid": os.getpid()}
    fs_cfg = fs_config()
    mine = [shard(b, rank, world) for b in inp["fs_batches"]]
    fs = run_fs(fs_cfg, inp["fs_state"], mine, wrap_model)
    out["fs"] = {k: v for k, v in fs.items() if k != "state"}
    # the negative control: DDP with each process's own batch norm
    out["fs_per_rank_bn"] = run_fs(
        fs_cfg, inp["fs_state"], mine[:1],
        lambda m: torch.nn.parallel.DistributedDataParallel(
            m, broadcast_buffers=False))["loss"]
    remat = fs_config()
    remat.TPU.REMAT = True
    out["fs_remat"] = run_fs(remat, inp["fs_state"], mine[:1], wrap_model)
    out["fs_remat"].pop("state")
    out["checkpoint"] = run_checkpoint(fs_cfg, fs["state"],
                                       str(directory / "checkpoints"))
    for cameras in ("given", "estimated"):
        out[f"ss_{cameras}"] = run_ss(
            ss_config(cameras), inp["ss_state"],
            shard(inp[f"ss_{cameras}"], rank, world), wrap_model)
    out["validate"] = run_validate(fs_cfg, inp["eval_state"])
    torch.save(out, directory / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    torch.set_num_threads(1)
    main(sys.argv[1])
