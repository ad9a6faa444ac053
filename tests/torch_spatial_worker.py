"""One rank of the model-axis runs of ``tests/test_torch_spatial.py``, and
the runs themselves, which the test also makes in one process.

    python tests/torch_spatial_worker.py <directory> <data> <model>

(``1 1``: the same cases in one process, the reference) with ``RANK``,
``WORLD_SIZE`` (``data * model``) and ``LOCAL_RANK`` set:
joins the ``gloo`` group through ``file://<directory>/rendezvous``, reads
``<directory>/inputs.pt`` (weights, layer cases and global batches),
builds the ``(data, model)`` mesh with ``parallel.make_mesh``, takes its
data group's slice of each batch (``host_shard_indices`` at
``data_index``/``data_count``), runs every case through a model switched
by ``models.partition_rows`` and writes ``<directory>/rank<r>.pt``. With
four processes the layer cases run on a model axis of 4 first (interior
ranks), then the steps on the 2 x 2 mesh. Imports the port only.

What is written stays small (the suite's temporary directory is shared):
the first rank and the reference keep the tensors the test compares
(step 1's gradients, the parameters and buffers a step is held by, the
SS step's buffers), every rank keeps a sha256 of each gradient and state
tensor for the bit-for-bit check, and of the checkpoints only
``final_state.pth.tar`` is left once every rank has restored the latest.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import sys

import numpy as np
import torch
from torch import nn

ROOT = pathlib.Path(__file__).resolve().parents[1]
for path in (ROOT, ROOT / "tests"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from epipolarpose_tpu_torch.config import load_config  # noqa: E402
from epipolarpose_tpu_torch.core import (create_train_state,  # noqa: E402
                                         make_eval_step, make_train_step,
                                         validate)
from epipolarpose_tpu_torch.data import epoch_loader  # noqa: E402
from epipolarpose_tpu_torch.data.h36m import FLIP_PAIRS  # noqa: E402
from epipolarpose_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticMultiviewDataset)
from epipolarpose_tpu_torch.models import (get_pose_net,  # noqa: E402
                                           partition_rows)
from epipolarpose_tpu_torch.models.pose_resnet import (  # noqa: E402
    SameDeconv2d)
from epipolarpose_tpu_torch.parallel import (data_count,  # noqa: E402
                                             data_index, init_distributed,
                                             local_rows, make_mesh, pod_sync,
                                             process_index, wrap_model)
import torch_parallel_worker as pw  # noqa: E402

DEBUG_2D = ROOT / "experiments/debug/synth_smoke.yaml"
# the layer cases' global input: (N, C, rows, W); rows split 2 or 4 ways
LAYER_SHAPE = (2, 8, 128, 12)
LAYER_GRAD_SEED = 9


def layer_cases() -> dict:
    """Every row-sensitive layer of the network alone (and the 1x1 stride-2
    convolution, which reads no halo): name -> (module, input channels)."""
    return {
        "stem": (lambda: nn.Conv2d(3, 8, 7, 2, 3, bias=False), 3),
        "maxpool": (lambda: nn.MaxPool2d(3, 2, 1), 8),
        "conv3x3_s1": (lambda: nn.Conv2d(8, 8, 3, 1, 1, bias=False), 8),
        "conv3x3_s2": (lambda: nn.Conv2d(8, 8, 3, 2, 1, bias=False), 8),
        "conv1x1_s2": (lambda: nn.Conv2d(8, 8, 1, 2, bias=False), 8),
        "deconv_k2": (lambda: SameDeconv2d(8, 8, 2), 8),
        "deconv_k3": (lambda: SameDeconv2d(8, 8, 3), 8),
        "deconv_k4": (lambda: SameDeconv2d(8, 8, 4), 8),
        "final_k1": (lambda: nn.Conv2d(8, 5, 1), 8),
        "final_k3": (lambda: nn.Conv2d(8, 5, 3, 1, 1), 8),
    }


def layer_inputs(name: str) -> tuple[nn.Module, torch.Tensor]:
    """The case's layer (seeded weights) and its global input (normal, so
    the max pool's edges see negative values)."""
    make, channels = layer_cases()[name]
    torch.manual_seed(len(name))
    layer = make()
    g = torch.Generator().manual_seed(3)
    x = torch.randn((LAYER_SHAPE[0], channels) + LAYER_SHAPE[2:],
                    generator=g)
    return layer, x


def run_layer(layer: nn.Module, x: torch.Tensor) -> dict:
    """The layer's output on ``x`` and the gradient of ``sum(y * g)`` with
    respect to ``x`` (``g`` seeded from the output's shape): on this
    process's rows of both under a model axis."""
    x = local_rows(x, 2).clone().requires_grad_(True)
    y = layer(x)
    shape = list(y.shape)
    shape[2] *= LAYER_SHAPE[2] // x.shape[2]
    g = torch.randn(shape, generator=torch.Generator().manual_seed(
        LAYER_GRAD_SEED))
    (y * local_rows(g, 2)).sum().backward()
    return {"y": y.detach(), "dx": x.grad}


def mesh_config(data: int, model: int, rows: int = 64):
    cfg = pw.fs_config()
    cfg.TPU.MESH.DATA, cfg.TPU.MESH.MODEL = data, model
    cfg.MODEL.IMAGE_SIZE = [64, rows]
    return cfg


def gaussian_config():
    """ResNet-18 at 64x64, 16 joints, gaussian heatmaps, float32, Adam."""
    cfg = load_config(DEBUG_2D)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def eval_config():
    """The FS config with the flip test and the heatmap shift."""
    cfg = pw.fs_config()
    cfg.TEST.FLIP_TEST = True
    cfg.TEST.SHIFT_HEATMAP = True
    return cfg


def split(model: nn.Module) -> nn.Module:
    """The train step's model under a process group: rows and DDP."""
    return wrap_model(partition_rows(model))


def run_eval(cfg, state_dict, batch, prepare=None) -> torch.Tensor:
    """The flip-test eval step's predictions (H36M flip pairs)."""
    model = pw._model(cfg, state_dict)
    if prepare is not None:
        model = prepare(model)
    return make_eval_step(cfg, model, FLIP_PAIRS, device="cpu")(
        batch)["preds"]


def run_validate(cfg, state_dict) -> dict:
    """``validate`` over ``epoch_loader`` of 12 synthetic records in
    global batches of 8 (the second padded), this data group's slice of
    each, through the row-split model."""
    ds = SyntheticMultiviewDataset(cfg, num_frames=pw.EVAL_FRAMES,
                                   is_train=False, image_shape=(64, 64))
    model = partition_rows(pw._model(cfg, state_dict))
    step = make_eval_step(cfg, model, device="cpu")
    loader = epoch_loader(ds, pw.EVAL_BATCH, 0, is_train=False,
                          device="cpu", process_index=data_index(),
                          process_count=data_count())
    name_values, perf = validate(cfg, loader, ds, step)
    return {"name_values": dict(name_values), "perf": float(perf)}


def digest(grads: dict, state: dict) -> dict:
    """sha256 of each gradient and state tensor's bytes."""
    items = [(f"grad {k}", v) for k, v in grads.items()]
    items += [(f"state {k}", v) for k, v in state.items()]
    return {k: hashlib.sha256(v.detach().contiguous().numpy().tobytes())
            .hexdigest() for k, v in items}


def kept_steps(run: dict, full: bool) -> dict:
    """A ``run_fs`` result as written: the losses and each step's digest;
    with ``full`` step 1's gradients and every step's state."""
    out = {"loss": run["loss"],
           "digest": [digest(g, sd) for g, sd in zip(run["grads"],
                                                     run["state_dict"])]}
    if full:
        out.update(grads=run["grads"][:1], state_dict=run["state_dict"])
    return out


def kept_ss(run: dict, full: bool) -> dict:
    """A ``run_ss`` result as written: loss, residual, the digest, the
    number of points of the last solve; with ``full`` the gradients and
    the BN buffers."""
    out = {"loss": run["loss"], "tri_residual": run["tri_residual"],
           "digest": digest(run["grads"], run["state_dict"]),
           "solve_points": int(run["solves"][-1][1].shape[0])}
    if full:
        out.update(grads=run["grads"], state_dict={
            k: v for k, v in run["state_dict"].items() if "running" in k})
    return out


def main(directory: str, data: int, model: int) -> None:
    """The rank's cases on the ``data x model`` mesh; with ``1 1`` the same
    cases in one process without a process group (the reference, made
    on one thread as the ranks are), written as ``one.pt``."""
    directory = pathlib.Path(directory)
    world = data * model
    inp = torch.load(directory / "inputs.pt", weights_only=False)
    out = {"pid": os.getpid(), "layers": {}}
    if world > 1:
        init_distributed("cpu", init_method=f"file://{directory}/rendezvous")
        # the layers alone on one model axis of every process
        make_mesh(mesh_config(1, world, 32 * world))
    for name in layer_cases():
        layer, x = layer_inputs(name)
        if world > 1:
            layer = partition_rows(nn.Sequential(layer))[0]
        out["layers"][name] = run_layer(layer, x)
    out["layer_mesh"] = (1, world)

    make_mesh(mesh_config(data, model))
    d, n = data_index(), data_count()
    full = process_index() == 0
    prepare, wrap = (partition_rows, split) if world > 1 else (None, None)
    mine = [pw.shard(b, d, n) for b in inp["fs_batches"]]
    fs_cfg = pw.fs_config()
    fs = pw.run_fs(fs_cfg, inp["fs_state"], mine, wrap)
    out["fs"] = kept_steps(fs, full)
    out["gaussian"] = kept_steps(pw.run_fs(
        gaussian_config(), inp["gaussian_state"],
        [pw.shard(inp["gaussian_batch"], d, n)], wrap), full)
    out["eval"] = run_eval(eval_config(), inp["fs_state"],
                           pw.shard(inp["eval_batch"], d, n), prepare)
    for cameras in ("given", "estimated"):
        out[f"ss_{cameras}"] = kept_ss(pw.run_ss(
            pw.ss_config(cameras), inp["ss_state"],
            pw.shard(inp[f"ss_{cameras}"], d, n), wrap), full)
    out["validate"] = run_validate(fs_cfg, inp["fs_state"])
    if world == 1:
        torch.save(out, directory / "one.pt")
        return
    remat = pw.fs_config()
    remat.TPU.REMAT = True
    remat_run = pw.run_fs(remat, inp["fs_state"], mine[:1], split)
    out["fs_remat"] = {"loss": remat_run["loss"], "differs": [
        k for k, v in kept_steps(remat_run, False)["digest"][0].items()
        if out["fs"]["digest"][0][k] != v]}
    checkpoints = directory / "checkpoints"
    out["checkpoint"] = pw.run_checkpoint(fs_cfg, fs["state"],
                                          str(checkpoints))
    pod_sync("restored")
    if full:        # every rank has restored the latest save
        for path in checkpoints.rglob("*.pth.tar"):
            if path.name != "final_state.pth.tar":
                path.unlink()
    try:        # a model whose layers were not switched is refused
        make_train_step(fs_cfg, get_pose_net(fs_cfg), "cpu")
    except ValueError as e:
        out["refused"] = str(e)
    out["mesh"] = (data_count(), world // data_count(), d)
    torch.save(out, directory / f"rank{process_index()}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    torch.set_num_threads(1)
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
