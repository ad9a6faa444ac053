"""The train and eval steps, for ``TARGET_TYPE: integral`` and ``gaussian``.

Counterparts of the JAX package's ``core/steps.py::make_train_step`` and
``make_eval_step``. A batch is what the JAX loaders ship: ``input`` uint8
crops (N, H, W, 3) NHWC; for training ``joints`` (N, J, 2+) crop pixels,
``joints_vis`` (N, J) or (N, J, k) and, in 3D, ``joints_3d`` (N, J, 3)
in mm; for eval ``center`` and ``scale`` (N, 2). Numpy arrays or tensors,
moved to the step's device. The model runs NCHW: a gaussian model's
heatmaps are (N, J, H, W).

``fused_steps=K > 1`` (``TPU.FUSED_STEPS``) is the JAX package's
``compile_step(fused_steps=K)``: the step takes a super-batch, every
leaf with a leading (K,) axis (``data/pipeline.py::stack_batches``), runs
K steps in order and returns its outputs with that leading axis
(:func:`fuse_steps`). On the card the K steps are one CUDA-graph replay.

Under a model axis (``TPU.MESH.MODEL = M > 1``, ``parallel.make_mesh``)
every process of a model group gets the same crops and takes its ``H/M``
rows of ``input`` (``parallel.local_rows``); its model, switched by
``models.partition_rows``, exchanges halos with the group, and the
network's output is gathered back whole (``parallel.gather_rows``)
before the soft-argmax kernels, the losses, the accuracy and the flip
test's merge (a flip along W needs no exchange).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from epipolarpose_tpu_torch import telemetry
from epipolarpose_tpu_torch.geometry.affine import (flip_back,
                                                    flip_back_volume,
                                                    shift_right,
                                                    transform_preds)
from epipolarpose_tpu_torch.data.pipeline import batch_leaves, map_batch
from epipolarpose_tpu_torch.graphs import StepGraph, constant
from epipolarpose_tpu_torch.models.pose_resnet import is_row_split
from epipolarpose_tpu_torch.ops.heatmap import (generate_target,
                                                get_final_preds)
from epipolarpose_tpu_torch.ops.integral import (generate_integral_target,
                                                 integral_to_camera_depth,
                                                 softmax_integral)
from epipolarpose_tpu_torch.ops.losses import (integral_l1_loss,
                                               joints_mse_loss)
from epipolarpose_tpu_torch.ops.metrics import heatmap_accuracy
from epipolarpose_tpu_torch.parallel.mesh import (mean_over_processes,
                                                  model_count,
                                                  process_count, unwrap)
from epipolarpose_tpu_torch.parallel.spatial import gather_rows, local_rows

# ImageNet mean/std (torchvision Normalize constants of the reference)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_images(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 in [0, 255] or float in [0, 1] -> normalized f32."""
    if not torch.is_floating_point(x):
        x = x.to(torch.float32) * (1.0 / 255.0)
    mean = constant(IMAGENET_MEAN, torch.float32, x.device)
    std = constant(IMAGENET_STD, torch.float32, x.device)
    return (x.to(torch.float32) - mean) / std


def _root_relative_depth(joints_3d: torch.Tensor, root_idx: int
                         ) -> torch.Tensor:
    z = joints_3d[..., 2]
    return z - z[..., root_idx:root_idx + 1]


def configure_backends(cfg) -> None:
    """Set PyTorch's process-wide GPU math flags for a config.

    ``CUDNN.*`` as the reference's scripts set them. TF32 is off for both
    cuDNN convolutions and cuBLAS matmuls: float32 configs are the ones
    held against the JAX package, and TF32 keeps about three digits.
    bfloat16 configs do not reach TF32 either way. The entry point calls
    this once, as the reference's scripts do; the step builders do not.
    """
    torch.backends.cudnn.benchmark = bool(cfg.CUDNN.BENCHMARK)
    torch.backends.cudnn.deterministic = bool(cfg.CUDNN.DETERMINISTIC)
    torch.backends.cudnn.enabled = bool(cfg.CUDNN.ENABLED)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def check_row_split_model(model: torch.nn.Module) -> None:
    """Under a model axis a step feeds ``model`` this process's rows: its
    layers must exchange halos (``models.partition_rows``), or each
    process would pad its rows' edges with zeros and give another
    network."""
    if model_count() > 1 and not is_row_split(unwrap(model)):
        raise ValueError("TPU.MESH.MODEL > 1: the model's layers read only "
                         "this process's rows; switch them first with "
                         "models.partition_rows(model)")


def local_crops(images) -> torch.Tensor:
    """(N, H, W, 3) crops -> this process's rows, normalized, NCHW."""
    x = normalize_images(local_rows(images, 1))
    return x.permute(0, 3, 1, 2).contiguous()


def _check_target_type(cfg) -> str:
    target_type = str(cfg.MODEL.EXTRA.TARGET_TYPE)
    if target_type not in ("integral", "gaussian"):
        raise ValueError(f"unknown TARGET_TYPE: {target_type}")
    return target_type


# eager DDP iterations PyTorch's CUDA-graph notes ask for before a capture
DDP_WARMUP_STEPS = 11


class FusedSteps:
    """K steps a call over a super-batch: the port's ``compile_step``.

    ``step`` is a train step ``(state, batch) -> (state, metrics)`` or,
    with ``stateful=False``, an eval step ``batch -> outputs``. A call
    takes a super-batch whose leaves have a leading (K,) axis (any K: a
    ragged tail is served as it is), runs the step on each inner batch in
    order and returns the metrics or outputs stacked on a leading (K,)
    axis; a train state's ``step`` advances by K.

    - CPU (the tests): a Python loop of the K steps.
    - Card: the first ``warmup_steps`` inner steps (whole super-batches)
      run eagerly on a side stream, PyTorch's warm-up before a capture.
      Then each super-batch shape is captured once into a
      :class:`graphs.StepGraph` (the capture runs it), over static input
      buffers; each later super-batch of that shape is copied into them
      on the current stream, after the loader's copy by that stream's
      wait, and replayed. A step that fails to capture or to replay
      raises :class:`graphs.CaptureError` naming the op; nothing falls
      back to the eager loop. The train state the graphs were captured
      on must be the one passed to every later call.

    ``gloo`` ranks on a card raise: their collectives go through the host
    and no graph can hold them. Spans: ``fused.capture``, and
    ``fused.replay`` (the copy into the static inputs, the replay).
    """

    def __init__(self, step: Callable, fused_steps: int,
                 device: str | torch.device = "cuda",
                 warmup_steps: int | None = None, stateful: bool = True):
        if int(fused_steps) < 1:
            raise ValueError(f"fused_steps must be >= 1, got {fused_steps}")
        self.step = step
        self.fused_steps = int(fused_steps)
        self.device = torch.device(device)
        self.stateful = stateful
        self.warmup_steps = (self.fused_steps if warmup_steps is None
                             else int(warmup_steps))
        self.eager_steps = 0
        self.graphs: dict = {}
        self.replays = 0
        self.capture_s = 0.0
        self._state = None
        self._pool = self._stream = None
        if (self.device.type == "cuda" and process_count() > 1
                and dist.get_backend() != "nccl"):
            raise NotImplementedError(
                f"fused steps on the card with the {dist.get_backend()} "
                "backend: its collectives go through the host, so no CUDA "
                "graph can hold the step; use nccl, or TPU.FUSED_STEPS: 1")

    @property
    def host_ops(self) -> int:
        """Ops run eagerly between graph segments, over every graph."""
        return sum(g.host_ops for g, _, _ in self.graphs.values())

    def _loop(self, state, superbatch):
        k = int(batch_leaves(superbatch)[0].shape[0])
        outs = []
        for i in range(k):
            batch = map_batch(lambda a: a[i], superbatch)
            if self.stateful:
                state, out = self.step(state, batch)
            else:
                out = self.step(batch)
            outs.append(out)
        stacked = {key: torch.stack([o[key] for o in outs])
                   for key in outs[0]}
        return state, stacked

    def _run(self, state, superbatch):
        if self.stateful:
            return self._loop(state, superbatch)
        with torch.inference_mode():
            return self._loop(state, superbatch)

    def __call__(self, *args):
        state, superbatch = args if self.stateful else (None, args[0])
        if self.device.type != "cuda":
            state, out = self._run(state, superbatch)
            return (state, out) if self.stateful else out
        k = int(batch_leaves(superbatch)[0].shape[0])
        current = torch.cuda.current_stream(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        if self.eager_steps < self.warmup_steps:
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                state, out = self._run(state, superbatch)
            current.wait_stream(self._stream)
            # the allocator's stream marks: inputs read on the side
            # stream, outputs read on the current one
            for t in batch_leaves(superbatch):
                if torch.is_tensor(t) and t.is_cuda:
                    t.record_stream(self._stream)
            for t in out.values():
                t.record_stream(current)
            self.eager_steps += k
            return (state, out) if self.stateful else out
        if self.stateful:
            if self._state is None:
                self._state = state
            elif state is not self._state:
                raise ValueError("the fused step's graphs hold another "
                                 "train state: build the step anew")
        key = tuple((tuple(t.shape), str(t.dtype))
                    for t in batch_leaves(superbatch))
        entry = self.graphs.get(key)
        if entry is None:
            t0 = time.perf_counter()
            with telemetry.span("fused.capture"):
                static = map_batch(lambda a: torch.as_tensor(a).to(
                    self.device).clone(), superbatch)
                graph = StepGraph(self._pool)
                out = graph.capture(lambda: self._run(state, static)[1],
                                    self._stream)
            self.graphs[key] = (graph, static, out)
            self.capture_s += time.perf_counter() - t0
        else:
            graph, static, out = entry
            with telemetry.span("fused.replay"):
                for dst, src in zip(batch_leaves(static),
                                    batch_leaves(superbatch)):
                    dst.copy_(torch.as_tensor(src), non_blocking=True)
                graph.replay()
            if self.stateful:
                state.step += k
                if state.scheduler is not None:
                    state.scheduler.last_epoch += k
        self.replays += 1
        out = {key: v.clone() for key, v in out.items()}
        return (state, out) if self.stateful else out


def fuse_steps(step: Callable, fused_steps: int,
               device: str | torch.device = "cuda",
               warmup_steps: int | None = None,
               stateful: bool = True) -> Callable:
    """``step`` itself for ``fused_steps`` 1, else :class:`FusedSteps`."""
    if int(fused_steps) == 1:
        return step
    return FusedSteps(step, fused_steps, device, warmup_steps, stateful)


def warmup_for(model: torch.nn.Module, fused_steps: int) -> int:
    """Eager inner steps before the first capture: one super-batch, or
    :data:`DDP_WARMUP_STEPS` under DDP."""
    if isinstance(model, DistributedDataParallel):
        return max(int(fused_steps), DDP_WARMUP_STEPS)
    return int(fused_steps)


def optimizer_step(state, loss: torch.Tensor) -> None:
    """Backward of ``loss``, then one step of ``state``'s optimizer and
    schedule. Under a model axis of ``M`` the backward is that of ``M x
    loss``: each process's parameter gradient is the part through its own
    rows, the right gradient their sum over the model group averaged over
    the data groups, and DDP averages over all ``D * M`` processes
    (``models.pose_resnet._GlobalBatchNormFn``). Graph-safe: the gradients are dropped, not zeroed, so the
    backward allocates them in the graph's pool; the schedule sets the
    rate on the card (``core/train_state.py``); ``state.step`` is the
    Python count, which a replay's caller advances. Spans:
    ``train.backward``, and ``train.optimizer`` twice (the gradients
    dropped before the backward; the step and the schedule after it)."""
    with telemetry.span("train.optimizer"):
        state.optimizer.zero_grad(set_to_none=True)
    with telemetry.span("train.backward"):
        (loss * model_count()).backward()
    with telemetry.span("train.optimizer"):
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1


def integral_update(state, model: torch.nn.Module, x: torch.Tensor,
                    target: torch.Tensor, tw: torch.Tensor | None,
                    num_joints: int, depth_dim: int,
                    decode: Callable = softmax_integral) -> torch.Tensor:
    """One optimizer step of the integral model on NCHW images ``x``: the
    forward in train mode, ``decode``, the L1 loss, the backward and the
    update. ``model`` runs the forward: under data parallelism the DDP
    wrapper of ``state.model``, whose hooks average the gradients; under a
    model axis ``x`` is this process's rows and the decode sees the
    gathered volume. Returns the loss, detached. Spans:
    ``train.forward`` (the mode switch to the loss), then those of
    :func:`optimizer_step`."""
    with telemetry.span("train.forward"):
        model.train()
        coords = decode(gather_rows(model(x)), num_joints, depth_dim)
        loss = integral_l1_loss(coords, target, tw)
    optimizer_step(state, loss)
    return loss.detach()


def make_train_step(cfg, model: torch.nn.Module,
                    device: str | torch.device = "cuda",
                    decode: Callable = softmax_integral,
                    fused_steps: int = 1):
    """Build ``step(state, batch) -> (state, metrics)``.

    One optimizer step of ``state``, a ``TrainState`` whose ``model`` is
    ``model`` itself (its optimizer holds that model's parameters; any
    other model, a copy included, raises): the forward in train mode (BN
    on batch statistics, which it updates), the loss, the backward,
    ``optimizer.step()`` and ``scheduler.step()``. Under data parallelism
    ``model`` is ``parallel.wrap_model``'s DDP wrapper: the forward runs
    through it and ``state.model`` is the module inside; each process
    steps on its slice of the global batch; under a model axis on its rows
    of it (module docstring).

    - ``integral``: the soft-argmax (``decode``: the CUDA kernels on the
      card, with their backward) and the integral L1 loss; metrics
      ``{"loss"}``.
    - ``gaussian``: Gaussian heatmap targets and the heatmap MSE; metrics
      ``{"loss", "acc"}``, ``acc`` the heatmap accuracy of this step's
      forward.

    The metrics are means over the processes and stay on the device:
    nothing waits for the card. ``model`` is moved to ``device``.
    ``fused_steps=K > 1``: the step takes K-stacked super-batches and
    returns (K,) metrics (:class:`FusedSteps`; on the card one CUDA-graph
    replay, after one super-batch of warm-up, or
    :data:`DDP_WARMUP_STEPS` steps under DDP). Spans (``telemetry``):
    ``train.step`` around ``train.inputs``, ``train.targets`` and
    :func:`integral_update`'s.
    """
    target_type = _check_target_type(cfg)
    device = torch.device(device)
    image_size = tuple(float(v) for v in cfg.MODEL.IMAGE_SIZE)
    heatmap_size = tuple(int(v) for v in cfg.MODEL.EXTRA.HEATMAP_SIZE)
    sigma = float(cfg.MODEL.EXTRA.SIGMA)
    depth_dim = int(cfg.MODEL.EXTRA.DEPTH_DIM)
    depth_bound = float(cfg.MODEL.EXTRA.get("DEPTH_BOUND", 1000.0))
    num_joints = int(cfg.MODEL.NUM_JOINTS)
    use_tw = bool(cfg.LOSS.USE_TARGET_WEIGHT)
    root_idx = 0
    net = unwrap(model).to(device)
    check_row_split_model(net)

    def to_device(a) -> torch.Tensor:
        return torch.as_tensor(a).to(device, non_blocking=True)

    def step(state, batch):
        if state.model is not net:
            raise ValueError("the train state holds another model than the "
                             "one this step was built for")
        with telemetry.span("train.step"):
            with telemetry.span("train.inputs"):
                x = local_crops(to_device(batch["input"]))
            with telemetry.span("train.targets"):
                joints = to_device(batch["joints"]).float()
                vis = to_device(batch["joints_vis"])
                if target_type == "gaussian":
                    target, tw = generate_target(joints, vis, heatmap_size,
                                                 sigma, image_size)
                else:
                    depth = None
                    if "joints_3d" in batch:
                        depth = _root_relative_depth(
                            to_device(batch["joints_3d"]).float(), root_idx)
                    target, tw = generate_integral_target(
                        joints, vis, image_size, depth_bound=depth_bound,
                        joints_depth=depth)
            if target_type == "gaussian":
                with telemetry.span("train.forward"):
                    model.train()
                    out = gather_rows(model(x))
                    loss = joints_mse_loss(out, target,
                                           tw if use_tw else None)
                optimizer_step(state, loss)
                with torch.no_grad():
                    acc = heatmap_accuracy(out.detach(), target)[1]
                return state, mean_over_processes({"loss": loss.detach(),
                                                   "acc": acc})
            loss = integral_update(state, model, x, target,
                                   tw if use_tw else None, num_joints,
                                   depth_dim, decode)
            return state, mean_over_processes({"loss": loss})

    return fuse_steps(step, fused_steps, device,
                      warmup_for(model, fused_steps))


def make_eval_step(cfg, model: torch.nn.Module, flip_pairs=(),
                   device: str | torch.device = "cuda",
                   decode: Callable = softmax_integral,
                   fused_steps: int = 1):
    """Build ``step(batch) -> dict`` of predictions in source-image pixels.

    - ``integral``: ``{"preds": (N, J, 3) float32}``, (x, y) in pixels and
      z in root-relative mm; ``decode`` is the soft-argmax (the default
      takes the CUDA kernel on the card; a caller may pass the plain
      version to compare).
    - ``gaussian``: ``{"preds": (N, J, 2) float32, "maxvals": (N, J)}``
      from the argmax decode (with the quarter offset when
      ``TEST.POST_PROCESS``).

    With ``TEST.FLIP_TEST`` the flipped forward is flipped back (and
    shifted one pixel right with ``TEST.SHIFT_HEATMAP``) and averaged in.
    Under a model axis each process runs its rows and the output is
    gathered whole before the decode; every process of a model group
    returns the same predictions. ``model`` is moved to ``device``. Each
    call puts it in eval mode, as
    the JAX step passes ``train=False`` on each call: BN runs on its
    running statistics and writes no buffer, so a train step built on the
    same model may run before and after it. ``fused_steps=K > 1``: the
    step takes K-stacked super-batches and returns (K, N, ...) outputs
    under ``inference_mode`` (:class:`FusedSteps`). Spans: ``eval.step``
    around ``eval.inputs`` (the mode switch, the crops), ``eval.forward``,
    ``eval.flip`` and ``eval.decode``.
    """
    target_type = _check_target_type(cfg)
    device = torch.device(device)
    image_size = tuple(float(v) for v in cfg.MODEL.IMAGE_SIZE)
    depth_dim = int(cfg.MODEL.EXTRA.DEPTH_DIM)
    depth_bound = float(cfg.MODEL.EXTRA.get("DEPTH_BOUND", 1000.0))
    num_joints = int(cfg.MODEL.NUM_JOINTS)
    flip_test = bool(cfg.TEST.FLIP_TEST)
    shift_heatmap = bool(cfg.TEST.SHIFT_HEATMAP)
    post_process = bool(cfg.TEST.POST_PROCESS)
    model = model.to(device)
    check_row_split_model(model)
    size = torch.tensor(image_size, dtype=torch.float32, device=device)

    @torch.inference_mode()
    def step(batch) -> dict[str, torch.Tensor]:
        with telemetry.span("eval.step"):
            with telemetry.span("eval.inputs"):
                model.eval()
                x = local_crops(torch.as_tensor(batch["input"]).to(
                    device, non_blocking=True))
            with telemetry.span("eval.forward"):
                out = model(x)
            if flip_test:
                with telemetry.span("eval.flip"):
                    out_f = model(x.flip(-1))
                    if target_type == "gaussian":
                        out_f = flip_back(out_f, flip_pairs)
                    else:
                        out_f = flip_back_volume(out_f, flip_pairs,
                                                 num_joints, depth_dim)
                    if shift_heatmap:
                        out_f = shift_right(out_f)
                    out = (out + out_f) * 0.5
            with telemetry.span("eval.decode"):
                out = gather_rows(out)
                center = torch.as_tensor(batch["center"]).to(device)
                scale = torch.as_tensor(batch["scale"]).to(device)
                if target_type == "gaussian":
                    preds, maxvals = get_final_preds(out, center, scale,
                                                     post_process)
                    return {"preds": preds, "maxvals": maxvals}
                coords = decode(out, num_joints, depth_dim)
                # normalized -> crop pixels -> source pixels; z -> mm
                xy_crop = (coords[..., :2] + 0.5) * size
                xy_src = transform_preds(xy_crop, center, scale, image_size)
                z_mm = integral_to_camera_depth(coords, depth_bound)
                return {"preds": torch.cat([xy_src, z_mm[..., None]],
                                           dim=-1)}

    return fuse_steps(step, fused_steps, device, stateful=False)
