"""Soft-argmax: CUDA kernels ``csrc/softargmax.cu`` and their plain twins.

Replaces the TPU kernel ``fused_softmax_integral``
(``epipolarpose_tpu/ops/pallas/softargmax.py``, removed from the JAX
package in ``da6785a``), forward and backward, for the live function
``epipolarpose_tpu/ops/integral.py::softmax_integral``.

Layout: logits (N, J*D, H, W) NCHW, channel ``j*D + d``, so each joint's
(D, H, W) volume is contiguous. Output (N, J, 3) float32 normalized
(x, y, z) in [-0.5, 0.5); z is 0 when D == 1.

:func:`softmax_integral` is the entry point. A tensor that needs a
gradient goes through :class:`SoftmaxIntegral`: its forward
(:func:`softmax_integral_fwd`) also gives four float32 statistics per
joint (``lse = M + ln Z`` and the expectations ``Ex, Ey, Ez`` in index
units), and its backward (:func:`softmax_integral_bwd`) works from them.
On a CUDA tensor these launch ``epk_softargmax_fwd`` and
``epk_softargmax_bwd``; on a CPU tensor they are the plain twins. Without a
gradient (the eval step runs under ``inference_mode``) the forward writes
no statistics. :func:`softmax_integral_plain` is the reference.

The forward without statistics is also the registered PyTorch op
``torch.ops.epipolarpose.softmax_integral`` (:func:`softmax_integral_op`),
so that a ``torch.export`` program of the eval computation
(``tools/export_model.py``) calls it as one node: the program launches
``epk_softargmax_fwd`` on the card and the plain twin on the CPU. The op
is for inference only: it registers no autograd, and a backward through
it raises.
"""

from __future__ import annotations

import torch

from epipolarpose_tpu_torch import telemetry
from epipolarpose_tpu_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _grids(d: int, h: int, w: int, device) -> tuple[torch.Tensor, ...]:
    """Index grids (zs, ys, xs) as float32, shaped to broadcast over a
    (..., D, H, W) volume."""
    kw = dict(dtype=torch.float32, device=device)
    return (torch.arange(d, **kw)[:, None, None],
            torch.arange(h, **kw)[:, None], torch.arange(w, **kw))


def softmax_integral_stats_plain(logits: torch.Tensor, num_joints: int,
                                 depth_dim: int = 1) -> torch.Tensor:
    """Plain per-joint statistics (N, J, 4) float32: ``lse = M + ln Z``
    and the expectations (Ex, Ey, Ez) in index units. Accumulates in
    float32 for any input."""
    n, c, h, w = logits.shape
    d = depth_dim
    if c != num_joints * d:
        raise ValueError(f"{c} channels != num_joints {num_joints} * "
                         f"depth_dim {d}")
    vol = logits.reshape(n, num_joints, d * h * w).float()
    # the max only steadies the exp: detached, as the JAX function
    # stop_gradients it, so autograd builds no max-scatter
    m = vol.amax(dim=-1, keepdim=True).detach()
    e = torch.exp(vol - m).reshape(n, num_joints, d, h, w)
    zs, ys, xs = _grids(d, h, w, logits.device)
    z_sum = e.sum(dim=(2, 3, 4))
    ex = (e.sum(dim=(2, 3)) * xs).sum(-1) / z_sum
    ey = (e.sum(dim=(2, 4)) * ys[:, 0]).sum(-1) / z_sum
    ez = (e.sum(dim=(3, 4)) * zs[:, 0, 0]).sum(-1) / z_sum
    lse = m[..., 0] + torch.log(z_sum)
    return torch.stack([lse, ex, ey, ez], dim=-1)


def _normalized(stats: torch.Tensor, d: int, h: int, w: int) -> torch.Tensor:
    """(N, J, 4) statistics -> (N, J, 3) normalized coordinates."""
    x = stats[..., 1] / w - 0.5
    y = stats[..., 2] / h - 0.5
    z = stats[..., 3] / d - 0.5 if d > 1 else torch.zeros_like(x)
    return torch.stack([x, y, z], dim=-1)


def softmax_integral_plain(logits: torch.Tensor, num_joints: int,
                           depth_dim: int = 1) -> torch.Tensor:
    """Plain PyTorch soft-argmax; accumulates in float32 for any input."""
    stats = softmax_integral_stats_plain(logits, num_joints, depth_dim)
    return _normalized(stats, depth_dim, *logits.shape[2:])


def softmax_integral_bwd_plain(logits: torch.Tensor, stats: torch.Tensor,
                               grad: torch.Tensor) -> torch.Tensor:
    """Plain gradient of the soft-argmax wrt the logits, from the logits,
    the (N, J, 4) statistics and the (N, J, 3) gradient of the normalized
    coordinates: ``p * (a*w + b*h + c*d + r)`` with ``p = exp(l - lse)``,
    ``a = gx/W``, ``b = gy/H``, ``c = gz/D`` (0 when D == 1) and
    ``r = -(a*Ex + b*Ey + c*Ez)``. Returns the logits' shape and dtype."""
    n, ch, h, w = logits.shape
    j = stats.shape[1]
    d = ch // j
    lse, ex, ey, ez = stats.float().unbind(-1)
    g = grad.float()
    a = g[..., 0] / w
    b = g[..., 1] / h
    c = g[..., 2] / d if d > 1 else torch.zeros_like(a)
    r = -(a * ex + b * ey + c * ez)
    zs, ys, xs = _grids(d, h, w, logits.device)

    def per_row(t):
        return t[..., None, None, None]

    p = torch.exp(logits.reshape(n, j, d, h, w).float() - per_row(lse))
    coef = (per_row(a) * xs + per_row(b) * ys + per_row(c) * zs
            + per_row(r))
    return (p * coef).reshape(logits.shape).to(logits.dtype)


def check_kernel_args(logits: torch.Tensor, num_joints: int,
                      depth_dim: int) -> None:
    """Raise on what the CUDA kernels do not take (no silent copies)."""
    if logits.dtype not in _DTYPE_CODE:
        raise TypeError(f"softargmax kernel takes float32 or bfloat16, "
                        f"not {logits.dtype}")
    if logits.ndim != 4 or logits.shape[1] != num_joints * depth_dim:
        raise ValueError(f"expected (N, {num_joints}*{depth_dim}, H, W), "
                         f"got {tuple(logits.shape)}")
    if not logits.is_contiguous():
        raise ValueError("softargmax kernel needs a contiguous NCHW tensor")
    vec = 16 // logits.element_size()
    if logits.shape[-1] % vec or logits.data_ptr() % 16:
        raise ValueError(f"softargmax kernel needs W % {vec} == 0 and a "
                         f"16-byte aligned tensor")
    if logits.numel() // max(logits.shape[0], 1) >= 2 ** 31:
        raise ValueError("softargmax kernel: one sample exceeds 2**31 "
                         "elements")


def _check_row_tensor(t: torch.Tensor, like: torch.Tensor, shape: tuple,
                      name: str) -> None:
    if (t.dtype != torch.float32 or tuple(t.shape) != shape
            or not t.is_contiguous() or t.device != like.device):
        raise ValueError(f"softargmax backward: {name} must be a contiguous "
                         f"float32 {shape} tensor on {like.device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def softmax_integral_fwd(logits: torch.Tensor, num_joints: int,
                         depth_dim: int = 1, with_stats: bool = True
                         ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(coords (N, J, 3), statistics (N, J, 4) or None), without autograd.

    A CPU tensor takes the plain versions; a CUDA tensor launches
    ``epk_softargmax_fwd`` on the current stream, or raises.
    """
    if logits.device.type == "cpu":
        stats = softmax_integral_stats_plain(logits, num_joints, depth_dim)
        coords = _normalized(stats, depth_dim, *logits.shape[2:])
        return coords, stats if with_stats else None
    if logits.device.type != "cuda":
        raise ValueError(f"no softargmax kernel for {logits.device}")
    check_kernel_args(logits, num_joints, depth_dim)
    n, _, h, w = logits.shape
    kw = dict(dtype=torch.float32, device=logits.device)
    out = torch.empty((n, num_joints, 3), **kw)
    stats = torch.empty((n, num_joints, 4), **kw) if with_stats else None
    if n == 0:
        return out, stats
    lib = _build.library()
    code = lib.epk_softargmax_fwd(
        logits.data_ptr(), out.data_ptr(),
        stats.data_ptr() if with_stats else None, _DTYPE_CODE[logits.dtype],
        n * num_joints, depth_dim, h, w, *_build.launch_args(logits.device))
    _build.check(lib, code, "epk_softargmax_fwd")
    telemetry.count(softmax_integral, "launches")
    return out, stats


def softmax_integral_bwd(logits: torch.Tensor, stats: torch.Tensor,
                         grad: torch.Tensor) -> torch.Tensor:
    """Gradient wrt the logits (their shape and dtype).

    A CPU tensor takes :func:`softmax_integral_bwd_plain`; a CUDA tensor
    launches ``epk_softargmax_bwd`` on the current stream, or raises.
    """
    if logits.device.type == "cpu":
        return softmax_integral_bwd_plain(logits, stats, grad)
    if logits.device.type != "cuda":
        raise ValueError(f"no softargmax kernel for {logits.device}")
    n, ch, h, w = logits.shape
    j = stats.shape[1] if stats.ndim == 3 else 0
    if j == 0 or ch % j:
        raise ValueError(f"statistics {tuple(stats.shape)} do not match "
                         f"logits {tuple(logits.shape)}")
    d = ch // j
    check_kernel_args(logits, j, d)
    _check_row_tensor(stats, logits, (n, j, 4), "stats")
    _check_row_tensor(grad, logits, (n, j, 3), "grad")
    dlogits = torch.empty_like(logits)
    if n == 0:
        return dlogits
    lib = _build.library()
    code = lib.epk_softargmax_bwd(
        logits.data_ptr(), stats.data_ptr(), grad.data_ptr(),
        dlogits.data_ptr(), _DTYPE_CODE[logits.dtype], n * j, d, h, w,
        *_build.launch_args(logits.device))
    _build.check(lib, code, "epk_softargmax_bwd")
    telemetry.count(softmax_integral_bwd, "launches")
    return dlogits


class SoftmaxIntegral(torch.autograd.Function):
    """Soft-argmax whose forward saves the logits and the per-joint
    statistics, and whose backward is :func:`softmax_integral_bwd`.

    On the card both halves are the CUDA kernels; on the CPU they are the
    plain twins. The backward reads the current stream when autograd runs
    it (on its own thread), through :func:`_build.launch_args`.
    """

    @staticmethod
    def forward(ctx, logits: torch.Tensor, num_joints: int,
                depth_dim: int) -> torch.Tensor:
        out, stats = softmax_integral_fwd(logits, num_joints, depth_dim)
        ctx.save_for_backward(logits, stats)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad: torch.Tensor):
        logits, stats = ctx.saved_tensors
        return (softmax_integral_bwd(logits, stats, grad.contiguous()), None,
                None)


def softmax_integral(logits: torch.Tensor, num_joints: int,
                     depth_dim: int = 1) -> torch.Tensor:
    """Soft-argmax of (N, J*D, H, W) logits -> (N, J, 3) float32.

    Through :class:`SoftmaxIntegral` when a gradient is wanted, else the
    forward alone. A CUDA tensor launches the kernels on the current
    stream, or raises; a CPU tensor takes their plain twins.
    """
    if torch.is_grad_enabled() and logits.requires_grad:
        return SoftmaxIntegral.apply(logits, num_joints, depth_dim)
    return softmax_integral_fwd(logits, num_joints, depth_dim,
                                with_stats=False)[0]


@torch.library.custom_op("epipolarpose::softmax_integral", mutates_args=())
def softmax_integral_op(logits: torch.Tensor, num_joints: int,
                        depth_dim: int) -> torch.Tensor:
    """``torch.ops.epipolarpose.softmax_integral``: (N, J*D, H, W) logits
    -> (N, J, 3) float32, the forward without statistics
    (:func:`softmax_integral_fwd`). The tensor's device picks the route:
    a CUDA tensor launches ``epk_softargmax_fwd`` (its launch counted as
    :func:`softmax_integral`'s) or raises; a CPU tensor takes the plain
    twin."""
    return softmax_integral_fwd(logits, num_joints, depth_dim,
                                with_stats=False)[0]


@softmax_integral_op.register_fake
def _softmax_integral_op_fake(logits: torch.Tensor, num_joints: int,
                              depth_dim: int) -> torch.Tensor:
    return logits.new_empty((logits.shape[0], num_joints, 3),
                            dtype=torch.float32)


# launches of the CUDA kernels (a graph's at each replay,
# ``telemetry.count``); the CPU path does not count
telemetry.counter(softmax_integral, "launches")
telemetry.counter(softmax_integral_bwd, "launches")
