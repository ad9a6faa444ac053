"""Soft-argmax decode: CUDA kernel ``csrc/softargmax.cu`` and its plain twin.

Replaces the forward of the TPU kernel ``fused_softmax_integral``
(``epipolarpose_tpu/ops/pallas/softargmax.py``, removed from the JAX
package in ``da6785a``) for the live function
``epipolarpose_tpu/ops/integral.py::softmax_integral``. The backward waits
for the training slice.

Layout: logits (N, J*D, H, W) NCHW, channel ``j*D + d``, so each joint's
(D, H, W) volume is contiguous. Output (N, J, 3) float32 normalized
(x, y, z) in [-0.5, 0.5); z is 0 when D == 1.
"""

from __future__ import annotations

import torch

from epipolarpose_tpu_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def softmax_integral_plain(logits: torch.Tensor, num_joints: int,
                           depth_dim: int = 1) -> torch.Tensor:
    """Plain PyTorch soft-argmax; accumulates in float32 for any input."""
    n, c, h, w = logits.shape
    d = depth_dim
    if c != num_joints * d:
        raise ValueError(f"{c} channels != num_joints {num_joints} * "
                         f"depth_dim {d}")
    vol = logits.reshape(n, num_joints, d * h * w).float()
    m = vol.amax(dim=-1, keepdim=True)
    e = torch.exp(vol - m).reshape(n, num_joints, d, h, w)
    dev = logits.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    zs = torch.arange(d, dtype=torch.float32, device=dev)
    z_sum = e.sum(dim=(2, 3, 4))
    ex = (e.sum(dim=(2, 3)) * xs).sum(-1)
    ey = (e.sum(dim=(2, 4)) * ys).sum(-1)
    ez = (e.sum(dim=(3, 4)) * zs).sum(-1)
    x = ex / z_sum / w - 0.5
    y = ey / z_sum / h - 0.5
    z = ez / z_sum / d - 0.5 if d > 1 else torch.zeros_like(x)
    return torch.stack([x, y, z], dim=-1)


def check_kernel_args(logits: torch.Tensor, num_joints: int,
                      depth_dim: int) -> None:
    """Raise on what the CUDA kernel does not take (no silent copies)."""
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


def softmax_integral(logits: torch.Tensor, num_joints: int,
                     depth_dim: int = 1) -> torch.Tensor:
    """Soft-argmax of (N, J*D, H, W) logits -> (N, J, 3) float32.

    A CPU tensor goes to :func:`softmax_integral_plain`; a CUDA tensor
    launches the kernel on the current stream, or raises.
    """
    if logits.device.type == "cpu":
        return softmax_integral_plain(logits, num_joints, depth_dim)
    if logits.device.type != "cuda":
        raise ValueError(f"no softargmax kernel for {logits.device}")
    check_kernel_args(logits, num_joints, depth_dim)
    n, _, h, w = logits.shape
    out = torch.empty((n, num_joints, 3), dtype=torch.float32,
                      device=logits.device)
    if n == 0:
        return out
    lib = _build.library()
    code = lib.epk_softargmax_fwd(
        logits.data_ptr(), out.data_ptr(), _DTYPE_CODE[logits.dtype],
        n * num_joints, depth_dim, h, w, *_build.launch_args(logits.device))
    _build.check(lib, code, "epk_softargmax_fwd")
    softmax_integral.launches += 1
    return out


# launches of the CUDA kernel; the CPU path does not count
softmax_integral.launches = 0
