"""Lower precisions for the control of the correctness check: the
reference computed one step below the precision the configuration
states. The configurations compute in bfloat16: under autocast the
program's weights enter each convolution in bfloat16 and every
activation, and every gradient of one, is a bfloat16 tensor. So the
control (:data:`FP8`) rounds each weight as it enters a convolution and
each activation to e4m3, and each activation's gradient to e5m2, every
tensor scaled by its largest magnitude, as fp8 training recipes do. The
triangulation is float32, so the control computes it in float32 with
every operand rounded to TF32's ten-bit mantissa (:func:`tf32`)."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 under a per-tensor scale, back in float32;
    the gradient passes straight through."""
    return t + (_round(t, torch.float8_e4m3fn, E4M3_MAX) - t).detach()


class _GradE5M2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


class Precision:
    """``operand(w)`` rounds a weight as it enters a convolution;
    ``act(t)`` rounds an activation, and in the backward pass the gradient
    that reaches it."""

    def __init__(self, operand, grad):
        self.operand, self.grad = operand, grad

    def act(self, t: torch.Tensor) -> torch.Tensor:
        return self.grad(self.operand(t))


FP8 = Precision(fp8, _GradE5M2.apply)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to the nearest TF32 value (ten mantissa
    bits)."""
    bits = t.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)
