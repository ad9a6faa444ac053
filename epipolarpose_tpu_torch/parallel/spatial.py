"""Image rows split over the mesh's model axis: the halo exchanges GSPMD
adds to the JAX package's convolutions under ``TPU.MESH.MODEL > 1``.

Each process of a model group (``parallel.mesh.model_group``) holds the
same crops and runs the network on its ``H / M`` contiguous rows:

- :func:`local_rows`: this process's rows of a tensor;
- :func:`halo_exchange`: the rows a layer reads beyond them, fetched from
  the neighbouring processes (its backward sends their gradient back to
  the process that owns those rows, which adds it on);
- :func:`gather_rows`: the whole tensor from every process's rows, after
  the network, so that the soft-argmax and the losses see the whole
  volume (its backward keeps this process's rows of the gradient).

Under ``gloo`` the collectives take host tensors; under ``nccl`` they
stay on the card. Every exchange is an all-gather over the model group
that every member joins, the edge processes too, so the exchanges of a
forward, of its backward and of ``TPU.REMAT``'s recomputation run in one
order on every process. Without a model axis :func:`local_rows` and
:func:`gather_rows` return their input and :func:`halo_exchange` pads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from epipolarpose_tpu_torch.parallel.mesh import (group_allgather,
                                                  model_count, model_group,
                                                  model_index)


def local_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This process's contiguous ``1/M`` of ``x`` along ``dim`` (``x``
    itself without a model axis)."""
    m = model_count()
    if m == 1:
        return x
    if x.shape[dim] % m:
        raise ValueError(f"{x.shape[dim]} rows do not split over a model "
                         f"axis of {m}")
    per = x.shape[dim] // m
    return x.narrow(dim, model_index() * per, per)


class _HaloExchange(torch.autograd.Function):
    """(N, C, R, W) -> (N, C, top + R + bottom, W): the last ``top`` rows
    of the process above and the first ``bottom`` rows of the one below;
    ``fill`` where the image ends. One all-gather of each process's
    boundary rows, forward and backward."""

    @staticmethod
    def forward(ctx, x, top, bottom, fill):
        ctx.top, ctx.bottom = top, bottom
        r = x.shape[2]
        m, k = model_index(), model_count()
        # every process sends its first `bottom` rows (the halo below the
        # process above it) and its last `top` rows (above the one below)
        sent = torch.cat([x[:, :, :bottom], x[:, :, r - top:]], 2)
        parts = group_allgather(sent, model_group())

        def edge(rows):
            return x.new_full(x.shape[:2] + (rows, x.shape[3]), fill)
        above = parts[m - 1][:, :, bottom:] if m > 0 else edge(top)
        below = parts[m + 1][:, :, :bottom] if m < k - 1 else edge(bottom)
        return torch.cat([above, x, below], 2)

    @staticmethod
    def backward(ctx, g):
        top, bottom = ctx.top, ctx.bottom
        r = g.shape[2] - top - bottom
        m, k = model_index(), model_count()
        # the halos' gradient goes back to the rows it came from
        sent = torch.cat([g[:, :, :top], g[:, :, top + r:]], 2)
        parts = group_allgather(sent, model_group())
        dx = g[:, :, top:top + r].clone()
        if m < k - 1 and top:
            dx[:, :, r - top:] += parts[m + 1][:, :, :top]
        if m > 0 and bottom:
            dx[:, :, :bottom] += parts[m - 1][:, :, top:]
        return dx, None, None, None


def halo_exchange(x: torch.Tensor, top: int, bottom: int,
                  fill: float = 0.0) -> torch.Tensor:
    """NCHW ``x`` (this process's rows) with ``top`` rows of the process
    above and ``bottom`` rows of the one below concatenated along H. At
    the image's own top and bottom the rows are ``fill``: the padding of
    the layer that reads them (0 for a convolution, ``-inf`` for max
    pooling). Without a model axis it is that padding alone."""
    if not (top or bottom):
        return x
    if model_count() == 1:
        return F.pad(x, (0, 0, top, bottom), value=fill)
    if max(top, bottom) > x.shape[2]:
        raise ValueError(f"a halo of {max(top, bottom)} rows is more than "
                         f"the {x.shape[2]} rows a process holds")
    return _HaloExchange.apply(x, top, bottom, fill)


class _GatherRows(torch.autograd.Function):
    """Every process's rows, concatenated along ``dim`` in model order.
    Every process of the group computes the same loss on the same
    gathered tensor, so each keeps its own rows of the gradient: their sum
    over the group is not wanted (the train step scales its loss by
    ``M`` for DDP's mean instead, ``core/steps.py::optimizer_step``)."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        parts = group_allgather(x, model_group())
        return torch.cat(list(parts.unbind()), dim)

    @staticmethod
    def backward(ctx, g):
        return local_rows(g, ctx.dim).contiguous(), None


def gather_rows(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """The whole tensor along ``dim`` from every process's rows (``x``
    itself without a model axis)."""
    if model_count() == 1:
        return x
    return _GatherRows.apply(x, dim)
