"""Gaussian heatmap targets and the argmax decode, batched, NCHW.

Counterpart of the JAX package's ``ops/heatmap.py``. Heatmaps here are
(..., J, H, W), the port's model layout, where the JAX functions take
(..., H, W, J). The reference's rules are kept exactly:

- ``generate_target``: the centre is ``trunc(joint / stride + 0.5)``
  (Python's ``int``, toward zero, not floor); the Gaussian is cut to the
  (6σ+1)² box; the weight is zeroed only when the box lies wholly outside
  (``br < 0``, not ``<= 0``).
- ``get_max_preds``: argmax over H*W (the first index of equal maxima) and
  the coords zeroed where the max is <= 0.
- ``post_process_preds``: the int32 cast truncates toward zero; the
  quarter-pixel step toward the larger neighbour applies only where
  ``1 < px < W-1`` and ``1 < py < H-1``; ``sign(0) = 0``.
"""

from __future__ import annotations

import torch

from epipolarpose_tpu_torch.geometry.affine import transform_preds


def generate_target(joints: torch.Tensor, joints_vis: torch.Tensor,
                    heatmap_size, sigma: float, image_size
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-joint Gaussian heatmaps and target weights.

    joints (..., J, 2+) in image pixels; joints_vis (..., J) or
    (..., J, k), the first entry read; heatmap_size and image_size (W, H).
    Returns (target (..., J, H, W) float32, weight (..., J) float32).
    """
    w, h = int(heatmap_size[0]), int(heatmap_size[1])
    stride_x = image_size[0] / w
    stride_y = image_size[1] / h
    tmp_size = sigma * 3
    if joints_vis.ndim == joints.ndim:
        joints_vis = joints_vis[..., 0]
    joints = joints.float()
    mu_x = torch.trunc(joints[..., 0] / stride_x + 0.5)
    mu_y = torch.trunc(joints[..., 1] / stride_y + 0.5)
    ul_x, ul_y = mu_x - tmp_size, mu_y - tmp_size
    br_x, br_y = mu_x + tmp_size + 1, mu_y + tmp_size + 1
    inside = (ul_x < w) & (ul_y < h) & (br_x >= 0) & (br_y >= 0)
    weight = joints_vis.to(torch.float32) * inside.to(torch.float32)

    kw = dict(dtype=torch.float32, device=joints.device)
    dx = torch.arange(w, **kw) - mu_x[..., None]          # (..., J, W)
    dy = torch.arange(h, **kw) - mu_y[..., None]          # (..., J, H)
    gx = torch.exp(-(dx * dx) / (2.0 * sigma * sigma))
    gy = torch.exp(-(dy * dy) / (2.0 * sigma * sigma))
    zero = torch.zeros((), **kw)
    gx = torch.where(dx.abs() <= tmp_size, gx, zero)
    gy = torch.where(dy.abs() <= tmp_size, gy, zero)
    g = gy[..., :, None] * gx[..., None, :]               # (..., J, H, W)
    return g * weight[..., None, None], weight


def get_max_preds(heatmaps: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Argmax decode of (..., J, H, W) maps.

    Returns (preds (..., J, 2) float32 (x, y), maxvals (..., J) in the
    maps' dtype); coords are 0 where the max is <= 0.
    """
    h, w = heatmaps.shape[-2:]
    flat = heatmaps.reshape(heatmaps.shape[:-2] + (h * w,))
    # argmax gives the first of equal maxima, as jnp.argmax does
    idx = flat.argmax(dim=-1)
    maxvals = flat.amax(dim=-1)
    preds = torch.stack([(idx % w).float(), (idx // w).float()], dim=-1)
    return preds * (maxvals > 0).float()[..., None], maxvals


def _gather_hm(heatmaps: torch.Tensor, px: torch.Tensor,
               py: torch.Tensor) -> torch.Tensor:
    """Values of (..., J, H, W) maps at integer (px, py) (..., J), clipped
    into the map."""
    h, w = heatmaps.shape[-2:]
    lin = py.clamp(0, h - 1) * w + px.clamp(0, w - 1)
    flat = heatmaps.reshape(heatmaps.shape[:-2] + (h * w,))
    return torch.gather(flat, -1, lin[..., None].long())[..., 0]


def post_process_preds(heatmaps: torch.Tensor,
                       preds: torch.Tensor) -> torch.Tensor:
    """A quarter pixel toward the larger neighbour (``POST_PROCESS``)."""
    h, w = heatmaps.shape[-2:]
    px = preds[..., 0].to(torch.int32)
    py = preds[..., 1].to(torch.int32)
    dx = _gather_hm(heatmaps, px + 1, py) - _gather_hm(heatmaps, px - 1, py)
    dy = _gather_hm(heatmaps, px, py + 1) - _gather_hm(heatmaps, px, py - 1)
    offset = torch.stack([torch.sign(dx), torch.sign(dy)], dim=-1).float()
    ok = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    return preds + offset * 0.25 * ok[..., None].float()


def get_final_preds(heatmaps: torch.Tensor, center, scale,
                    post_process: bool = True
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Argmax (with the quarter offset) -> source-image pixels.

    heatmaps (N, J, H, W); center, scale (N, 2). Returns (preds (N, J, 2)
    float32, maxvals (N, J)).
    """
    h, w = heatmaps.shape[-2:]
    preds, maxvals = get_max_preds(heatmaps)
    if post_process:
        preds = post_process_preds(heatmaps, preds)
    return transform_preds(preds, center, scale, (w, h)), maxvals
