"""Metrics (counterparts of the JAX package's ``ops/metrics.py``): the
train-time heatmap accuracy, PCK and PCKh (2D), the MPJPE family and the
Pose Structure Score (3D)."""

from __future__ import annotations

import torch

from epipolarpose_tpu_torch.geometry.procrustes import procrustes_align
from epipolarpose_tpu_torch.graphs import constant
from epipolarpose_tpu_torch.ops.heatmap import get_max_preds


def _calc_dists(preds: torch.Tensor, target: torch.Tensor,
                normalize: torch.Tensor) -> torch.Tensor:
    """Normalized distances (N, J); -1 where the target is not valid
    (x <= 1 or y <= 1). preds/target (N, J, 2); normalize (N,) or (N, 2)."""
    if normalize.ndim == 1:
        normalize = normalize[:, None]
    valid = (target[..., 0] > 1) & (target[..., 1] > 1)
    d = torch.linalg.vector_norm((preds - target) / normalize[:, None, :],
                                 dim=-1)
    return torch.where(valid, d, torch.full_like(d, -1.0))


def _dist_acc(dists: torch.Tensor, thr: float = 0.5) -> torch.Tensor:
    """Per joint, the share of valid distances below ``thr``; -1 where
    no distance is valid."""
    valid = dists != -1
    n = valid.sum(dim=0)
    hit = ((dists < thr) & valid).sum(dim=0)
    acc = hit / n.clamp(min=1)
    return torch.where(n > 0, acc, torch.full_like(acc, -1.0))


def heatmap_accuracy(output: torch.Tensor, target: torch.Tensor,
                     thr: float = 0.5):
    """Train-time PCK on the heatmap grid. output/target (N, J, H, W); the
    normalizer is the heatmap size / 10, built in the output's dtype as the
    JAX function builds it (x divided by h/10, as the reference does).

    Returns (per-joint accuracy (J,), average (), valid joints (), pred).
    """
    h, w = output.shape[-2:]
    pred, _ = get_max_preds(output)
    gt, _ = get_max_preds(target)
    norm = (torch.ones((output.shape[0], 2), dtype=output.dtype,
                       device=output.device)
            * constant([h, w], output.dtype, output.device) / 10.0)
    acc = _dist_acc(_calc_dists(pred, gt, norm), thr)
    valid_joint = acc >= 0
    avg = (torch.where(valid_joint, acc, torch.zeros_like(acc)).sum()
           / valid_joint.sum().clamp(min=1))
    return acc, avg, valid_joint.sum(), pred


def mpjpe(pred: torch.Tensor, gt: torch.Tensor,
          joints_vis: torch.Tensor | None = None) -> torch.Tensor:
    """Mean per-joint position error. pred/gt: (N, J, 3)."""
    d = torch.linalg.vector_norm(pred - gt, dim=-1)
    if joints_vis is not None:
        w = (joints_vis > 0).to(d.dtype)
        return (d * w).sum() / w.sum().clamp(min=1)
    return d.mean()


def nmpjpe(pred: torch.Tensor, gt: torch.Tensor,
           joints_vis: torch.Tensor | None = None) -> torch.Tensor:
    """Scale-normalized MPJPE: optimal per-sample scale before MPJPE."""
    num = (pred * gt).sum(dim=(-1, -2), keepdim=True)
    den = (pred * pred).sum(dim=(-1, -2), keepdim=True)
    s = num / torch.where(den < 1e-12, torch.full_like(den, 1e-12), den)
    return mpjpe(s * pred, gt, joints_vis)


def pck(preds: torch.Tensor, target: torch.Tensor, normalize: torch.Tensor,
        thr: float = 0.5) -> torch.Tensor:
    """PCK@thr per joint with an external normalizer (N,) or (N, 2); -1
    where a joint has no valid target."""
    return _dist_acc(_calc_dists(preds, target, normalize), thr)


def pckh(preds: torch.Tensor, target: torch.Tensor, headsizes: torch.Tensor,
         joints_vis: torch.Tensor | None = None, thr: float = 0.5):
    """PCKh@thr: distances over each sample's head size (N,).
    preds/target (N, J, 2). Returns (per joint (J,), mean), in percent."""
    d = torch.linalg.vector_norm(preds - target, dim=-1) / headsizes[:, None]
    valid = (torch.ones(d.shape, dtype=torch.bool, device=d.device)
             if joints_vis is None else joints_vis > 0)
    hit = (d <= thr) & valid
    n = valid.sum(dim=0)
    per_joint = torch.where(n > 0, hit.sum(dim=0) / n.clamp(min=1),
                            torch.zeros((), device=d.device)) * 100.0
    mean = 100.0 * hit.sum() / valid.sum().clamp(min=1)
    return per_joint, mean


def pa_mpjpe(pred: torch.Tensor, gt: torch.Tensor,
             joints_vis: torch.Tensor | None = None) -> torch.Tensor:
    """Procrustes-aligned MPJPE (protocol 2)."""
    return mpjpe(procrustes_align(pred, gt), gt, joints_vis)


def _nearest(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Index of the nearest centre (the first of equals) for each point."""
    d = torch.linalg.vector_norm(points[:, None] - centers[None], dim=-1)
    return d.argmin(dim=-1)


def kmeans(points: torch.Tensor, k: int, iters: int = 20,
           generator: torch.Generator | None = None,
           init: torch.Tensor | None = None):
    """Plain k-means with a fixed number of iterations. points (N, D).

    The start is ``points[init]`` (k indices), else k distinct indices
    drawn from ``generator``. A cluster that loses every point keeps its
    centre. Returns (centers (k, D), assignment (N,)).
    """
    n = points.shape[0]
    if n < k:
        raise ValueError(f"kmeans needs at least k={k} points, got {n}")
    if init is None:
        init = torch.randperm(n, generator=generator)[:k]
    centers = points[torch.as_tensor(init, device=points.device)]
    for _ in range(iters):
        assign = _nearest(points, centers)
        counts = torch.zeros(k, dtype=points.dtype, device=points.device)
        counts.index_add_(0, assign, torch.ones_like(assign,
                                                     dtype=points.dtype))
        sums = torch.zeros_like(centers).index_add_(0, assign, points)
        new = sums / counts.clamp(min=1.0)[:, None]
        centers = torch.where(counts[:, None] > 0, new, centers)
    return centers, _nearest(points, centers)


# the version of _pose_embed; cached PSS centres (data/h36m.py) carry it
# in their file name, so centres fit under another embedding are not read
PSS_EMBED_VERSION = 2


def _pose_embed(poses: torch.Tensor, root_idx: int = 0) -> torch.Tensor:
    """Root-centred, flattened, unit-norm poses: PSS's representation."""
    x = poses - poses[..., root_idx:root_idx + 1, :]
    x = x.reshape(x.shape[:-2] + (-1,))
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def pss(pred: torch.Tensor, gt: torch.Tensor,
        centers: torch.Tensor) -> torch.Tensor:
    """Pose Structure Score: the share of samples whose prediction and
    ground truth fall in the same cluster of ``centers`` (embedded by
    :func:`_pose_embed`)."""
    same = _nearest(_pose_embed(pred), centers) == _nearest(
        _pose_embed(gt), centers)
    return same.to(torch.float32).mean()


def fit_pss_centers(generator: torch.Generator | None, gt_poses: torch.Tensor,
                    k: int = 50, iters: int = 20) -> torch.Tensor:
    """PSS cluster centres: k-means on the embedded GT poses (J, 3)."""
    centers, _ = kmeans(_pose_embed(gt_poses), k, iters, generator=generator)
    return centers


def pck3d(pred: torch.Tensor, gt: torch.Tensor,
          thresh_mm: float = 150.0) -> torch.Tensor:
    """3D PCK@thresh (the MPI-INF-3DHP transfer protocol), in percent: the
    share of joints within ``thresh_mm`` of the ground truth. pred/gt:
    (N, J, 3) root-relative mm."""
    d = torch.linalg.vector_norm(pred - gt, dim=-1)
    return 100.0 * (d < thresh_mm).to(torch.float32).mean()


def auc3d(pred: torch.Tensor, gt: torch.Tensor, max_thresh_mm: float = 150.0,
          steps: int = 30) -> torch.Tensor:
    """Area under the 3D-PCK curve over ``steps`` thresholds in (0,
    max_thresh] (the 3DHP AUC), in percent."""
    d = torch.linalg.vector_norm(pred - gt, dim=-1)
    ts = torch.linspace(max_thresh_mm / steps, max_thresh_mm, steps,
                        device=d.device)
    curve = (d[..., None] < ts).to(torch.float32).mean(dim=(0, 1))
    return 100.0 * curve.mean()
