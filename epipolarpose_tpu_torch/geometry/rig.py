"""Rig self-calibration: camera extrinsics from 2D correspondences.

Counterpart of the JAX package's ``geometry/rig.py``, the paper's
calibration-free mode: with the extrinsics withheld, the essential matrix
between view 0 and each other view comes from the teacher's 2D joints,
gives that view's relative (R, t) up to scale, and the pseudo-GT is
triangulated in camera 0's frame. The scale is a unit (0, 1) baseline, or
set by a known mean bone length.

Every triangulation here is the ``fast`` solver, as in the JAX package:
``solve`` (default :func:`kernels.triangulate.triangulate_fast`, the CUDA
kernel ``epk_triangulate`` on the card and its plain twin on the CPU), with
the signature ``solve(points2d, P, weights) -> (X, residual)``. A rig of V
views launches it V - 1 times on (G·J, 2, 1, 2) points with a shared
P (2, 3, 4), and :func:`pseudo_gt_uncalibrated` once more on
(G, V, J, 2). The essential matrices of the V - 1 pairs are estimated in
one batched solve.
"""

from __future__ import annotations

from typing import Callable

import torch

from epipolarpose_tpu_torch.geometry.camera import (Camera,
                                                    normalized_camera_coords)
from epipolarpose_tpu_torch.geometry.epipolar import (estimate_essential,
                                                      recover_pose)
from epipolarpose_tpu_torch.geometry.triangulation import triangulate
from epipolarpose_tpu_torch.graphs import constant
# the module, not the name: ``kernels.triangulate`` imports this package
# (``geometry.triangulation``), so either may be imported first
from epipolarpose_tpu_torch.kernels import triangulate as ktri


def _eye34(like: torch.Tensor) -> torch.Tensor:
    """[I | 0] in ``like``'s dtype and device."""
    kw = dict(dtype=like.dtype, device=like.device)
    return torch.cat([torch.eye(3, **kw), torch.zeros((3, 1), **kw)], dim=1)


def estimate_rig(detections_norm: torch.Tensor,
                 conf: torch.Tensor | None = None,
                 solve: Callable | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-view [R | t] from multi-view 2D correspondences.

    detections_norm (G, V, J, 2): normalized (K⁻¹) coordinates of the same
    G·J points in V views, view 0 the reference; conf (G, V, J) weights the
    essential matrices. Returns (P (V, 3, 4) with P[0] = [I | 0], X_ref
    (G·J, 3), the (0, 1) pair's points). The (0, 1) baseline has unit
    length; every other view's translation is scaled so its two-view
    points match pair (0, 1)'s.
    """
    solve = solve or ktri.triangulate_fast
    g, v, j, _ = detections_norm.shape
    x0 = detections_norm[:, 0].reshape(g * j, 2)
    xv = detections_norm[:, 1:].transpose(0, 1).reshape(v - 1, g * j, 2)
    wv = None
    if conf is not None:
        wv = (conf[:, :1] * conf[:, 1:]).transpose(0, 1).reshape(v - 1, -1)
    x0s = x0.expand(v - 1, g * j, 2)
    e = estimate_essential(x0s, xv, weights=wv)
    r, t, _ = recover_pose(e, x0s, xv)        # (V-1, 3, 3), (V-1, 3)
    eye34 = _eye34(detections_norm)
    ps = [eye34]
    x_ref = None
    for k in range(v - 1):
        p_v = torch.cat([r[k], t[k, :, None]], dim=1)
        # two-view points (G·J, 2 views, 1 joint, 2) with a shared P
        pts = torch.stack([x0, xv[k]], dim=1)[:, :, None, :].contiguous()
        x_v = solve(pts, torch.stack([eye34, p_v]).contiguous(), None)[0]
        x_v = x_v[:, 0]
        if x_ref is None:
            x_ref = x_v
            ps.append(p_v)
        else:
            # a unit baseline gives scene / B_v; matching pair (0, 1)'s
            # scene / B_1 scales the baseline by B_v / B_1, the
            # least-squares ratio of the two point sets
            s = (x_v * x_ref).sum() / ((x_v * x_v).sum() + 1e-12)
            ps.append(torch.cat([r[k], (t[k] * s)[:, None]], dim=1))
    return torch.stack(ps), x_ref


def pseudo_gt_uncalibrated(detections_px: torch.Tensor, intrinsics: Camera,
                           conf: torch.Tensor | None = None,
                           method: str = "fast", bone_pairs=None,
                           bone_length_mm: float | None = None,
                           solve: Callable | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Pseudo-GT without extrinsics: pixels -> rig -> triangulation.

    detections_px (G, V, J, 2) pixels; ``intrinsics`` with (V,) fields
    (only f and c are read); conf (G, V, J) or None. Returns (X (G, J, 3)
    in camera 0's frame, P (V, 3, 4), residual (G, J), in X's scale).
    ``method`` is the last triangulation's solver (``fast`` is ``solve``);
    the rig's are always ``solve``.

    Scale: a unit (0, 1) baseline; with ``bone_pairs`` (joint index pairs)
    and ``bone_length_mm``, the whole reconstruction (points, baselines
    and residuals) is rescaled so that the mean bone has that length.
    """
    solve = solve or ktri.triangulate_fast
    g, v, j, _ = detections_px.shape
    det_v = detections_px.transpose(0, 1).reshape(v, g * j, 2)
    norm = normalized_camera_coords(det_v, intrinsics)
    norm = norm.reshape(v, g, j, 2).transpose(0, 1).contiguous()
    p, _ = estimate_rig(norm, conf, solve)
    w = None if conf is None else conf.to(norm.dtype).contiguous()
    if method == "fast":
        x, res = solve(norm, p.contiguous(), w)
    else:
        x, res = triangulate(norm, p, w, method=method)
    if bone_pairs is not None and bone_length_mm is not None:
        a = constant([q[0] for q in bone_pairs], torch.int64, x.device)
        b = constant([q[1] for q in bone_pairs], torch.int64, x.device)
        lengths = torch.linalg.vector_norm(
            x.index_select(1, a) - x.index_select(1, b), dim=-1)
        s = bone_length_mm / (lengths.mean() + 1e-12)
        # scale the points and the baselines together: R (s X) + s t keeps
        # every view's projection and gives depths in mm
        x = x * s
        p = torch.cat([p[..., :3], p[..., 3:] * s], dim=-1)
        res = res * s
    return x, p, res
