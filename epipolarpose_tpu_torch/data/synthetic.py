"""The synthetic H36M-like rig and skeleton poses, in numpy.

The port's copy of the rig part of the JAX package's ``data/synthetic.py``
(``_rodrigues_batch``, ``skeleton_template``, ``synth_skeleton_poses``,
``make_rig``): the same numbers from the same seeds, with ``make_rig``
returning the port's :class:`Camera`. The datasets and loaders are not
ported yet.
"""

from __future__ import annotations

import numpy as np

from epipolarpose_tpu_torch.geometry.camera import Camera


def _rodrigues_batch(aa: np.ndarray) -> np.ndarray:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3)."""
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)
    k = aa / np.maximum(theta, 1e-12)
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    z = np.zeros_like(kx)
    K = np.stack([
        np.stack([z, -kz, ky], axis=-1),
        np.stack([kz, z, -kx], axis=-1),
        np.stack([-ky, kx, z], axis=-1),
    ], axis=-2)
    t = theta[..., None]
    eye = np.broadcast_to(np.eye(3, dtype=aa.dtype), K.shape)
    return eye + np.sin(t) * K + (1.0 - np.cos(t)) * (K @ K)


def skeleton_template(num_joints: int, seed: int = 1234):
    """Fixed kinematic tree for synthetic skeletons, per (num_joints,
    seed): parents, bone lengths (mm), rest directions and a low-rank
    joint-angle basis."""
    rng = np.random.default_rng(seed + 7919 * num_joints)
    parents = np.array([(j - 1) // 2 for j in range(num_joints)])
    parents[0] = -1
    lengths = rng.uniform(150.0, 400.0, num_joints).astype(np.float32)
    rest = rng.normal(size=(num_joints, 3)).astype(np.float32)
    rest /= np.linalg.norm(rest, axis=1, keepdims=True)
    latent_dim = 8
    basis = rng.normal(size=(latent_dim, num_joints, 3)).astype(np.float32)
    basis *= 0.3 / np.sqrt(latent_dim)       # ~0.3 rad rms per joint
    return parents, lengths, rest, basis


def synth_skeleton_poses(rng: np.random.Generator, n: int,
                         num_joints: int) -> np.ndarray:
    """(n, J, 3) root-relative skeleton poses (mm, world frame): a
    low-dimensional latent drives per-joint axis-angle turns accumulated
    down the tree, plus a free rotation about the vertical. Bone lengths
    are the same in every sample."""
    parents, lengths, rest, basis = skeleton_template(num_joints)
    J = num_joints
    z = rng.normal(size=(n, basis.shape[0])).astype(np.float32)
    aa = np.einsum("nk,kjc->njc", z, basis)             # (n, J, 3)
    g = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    cg, sg = np.cos(g), np.sin(g)
    zn = np.zeros_like(cg)
    on = np.ones_like(cg)
    Rg = np.stack([
        np.stack([cg, -sg, zn], axis=-1),
        np.stack([sg, cg, zn], axis=-1),
        np.stack([zn, zn, on], axis=-1),
    ], axis=-2)                                          # (n, 3, 3)
    Racc = np.zeros((n, J, 3, 3), np.float32)
    pos = np.zeros((n, J, 3), np.float32)
    Rj = _rodrigues_batch(aa)                            # (n, J, 3, 3)
    for j in range(J):
        if parents[j] < 0:
            Racc[:, j] = Rg @ Rj[:, j]
        else:
            Racc[:, j] = Racc[:, parents[j]] @ Rj[:, j]
            bone = lengths[j] * rest[j]
            pos[:, j] = pos[:, parents[j]] + np.einsum(
                "nij,j->ni", Racc[:, j], bone)
    return pos


def make_rig(num_views: int = 4, radius: float = 4500.0,
             height: float = 1500.0, focal: float = 1145.0,
             img_size: int = 1000, seed: int = 0) -> list[Camera]:
    """H36M-like rig (mm): ``num_views`` cameras on a circle, looking at
    the origin, with H36M-sized distortion. Returns CPU cameras."""
    rng = np.random.default_rng(seed)
    cams = []
    for v in range(num_views):
        ang = 2 * np.pi * v / num_views + rng.uniform(-0.1, 0.1)
        T = np.array([radius * np.cos(ang), radius * np.sin(ang), height],
                     np.float32)
        z = -T / np.linalg.norm(T)
        up = np.array([0, 0, 1.0], np.float32)
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        cams.append(Camera.from_arrays(
            R=np.stack([x, y, z]), T=T, f=np.array([focal, focal]),
            c=np.array([img_size / 2, img_size / 2]),
            k=np.array([-0.2, 0.24, -0.002]), p=np.array([0.001, -0.0005])))
    return cams
