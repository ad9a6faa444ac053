"""Synthetic datasets: learnable pose data made from a seed, no files.

The port's copy of the JAX package's ``data/synthetic.py``: the same
records, images and numbers from the same seeds. Images are one Gaussian
blob per joint, each joint its own colour, so a heatmap network can learn
joint detection from them.

- :class:`SyntheticPoseDataset`: single view, MPII-like (2D), PCKh.
- :class:`SyntheticMultiviewDataset`: an H36M-like 4-camera rig with GT 3D
  joints, cameras and view groups, evaluated as H36M is.
- :func:`write_synthetic_mpii` and :func:`write_synthetic_h36m` write
  on-disk trees for the file readers (they encode JPEGs with OpenCV).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from epipolarpose_tpu_torch.data.h36m import MultiviewDataset
from epipolarpose_tpu_torch.data.joints_dataset import (JointsDataset,
                                                        JointsRecord)
from epipolarpose_tpu_torch.geometry.camera import (Camera,
                                                    project_point_radial,
                                                    world_to_camera_frame)
from epipolarpose_tpu_torch.ops.metrics import pckh


def _render_blobs(joints, shape, num_joints, blob_sigma=4.0) -> np.ndarray:
    """An (H, W, 3) float32 image in [0, 1] with one Gaussian blob per
    joint, coloured by joint id. ``blob_sigma`` is a scalar or one value
    a joint."""
    H, W = shape
    img = np.zeros((H, W, 3), np.float32)
    sig = np.broadcast_to(np.asarray(blob_sigma, np.float32),
                          (len(joints),))
    for j, (x, y) in enumerate(joints):
        # a blob reaches +-4 sigma: beyond, exp(-8) is under half a grey
        # level
        r = max(int(np.ceil(4.0 * sig[j])), 2)
        x0 = max(int(np.floor(x)) - r, 0)
        y0 = max(int(np.floor(y)) - r, 0)
        x1 = min(int(np.ceil(x)) + r + 1, W)
        y1 = min(int(np.ceil(y)) + r + 1, H)
        if x0 >= x1 or y0 >= y1:
            continue
        ys = np.arange(y0, y1, dtype=np.float32)[:, None]
        xs = np.arange(x0, x1, dtype=np.float32)[None, :]
        g = np.exp(-((xs - x) ** 2 + (ys - y) ** 2) / (2 * sig[j] ** 2))
        w = np.array([np.cos(j * 1.3) ** 2, np.sin(j * 0.7) ** 2,
                      ((j % 4) + 1) / 4.0], np.float32)
        img[y0:y1, x0:x1] += g[..., None] * w
    return np.clip(img, 0, 1)


class SyntheticPoseDataset(JointsDataset):
    """Single-view synthetic dataset with the MPII surface.

    ``flip_pairs`` is empty: each blob's colour is its joint's, whatever
    the side, so a flip only mirrors; swapping labels would contradict
    the colours on every flipped sample."""

    flip_pairs = ()

    def __init__(self, cfg, num_samples: int = 64, is_train: bool = True,
                 image_shape=(256, 256), seed: int = 0, **kwargs):
        self.image_shape = image_shape
        J = int(cfg.MODEL.NUM_JOINTS)
        rng = np.random.default_rng(seed)
        side = float(min(image_shape))
        margin = 0.31 * side
        spread = 0.23 * side
        box_scale = side / 200.0 * 0.9
        records = []
        for i in range(num_samples):
            center = rng.uniform(
                [margin, margin],
                [image_shape[1] - margin, image_shape[0] - margin],
                2).astype(np.float32)
            joints = (center + rng.uniform(-spread, spread, (J, 2))).astype(
                np.float32)
            records.append(JointsRecord(
                image=f"synthetic://{i}", center=center,
                scale=np.array([box_scale, box_scale], np.float32),
                joints=joints, joints_vis=np.ones(J, np.float32)))
        super().__init__(cfg, records, is_train, **kwargs)

    def _read_image(self, path: str) -> np.ndarray:
        rec = self.records[int(path.split("://")[1])]
        img = _render_blobs(rec.joints, self.image_shape, len(rec.joints))
        return (img * 255).astype(np.uint8)

    def evaluate(self, cfg, preds, output_dir=None, **kwargs):
        """PCKh@0.5 with a fixed 30 px head size: ({"Mean": pckh}, pckh)."""
        preds = torch.as_tensor(np.asarray(preds)[..., :2])
        gts = torch.from_numpy(
            np.stack([r.joints for r in self.records])[:len(preds)])
        heads = torch.full((len(preds),), 30.0)
        _, mean = pckh(preds, gts, heads)
        return {"Mean": float(mean)}, float(mean)


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


class SyntheticMultiviewDataset(MultiviewDataset):
    """H36M-like synthetic rig: ``num_views`` views a time instant, GT 3D
    joints (camera mm), per-view cameras and view groups; batched and
    evaluated as H36M is.

    ``pose_mode``: ``"uniform"`` joints in an 800 mm cube, or
    ``"skeleton"`` kinematic-tree poses (constant bones, a low-rank pose
    manifold). ``depth_cue`` > 0 draws each blob at the size a fixed ball
    would project to, ``sigma * (mean z / z) ** depth_cue``."""

    # empty for the same reason as SyntheticPoseDataset's
    flip_pairs = ()

    def __init__(self, cfg, num_frames: int = 16, is_train: bool = True,
                 image_shape=(256, 256), num_views: int = 4, seed: int = 0,
                 pose_mode: str = "uniform", depth_cue: float = 0.0,
                 **kwargs):
        self.image_shape = image_shape
        self.depth_cue = float(depth_cue)
        J = int(cfg.MODEL.NUM_JOINTS)
        rng = np.random.default_rng(seed)
        self.rig = make_rig(num_views, img_size=image_shape[0] * 4,
                            seed=seed)
        if pose_mode == "skeleton":
            poses_w = synth_skeleton_poses(rng, num_frames, J)
            poses_w += rng.uniform([-150.0, -150.0, 600.0],
                                   [150.0, 150.0, 1000.0],
                                   (num_frames, 1, 3)).astype(np.float32)
        else:
            poses_w = rng.uniform(-400, 400, (num_frames, J, 3)).astype(
                np.float32)
            poses_w[:, :, 2] += 900.0
        # one float32 projection of every (view, frame) on the CPU
        cam_b = Camera.stack(self.rig).map(lambda t: t[:, None])
        pts = torch.from_numpy(poses_w)
        px_all = project_point_radial(pts, cam_b)[0].numpy()
        pc_all = world_to_camera_frame(pts, cam_b).numpy()
        records, groups = [], []
        for t in range(num_frames):
            pose_w = poses_w[t]
            group = []
            for v in range(num_views):
                px = px_all[v, t]
                center = px.mean(axis=0).astype(np.float32)
                extent = float(np.abs(px - center).max() * 2.4 + 40)
                group.append(len(records))
                records.append(JointsRecord(
                    image=f"synthetic://{t}:{v}", center=center,
                    scale=np.array([extent / 200, extent / 200], np.float32),
                    joints=px.astype(np.float32),
                    joints_vis=np.ones(J, np.float32),
                    joints_3d=pc_all[v, t].astype(np.float32),
                    meta={"subject": 1, "action": "Synth", "subaction": 1,
                          "camera": str(v), "frame": t, "pose_world": pose_w,
                          "view": v}))
            groups.append(tuple(group))
        self.view_groups = groups
        super().__init__(cfg, records, is_train, **kwargs)

    def _read_image(self, path: str) -> np.ndarray:
        t, v = map(int, path.split("://")[1].split(":"))
        rec = self.records[self.view_groups[t][v]]
        size = self.image_shape[0] * 4
        sigma = float(rec.scale[0] * 200 / 40)
        if self.depth_cue > 0:
            z = rec.joints_3d[:, 2]            # camera-frame depth (mm)
            sigma = sigma * (z.mean() / z) ** self.depth_cue
        img = _render_blobs(rec.joints, (size, size), len(rec.joints),
                            blob_sigma=sigma)
        return (img * 255).astype(np.uint8)

    def camera_for(self, rec: JointsRecord) -> Camera:
        return self.rig[int(rec.meta["camera"])]


def write_synthetic_mpii(root: str, cfg, num_samples: int = 8,
                         seed: int = 0) -> None:
    """Write an MPII-format tree (annot json and JPEG images) under
    ``root``. Needs OpenCV to encode the images."""
    import cv2
    os.makedirs(os.path.join(root, "annot"), exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    ds = SyntheticPoseDataset(cfg, num_samples, seed=seed)
    annots = []
    for i, rec in enumerate(ds.records):
        name = f"synth_{i:05d}.jpg"
        img = ds._read_image(rec.image)
        cv2.imwrite(os.path.join(root, "images", name),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        annots.append({
            "image": name,
            # undo the reader's centre and scale adjustment (+15 s,
            # x1.25, -1) and write 1-based joints, so the reader gets the
            # records back
            "center": [float(rec.center[0] + 1),
                       float(rec.center[1] + 1 - 15 * rec.scale[1] / 1.25)],
            "scale": float(rec.scale[0] / 1.25),
            "joints": (rec.joints + 1).tolist(),
            "joints_vis": rec.joints_vis.tolist(),
        })
    for split in ("train", "valid"):
        with open(os.path.join(root, "annot", f"{split}.json"), "w") as f:
            json.dump(annots, f)


def write_synthetic_h36m(root: str, cfg, num_frames: int = 6,
                         seed: int = 0, camera_ids=None,
                         jpeg: bytes | None = None) -> None:
    """Write an H36M-format tree (annot jsons, cameras.json, JPEG images
    in a zip) under ``root``; ``camera_ids`` names the 4 cameras (default
    '0'..'3'). Each image is its rendered view, encoded by OpenCV; with
    ``jpeg``, every image is those JPEG bytes instead (no OpenCV needed;
    the labels then do not match the pictures)."""
    import zipfile

    if jpeg is None:
        import cv2
    os.makedirs(os.path.join(root, "annot"), exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    ds = SyntheticMultiviewDataset(cfg, num_frames=num_frames, seed=seed)
    cam_name = (lambda v: str(camera_ids[v])) if camera_ids else str

    cameras = {}
    for v, cam in enumerate(ds.rig):
        cameras[f"1:{cam_name(v)}"] = {
            n: getattr(cam, n).numpy().tolist()
            for n in ("R", "T", "f", "c", "k", "p")}
    with open(os.path.join(root, "annot", "cameras.json"), "w") as f:
        json.dump(cameras, f)

    zip_path = os.path.join(root, "images", "S1.zip")
    annots = []
    with zipfile.ZipFile(zip_path, "w") as z:
        for i, rec in enumerate(ds.records):
            name = f"S1/img_{i:05d}.jpg"
            if jpeg is None:
                img = ds._read_image(rec.image)
                ok, enc = cv2.imencode(
                    ".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
                if not ok:
                    raise IOError(f"JPEG encoding failed for {name}")
                z.writestr(name, enc.tobytes())
            else:
                z.writestr(name, jpeg)
            annots.append({
                "image": f"{zip_path}@/{name}",
                "center": rec.center.tolist(),
                "scale": rec.scale.tolist(),
                "joints_2d": rec.joints.tolist(),
                "joints_vis": rec.joints_vis.tolist(),
                "joints_3d": rec.joints_3d.tolist(),
                "subject": 1,
                "action": rec.meta["action"],
                "subaction": rec.meta["subaction"],
                "camera": cam_name(int(rec.meta["camera"])),
                "frame": rec.meta["frame"],
            })
    for split in ("train", "valid"):
        with open(os.path.join(root, "annot", f"{split}.json"), "w") as f:
            json.dump(annots, f)
