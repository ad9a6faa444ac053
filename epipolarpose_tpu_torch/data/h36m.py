"""Human3.6M: multi-view records, cameras, and MPJPE-family evaluation.

The port's copy of the JAX package's ``data/h36m.py``. Subjects S1, S5,
S6, S7, S8 train and S9, S11 test; images from per-subject zips; four
synchronized cameras; the 17-joint skeleton; MPJPE per action, NMPJPE,
PA-MPJPE and PSS@{50, 100}.

On disk:
  <root>/annot/<image_set>.json   samples with image, center [2], scale
      [2], joints_2d [J, 2], joints_3d [J, 3] (camera-frame mm), subject,
      action, subaction, camera, frame
  <root>/annot/cameras.json       {"<subject>:<camera>": {R, T, f, c, k, p}}

17-joint order: 0 pelv 1 rhip 2 rkne 3 rank 4 lhip 5 lkne 6 lank
7 spine 8 neck 9 head 10 site 11 lsho 12 lelb 13 lwri 14 rsho 15 relb
16 rwri.
"""

from __future__ import annotations

import collections
import json
import os

import numpy as np
import torch

from epipolarpose_tpu_torch.data import fastloader
from epipolarpose_tpu_torch.data.imgproc import (resize_bilinear_u8,
                                                 warp_affine_u8)
from epipolarpose_tpu_torch.data.joints_dataset import (JointsDataset,
                                                        JointsRecord,
                                                        host_shard_indices,
                                                        record_seed)
from epipolarpose_tpu_torch.data.zipreader import read_file_bytes
from epipolarpose_tpu_torch.geometry.affine import get_affine_transform_np
from epipolarpose_tpu_torch.geometry.camera import (Camera, pixel2cam,
                                                    undistort_points)
from epipolarpose_tpu_torch.ops.metrics import (PSS_EMBED_VERSION,
                                                fit_pss_centers, mpjpe,
                                                nmpjpe, pa_mpjpe, pss)

CAMERA_IDS = ("54138969", "55011271", "58860488", "60457274")
TRAIN_SUBJECTS = (1, 5, 6, 7, 8)
TEST_SUBJECTS = (9, 11)
FLIP_PAIRS = ((1, 4), (2, 5), (3, 6), (11, 14), (12, 15), (13, 16))
ROOT_IDX = 0
ACTIONS = ("Directions", "Discussion", "Eating", "Greeting", "Phoning",
           "Photo", "Posing", "Purchases", "Sitting", "SittingDown",
           "Smoking", "Waiting", "WalkDog", "Walking", "WalkTogether")
# seed of the PSS centres' k-means start
PSS_SEED = 0


def load_cameras(path: str) -> dict[str, Camera]:
    """cameras.json -> {"<subject>:<camera_id>": Camera} (CPU tensors)."""
    with open(path) as f:
        raw = json.load(f)
    return {key: Camera.from_arrays(
        R=np.reshape(c["R"], (3, 3)), T=np.reshape(c["T"], 3),
        f=np.reshape(c["f"], 2), c=np.reshape(c["c"], 2),
        k=np.reshape(c["k"], 3), p=np.reshape(c["p"], 2))
        for key, c in raw.items()}


class MultiviewDataset(JointsDataset):
    """What H36M and the synthetic rig share: 4-view batches with the
    dual crop, the camera-frame lift of predictions, and the MPJPE-family
    evaluation. A subclass sets ``view_groups`` (record indices a view
    group, in ``CAMERA_IDS`` order) and ``camera_for``."""

    root_idx = ROOT_IDX
    perf_higher_is_better = False   # MPJPE in mm

    def camera_for(self, rec: JointsRecord) -> Camera | None:
        raise NotImplementedError

    # ---------------------------------------------------- multi-view batches
    def view_batches(self, groups_per_batch: int, seed: int = 0,
                     shuffle: bool | None = None, augment: bool = False,
                     process_index: int = 0, process_count: int = 1):
        """Yield multi-view batches: ``input`` (G, V, H, W, 3), boxes and
        labels with (G, V) leading dims, and ``camera``, one
        :class:`Camera` with (G, V) fields, when every view has one.

        ``augment=True`` adds the student's augmented crop of each view
        (``input_aug``, its source -> crop affine ``aug_M`` with random
        scale and rotation and the flip folded in, and ``aug_flip``): the
        teacher sees the clean crop, the student trains on the other.
        Each view is read once and warped twice. ``groups_per_batch`` is
        global: with ``process_count`` > 1 each process (each data group,
        under a model axis) takes its contiguous slice of every batch's
        groups (``host_shard_indices``).
        """
        n = len(self.view_groups)
        order = np.arange(n)
        if shuffle if shuffle is not None else self.is_train:
            np.random.default_rng(seed).shuffle(order)
        stop = n - (n % groups_per_batch)
        V = len(CAMERA_IDS)
        for b in range(0, stop, groups_per_batch):
            gidx = order[b:b + groups_per_batch]
            if process_count > 1:
                gidx = host_shard_indices(gidx, process_index, process_count)
            flat = [i for g in gidx for i in self.view_groups[g]]
            t_scale = float(getattr(self.cfg.TPU, "SS_TEACHER_SCALE", 1.0)) \
                if augment else 1.0
            batch = None
            if augment:
                batch = self._dual_batch_native(flat, seed_clean=seed + b,
                                                seed_aug=seed + b + 1,
                                                teacher_scale=t_scale)
            if batch is None:
                was_train = self.is_train
                try:
                    self.is_train = False    # clean crops for the teacher
                    batch = (self._dual_batch_pool(flat, seed + b + 1)
                             if augment else self.get_batch(flat,
                                                            seed=seed + b))
                finally:
                    self.is_train = was_train
                if t_scale != 1.0:
                    batch = self._scale_teacher_crop(batch, t_scale)
            out = {k: v.reshape((len(gidx), V) + v.shape[1:])
                   for k, v in batch.items()}
            cams = [self.camera_for(self.records[i]) for i in flat]
            if all(c is not None for c in cams):
                out["camera"] = Camera.stack(cams).map(
                    lambda t: t.reshape((len(gidx), V) + t.shape[1:]))
            yield out

    def _aug_affines(self, indices, seed: int):
        """The student crops' affines and flips: (Ms (N, 2, 3) source ->
        crop with random scale and rotation and the crop-space flip
        folded in, flips (N,) float 0/1)."""
        n = len(indices)
        Ms = np.zeros((n, 2, 3), np.float32)
        flips = np.zeros(n, np.float32)
        for k, idx in enumerate(indices):
            rec = self.records[idx]
            rng = np.random.default_rng(record_seed(seed, idx))
            s_mult, rot, do_flip = self._augment_params(rng)
            M = get_affine_transform_np(
                rec.center, rec.scale * s_mult, rot, self.image_size)
            if do_flip:
                # M_flip = F o M with F: x' = (W - 1) - x
                F = np.array([[-1.0, 0.0, self.image_size[0] - 1.0],
                              [0.0, 1.0, 0.0]], np.float32)
                M = np.concatenate(
                    [F[:, :2] @ M[:, :2],
                     (F[:, :2] @ M[:, 2] + F[:, 2])[:, None]], axis=1)
            Ms[k] = M
            flips[k] = float(do_flip)
        return Ms, flips

    def _teacher_crop_size(self, teacher_scale: float):
        return (max(int(round(self.image_size[0] * teacher_scale)), 1),
                max(int(round(self.image_size[1] * teacher_scale)), 1))

    def _scale_teacher_crop(self, batch: dict, teacher_scale: float) -> dict:
        """The numpy route's reduced teacher crop: the full-size clean crop
        resized bilinearly (the native route warps at the reduced size);
        ``joints`` follow into the scaled frame, ``s * M``."""
        W, H = self._teacher_crop_size(teacher_scale)
        batch = dict(batch)
        batch["input"] = np.stack([resize_bilinear_u8(im, (W, H))
                                   for im in batch["input"]])
        if "joints" in batch:
            j = batch["joints"].copy()
            j[..., :2] *= np.float32(teacher_scale)
            batch["joints"] = j
        return batch

    def _dual_batch_pool(self, indices, seed_aug: int) -> dict:
        """Clean and augmented crops of ``indices`` through the thread
        pool, each image read once: ``get_batch`` (at ``is_train``
        False) plus ``input_aug``, ``aug_M`` and ``aug_flip``."""
        Ms, flips = self._aug_affines(indices, seed_aug)

        def load(k_i):
            k, i = k_i
            img = self._read_image(self.records[i].image)
            out = self._load_one(i, 0, img=img)
            out["input_aug"] = warp_affine_u8(img, Ms[k], self.image_size)
            return out

        outs = list(self.pool.map(load, enumerate(indices)))
        batch = {k: np.stack([o[k] for o in outs]) for k in outs[0]}
        batch["aug_M"] = Ms
        batch["aug_flip"] = flips
        return batch

    def _dual_batch_native(self, indices, seed_clean: int, seed_aug: int,
                           teacher_scale: float = 1.0):
        """The dual-crop batch through one native decode + two warps of
        each JPEG (the clean crop at ``teacher_scale`` of the size, its
        ``joints`` in that frame); None when the native loader does not
        serve these records."""
        if not self._use_native(indices, seed_clean):
            return None
        recs = [self.records[i] for i in indices]
        bufs = list(self.pool.map(lambda r: read_file_bytes(r.image), recs))
        centers = np.stack([r.center for r in recs]).astype(np.float32)
        scales = np.stack([r.scale for r in recs]).astype(np.float32)
        joints = np.stack([r.joints for r in recs]).astype(np.float32)
        vis = np.stack([r.joints_vis for r in recs]).astype(np.float32)
        n = len(recs)
        t_size = self.image_size if teacher_scale == 1.0 else \
            self._teacher_crop_size(teacher_scale)
        M1 = get_affine_transform_np(centers, scales,
                                     np.zeros(n, np.float32), t_size)
        M2, flips = self._aug_affines(indices, seed_aug)
        crops, crops_aug = fastloader.decode_warp2_batch(
            bufs, M1, M2, self.image_size, output_size1=t_size)
        joints_crop = np.einsum("nij,nkj->nki", M1[:, :, :2], joints) \
            + M1[:, None, :, 2]
        batch = dict(input=crops, joints=joints_crop.astype(np.float32),
                     joints_vis=vis, center=centers, scale=scales,
                     rotation=np.zeros(n, np.float32),
                     index=np.asarray(indices, np.int64),
                     input_aug=crops_aug, aug_M=M2, aug_flip=flips)
        if recs[0].joints_3d is not None:
            batch["joints_3d"] = np.stack(
                [r.joints_3d for r in recs]).astype(np.float32)
        return batch

    # ------------------------------------------------------------ evaluate
    def evaluate(self, cfg, preds, output_dir=None, **kwargs):
        """MPJPE per action and overall, NMPJPE, PA-MPJPE (protocol 2),
        and PSS@{50, 100} when centres exist; returns (name_values, MPJPE).

        ``preds`` (N, J, 3) as the integral eval step gives them: (x, y)
        in source pixels, z in root-relative mm. With cameras and absolute
        GT depth they are lifted to camera-frame mm with the GT root depth
        (undistort, then ``pixel2cam``); otherwise they are taken as
        camera-frame mm.
        """
        preds = np.asarray(preds)
        recs = self.records[:len(preds)]
        gts, actions = [], []
        for r in recs:
            g = r.joints_3d
            gts.append(g - g[self.root_idx:self.root_idx + 1])
            actions.append((r.meta or {}).get("action", "All"))
        gts = np.stack(gts).astype(np.float32)

        preds = self._preds_to_camera_mm(preds, recs).astype(np.float32)
        preds = preds - preds[:, self.root_idx:self.root_idx + 1]
        p, g = torch.from_numpy(preds), torch.from_numpy(gts)

        name_value = {}
        actions_arr = np.array([str(a) for a in actions])
        for act in sorted(set(actions_arr.tolist())):
            m = torch.from_numpy(actions_arr == act)
            name_value[str(act)] = float(mpjpe(p[m], g[m]))
        mean = float(mpjpe(p, g))
        name_value["MPJPE"] = mean
        name_value["NMPJPE"] = float(nmpjpe(p, g))
        name_value["PA-MPJPE"] = float(pa_mpjpe(p, g))
        # PSS centres are fit on train-split poses (the paper's protocol),
        # falling back to the eval GT when no train annotation exists
        for k in (50, 100):
            centers = self.pss_centers(k, fallback_gts=gts)
            if centers is not None:
                name_value[f"PSS@{k}"] = float(
                    pss(p, g, torch.as_tensor(centers)))
        return name_value, mean

    def pss_centers(self, k: int, fallback_gts=None):
        """k-means PSS centres (k, 3J) from the train split's
        root-centred poses, cached at
        ``<root>/annot/pss_centers_k{k}_v{PSS_EMBED_VERSION}.npy`` (the
        JAX package's file: either package reads the other's). Without a
        train annotation they are fit on ``fallback_gts`` and not cached;
        None when neither has 2k poses."""
        root = getattr(self, "root", None)
        cache = os.path.join(
            root, "annot", f"pss_centers_k{k}_v{PSS_EMBED_VERSION}.npy") \
            if root else None
        if cache and os.path.exists(cache):
            return np.load(cache)

        poses = None
        train_annot = os.path.join(root, "annot", "train.json") \
            if root else None
        if train_annot and os.path.exists(train_annot):
            with open(train_annot) as f:
                annots = json.load(f)
            ps = [np.asarray(a["joints_3d"], np.float32)
                  for a in annots if "joints_3d" in a]
            if len(ps) >= 2 * k:
                poses = np.stack(ps)
                poses = poses - poses[:, self.root_idx:self.root_idx + 1]
        from_train_split = poses is not None
        if poses is None:
            if fallback_gts is None or len(fallback_gts) < 2 * k:
                return None
            poses = np.asarray(fallback_gts, np.float32)

        centers = fit_pss_centers(
            torch.Generator().manual_seed(PSS_SEED),
            torch.from_numpy(poses.astype(np.float32)), k=k).numpy()
        # cache only train-split fits: an eval-set fit would stay pinned
        # after a train annotation appears
        if cache and from_train_split:
            try:
                np.save(cache, centers)
            except OSError:
                pass
        return centers

    def _preds_to_camera_mm(self, preds, recs) -> np.ndarray:
        """Eval-step predictions (x, y px; z root-relative mm) -> camera
        mm with the GT root depth, through undistortion and the pinhole
        back-projection; unchanged without cameras or absolute depth."""
        cams = [self.camera_for(r) for r in recs]
        root_z = np.asarray([r.joints_3d[self.root_idx, 2] for r in recs],
                            np.float32)
        if any(c is None for c in cams) or np.median(np.abs(root_z)) < 1.0:
            return preds
        cam_b = Camera.stack(cams)
        px = undistort_points(
            torch.as_tensor(preds[..., :2], dtype=torch.float32), cam_b)
        depth = torch.as_tensor(preds[..., 2], dtype=torch.float32) \
            + torch.from_numpy(root_z)[:, None]
        return pixel2cam(px, depth, cam_b).numpy()


class H36MDataset(MultiviewDataset):
    flip_pairs = FLIP_PAIRS

    def __init__(self, cfg, root: str, image_set: str, is_train: bool,
                 **kwargs):
        self.root = root
        self.image_set = image_set
        self.subsample = int(cfg.DATASET.get("SUBSAMPLE", 1)) or 1
        records, cameras, groups = self._load(cfg, root, image_set)
        self.cameras = cameras
        self.view_groups = groups     # [(record index per camera), ...]
        super().__init__(cfg, records, is_train, **kwargs)

    def _load(self, cfg, root, image_set):
        annot_file = os.path.join(root, "annot", f"{image_set}.json")
        with open(annot_file) as f:
            annots = json.load(f)
        cam_file = os.path.join(root, "annot", "cameras.json")
        cameras = load_cameras(cam_file) if os.path.exists(cam_file) else {}

        records = []
        group_map: dict[tuple, dict[str, int]] = collections.defaultdict(dict)
        # SUBSAMPLE strides over time instants (frame keys in order of
        # first appearance), not rows: every view of each kept instant
        # stays, so the 4-view groups survive
        frame_ids: dict[tuple, int] = {}
        for a in annots:
            fkey = (a.get("subject"), a.get("action"), a.get("subaction"),
                    a.get("frame"))
            if frame_ids.setdefault(fkey, len(frame_ids)) % self.subsample:
                continue
            joints3d = (np.array(a["joints_3d"], np.float32)
                        if "joints_3d" in a else None)
            image = str(a["image"])
            rec = JointsRecord(
                image=os.path.join(root, "images", image)
                if not image.startswith("/") and "@" not in image
                else image,
                center=np.array(a["center"], np.float32),
                scale=np.array(a["scale"], np.float32).reshape(-1)[:2]
                if np.ndim(a["scale"]) else np.array(
                    [a["scale"], a["scale"]], np.float32),
                joints=np.array(a["joints_2d"], np.float32),
                joints_vis=np.array(
                    a.get("joints_vis", np.ones(len(a["joints_2d"]))),
                    np.float32),
                joints_3d=joints3d,
                meta={
                    "subject": a.get("subject"),
                    "action": a.get("action"),
                    "subaction": a.get("subaction"),
                    "camera": str(a.get("camera")),
                    "frame": a.get("frame"),
                })
            group_map[fkey][str(a.get("camera"))] = len(records)
            records.append(rec)

        groups = [tuple(g[c] for c in CAMERA_IDS)
                  for g in group_map.values()
                  if all(c in g for c in CAMERA_IDS)]
        return records, cameras, groups

    def camera_for(self, rec: JointsRecord) -> Camera | None:
        return self.cameras.get(f"{rec.meta['subject']}:{rec.meta['camera']}")
