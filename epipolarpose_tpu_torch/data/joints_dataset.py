"""Base joints dataset: host decode and augmentation into numpy batches.

The port's copy of the JAX package's ``data/joints_dataset.py``. The host
side stays thin: decode, the augmentation parameters (scale
``±SCALE_FACTOR``, rotation ``±ROT_FACTOR`` behind the reference's 60%
gate, horizontal flip), the crop warp to ``IMAGE_SIZE`` and the joints'
transform. Normalization and targets happen in the step, on the card.

Batches are dicts of numpy arrays with static shapes, built by a thread
pool. The crop warp is :func:`imgproc.warp_affine_u8` (OpenCV's bilinear
``warpAffine`` in numpy), so no path of the loader needs OpenCV. Each
record's augmentation draws from ``np.random.default_rng(seed * 1_000_003
+ index)``, so a record gets the same crop whatever batch or process
decodes it, and the same one as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np

from epipolarpose_tpu_torch.data import fastloader
from epipolarpose_tpu_torch.data.imgproc import warp_affine_u8
from epipolarpose_tpu_torch.data.zipreader import (JPEG_SUFFIXES, imread,
                                                   read_file_bytes)
from epipolarpose_tpu_torch.geometry.affine import get_affine_transform_np

# ImageNet mean/std, the reference's torchvision Normalize constants
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

logger = logging.getLogger(__name__)


def host_shard_indices(idx: np.ndarray, process_index: int,
                       process_count: int) -> np.ndarray:
    """This process's contiguous slice of a global batch's record
    indices (each of P processes decodes 1/P of every global batch).
    Under a model axis ``process_index``/``process_count`` are the data
    axis's (``parallel.data_index``/``data_count``): the processes of a
    model group decode the same slice and split its rows."""
    idx = np.asarray(idx)
    n = len(idx)
    if n % process_count:
        raise ValueError(f"global batch {n} not divisible by "
                         f"{process_count} processes")
    per = n // process_count
    return idx[process_index * per:(process_index + 1) * per]


def record_seed(seed: int, index: int) -> int:
    """The augmentation seed of record ``index`` in a batch seeded
    ``seed``: keyed on the record, not its place in the batch."""
    return seed * 1_000_003 + int(index)


def flip_permutation(flip_pairs, num_joints: int) -> list[int]:
    """Joint order after a horizontal flip: each pair swapped."""
    perm = list(range(num_joints))
    for a, b in flip_pairs:
        if a < num_joints and b < num_joints:
            perm[a], perm[b] = perm[b], perm[a]
    return perm


def _distributed_world() -> int:
    """Processes in the default torch.distributed group (1 without one)."""
    import torch.distributed as dist
    return dist.get_world_size() if (dist.is_available()
                                     and dist.is_initialized()) else 1


@dataclasses.dataclass
class JointsRecord:
    """One sample: image reference, person box and annotated joints."""

    image: str                       # path or zip@/inner path
    center: np.ndarray               # (2,)
    scale: np.ndarray                # (2,) in 200 px units
    joints: np.ndarray               # (J, 2) image pixels
    joints_vis: np.ndarray           # (J,)
    joints_3d: np.ndarray | None = None   # (J, 3) camera/world frame (mm)
    meta: dict | None = None


class JointsDataset:
    """Batched host pipeline over a list of :class:`JointsRecord`."""

    flip_pairs: Sequence[tuple[int, int]] = ()
    parent_ids: Sequence[int] = ()
    # direction of evaluate()'s indicator: PCKh is higher-is-better;
    # MPJPE datasets set False
    perf_higher_is_better: bool = True

    def __init__(self, cfg, records: list[JointsRecord], is_train: bool,
                 workers: int | None = None):
        self.cfg = cfg
        self.records = records
        self.is_train = is_train
        self.image_size = tuple(int(v) for v in cfg.MODEL.IMAGE_SIZE)
        self.num_joints = int(cfg.MODEL.NUM_JOINTS)
        self.scale_factor = float(cfg.DATASET.SCALE_FACTOR)
        self.rot_factor = float(cfg.DATASET.ROT_FACTOR)
        self.flip = bool(cfg.DATASET.FLIP)
        self.pool = ThreadPoolExecutor(
            max_workers=workers or int(cfg.WORKERS) or 1)

    def __len__(self) -> int:
        return len(self.records)

    # picklable: the thread pool is per-process state, rebuilt after
    # unpickling
    def __getstate__(self):
        state = self.__dict__.copy()
        state["pool"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        if self.pool is None:
            self.pool = ThreadPoolExecutor(
                max_workers=int(self.cfg.WORKERS) or 1)

    # -------------------------------------------------------------- loading
    def _read_image(self, path: str) -> np.ndarray:
        return imread(path, rgb=True)

    def _augment_params(self, rng: np.random.Generator):
        """(scale_mult, rot, do_flip) with the reference's semantics:
        s *= clip(N(1, sf), 1-sf, 1+sf); r = clip(N(0, 2rf), -2rf, 2rf)
        with probability 0.6, else 0; flip with probability 0.5."""
        sf, rf = self.scale_factor, self.rot_factor
        s_mult = float(np.clip(rng.normal(1.0, sf), 1 - sf, 1 + sf))
        rot = float(np.clip(rng.normal(0.0, 2 * rf), -2 * rf, 2 * rf)) \
            if rng.uniform() <= 0.6 else 0.0
        do_flip = self.flip and rng.uniform() <= 0.5
        return s_mult, rot, do_flip

    def _load_one(self, idx: int, seed: int, img: np.ndarray | None = None):
        """One record's crop and labels; ``img`` is its image when the
        caller has read it already."""
        rec = self.records[idx]
        # the warp reads uint8 and writes a uint8 crop: the full image is
        # never converted to float
        if img is None:
            img = self._read_image(rec.image)
        joints = rec.joints.copy().astype(np.float32)
        vis = rec.joints_vis.copy().astype(np.float32)
        center = rec.center.astype(np.float32).copy()
        scale = rec.scale.astype(np.float32).copy()
        rot = 0.0

        if self.is_train:
            rng = np.random.default_rng(seed)
            s_mult, rot, do_flip = self._augment_params(rng)
            scale = scale * s_mult
            if do_flip:
                img = np.ascontiguousarray(img[:, ::-1])
                joints[:, 0] = img.shape[1] - 1 - joints[:, 0]
                perm = flip_permutation(self.flip_pairs, self.num_joints)
                joints = joints[perm]
                vis = vis[perm]
                center[0] = img.shape[1] - center[0] - 1

        M = get_affine_transform_np(center, scale, rot, self.image_size)
        crop = warp_affine_u8(img, M, self.image_size)
        joints_crop = joints @ M[:, :2].T + M[:, 2]
        out = dict(
            input=crop, joints=joints_crop.astype(np.float32),
            joints_vis=vis, center=center, scale=scale,
            rotation=np.float32(rot), index=np.int64(idx))
        if rec.joints_3d is not None:
            out["joints_3d"] = rec.joints_3d.astype(np.float32)
        return out

    def get_batch(self, indices: Sequence[int], seed: int = 0) -> dict:
        """Decode and augment ``indices`` in parallel; stack into one dict.

        When every record is a JPEG on disk or in a zip and the native
        loader is built, the batch may go through one native decode +
        warp call (``TPU.NATIVE_LOADER``; its flip is applied in crop
        space). Otherwise the thread pool runs :meth:`_load_one`.
        """
        batch = None
        if self._use_native(indices, seed):
            batch = self._get_batch_native(indices, seed)
        if batch is None:
            batch = self._get_batch_pool(indices, seed)
        if self.records[indices[0]].joints_3d is not None:
            batch["joints_3d"] = np.stack(
                [self.records[i].joints_3d for i in indices]).astype(
                    np.float32)
        return batch

    def _get_batch_pool(self, indices, seed: int) -> dict:
        outs = list(self.pool.map(
            lambda i: self._load_one(i, record_seed(seed, i)), indices))
        return {k: np.stack([o[k] for o in outs]) for k in outs[0]}

    def _native_eligible(self, indices) -> bool:
        for i in indices:
            img = self.records[i].image
            if img.startswith("synthetic://") or not img.endswith(
                    JPEG_SUFFIXES):
                return False
        return fastloader.available()

    # the native path must beat the pool by this relative margin to be
    # chosen (a tie keeps the simpler pool path)
    CALIBRATION_MARGIN = 0.2
    CALIBRATION_REPS = 3

    @staticmethod
    def decide_native(native_times, pool_times,
                      margin: float = CALIBRATION_MARGIN) -> dict:
        """The calibration's decision from repeated timings of both paths:
        native only when its median beats the pool's by more than
        ``margin``. Returns the decision and its evidence."""
        t_native = float(np.median(native_times))
        t_pool = float(np.median(pool_times))
        use_native = t_native < t_pool * (1.0 - margin)
        return {
            "use_native": bool(use_native),
            "t_native_median_s": t_native,
            "t_pool_median_s": t_pool,
            "native_advantage": (t_pool - t_native) / t_pool
            if t_pool > 0 else 0.0,
            "margin_required": margin,
            "reps": (list(map(float, native_times)),
                     list(map(float, pool_times))),
        }

    def _use_native(self, indices, seed: int) -> bool:
        """The batch path. ``TPU.NATIVE_LOADER``: True / False / 'auto'.

        'auto' times both paths on the first eligible batch,
        ``CALIBRATION_REPS`` times each, and keeps the winner (the decision
        is in ``self.calibration``). Under torch.distributed with more
        than one process the rule is fixed instead (native when eligible),
        so every process takes the same path."""
        flag = getattr(self.cfg.TPU, "NATIVE_LOADER", "auto")
        if flag is False or not self._native_eligible(indices):
            return False
        if flag is True or _distributed_world() > 1:
            return True
        if getattr(self, "calibration", None) is None:
            probe = list(indices)
            tn, tp = [], []
            # interleaved, so drifting host load hits both paths
            for _ in range(self.CALIBRATION_REPS):
                t0 = time.perf_counter()
                self._get_batch_native(probe, seed)
                tn.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                self._get_batch_pool(probe, seed)
                tp.append(time.perf_counter() - t0)
            self.calibration = self.decide_native(tn, tp)
            self.calibration["batch_size"] = len(probe)
            c = self.calibration
            logger.info(
                "loader calibration (bs=%d, %d reps): native median "
                "%.3fs vs pool %.3fs (advantage %+.1f%%, need >%.0f%%)"
                " -> %s", len(probe), self.CALIBRATION_REPS,
                c["t_native_median_s"], c["t_pool_median_s"],
                100 * c["native_advantage"], 100 * c["margin_required"],
                "native" if c["use_native"] else "pool")
        return self.calibration["use_native"]

    def _get_batch_native(self, indices, seed: int):
        if not self._native_eligible(indices):
            return None
        recs = [self.records[i] for i in indices]
        bufs = list(self.pool.map(lambda r: read_file_bytes(r.image), recs))

        n = len(recs)
        centers = np.stack([r.center for r in recs]).astype(np.float32)
        scales = np.stack([r.scale for r in recs]).astype(np.float32)
        joints = np.stack([r.joints for r in recs]).astype(np.float32)
        vis = np.stack([r.joints_vis for r in recs]).astype(np.float32)
        rots = np.zeros(n, np.float32)
        flips = np.zeros(n, bool)
        if self.is_train:
            for k, i in enumerate(indices):
                rng = np.random.default_rng(record_seed(seed, i))
                s_mult, rot, do_flip = self._augment_params(rng)
                scales[k] *= s_mult
                rots[k] = rot
                flips[k] = do_flip

        M = get_affine_transform_np(centers, scales, rots, self.image_size)
        crops = fastloader.decode_warp_batch(bufs, M, self.image_size)
        joints_crop = np.einsum("nij,nkj->nki", M[:, :, :2], joints) \
            + M[:, None, :, 2]

        if flips.any():
            W = self.image_size[0]
            perm = flip_permutation(self.flip_pairs, self.num_joints)
            fidx = np.where(flips)[0]
            crops[fidx] = crops[fidx, :, ::-1]
            joints_crop[fidx, :, 0] = W - 1 - joints_crop[fidx, :, 0]
            joints_crop[fidx] = joints_crop[fidx][:, perm]
            vis[fidx] = vis[fidx][:, perm]

        return dict(input=crops, joints=joints_crop.astype(np.float32),
                    joints_vis=vis, center=centers, scale=scales,
                    rotation=rots, index=np.asarray(indices, np.int64))

    # ------------------------------------------------------------- epochs
    def batches(self, batch_size: int, seed: int = 0,
                shuffle: bool | None = None, drop_last: bool = True,
                process_index: int = 0, process_count: int = 1):
        """Yield the batches of one epoch (static shapes: a training
        remainder is dropped, an eval remainder padded with its last
        record). ``batch_size`` is global; with ``process_count`` > 1 each
        process (each data group, under a model axis) decodes its
        contiguous slice of every batch (:func:`host_shard_indices`), in
        the same seeded order."""
        n = len(self.records)
        order = np.arange(n)
        if shuffle if shuffle is not None else self.is_train:
            np.random.default_rng(seed).shuffle(order)
        stop = n - (n % batch_size) if drop_last else n
        for i in range(0, stop, batch_size):
            idx = order[i:i + batch_size]
            if len(idx) < batch_size:            # pad the eval remainder
                idx = np.concatenate(
                    [idx, np.full(batch_size - len(idx), idx[-1])])
            if process_count > 1:
                idx = host_shard_indices(idx, process_index, process_count)
            yield self.get_batch(idx.tolist(), seed=seed + i)

    def evaluate(self, cfg, preds, output_dir=None, **kwargs):
        raise NotImplementedError
