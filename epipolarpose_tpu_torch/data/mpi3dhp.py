"""MPI-INF-3DHP test set: the reader and the H36M -> 3DHP transfer
evaluation (PCK3D@150, AUC, MPJPE).

The port's copy of the JAX package's ``data/mpi3dhp.py``. The test-release
layout:

  <root>/TS{1..6}/annot_data.mat     valid_frame (F, 1), annot2 (F, 1, 17, 2)
      pixels, annot3 (F, 1, 17, 3) camera-frame mm (univ_annot3 unused)
  <root>/TS{n}/imageSequence/img_{frame:06d}.jpg

The release ships no intrinsics: (fx, fy, cx, cy) are fitted per sequence
by least squares of annot2 against annot3. 3DHP's 17-joint order:

  0 head_top 1 neck 2 rsho 3 relb 4 rwri 5 lsho 6 lelb 7 lwri
  8 rhip 9 rkne 10 rank 11 lhip 12 lkne 13 lank 14 pelv 15 spine 16 head

The transfer protocol evaluates an H36M-ordered model: ``evaluate`` maps
its predictions onto this order (``H36M_TO_3DHP``) and back-projects the
eval step's (x, y px, root-relative z mm) with the GT root depth before
the root-relative metrics. The frames are JPEGs, read by
``zipreader.imread``: the card's machine decodes them with the port's own
decoder.
"""

from __future__ import annotations

import glob
import itertools
import os

import numpy as np
import torch

from epipolarpose_tpu_torch.data.h36m import FLIP_PAIRS as FLIP_PAIRS_H36M
from epipolarpose_tpu_torch.data.joints_dataset import (JointsDataset,
                                                        JointsRecord)
from epipolarpose_tpu_torch.ops.metrics import auc3d, mpjpe, pck3d

# 3DHP[i] = H36M[H36M_TO_3DHP[i]]
H36M_TO_3DHP = (10, 8, 14, 15, 16, 11, 12, 13, 1, 2, 3, 4, 5, 6, 0, 7, 9)
ROOT_IDX = 14            # pelvis in 3DHP order
# left/right pairs in 3DHP order (for 3DHP-ordered models)
FLIP_PAIRS_3DHP = ((2, 5), (3, 6), (4, 7), (8, 11), (9, 12), (10, 13))
ANNOT_KEYS = ("valid_frame", "annot2", "annot3", "univ_annot3")


def _load_annot_mat(path: str) -> dict:
    """annot_data.mat -> dict of numpy arrays: MATLAB v5 through scipy,
    v7.3 (HDF5, column-major: transposed) through h5py. Both are imported
    here, only when a file is read."""
    from scipy.io import loadmat
    try:
        m = loadmat(path)
        return {k: np.asarray(v) for k, v in m.items()
                if not k.startswith("__")}
    except NotImplementedError:      # v7.3: scipy refuses it
        pass
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"{path} is a MATLAB v7.3 file: h5py reads v7.3 "
                          "files and is not installed") from e
    out = {}
    with h5py.File(path, "r") as f:
        for k in ANNOT_KEYS:
            if k in f:
                out[k] = np.asarray(f[k]).T
    return out


def _canon_annot(a: np.ndarray, k: int, num_joints: int = 17) -> np.ndarray:
    """An annot array in canonical (F, J, k) order, whatever its layout.

    The v5 release stores (F, 1, 17, k); a v7.3 file read through h5py
    comes out reversed, and re-exports carry other permutations. The
    joints axis (17) and the coordinate axis (k) move to the back; the
    frame axis is what remains. Shapes where F equals 17 or k keep the
    canonical reading, and among several matches the full reverse (the
    h5py layout) wins.
    """
    a = np.squeeze(np.asarray(a))
    if a.ndim == 2:                       # one frame (J, k)
        a = a[None]
    if a.ndim != 3:
        raise ValueError(f"annot array has shape {a.shape}, "
                         f"expected 3 non-singleton dims")
    if a.shape[-1] == k and a.shape[-2] == num_joints:
        return a
    matches = [perm for perm in itertools.permutations(range(3))
               if a.shape[perm[2]] == k and a.shape[perm[1]] == num_joints]
    if not matches:
        raise ValueError(f"cannot locate (J={num_joints}, k={k}) axes in "
                         f"annot array of shape {a.shape}")
    perm = (2, 1, 0) if (2, 1, 0) in matches else matches[0]
    return np.ascontiguousarray(a.transpose(perm))


def fit_pinhole_intrinsics(px: np.ndarray, cam3d: np.ndarray):
    """Least-squares (fx, fy, cx, cy) from pixel <-> camera-frame pairs:
    u = fx X/Z + cx and v = fy Y/Z + cy, solved apart. px (N, 2); cam3d
    (N, 3) with Z > 0."""
    xn = cam3d[:, 0] / cam3d[:, 2]
    yn = cam3d[:, 1] / cam3d[:, 2]
    Ax = np.stack([xn, np.ones_like(xn)], axis=1)
    Ay = np.stack([yn, np.ones_like(yn)], axis=1)
    fx, cx = np.linalg.lstsq(Ax, px[:, 0], rcond=None)[0]
    fy, cy = np.linalg.lstsq(Ay, px[:, 1], rcond=None)[0]
    return float(fx), float(fy), float(cx), float(cy)


class MPI3DHPDataset(JointsDataset):
    """Test-set reader for the H36M -> 3DHP transfer protocol."""

    flip_pairs = FLIP_PAIRS_H36M     # the model's outputs are H36M-ordered
    root_idx = ROOT_IDX
    perf_higher_is_better = True     # the indicator is PCK3D@150

    def __init__(self, cfg, root: str, image_set: str, is_train: bool,
                 **kwargs):
        self.root = root
        self.image_set = image_set
        records = []
        self.intrinsics = {}         # sequence -> (fx, fy, cx, cy)
        for seq_dir in sorted(glob.glob(os.path.join(root, "TS*"))):
            seq = os.path.basename(seq_dir)
            annot = _load_annot_mat(os.path.join(seq_dir, "annot_data.mat"))
            valid = np.asarray(annot["valid_frame"]).reshape(-1) > 0
            p2 = _canon_annot(annot["annot2"], 2).astype(np.float32)
            p3 = _canon_annot(annot["annot3"], 3).astype(np.float32)
            self.intrinsics[seq] = fit_pinhole_intrinsics(
                p2[valid].reshape(-1, 2), p3[valid].reshape(-1, 3))
            for f in np.flatnonzero(valid):
                joints = p2[f]
                center = 0.5 * (joints.min(0) + joints.max(0))
                extent = float((joints.max(0) - joints.min(0)).max() * 1.25
                               + 40)
                records.append(JointsRecord(
                    image=os.path.join(seq_dir, "imageSequence",
                                       f"img_{f + 1:06d}.jpg"),
                    center=center.astype(np.float32),
                    scale=np.array([extent / 200, extent / 200], np.float32),
                    joints=joints,
                    joints_vis=np.ones(17, np.float32),
                    joints_3d=p3[f],
                    meta={"seq": seq, "frame": int(f)}))
        super().__init__(cfg, records, is_train, **kwargs)

    def evaluate(self, cfg, preds, output_dir=None, **kwargs):
        """PCK3D@150 (the indicator), AUC and MPJPE.

        ``preds`` (N, J, 3) as the eval step gives them, (x, y) source
        pixels and root-relative z (mm), in the model's H36M joint order
        (mapped here); or 3DHP-ordered camera mm when
        ``DATASET.MAP_H36M_JOINTS`` is false.
        """
        preds = np.asarray(preds, np.float32)
        if bool(cfg.DATASET.get("MAP_H36M_JOINTS", True)) and \
                preds.shape[1] == 17:
            preds = preds[:, H36M_TO_3DHP]
        recs = self.records[:len(preds)]
        gts = np.stack([r.joints_3d for r in recs])

        # pixels -> camera mm with the GT root depth and fitted intrinsics
        cam_preds = np.empty_like(preds)
        for i, r in enumerate(recs):
            fx, fy, cx, cy = self.intrinsics[r.meta["seq"]]
            Z = preds[i, :, 2] + r.joints_3d[self.root_idx, 2]
            cam_preds[i, :, 0] = (preds[i, :, 0] - cx) / fx * Z
            cam_preds[i, :, 1] = (preds[i, :, 1] - cy) / fy * Z
            cam_preds[i, :, 2] = Z
        cam_preds -= cam_preds[:, self.root_idx:self.root_idx + 1]
        gts = gts - gts[:, self.root_idx:self.root_idx + 1]

        p, g = torch.from_numpy(cam_preds), torch.from_numpy(gts)
        name_value = {
            "PCK3D@150": float(pck3d(p, g, 150.0)),
            "AUC": float(auc3d(p, g, 150.0)),
            "MPJPE": float(mpjpe(p, g)),
        }
        return name_value, name_value["PCK3D@150"]


def _write_mat73(path: str, arrays: dict) -> None:
    """A MATLAB v7.3-style file: the HDF5 payload behind the 512-byte MAT
    header (version 0x0200) that makes ``scipy.io.loadmat`` raise
    NotImplementedError, as :func:`_load_annot_mat` expects of v7.3."""
    import h5py
    with h5py.File(path, "w", userblock_size=512) as f:
        for k, v in arrays.items():
            f[k] = v
    header = b"MATLAB 7.3 MAT-file, synthetic 3DHP fixture"
    header = header + b" " * (116 - len(header)) + b"\x00" * 8
    header += (0x0200).to_bytes(2, "little") + b"IM"
    with open(path, "r+b") as fh:
        fh.write(header)


def write_synthetic_3dhp(root: str, num_frames: int = 8, seed: int = 0,
                         with_images: bool = False,
                         fmt: str = "v5") -> None:
    """A 3DHP-format test tree (``annot_data.mat`` in TS1 and TS2, the last
    frame of each marked invalid): poses projected through a known pinhole,
    so the intrinsics fit and the back-projection invert exactly.

    ``fmt``: 'v5' (scipy, the release's (F, 1, 17, k)), 'v73' (HDF5
    stored reversed, as a MATLAB v7.3 export reads back) or 'v73_rowmajor'
    (HDF5 stored row-major: the reader's transpose yields a reversed
    array). ``with_images`` writes black 128x128 JPEGs with OpenCV."""
    from scipy.io import savemat
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = 1500.0, 1495.0, 1024.0, 1020.0
    for ts in (1, 2):
        seq_dir = os.path.join(root, f"TS{ts}")
        os.makedirs(os.path.join(seq_dir, "imageSequence"), exist_ok=True)
        p3 = rng.uniform(-400, 400, (num_frames, 1, 17, 3)).astype(
            np.float32)
        p3[..., 2] += 3500.0
        p2 = np.empty((num_frames, 1, 17, 2), np.float32)
        p2[..., 0] = fx * p3[..., 0] / p3[..., 2] + cx
        p2[..., 1] = fy * p3[..., 1] / p3[..., 2] + cy
        valid = np.ones((num_frames, 1), np.uint8)
        valid[-1] = 0
        arrays = {"valid_frame": valid, "annot2": p2, "annot3": p3,
                  "univ_annot3": p3}
        path = os.path.join(seq_dir, "annot_data.mat")
        if fmt == "v5":
            savemat(path, arrays)
        elif fmt == "v73":
            _write_mat73(path, {k: np.ascontiguousarray(v.T)
                                for k, v in arrays.items()})
        elif fmt == "v73_rowmajor":
            _write_mat73(path, arrays)
        else:
            raise ValueError(f"unknown fmt {fmt!r}")
        if with_images:
            import cv2
            for f in range(num_frames):
                img = np.zeros((128, 128, 3), np.uint8)
                cv2.imwrite(os.path.join(
                    seq_dir, "imageSequence", f"img_{f + 1:06d}.jpg"), img)
