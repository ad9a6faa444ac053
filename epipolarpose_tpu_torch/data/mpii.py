"""MPII: the annotation json reader and PCKh@0.5 evaluation.

The port's copy of the JAX package's ``data/mpii.py``: 16 joints,
``annot/{train,valid,test}.json`` with image, center, scale (200 px
units), joints and joints_vis; PCKh@0.5 against ``annot/gt_valid.mat``
when it exists for the valid split, else against the json annotations.

Joint order: 0 rank 1 rkne 2 rhip 3 lhip 4 lkne 5 lank 6 pelv 7 thrx
8 neck 9 head 10 rwri 11 relb 12 rsho 13 lsho 14 lelb 15 lwri.
"""

from __future__ import annotations

import json
import os

import numpy as np

from epipolarpose_tpu_torch.data.joints_dataset import (JointsDataset,
                                                        JointsRecord)

FLIP_PAIRS = ((0, 5), (1, 4), (2, 3), (10, 15), (11, 14), (12, 13))
# PCKh head segment: (head_top, upper_neck), as in the MPII toolkit
HEAD_PAIR = (9, 8)
SC_BIAS = 0.6   # the toolkit scales the head size by 0.6


class MPIIDataset(JointsDataset):
    flip_pairs = FLIP_PAIRS

    def __init__(self, cfg, root: str, image_set: str, is_train: bool,
                 **kwargs):
        self.root = root
        self.image_set = image_set
        records = self._load_records(cfg, root, image_set)
        super().__init__(cfg, records, is_train, **kwargs)

    def _load_records(self, cfg, root, image_set):
        annot_file = os.path.join(root, "annot", f"{image_set}.json")
        with open(annot_file) as f:
            annots = json.load(f)
        records = []
        for a in annots:
            c = np.array(a["center"], np.float32)
            s = np.array([a["scale"], a["scale"]], np.float32) \
                if np.isscalar(a["scale"]) else np.array(a["scale"],
                                                         np.float32)
            # the reference's centre and scale adjustment for tight crops
            if c[0] != -1:
                c[1] = c[1] + 15 * s[1]
                s = s * 1.25
            # MATLAB's 1-based indices: centre and joints move by -1
            c = c - 1
            joints = np.array(a.get("joints", np.ones((16, 2))), np.float32)
            joints = joints - 1
            vis = np.array(a.get("joints_vis", np.ones(16)), np.float32)
            records.append(JointsRecord(
                image=os.path.join(root, "images", a["image"]),
                center=c, scale=s, joints=joints, joints_vis=vis,
                meta={"name": a["image"]}))
        return records

    # ------------------------------------------------------------ evaluate
    def evaluate(self, cfg, preds, output_dir=None, **kwargs):
        """PCKh@0.5 of ``preds`` (N, J, 2) image coords: (name_values,
        mean). The toolkit's protocol against gt_valid.mat when it exists
        for the valid split, else the json annotations."""
        preds = np.asarray(preds)[..., :2]
        gt_file = os.path.join(self.root, "annot", "gt_valid.mat")
        if os.path.exists(gt_file) and self.image_set == "valid":
            return self._evaluate_mat(preds, gt_file)
        gts = np.stack([r.joints for r in self.records])[:len(preds)]
        vis = np.stack([r.joints_vis for r in self.records])[:len(preds)]
        heads = np.linalg.norm(
            gts[:, HEAD_PAIR[0]] - gts[:, HEAD_PAIR[1]], axis=-1) * SC_BIAS
        heads = np.maximum(heads, 1e-6)
        d = np.linalg.norm(preds - gts, axis=-1) / heads[:, None]
        valid = vis > 0
        per_joint = np.where(
            valid.sum(0) > 0,
            100.0 * ((d <= 0.5) & valid).sum(0) / np.maximum(valid.sum(0), 1),
            0.0)
        # the toolkit leaves pelvis (6) and thorax (7) out of the Mean
        mv = valid.copy()
        mv[:, 6:8] = False
        mean = 100.0 * ((d <= 0.5) & mv).sum() / max(mv.sum(), 1)
        mean01 = 100.0 * ((d <= 0.1) & mv).sum() / max(mv.sum(), 1)
        return self._name_value(per_joint, mean, mean01), mean

    def _evaluate_mat(self, preds, gt_file):
        """The toolkit's protocol against gt_valid.mat (scipy.io)."""
        from scipy.io import loadmat
        gt = loadmat(gt_file)
        jnt_missing = gt["jnt_missing"]                 # (J, N)
        pos_gt = gt["pos_gt_src"]                       # (J, 2, N)
        headbox = gt["headboxes_src"]                   # (2, 2, N)
        pred = preds.transpose(1, 2, 0)                 # (J, 2, N)
        jnt_vis = 1 - jnt_missing
        err = np.linalg.norm(pred - pos_gt, axis=1)     # (J, N)
        headsize = np.linalg.norm(headbox[1] - headbox[0], axis=0) * SC_BIAS
        scaled = err / headsize[None, :]
        below = (scaled <= 0.5) * jnt_vis
        per_joint = 100.0 * below.sum(1) / np.maximum(jnt_vis.sum(1), 1)
        keep = np.ones(below.shape[0], bool)
        keep[6:8] = False
        mean = 100.0 * below[keep].sum() / max(jnt_vis[keep].sum(), 1)
        below01 = (scaled <= 0.1) * jnt_vis
        mean01 = 100.0 * below01[keep].sum() / max(jnt_vis[keep].sum(), 1)
        return self._name_value(per_joint, mean, mean01), mean

    @staticmethod
    def _name_value(per_joint, mean, mean01=None):
        """The reference's per-joint table (with Mean@0.1)."""
        pj = np.asarray(per_joint, np.float64)
        out = {
            "Head": pj[9],
            "Shoulder": 0.5 * (pj[12] + pj[13]),
            "Elbow": 0.5 * (pj[11] + pj[14]),
            "Wrist": 0.5 * (pj[10] + pj[15]),
            "Hip": 0.5 * (pj[2] + pj[3]),
            "Knee": 0.5 * (pj[1] + pj[4]),
            "Ankle": 0.5 * (pj[0] + pj[5]),
            "Mean": float(mean),
        }
        if mean01 is not None:
            out["Mean@0.1"] = float(mean01)
        return out
