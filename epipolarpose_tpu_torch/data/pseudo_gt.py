"""Offline pseudo-GT merge: triangulated 3D joints into an annot json.

The port's copy of the JAX package's ``data/pseudo_gt.py``. The
reference's self-supervised workflow is offline and in two stages: the
frozen 2D teacher and the triangulation label the train set
(``scripts/generate_pseudo_gt.py``), then the 3D student trains on those
labels as under full supervision. This module is the second half: it
writes the generated ``joints_3d`` into an annot json, so that the H36M
reader trains from pseudo-GT unchanged.
"""

from __future__ import annotations

import json


def merge_pseudo_gt_into_annot(annot_path: str, pseudo_path: str,
                               out_path: str,
                               conf_min: float = 0.0) -> int:
    """Write ``out_path``: the annot json with ``joints_3d`` replaced by the
    pseudo-GT of ``pseudo_path`` (keyed by record index). Records without
    pseudo-GT, or whose smallest teacher confidence is under ``conf_min``,
    keep their labels (or none). Returns how many records got pseudo-GT.
    """
    with open(annot_path) as f:
        annots = json.load(f)
    with open(pseudo_path) as f:
        pseudo = json.load(f)
    merged = 0
    for key, rec in pseudo.items():
        i = int(key)
        if i >= len(annots):
            continue
        if (rec.get("conf") is not None and conf_min > 0.0
                and min(rec["conf"]) < conf_min):
            continue
        annots[i]["joints_3d"] = rec["joints_3d"]
        merged += 1
    with open(out_path, "w") as f:
        json.dump(annots, f)
    return merged
