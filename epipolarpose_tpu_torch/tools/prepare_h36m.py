"""Convert public H36M annotation releases into this port's schema.

    python -m epipolarpose_tpu_torch.tools.prepare_h36m --cameras-h5 metadata/cameras.h5 \
        --train-annot raw/train.json --valid-annot raw/valid.json \
        --out data/h36m/annot

Counterpart of the JAX package's ``tools/prepare_h36m.py``, writing the
same json bytes. Supported inputs:

- una-dinosauria/3d-pose-baseline style ``cameras.h5`` (per-subject,
  per-camera R, T, f, c, k, p) -> ``annot/cameras.json``; this route
  needs ``h5py``, imported when it runs;
- integral-human-pose / EpipolarPose style per-sample annotation lists
  (json or pickled list of dicts with image path, center, scale, 2D/3D
  joints, subject/action/camera ids) -> ``annot/{train,valid}.json``.

The output schema is the one ``data/h36m.py`` reads.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

from epipolarpose_tpu_torch.data.h36m import CAMERA_IDS


def _decode_camera_name(arr: np.ndarray) -> str:
    """Decode a cameras.h5 'Name' dataset by its dtype, not a fixed
    codec (ADVICE r2): MATLAB char exports come through as uint16
    (UTF-16-LE code units); ASCII/bytes exports as uint8 or bytes.
    Decoding uint8 data as utf-16-le yields garbage whose digits are
    stripped, silently mis-keying cameras by group order."""
    if arr.dtype.kind in ("S", "U"):                 # string datasets
        return "".join(np.char.decode(arr.astype("S"), "ascii").ravel()) \
            if arr.dtype.kind == "S" else "".join(arr.ravel())
    if arr.dtype == np.uint16:
        return arr.tobytes().decode("utf-16-le", "ignore")
    if arr.dtype == np.uint8:
        return arr.tobytes().decode("ascii", "ignore")
    # other numeric dtypes: re-exports (MATLAB/scipy) may store ASCII
    # char CODES as int16/int32/float — concatenating raw values there
    # would build a wrong-but-plausible digit string ('5','4' -> 53,52 ->
    # "5352...") that defeats the positional fallback. If every value
    # looks like a printable ASCII code, decode as characters; otherwise
    # treat the values as literal digits (e.g. a single int 54138969).
    vals = arr.ravel()
    if vals.size and np.all((vals >= 32) & (vals <= 126)
                            & (vals == np.floor(vals))):
        return "".join(chr(int(v)) for v in vals)
    return "".join(str(int(v)) for v in vals)


def convert_cameras_h5(path: str) -> dict:
    """una-dinosauria cameras.h5 -> {"<subject>:<camera_id>": {...}}.
    Needs ``h5py``; without it, raises an ImportError that names it."""
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(
            "--cameras-h5 needs h5py to read cameras.h5, and h5py is not "
            "installed; the annotation routes run without it") from exc
    out = {}
    with h5py.File(path, "r") as f:
        for subj_key in f.keys():              # e.g. 'subject1'
            if not subj_key.startswith("subject"):
                continue
            subject = int(subj_key.replace("subject", ""))
            for cam_key in f[subj_key].keys():  # 'camera1'..'camera4'
                cam_idx = int(cam_key.replace("camera", "")) - 1
                g = f[subj_key][cam_key]
                # the h5 (MATLAB export) capitalizes the dataset as 'Name'
                name_key = next((k for k in ("Name", "name") if k in g),
                                None)
                cam_id = _decode_camera_name(
                    np.array(g[name_key])) if name_key else ""
                cam_id = "".join(ch for ch in cam_id if ch.isdigit()) \
                    or CAMERA_IDS[cam_idx]
                # MATLAB h5 arrays are column-major: R must be TRANSPOSED
                # on read (3d-pose-baseline load_camera_params does R = R.T)
                # to be the row-major world->cam rotation our Camera
                # convention X_cam = R (X_world - T) expects
                R = np.array(g["R"]).reshape(3, 3).T
                out[f"{subject}:{cam_id}"] = {
                    "R": R.tolist(),
                    "T": np.array(g["T"]).reshape(3).tolist(),
                    "f": np.array(g["f"]).reshape(2).tolist(),
                    "c": np.array(g["c"]).reshape(2).tolist(),
                    "k": np.array(g["k"]).reshape(3).tolist(),
                    "p": np.array(g["p"]).reshape(2).tolist(),
                }
    return out


_FIELD_ALIASES = {
    "image": ("image", "img_path", "image_path", "file_name"),
    "center": ("center", "c", "objpos"),
    "scale": ("scale", "s"),
    "joints_2d": ("joints_2d", "joints", "joint_img", "keypoints_2d"),
    "joints_3d": ("joints_3d", "joint_cam", "S", "keypoints_3d"),
    "joints_vis": ("joints_vis", "joint_vis", "vis"),
    "subject": ("subject", "s_id", "subject_id"),
    "action": ("action", "act_id", "action_name"),
    "subaction": ("subaction", "subact_id"),
    "camera": ("camera", "cam_id", "cam"),
    "frame": ("frame", "image_id", "frame_id"),
}


def _get(d: dict, field: str, default=None):
    for k in _FIELD_ALIASES[field]:
        if k in d:
            return d[k]
    return default


def convert_annotations(path: str) -> list[dict]:
    """Per-sample annotation list (json/pkl) -> our schema."""
    if path.endswith((".pkl", ".pickle")):
        with open(path, "rb") as f:
            raw = pickle.load(f)
    else:
        with open(path) as f:
            raw = json.load(f)
    if isinstance(raw, dict):              # COCO-ish container
        raw = raw.get("annotations", raw.get("images", []))
    out = []
    for a in raw:
        j2 = np.asarray(_get(a, "joints_2d"), np.float64)
        if j2.ndim == 2 and j2.shape[1] > 2:
            j2 = j2[:, :2]
        rec = {
            "image": str(_get(a, "image")),
            "center": np.asarray(_get(a, "center"),
                                 np.float64).reshape(2).tolist(),
            "scale": (np.asarray(_get(a, "scale"), np.float64).reshape(-1)
                      [:2].tolist()
                      if np.ndim(_get(a, "scale")) else
                      [float(_get(a, "scale"))] * 2),
            "joints_2d": j2.tolist(),
            "subject": int(_get(a, "subject", 0) or 0),
            "action": str(_get(a, "action", "")),
            "subaction": int(_get(a, "subaction", 0) or 0),
            "camera": str(_get(a, "camera", "")),
            "frame": int(_get(a, "frame", 0) or 0),
        }
        j3 = _get(a, "joints_3d")
        if j3 is not None:
            rec["joints_3d"] = np.asarray(j3, np.float64)[:, :3].tolist()
        vis = _get(a, "joints_vis")
        if vis is not None:
            v = np.asarray(vis, np.float64)
            rec["joints_vis"] = (v[:, 0] if v.ndim == 2 else v).tolist()
        out.append(rec)
    return out


def main(argv=None) -> dict:
    """Convert what the arguments name; returns the written files' paths
    by name."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cameras-h5", default=None)
    p.add_argument("--train-annot", default=None)
    p.add_argument("--valid-annot", default=None)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    written = {}
    if args.cameras_h5:
        cams = convert_cameras_h5(args.cameras_h5)
        written["cameras.json"] = os.path.join(args.out, "cameras.json")
        with open(written["cameras.json"], "w") as f:
            json.dump(cams, f)
        print(f"wrote cameras.json ({len(cams)} cameras)")
    for split, src in (("train", args.train_annot),
                       ("valid", args.valid_annot)):
        if src:
            annots = convert_annotations(src)
            written[f"{split}.json"] = os.path.join(args.out,
                                                    f"{split}.json")
            with open(written[f"{split}.json"], "w") as f:
                json.dump(annots, f)
            print(f"wrote {split}.json ({len(annots)} samples)")
    return written


if __name__ == "__main__":
    main()
