"""Debug images: joint overlays, heatmap strips and a 3D skeleton, as PNG.

Counterpart of the JAX package's ``utils/vis.py``. The card's machine has
no OpenCV, PIL or matplotlib, so everything is drawn in numpy and written
by a small PNG encoder (``zlib`` and ``struct``) and read back by the
port's PNG decoder (``data/png.py``): joints are filled discs,
bones are line segments, heatmaps take OpenCV's JET colours (within one
grey level of ``cv2.COLORMAP_JET``), and the 3D skeleton is an
orthographic two-panel drawing, front (x, -y) and side (z, -y). File
names keep the JAX stems with ``.png`` for ``.jpg``.
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np

from epipolarpose_tpu_torch.data import png
from epipolarpose_tpu_torch.data.imgproc import resize_bilinear_u8
from epipolarpose_tpu_torch.data.joints_dataset import (IMAGENET_MEAN,
                                                        IMAGENET_STD)

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _to_uint8(images) -> np.ndarray:
    """(N, H, W, 3) uint8, [0, 1] float, or ImageNet-normalized -> uint8.
    Any value below -1e-3 or above 1.5 marks a normalized batch."""
    if np.issubdtype(np.asarray(images).dtype, np.integer):
        return np.asarray(images, np.uint8)
    imgs = np.asarray(images, np.float32)
    if imgs.min() < -1e-3 or imgs.max() > 1.5:
        imgs = imgs * IMAGENET_STD + IMAGENET_MEAN
    return np.clip(imgs * 255.0, 0, 255).astype(np.uint8)


# ----------------------------------------------------------------- PNG
def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(file_name: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) or (H, W) uint8 image as an 8-bit RGB or grey
    PNG (no filtering, one IDAT chunk)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    color = 2 if img.ndim == 3 else 0
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, -1)], axis=1)
    data = (_PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
    with open(file_name, "wb") as f:
        f.write(data)


def read_png(file_name: str) -> np.ndarray:
    """Read a PNG with the port's PNG decoder (``data/png.py``), after
    checking the signature, IHDR and every chunk's CRC: (H, W, 3) RGB, or
    (H, W) for a grey PNG (what :func:`write_png` writes comes back as it
    was). Raises ValueError otherwise."""
    with open(file_name, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{file_name}: not a PNG signature")
    pos, header = 8, None
    while pos + 8 <= len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(crc) < 4 or struct.pack(
                ">I", zlib.crc32(kind + body) & 0xFFFFFFFF) != crc:
            raise ValueError(f"{file_name}: bad CRC in {kind!r}")
        if kind == b"IHDR" and n == 13:
            header = struct.unpack(">IIBBBBB", body)
        pos += 12 + n
    if header is None:
        raise ValueError(f"{file_name}: no IHDR")
    try:
        img, _ = png.decode(data)
    except IOError as e:
        raise ValueError(f"{file_name}: {e}") from e
    if img.shape[:2] != (header[1], header[0]):
        raise ValueError(f"{file_name}: IDAT does not hold "
                         f"{header[0]}x{header[1]} pixels")
    return img[..., 0].copy() if header[3] in (0, 4) else img


# ------------------------------------------------------------- drawing
def _disc(img: np.ndarray, x: float, y: float, radius: int, color) -> None:
    """Fill the pixels within ``radius`` of (x, y), in place."""
    h, w = img.shape[:2]
    cx, cy = int(x), int(y)
    y0, y1 = max(cy - radius, 0), min(cy + radius + 1, h)
    x0, x1 = max(cx - radius, 0), min(cx + radius + 1, w)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    mask = (yy - cy) ** 2 + (xx - cx) ** 2 <= radius * radius
    img[y0:y1, x0:x1][mask] = color


def _line(img: np.ndarray, p0, p1, color) -> None:
    """Draw the segment p0 -> p1 (pixel coords), one pixel wide."""
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
    xs = np.rint(np.linspace(p0[0], p1[0], n)).astype(int)
    ys = np.rint(np.linspace(p0[1], p1[1], n)).astype(int)
    ok = (xs >= 0) & (xs < img.shape[1]) & (ys >= 0) & (ys < img.shape[0])
    img[ys[ok], xs[ok]] = color


def jet_colors(values: np.ndarray) -> np.ndarray:
    """uint8 values -> (..., 3) RGB in OpenCV's JET colour table: a
    piecewise-linear ramp, blue to red."""
    i = np.asarray(values, np.int32)[..., None] * 4
    centre = np.array([765, 510, 255], np.int32)      # 255 * (3, 2, 1)
    top = np.array([383, 382, 383], np.int32)
    return np.clip(top - np.abs(i - centre), 0, 255).astype(np.uint8)


def save_batch_image_with_joints(batch_image, batch_joints,
                                 batch_joints_vis, file_name, nrow=8,
                                 padding=2):
    """A grid of the batch's (N, H, W, 3) images, ``nrow`` a row, with its
    visible joints (N, J, 2+) in crop pixels drawn as red discs."""
    imgs = _to_uint8(batch_image)
    N, H, W, _ = imgs.shape
    nrow = min(nrow, N)
    ncol = math.ceil(N / nrow)
    grid = np.zeros((ncol * (H + padding), nrow * (W + padding), 3),
                    np.uint8)
    joints = np.asarray(batch_joints)
    vis = np.asarray(batch_joints_vis).reshape(N, -1)
    for n in range(N):
        r, c = divmod(n, nrow)
        img = imgs[n].copy()
        for j, (x, y) in enumerate(joints[n][:, :2]):
            if vis[n][j] > 0 and 0 <= x < W and 0 <= y < H:
                _disc(img, x, y, 3, (255, 0, 0))
        grid[r * (H + padding):r * (H + padding) + H,
             c * (W + padding):c * (W + padding) + W] = img
    write_png(file_name, grid)


def save_batch_heatmaps(batch_image, batch_heatmaps, file_name,
                        normalize=True):
    """One row a sample: the image shrunk to the heatmap size, then each
    joint's heatmap in JET blended 0.7 over it. ``batch_heatmaps`` is
    (N, J, h, w), the port's NCHW layout."""
    imgs = _to_uint8(batch_image)
    hms = np.asarray(batch_heatmaps, np.float32)
    N, J, hh, hw = hms.shape
    out = np.zeros((N * hh, (J + 1) * hw, 3), np.uint8)
    for n in range(N):
        img_small = resize_bilinear_u8(imgs[n], (hw, hh))
        out[n * hh:(n + 1) * hh, :hw] = img_small
        for j in range(J):
            hm = hms[n, j]
            if normalize:
                mn, mx = hm.min(), hm.max()
                hm = (hm - mn) / (mx - mn + 1e-9)
            colored = jet_colors((hm * 255).astype(np.uint8))
            blend = (colored * 0.7 + img_small * 0.3).astype(np.uint8)
            out[n * hh:(n + 1) * hh, (j + 1) * hw:(j + 2) * hw] = blend
    write_png(file_name, out)


def save_debug_images(config, batch, target, output, preds, prefix):
    """The ``DEBUG.*`` dumps of a batch: ground-truth and predicted joints
    (``<prefix>_gt.png``, ``_pred.png``) and heatmaps (``_hm_gt.png``,
    ``_hm_pred.png``), each behind its flag; nothing without
    ``DEBUG.DEBUG``."""
    if not config.DEBUG.DEBUG:
        return
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    imgs = np.asarray(batch["input"])
    if config.DEBUG.SAVE_BATCH_IMAGES_GT:
        save_batch_image_with_joints(
            imgs, np.asarray(batch["joints"]),
            np.asarray(batch["joints_vis"]), f"{prefix}_gt.png")
    if config.DEBUG.SAVE_BATCH_IMAGES_PRED and preds is not None:
        save_batch_image_with_joints(
            imgs, np.asarray(preds),
            np.ones_like(np.asarray(batch["joints_vis"])),
            f"{prefix}_pred.png")
    if config.DEBUG.SAVE_HEATMAPS_GT and target is not None \
            and np.asarray(target).ndim == 4:
        save_batch_heatmaps(imgs, np.asarray(target), f"{prefix}_hm_gt.png")
    if config.DEBUG.SAVE_HEATMAPS_PRED and output is not None \
            and np.asarray(output).ndim == 4:
        save_batch_heatmaps(imgs, np.asarray(output, np.float32),
                            f"{prefix}_hm_pred.png")


# H36M 17-joint skeleton edges for 3D plots
H36M_EDGES = ((0, 1), (1, 2), (2, 3), (0, 4), (4, 5), (5, 6), (0, 7),
              (7, 8), (8, 9), (9, 10), (8, 11), (11, 12), (12, 13),
              (8, 14), (14, 15), (15, 16))


_PANEL, _MARGIN = 256, 16          # skeleton panel side and margin (px)


def plot_3d_skeleton(pose3d, file_name, edges=H36M_EDGES, title=""):
    """Draw a (J, 3) pose orthographically in two panels side by side,
    front (x right, y up) and side (z right, y up), on one scale that
    fits both; bones in blue, joints as discs. ``title`` is not drawn
    (there is no font); it is kept for the JAX signature."""
    del title
    panel, margin = _PANEL, _MARGIN
    pose = np.asarray(pose3d, np.float64)
    img = np.full((panel, 2 * panel, 3), 255, np.uint8)
    img[:, panel - 1:panel + 1] = 200
    views = ((pose[:, 0], -pose[:, 1]), (pose[:, 2], -pose[:, 1]))
    span = max(max(np.ptp(u), np.ptp(v)) for u, v in views)
    s = (panel - 2 * margin) / max(span, 1e-6)
    for k, (u, v) in enumerate(views):
        # centre each panel on its pose; image rows grow downwards
        px = (u - (u.min() + u.max()) / 2) * s + panel / 2 + k * panel
        py = panel / 2 - (v - (v.min() + v.max()) / 2) * s
        for a, b in edges:
            if a < len(pose) and b < len(pose):
                _line(img, (px[a], py[a]), (px[b], py[b]), (0, 0, 255))
        for x, y in zip(px, py):
            _disc(img, x, y, 2, (0, 0, 255))
    write_png(file_name, img)
