"""Image reader for plain paths and ``archive.zip@/inner/path`` paths.

The port's copy of the JAX package's ``data/zipreader.py``: H36M images
ship as per-subject zips, read through a per-process handle cache.
:func:`imread` decodes every JPEG with the port's own decoder
(``data/jpeg.py``, the one the native loader includes), which needs
neither libjpeg nor OpenCV and gives libjpeg-turbo's bits, baseline and
progressive. OpenCV, imported only then, reads what is not a JPEG and the
JPEG modes the decoder refuses (arithmetic coding, 12-bit, CMYK, ...). A
JPEG that the decoder accepts never reaches OpenCV.
"""

from __future__ import annotations

import os
import threading
import zipfile

import numpy as np

from epipolarpose_tpu_torch.data import jpeg

_cache: dict[str, zipfile.ZipFile] = {}
_lock = threading.Lock()
JPEG_SUFFIXES = (".jpg", ".jpeg", ".JPG", ".JPEG")


def split_zip_path(path: str) -> tuple[str, str]:
    """'a.zip@/inner.jpg' -> ('a.zip', 'inner.jpg')."""
    if "@" not in path:
        raise ValueError(f"not a zip path: {path}")
    zip_path, inner = path.split("@", 1)
    return zip_path, inner.lstrip("/")


def is_zip_path(path: str) -> bool:
    return ".zip@" in path


def _handle(zip_path: str) -> zipfile.ZipFile:
    key = f"{os.getpid()}:{zip_path}"
    with _lock:
        zf = _cache.get(key)
        if zf is None:
            zf = zipfile.ZipFile(zip_path, "r")
            _cache[key] = zf
        return zf


def read_bytes(path: str) -> bytes:
    """The bytes of ``zip@/inner`` from the archive."""
    zip_path, inner = split_zip_path(path)
    return _handle(zip_path).read(inner)


def read_file_bytes(path: str) -> bytes:
    """Raw bytes from a plain path or a ``zip@/inner`` path."""
    if is_zip_path(path):
        return read_bytes(path)
    with open(path, "rb") as f:
        return f.read()


def imread(path: str, rgb: bool = False) -> np.ndarray:
    """(H, W, 3) uint8 image from a plain or ``zip@/inner`` path, BGR as
    OpenCV reads it unless ``rgb``. Raises IOError when the image cannot
    be read, and ImportError when it needs OpenCV (not a JPEG, or a JPEG
    mode the port's decoder refuses) and OpenCV is not installed."""
    buf = read_file_bytes(path)
    why = "not a JPEG"
    if path.endswith(JPEG_SUFFIXES):
        img = None
        try:
            if jpeg.available():
                img = jpeg.decode(buf)
            else:
                why = f"the port's decoder is not built ({jpeg.build_error()})"
        except jpeg.UnsupportedJpeg as e:
            why = f"the port's JPEG decoder refuses its mode, {e.mode}"
        except (ValueError, IOError) as e:
            raise IOError(f"failed to read image: {path}: {e}") from e
        if img is not None:
            return img if rgb else np.ascontiguousarray(img[..., ::-1])
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"cannot decode {path}: {why}, and OpenCV (cv2) "
                          "is not installed") from e
    img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"failed to read image: {path}")
    if rgb:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img
