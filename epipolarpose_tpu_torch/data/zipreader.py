"""Image reader for plain paths and ``archive.zip@/inner/path`` paths.

The port's copy of the JAX package's ``data/zipreader.py``: H36M images
ship as per-subject zips, read through a per-process handle cache.
:func:`imread` gives what the JAX package's imread (OpenCV's
``IMREAD_COLOR``) gives, with the port's own decoders, which need neither
OpenCV nor libjpeg nor libpng; it picks the decoder by the file's first
bytes, as OpenCV does (``imgformats.sniff``), not by its name:

- JPEG with ``data/jpeg.py`` (the decoder the native loader includes):
  baseline, progressive, arithmetic coding and lossless, every sampling,
  CMYK and YCCK converted as OpenCV converts them, block smoothing as
  OpenCV's libjpeg-turbo does it, and a truncated file read as OpenCV
  reads it (decoded as libjpeg fills it from a plain path, refused from a
  zip member); the modes OpenCV 5 gives no image of (hierarchical,
  12-bit, lossless of over 8 bits or in another colour space than RGB
  and CMYK) raise IOError here too;
- PNG with ``data/png.py``; PNM (P1-P6) and BMP with
  ``data/imgformats.py``; TIFF with ``data/tiff.py``;

each with the orientation applied where OpenCV applies it (JPEG's
APP1, PNG's eXIf, TIFF's Orientation tag). OpenCV, imported only then,
reads every other format and the few files of these the port leaves to
it (animated PNGs whose first frame is not their default image, or that
are damaged; TIFFs of CCITT or old-style JPEG compression, uncompressed
YCbCr, CMYK and the like, or damaged inside a Deflate or JPEG stream);
a file the port's decoders take never reaches OpenCV.
"""

from __future__ import annotations

import os
import threading
import zipfile

import numpy as np

from epipolarpose_tpu_torch.data import imgformats, jpeg, png, tiff
from epipolarpose_tpu_torch.data.imgformats import tiff_orientation

_cache: dict[str, zipfile.ZipFile] = {}
_lock = threading.Lock()
_routes = dict.fromkeys(("jpeg", "png", "pnm", "bmp", "tiff", "opencv"), 0)
# the names the native loader takes for JPEGs (joints_dataset.py), as the
# JAX package's loader does
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


def exif_orientation(buf: bytes) -> int:
    """The EXIF orientation (1-8) of a JPEG as OpenCV reads it: the
    first APP1 segment before the first scan whose payload starts with
    ``Exif\\0\\0``, its TIFF header in either byte order, and the first
    entry of tag 0x0112 in IFD0, whose 16-bit value sits at the entry's
    offset 8 whatever its type; 1 when any of that is missing, cut short
    or out of 1-8."""
    pos, n = 2, len(buf)
    while pos < n:
        while pos < n and buf[pos] != 0xFF:             # bytes before a marker
            pos += 1
        while pos < n and buf[pos] == 0xFF:
            pos += 1
        if pos >= n:
            return 1
        marker = buf[pos]
        pos += 1
        if marker in (0xD9, 0xDA):                      # EOI, SOS
            return 1
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:    # no length
            continue
        if pos + 2 > n:
            return 1
        length = int.from_bytes(buf[pos:pos + 2], "big")
        payload = buf[pos + 2:pos + length]
        pos += length
        if marker == 0xE1 and payload[:6] == b"Exif\0\0":
            return tiff_orientation(payload[6:])
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """``img`` turned upright for its EXIF ``orientation``, as OpenCV's
    ApplyExifOrientation does: 2-4 flip (horizontally, both ways,
    vertically), 5-8 transpose and then flip none, horizontally, both ways
    and vertically."""
    if orientation >= 5:
        img = img.transpose(1, 0, *range(2, img.ndim))
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    for axis in flips.get(orientation, ()):
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


def route_counts() -> dict:
    """The images :func:`imread` decoded since the last
    :func:`reset_route_counts`, by decoder: ``jpeg``, ``png``, ``pnm``,
    ``bmp``, ``tiff`` (the port's) and ``opencv``."""
    with _lock:
        return dict(_routes)


def reset_route_counts() -> None:
    with _lock:
        for k in _routes:
            _routes[k] = 0


def _count(route: str) -> None:
    with _lock:
        _routes[route] += 1


def _decode_jpeg(buf: bytes, path: str) -> tuple[np.ndarray | None, str]:
    """The port's JPEG decode (RGB, upright) or, where OpenCV must read
    the file, (None, why)."""
    if not jpeg.available():
        return None, f"the port's JPEG decoder is not built " \
                     f"({jpeg.build_error()})"
    try:
        img = jpeg.decode(buf, flavour="opencv")
    except jpeg.JpegWarning as e:
        # OpenCV reads what libjpeg warns about, but from memory (a zip
        # member) not a file whose data ends before EOI
        if e.ended and is_zip_path(path):
            raise IOError(f"failed to read image: {path}: {e}") from e
        img = e.image
    except (ValueError, IOError) as e:
        # UnsupportedJpeg among them: the modes OpenCV reads none of
        raise IOError(f"failed to read image: {path}: {e}") from e
    return apply_orientation(img, exif_orientation(buf)), ""


def _decode_port(kind: str, buf: bytes,
                 path: str) -> tuple[np.ndarray | None, str]:
    """The port's decode of a file ``sniff`` named: (RGB image, upright,
    "") or (None, why OpenCV must read it)."""
    if kind == "jpeg":
        return _decode_jpeg(buf, path)
    if kind in ("png", "tiff") and not png.available():
        return None, f"the port's {kind.upper()} decoder is not built " \
                     f"({png.build_error()})"
    try:
        if kind == "png":
            img, orientation = png.decode(buf, not is_zip_path(path))
            return apply_orientation(img, orientation), ""
        if kind == "tiff":
            img, orientation = tiff.decode(buf, not is_zip_path(path))
            return apply_orientation(img, orientation), ""
        if kind == "pnm":
            return imgformats.decode_pnm(buf), ""
        return imgformats.decode_bmp(buf), ""
    except imgformats.NeedsOpenCV as e:
        return None, e.what
    except imgformats.ImageTooLarge:
        raise
    except (ValueError, IOError) as e:
        raise IOError(f"failed to read image: {path}: {e}") from e


def imread(path: str, rgb: bool = False) -> np.ndarray:
    """(H, W, 3) uint8 image from a plain or ``zip@/inner`` path, BGR as
    OpenCV reads it unless ``rgb``, turned upright by its EXIF orientation.
    The decoder is chosen by the file's first bytes, as OpenCV chooses it
    (:func:`imgformats.sniff`), not by its name: JPEG, PNG, PNM, BMP and
    TIFF are the port's own, and give OpenCV's pixels; anything else, and
    the few files of those formats the port leaves to OpenCV (some
    animated PNGs, some TIFFs), goes to OpenCV.
    Raises IOError when the image cannot be read, where OpenCV gives no
    image (among them a zip member whose JPEG data ends before its EOI
    marker: OpenCV decodes such a file from a path, as libjpeg fills it,
    but not from memory); :class:`imgformats.ImageTooLarge`, an IOError,
    over OpenCV's size limits, where OpenCV raises; and ImportError when
    the file needs OpenCV and OpenCV is not installed, naming what the
    file is."""
    buf = read_file_bytes(path)
    kind = imgformats.sniff(buf)
    if kind is not None:
        img, why = _decode_port(kind, buf, path)
        if img is not None:
            _count(kind)
            return img if rgb else np.ascontiguousarray(img[..., ::-1])
    else:
        why = imgformats.format_name(buf)
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"cannot decode {path}: {why}, which only "
                          "OpenCV reads here, and OpenCV (cv2) is not "
                          "installed") from e
    # as the JAX package reads: from memory for a zip member, else the
    # file (OpenCV shows an APNG's default image from one, not the other)
    if is_zip_path(path):
        img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    else:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"failed to read image: {path}")
    _count("opencv")
    if rgb:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img
