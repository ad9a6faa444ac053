"""Image reader for plain paths and ``archive.zip@/inner/path`` paths.

The port's copy of the JAX package's ``data/zipreader.py``: H36M images
ship as per-subject zips, read through a per-process handle cache.
:func:`imread` gives what the JAX package's imread (OpenCV's
``IMREAD_COLOR``) gives, and decodes every JPEG with the port's own
decoder (``data/jpeg.py``, the one the native loader includes), which
needs neither libjpeg nor OpenCV: baseline, progressive and arithmetic
coding, every sampling, CMYK and YCCK converted as OpenCV converts them,
block smoothing as OpenCV's libjpeg-turbo does it, the EXIF orientation
applied as OpenCV applies it, and a truncated file read as OpenCV reads
it (decoded as libjpeg fills it from a plain path, refused from a zip
member). OpenCV, imported only then, reads what is not a JPEG and the
three JPEG modes the decoder refuses (lossless, hierarchical, 12-bit). A
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
            return _tiff_orientation(payload[6:])
    return 1


def _tiff_orientation(t: bytes) -> int:
    order = {b"II": "little", b"MM": "big"}.get(t[:2])
    if order is None or len(t) < 8:
        return 1

    def u(at: int, size: int) -> int | None:
        if at + size > len(t):
            return None
        return int.from_bytes(t[at:at + size], order)
    if u(2, 2) != 42:
        return 1
    ifd = u(4, 4)
    count = u(ifd, 2)
    for i in range(count or 0):
        entry = ifd + 2 + 12 * i
        tag = u(entry, 2)
        if tag is None:
            break
        if tag == 0x0112:
            value = u(entry + 8, 2)
            return value if value is not None and 1 <= value <= 8 else 1
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


def imread(path: str, rgb: bool = False) -> np.ndarray:
    """(H, W, 3) uint8 image from a plain or ``zip@/inner`` path, BGR as
    OpenCV reads it unless ``rgb``, turned upright by its EXIF orientation.
    Raises IOError when the image cannot be read (among them a zip
    member whose JPEG data ends before its EOI marker: OpenCV decodes such
    a file from a path, as libjpeg fills it, but not from memory), and
    ImportError when it needs OpenCV (not a JPEG, or a lossless,
    hierarchical or 12-bit JPEG) and OpenCV is not installed."""
    buf = read_file_bytes(path)
    why = "not a JPEG"
    if path.endswith(JPEG_SUFFIXES):
        img = None
        try:
            if jpeg.available():
                img = jpeg.decode(buf, flavour="opencv")
            else:
                why = f"the port's decoder is not built ({jpeg.build_error()})"
        except jpeg.JpegWarning as e:
            # OpenCV reads what libjpeg warns about, but from memory (a
            # zip member) not a file whose data ends before EOI
            if e.ended and is_zip_path(path):
                raise IOError(f"failed to read image: {path}: {e}") from e
            img = e.image
        except jpeg.UnsupportedJpeg as e:
            why = f"the port's JPEG decoder refuses its mode, {e.mode}"
        except (ValueError, IOError) as e:
            raise IOError(f"failed to read image: {path}: {e}") from e
        if img is not None:
            img = apply_orientation(img, exif_orientation(buf))
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
