"""The port's JPEG decoder (``native/jpegdec.cpp``) via ctypes.

It needs neither libjpeg nor OpenCV, only ``g++``: the card's machine has
neither ``jpeglib.h`` nor OpenCV. Its RGB output equals libjpeg-turbo's
default decode bit for bit (what ``cv2.imdecode`` and the JAX package's
native loader give), baseline, progressive and arithmetic-coded, grey,
YCbCr, RGB, CMYK and YCCK (these two converted as OpenCV converts them),
at full size and at libjpeg's DCT-scaled sizes ``scale_num``/8 for
``scale_num`` 1-4 and 8. Progressive files whose coefficients stay
unfinished are block-smoothed as libjpeg-turbo 2.1 (``flavour="libjpeg"``,
the JAX package's native loader) or OpenCV's libjpeg-turbo 3.1
(``"opencv"``, the JAX package's imread) smooths them. OpenCV's flavour
also decodes lossless files (SOF3, Huffman-coded) as OpenCV 5 reads them:
2-8 bits, predictors 1-7, point transform, restarts, RGB and CMYK. A file
libjpeg decodes with a warning (a truncated file, a lost restart marker)
raises :class:`JpegWarning`, which holds libjpeg's decode. It refuses
with :class:`UnsupportedJpeg`, which names the mode, lossless files in the
libjpeg flavour and hierarchical and 12-bit files in both, as
libjpeg-turbo 2.1 refuses them and OpenCV's imread gives no image of them
(nor of lossless files of other precisions or colour spaces, which the
OpenCV flavour refuses too); data it cannot decode raises ``IOError``.

The library is built as the native loader's is (``data/cxx_library.py``):
one ``g++`` call, no ``-march`` and no ``-ljpeg``, into
``epipolarpose_tpu_torch/_build/jpegdec-<key>/``. A ctypes call releases
the interpreter lock, so the datasets' thread pool decodes in parallel.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import numpy as np

from epipolarpose_tpu_torch.data.cxx_library import CxxLibrary

PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR / "native" / "jpegdec.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
STATUS_UNSUPPORTED = 2
# decoded, where libjpeg warns; STATUS_ENDED: the data ended before its EOI
STATUS_WARNED, STATUS_ENDED = 4, 5
# whose decode: libjpeg-turbo 2.1 as the JAX package's native loader calls
# it, or OpenCV's imread (its bundled libjpeg-turbo 3.1): the block
# smoothing of progressive files with unfinished coefficients differs, and
# OpenCV keeps a one-scan image whose file goes wrong after that scan
# OpenCV keeps a one-scan image whose file goes wrong after that scan,
# and decodes lossless files. The TIFF flavours decode as OpenCV's libtiff
# has libjpeg decode a TIFF's JPEG strips: "tiff_ycbcr" converts YCbCr to
# RGB whatever the markers say, "tiff_raw" gives the samples as coded.
FLAVOURS = {"libjpeg": 0, "opencv": 1, "tiff_ycbcr": 2, "tiff_raw": 3}
ERR_LEN = 256

_i = ctypes.c_int
_pi = ctypes.POINTER(ctypes.c_int)
SIGNATURES = {
    "epk_jpeg_info": (_i, (ctypes.c_char_p, ctypes.c_size_t, _i, _pi, _pi,
                           _pi, _i, ctypes.c_char_p, _i)),
    "epk_jpeg_decode_rgb": (_i, (ctypes.c_char_p, ctypes.c_size_t, _i,
                                 ctypes.c_void_p, _i, _i, _i,
                                 ctypes.c_char_p, _i)),
}
_LIB = CxxLibrary("jpegdec", SOURCE, CXX_FLAGS, (), SIGNATURES,
                  "JPEG decoder")
_count_lock = threading.Lock()
# decodes since the last reset_count() (read by the smoke run)
_count = 0


class UnsupportedJpeg(IOError):
    """A JPEG in a mode the decoder does not implement; ``mode`` names
    it."""

    def __init__(self, message: str):
        super().__init__(message)
        self.mode = message.split(": ", 1)[-1]


class JpegWarning(IOError):
    """A JPEG that libjpeg decodes with a warning (a scan that ends early,
    a lost restart marker, data ending before its EOI marker, ...):
    ``image`` is that decode, libjpeg's bits; ``ended`` is true when the
    data ended before EOI, where OpenCV's reader gives no image."""

    def __init__(self, message: str, image: np.ndarray, ended: bool):
        super().__init__(message)
        self.image = image
        self.ended = ended


def available() -> bool:
    """True when the library is built (or builds now) and loads."""
    return _LIB.available()


def build_error() -> str | None:
    """Why the library is unavailable; None when it loaded or was never
    tried."""
    return _LIB.build_error()


def library_path() -> pathlib.Path | None:
    """Path of the loaded library, None when it is not loaded."""
    return _LIB.library_path()


def decode_count() -> int:
    """Images decoded since the last :func:`reset_count`."""
    return _count


def reset_count() -> None:
    global _count
    with _count_lock:
        _count = 0


def _raise(status: int, err: ctypes.Array) -> None:
    msg = err.value.decode(errors="replace")
    if status == STATUS_UNSUPPORTED:
        raise UnsupportedJpeg(msg)
    raise IOError(f"JPEG decode failed: {msg}")


def jpeg_info(buf: bytes, scale_num: int = 8,
              flavour: str = "libjpeg") -> tuple[int, int, int]:
    """(width, height, components) from a JPEG's headers, the size being
    the output's at ``scale_num``/8; raises like :func:`decode`."""
    lib = _LIB.load()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(ERR_LEN)
    status = lib.epk_jpeg_info(buf, len(buf), scale_num, ctypes.byref(w),
                               ctypes.byref(h), ctypes.byref(c),
                               FLAVOURS[flavour], err, ERR_LEN)
    if status:
        _raise(status, err)
    return w.value, h.value, c.value


def decode(buf: bytes, scale_num: int = 8,
           flavour: str = "libjpeg") -> np.ndarray:
    """One JPEG -> (H, W, 3) uint8 RGB at libjpeg's DCT scale
    ``scale_num``/8 (8: full size; the size is ``ceil(W * scale_num / 8)``
    by ``ceil(H * scale_num / 8)``); grayscale is replicated into three
    channels, CMYK and YCCK converted as OpenCV converts them. Where
    libjpeg decodes with a warning it raises :class:`JpegWarning`, which
    holds that decode (``.image``).
    ``flavour`` names whose decode it gives (:data:`FLAVOURS`). Raises
    :class:`UnsupportedJpeg` for a mode it refuses and ``IOError`` for
    data it cannot decode."""
    global _count
    w, h, _ = jpeg_info(buf, scale_num, flavour)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(ERR_LEN)
    status = _LIB.load().epk_jpeg_decode_rgb(buf, len(buf), scale_num,
                                             out.ctypes.data, w, h,
                                             FLAVOURS[flavour], err,
                                             ERR_LEN)
    if status not in (0, STATUS_WARNED, STATUS_ENDED):
        _raise(status, err)
    with _count_lock:
        _count += 1
    if status:
        raise JpegWarning(err.value.decode(errors="replace"), out,
                          status == STATUS_ENDED)
    return out
