"""The port's baseline JPEG decoder (``native/jpegdec.cpp``) via ctypes.

It needs neither libjpeg nor OpenCV, only ``g++``: the card's machine has
neither ``jpeglib.h`` nor OpenCV. Its RGB output equals libjpeg-turbo's
default decode bit for bit (what ``cv2.imdecode`` and the native loader
give). It refuses progressive, lossless, hierarchical and arithmetic-coded
files, 12-bit samples and CMYK/YCCK with :class:`UnsupportedJpeg`, which
names the mode; truncated or corrupt data raises ``IOError``.

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
ERR_LEN = 256

_i = ctypes.c_int
_pi = ctypes.POINTER(ctypes.c_int)
SIGNATURES = {
    "epk_jpeg_info": (_i, (ctypes.c_char_p, ctypes.c_size_t, _pi, _pi, _pi,
                           ctypes.c_char_p, _i)),
    "epk_jpeg_decode_rgb": (_i, (ctypes.c_char_p, ctypes.c_size_t,
                                 ctypes.c_void_p, _i, _i, ctypes.c_char_p,
                                 _i)),
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


def jpeg_info(buf: bytes) -> tuple[int, int, int]:
    """(width, height, components) from a JPEG's headers; raises like
    :func:`decode`."""
    lib = _LIB.load()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(ERR_LEN)
    status = lib.epk_jpeg_info(buf, len(buf), ctypes.byref(w),
                               ctypes.byref(h), ctypes.byref(c), err, ERR_LEN)
    if status:
        _raise(status, err)
    return w.value, h.value, c.value


def decode(buf: bytes) -> np.ndarray:
    """One JPEG -> (H, W, 3) uint8 RGB; grayscale is replicated into three
    channels. Raises :class:`UnsupportedJpeg` for a mode it refuses and
    ``IOError`` for truncated or corrupt data."""
    global _count
    w, h, _ = jpeg_info(buf)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(ERR_LEN)
    status = _LIB.load().epk_jpeg_decode_rgb(buf, len(buf), out.ctypes.data,
                                             w, h, err, ERR_LEN)
    if status:
        _raise(status, err)
    with _count_lock:
        _count += 1
    return out
