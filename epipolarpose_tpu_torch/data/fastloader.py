"""ctypes binding for the native batch loader (``native/fastloader.cpp``).

The port's counterpart of the JAX package's ``data/fastloader.py``, with
the same functions and C signatures. It builds its own copy of the
library from ``native/fastloader.cpp`` with one ``g++`` call into
``epipolarpose_tpu_torch/_build/fastloader-<key>/`` (``key`` hashes the
source, the flags and ``g++ --version``) and never writes into
``native/``. The flags name no ``-march``: the library may be built on
one host and run on another. Without a compiler or ``jpeglib.h`` the build
fails, :func:`available` is false and :func:`build_error` says why;
callers then take the numpy route.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import uuid

import numpy as np

PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR.parent / "native" / "fastloader.cpp"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libfastloader.so"
CXX_FLAGS = ("-O3", "-fPIC", "-fopenmp", "-shared", "-Wall")
LD_FLAGS = ("-ljpeg",)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None

_pv = ctypes.POINTER(ctypes.c_void_p)
_ps = ctypes.POINTER(ctypes.c_size_t)
_pf = ctypes.POINTER(ctypes.c_float)
_pu8 = ctypes.POINTER(ctypes.c_uint8)
_i = ctypes.c_int
# exported C functions: name -> (result type, argument types)
SIGNATURES = {
    "decode_warp_batch": (_i, (_pv, _ps, _i, _pf, _i, _i, _pf,
                               ctypes.c_float)),
    "decode_warp_batch_u8": (_i, (_pv, _ps, _i, _pf, _i, _i, _pu8)),
    "warp_batch_u8": (None, (_pu8, _i, _i, _i, _pf, _i, _i, _pf,
                             ctypes.c_float)),
    "decode_warp2_batch_u8": (_i, (_pv, _ps, _i, _pf, _pf, _i, _i, _pu8,
                                   _pu8)),
    "decode_warp2_sized_batch_u8": (_i, (_pv, _ps, _i, _pf, _pf, _i, _i, _i,
                                         _i, _pu8, _pu8)),
}


def build_key(cxx_version: str) -> str:
    """Content hash of the source, the flags and the compiler version."""
    h = hashlib.sha256()
    h.update(cxx_version.encode())
    h.update(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:24]


def build() -> pathlib.Path:
    """Compile the loader unless a library for this source exists; the
    path of the library. Raises RuntimeError when ``g++`` fails."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    version = subprocess.run([cxx, "--version"], check=True,
                             capture_output=True, text=True).stdout
    out_dir = BUILD_DIR / f"fastloader-{build_key(version)}"
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # write a temporary file and rename it: concurrent builds need no
    # lock, and no reader sees a half-written library
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.{uuid.uuid4().hex}.tmp"
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), *LD_FLAGS, "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            errors = [ln for ln in res.stderr.splitlines() if "error" in ln]
            raise RuntimeError(f"g++ failed ({res.returncode}): "
                               + ("; ".join(errors) or res.stderr.strip()))
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def _load() -> ctypes.CDLL:
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = f"native loader unavailable: {e}"
            raise RuntimeError(_error) from e
        for name, (restype, argtypes) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = list(argtypes)
        _lib = lib
        return lib


def available() -> bool:
    """True when the library is built (or builds now) and loads."""
    try:
        _load()
        return True
    except RuntimeError:
        return False


def build_error() -> str | None:
    """Why the library is unavailable; None when it loaded or was never
    tried."""
    return _error


def library_path() -> pathlib.Path | None:
    """Path of the loaded library, None when it is not loaded."""
    return None if _lib is None else pathlib.Path(_lib._name)


def _jpeg_ptrs(jpeg_buffers: list[bytes]):
    """Pointer and size arrays aliasing the bytes objects (the C side only
    reads them; the caller's list keeps them alive)."""
    n = len(jpeg_buffers)
    ptrs = ctypes.cast((ctypes.c_char_p * n)(*jpeg_buffers), _pv)
    sizes = (ctypes.c_size_t * n)(*[len(b) for b in jpeg_buffers])
    return ptrs, sizes


def _affines(Ms, n: int) -> np.ndarray:
    Ms = np.ascontiguousarray(Ms, np.float32)
    if Ms.size != n * 6:
        raise ValueError(f"expected {n} affines of (2, 3), got shape "
                         f"{Ms.shape}")
    return Ms.reshape(n, 6)


def decode_warp_batch(jpeg_buffers: list[bytes], Ms: np.ndarray,
                      output_size: tuple[int, int],
                      scale: float = 1.0 / 255.0,
                      dtype=np.uint8) -> np.ndarray:
    """Decode each JPEG and warp it through its (2, 3) source -> crop
    affine into an (W, H) = ``output_size`` crop: (N, H, W, 3) uint8, or
    float32 in [0, 255 * scale]. A JPEG that fails to decode gives a zero
    crop."""
    lib = _load()
    n = len(jpeg_buffers)
    W, H = int(output_size[0]), int(output_size[1])
    ptrs, sizes = _jpeg_ptrs(jpeg_buffers)
    Ms = _affines(Ms, n)
    Mp = Ms.ctypes.data_as(_pf)
    if np.dtype(dtype) == np.uint8:
        out = np.empty((n, H, W, 3), np.uint8)
        lib.decode_warp_batch_u8(ptrs, sizes, n, Mp, W, H,
                                 out.ctypes.data_as(_pu8))
        return out
    out = np.empty((n, H, W, 3), np.float32)
    lib.decode_warp_batch(ptrs, sizes, n, Mp, W, H, out.ctypes.data_as(_pf),
                          ctypes.c_float(scale))
    return out


def decode_warp2_batch(jpeg_buffers: list[bytes], Ms1: np.ndarray,
                       Ms2: np.ndarray, output_size: tuple[int, int],
                       output_size1: tuple[int, int] | None = None):
    """Decode each JPEG once and warp it through two affines: (crops1,
    crops2), uint8 (N, H, W, 3) each; ``output_size1`` sets crop 1's size
    (``Ms1`` must map into that frame)."""
    lib = _load()
    n = len(jpeg_buffers)
    W2, H2 = int(output_size[0]), int(output_size[1])
    W1, H1 = (W2, H2) if output_size1 is None else (
        int(output_size1[0]), int(output_size1[1]))
    ptrs, sizes = _jpeg_ptrs(jpeg_buffers)
    Ms1, Ms2 = _affines(Ms1, n), _affines(Ms2, n)
    out1 = np.empty((n, H1, W1, 3), np.uint8)
    out2 = np.empty((n, H2, W2, 3), np.uint8)
    lib.decode_warp2_sized_batch_u8(
        ptrs, sizes, n, Ms1.ctypes.data_as(_pf), Ms2.ctypes.data_as(_pf),
        W1, H1, W2, H2, out1.ctypes.data_as(_pu8), out2.ctypes.data_as(_pu8))
    return out1, out2


def warp_batch(images_u8: np.ndarray, Ms: np.ndarray,
               output_size: tuple[int, int],
               scale: float = 1.0 / 255.0) -> np.ndarray:
    """Warp same-size uint8 RGB images (N, H, W, 3) into float32 crops."""
    lib = _load()
    images_u8 = np.ascontiguousarray(images_u8, np.uint8)
    if images_u8.ndim != 4 or images_u8.shape[-1] != 3:
        raise ValueError(f"expected (N, H, W, 3) images, got "
                         f"{images_u8.shape}")
    n, sh, sw, _ = images_u8.shape
    W, H = int(output_size[0]), int(output_size[1])
    Ms = _affines(Ms, n)
    out = np.empty((n, H, W, 3), np.float32)
    lib.warp_batch_u8(images_u8.ctypes.data_as(_pu8), n, sw, sh,
                      Ms.ctypes.data_as(_pf), W, H, out.ctypes.data_as(_pf),
                      ctypes.c_float(scale))
    return out


def jpeg_size(buf: bytes) -> tuple[int, int]:
    """(width, height) from a JPEG's frame header."""
    if buf[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG")
    i = 2
    while i + 4 <= len(buf):
        if buf[i] != 0xFF:
            raise ValueError("malformed JPEG marker")
        marker = buf[i + 1]
        if marker == 0xFF:                      # fill byte
            i += 1
            continue
        if marker in (0x01, *range(0xD0, 0xD9)):  # markers with no length
            i += 2
            continue
        length = int.from_bytes(buf[i + 2:i + 4], "big")
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if i + 9 > len(buf):
                break
            return (int.from_bytes(buf[i + 7:i + 9], "big"),
                    int.from_bytes(buf[i + 5:i + 7], "big"))
        i += 2 + length
    raise ValueError("JPEG has no frame header")


def decode(buf: bytes) -> np.ndarray:
    """One JPEG -> (H, W, 3) uint8 RGB (an identity warp of the full
    decode, which copies every pixel as decoded)."""
    w, h = jpeg_size(buf)
    eye = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    lib = _load()
    out = np.empty((1, h, w, 3), np.uint8)
    ptrs, sizes = _jpeg_ptrs([buf])
    failed = lib.decode_warp_batch_u8(ptrs, sizes, 1,
                                      eye.ctypes.data_as(_pf), w, h,
                                      out.ctypes.data_as(_pu8))
    if failed:
        raise IOError("JPEG decode failed")
    return out[0]
