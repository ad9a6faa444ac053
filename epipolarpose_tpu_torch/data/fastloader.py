"""ctypes binding for the port's native batch loader
(``epipolarpose_tpu_torch/native/fastloader.cpp``).

The port's counterpart of the JAX package's ``data/fastloader.py``, with
the same functions, C signatures and crops, but no libjpeg: each frame is
decoded by the port's own decoder (``native/jpegdec.cpp``, which the
loader's source includes), at libjpeg's DCT scale ``scale_num``/8 when the
crop shrinks the frame 2x or more, as the JAX loader decodes it. One
``g++`` call builds it into
``epipolarpose_tpu_torch/_build/fastloader-<key>/`` (``data/cxx_library.py``;
``key`` hashes both sources, the flags and ``g++ --version``). The flags
name no ``-march``, so the library may be built on one host and run on
another, and no library but OpenMP's. Without a compiler the build fails,
:func:`available` is false and :func:`build_error` says why; callers then
take the numpy route.

:func:`decode_counts` reads the library's counts of decodes by scale, of
failures and of the unsupported among them, and of decodes libjpeg would
have warned about, since :func:`reset_counts`.
"""

from __future__ import annotations

import ctypes
import pathlib

import numpy as np

from epipolarpose_tpu_torch.data import jpeg
from epipolarpose_tpu_torch.data.cxx_library import CxxLibrary

PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR / "native" / "fastloader.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-fopenmp", "-shared", "-std=c++17", "-Wall")
LD_FLAGS = ()

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
    "epk_loader_counts": (None, (ctypes.POINTER(ctypes.c_int64),)),
    "epk_loader_reset_counts": (None, ()),
}
_LIB = CxxLibrary("fastloader", SOURCE, CXX_FLAGS, LD_FLAGS, SIGNATURES,
                  "native loader", includes=(jpeg.SOURCE,))
_load = _LIB.load


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


COUNT_SLOTS = 11


def _counts():
    counts = (ctypes.c_int64 * COUNT_SLOTS)()
    if _LIB.library_path() is not None:
        _load().epk_loader_counts(counts)
    return counts


def decode_counts() -> dict:
    """The library's decodes since :func:`reset_counts`: ``{"scale":
    {scale_num: n}, "failed": n, "unsupported": n, "warned": n}``, scales
    with no decode left out; zeros when the library is not loaded.
    ``unsupported`` counts the failures of a mode that the JAX package's
    loader (libjpeg) refuses too (lossless, hierarchical, 12-bit,
    CMYK/YCCK), the rest of ``failed`` being corrupt data; ``warned`` the
    decodes libjpeg warns about (a truncated file, decoded as libjpeg
    fills it)."""
    counts = _counts()
    return {"scale": {s: int(counts[s]) for s in range(1, 9) if counts[s]},
            "failed": int(counts[0]), "unsupported": int(counts[9]),
            "warned": int(counts[10])}


def reset_counts() -> None:
    """Set the library's counts of decodes and failures to 0."""
    if _LIB.library_path() is not None:
        _load().epk_loader_reset_counts()


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
    float32 in [0, 255 * scale]. A JPEG that fails to decode (CMYK and
    YCCK among them, as in the JAX package's loader) gives a zero crop; a
    truncated one is decoded as libjpeg fills it."""
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
