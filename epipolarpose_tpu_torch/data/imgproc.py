"""The loader's image operations, in numpy, with OpenCV's semantics.

The port's loader runs where OpenCV may not be installed, so it carries
its own copies of the calls the JAX package's loader makes:

- :func:`warp_affine_u8` is ``cv2.warpAffine(img, M, (W, H),
  flags=cv2.INTER_LINEAR)`` with ``BORDER_CONSTANT`` 0 on uint8 images, as
  OpenCV 4.11 and later compute it: the matrix inverted in float64 and
  rounded to float32, source coordinates ``fma(m0, x, m1*y + m2)`` in
  float32, a bilinear blend as three fused lerps in float32 (x, then y),
  rounded half to even. Fused multiply-adds are emulated in float64,
  where every product and sum they take is exact or rounds once.
- :func:`warp_affine_f32` is the same call on float32 images (1, 3 or 4
  channels): the same coordinates and lerps, unrounded; equal bits but in
  OpenCV's scalar tail (the last W mod 16 columns), within 3e-5 there on
  [0, 1] images. Two-channel images take an older OpenCV path that
  neither warp reproduces.
- :func:`resize_bilinear_u8` is ``cv2.resize(img, (W, H),
  interpolation=cv2.INTER_LINEAR)`` on uint8 images in float32 (OpenCV's
  fixed-point path rounds its weights to 1/2048; the two differ by at
  most one grey level).
"""

from __future__ import annotations

import numpy as np

_F32, _F64 = np.float32, np.float64


def _inverse_affine_f32(M) -> np.ndarray:
    """OpenCV's inversion of a (2, 3) source -> destination affine, in
    float64, rounded to float32: the destination -> source map."""
    m = np.asarray(M, _F64).reshape(6)
    det = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    a12, a21 = -m[1] * d, -m[3] * d
    b1 = -a11 * m[2] - a12 * m[5]
    b2 = -a21 * m[2] - a22 * m[5]
    return np.array([a11, a12, b1, a21, a22, b2], _F32)


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` with one rounding (float64 inside)."""
    return (np.asarray(a, _F64) * b + c).astype(_F32)


def _warp_bilinear(img: np.ndarray, M, size) -> np.ndarray:
    """The bilinear warp of (H, W) or (H, W, C) ``img`` in float32, zero
    border, before any rounding: (H_out, W_out, C) float32."""
    W, H = int(size[0]), int(size[1])
    m = _inverse_affine_f32(M)
    xs = np.arange(W, dtype=_F32)[None, :]
    ys = np.arange(H, dtype=_F32)[:, None]
    sx = _fma(m[0], xs, m[1] * ys + m[2])              # (H, W) float32
    sy = _fma(m[3], xs, m[4] * ys + m[5])
    fx, fy = np.floor(sx), np.floor(sy)
    ax = (sx - fx)[..., None]
    ay = (sy - fy)[..., None]
    sh, sw = img.shape[:2]
    # one zero pixel around the image: a tap outside it reads the border
    # value 0, and indices clipped into the pad read 0 too
    pad = np.zeros((sh + 2, sw + 2) + img.shape[2:], img.dtype)
    pad[1:-1, 1:-1] = img
    pad = pad.reshape((sh + 2) * (sw + 2), -1)
    # clip in float first: a coordinate far outside may not fit an int32
    x0 = np.clip(fx + 1, 0, sw + 1).astype(np.intp)
    x1 = np.clip(fx + 2, 0, sw + 1).astype(np.intp)
    y0 = np.clip(fy + 1, 0, sh + 1).astype(np.intp) * (sw + 2)
    y1 = np.clip(fy + 2, 0, sh + 1).astype(np.intp) * (sw + 2)
    p00, p01, p10, p11 = (pad[i].astype(_F32) for i in
                          (y0 + x0, y0 + x1, y1 + x0, y1 + x1))
    top = _fma(ax, p01 - p00, p00)
    bottom = _fma(ax, p11 - p10, p10)
    return _fma(ay, bottom - top, top)


def warp_affine_u8(img: np.ndarray, M, size) -> np.ndarray:
    """``cv2.warpAffine(img, M, size, flags=cv2.INTER_LINEAR)`` for uint8
    (H, W) or (H, W, C) images, zero border. ``M`` (2, 3) maps source to
    destination pixels; ``size`` is (W, H) of the output."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"warp_affine_u8 takes uint8 images, got {img.dtype}")
    out = _warp_bilinear(img, M, size)
    out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.reshape((int(size[1]), int(size[0])) + img.shape[2:])


def warp_affine_f32(img: np.ndarray, M, size) -> np.ndarray:
    """``cv2.warpAffine(img, M, size, flags=cv2.INTER_LINEAR)`` for float32
    (H, W) or (H, W, C) images, zero border: the uint8 warp's coordinates
    and lerps, unrounded."""
    img = np.asarray(img)
    if img.dtype != np.float32:
        raise TypeError(f"warp_affine_f32 takes float32 images, got "
                        f"{img.dtype}")
    out = _warp_bilinear(img, M, size)
    return out.reshape((int(size[1]), int(size[0])) + img.shape[2:])


def _linear_taps(n_src: int, n_dst: int):
    """Source indices (i0, i1) and the weight of i1 for each of ``n_dst``
    outputs: OpenCV's half-pixel-centre mapping, clamped at the edges."""
    scale = n_src / n_dst
    f = ((np.arange(n_dst, dtype=_F64) + 0.5) * scale - 0.5).astype(_F32)
    i0 = np.floor(f)
    w = (f - i0).astype(_F32)
    i0 = i0.astype(np.intp)
    low = i0 < 0
    high = i0 >= n_src - 1
    w[low | high] = 0.0
    i0 = np.clip(i0, 0, n_src - 1)
    i1 = np.minimum(i0 + 1, n_src - 1)
    return i0, i1, w


def resize_bilinear_u8(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)`` for uint8
    (H, W) or (H, W, C) images, in float32; ``size`` is (W, H)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"resize_bilinear_u8 takes uint8 images, got "
                        f"{img.dtype}")
    W, H = int(size[0]), int(size[1])
    x0, x1, wx = _linear_taps(img.shape[1], W)
    y0, y1, wy = _linear_taps(img.shape[0], H)
    src = img.astype(_F32)
    e = (slice(None),) + (None,) * (img.ndim - 2)
    rows = (src[:, x0] * (1 - wx)[e] + src[:, x1] * wx[e])
    e = (slice(None), None) + (None,) * (img.ndim - 2)
    out = rows[y0] * (1 - wy)[e] + rows[y1] * wy[e]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
