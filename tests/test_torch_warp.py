"""The port's ``ops/warp.py`` vs OpenCV and the JAX package's warps.

- Every case of ``tests/test_warp.py`` on the port, with its bounds.
- The port against the JAX package on the same inputs: within 1e-5 of
  the image's range. Sample coordinates are float32: the inverse affine's
  translation (about 100 px) is rounded to 1.5e-5 px, so a one-spacing
  difference there moves a sample by that much (for a rotation-free map
  the port rounds as JAX does).
- The separable warp gives the same bits whatever float32 matmul
  precision the process allows (JAX asks for ``Precision.HIGHEST``): on
  this CPU ``torch.set_float32_matmul_precision`` lets oneDNN round a
  matmul's inputs to bfloat16, as TF32 does on the card.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epipolarpose_tpu.geometry import get_affine_transform
from epipolarpose_tpu.ops import warp as jwarp
from epipolarpose_tpu_torch.ops import warp as twarp


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _blurred(rng, shape, sigma):
    img = rng.uniform(0, 255, shape).astype(np.float32)
    return cv2.GaussianBlur(img, (0, 0), sigma)


def _crop(center, scale, rot, size):
    return np.asarray(get_affine_transform(
        np.asarray(center, np.float32), np.asarray(scale, np.float32), rot,
        size))


# ---------------------------------------------- the cases of test_warp.py
@pytest.mark.parametrize("rot", [0.0, 15.0, -40.0])
def test_matches_cv2_crop(rot, rng):
    img = _blurred(rng, (480, 640, 3), 2.0)
    M = _crop([320.0, 240.0], [1.1, 1.1], rot, (256, 256))
    oracle = cv2.warpAffine(img, M, (256, 256), flags=cv2.INTER_LINEAR)
    ours = twarp.warp_affine(_t(img[None]), M, (256, 256))[0].numpy()
    diff = np.abs(ours - oracle)
    assert np.median(diff) < 0.5
    assert (diff < 2.0).mean() > 0.97


def test_identity_warp(rng):
    img = rng.uniform(0, 1, (2, 32, 32, 1)).astype(np.float32)
    M = np.array([[1.0, 0, 0], [0, 1, 0]], np.float32)
    out = twarp.warp_affine(_t(img), M, (32, 32)).numpy()
    np.testing.assert_allclose(out, img, atol=1e-5)


def test_translation_zero_border():
    img = np.ones((1, 8, 8, 1), np.float32)
    M = np.array([[1.0, 0, 4], [0, 1, 0]], np.float32)
    out = twarp.warp_affine(_t(img), M, (8, 8))[0, :, :, 0].numpy()
    np.testing.assert_allclose(out[:, 4:], 1.0)
    np.testing.assert_allclose(out[:, :4], 0.0)


def test_batched_distinct_transforms(rng):
    img = rng.uniform(0, 1, (3, 64, 64, 2)).astype(np.float32)
    Ms = np.stack([
        np.array([[1.0, 0, 0], [0, 1, 0]], np.float32),
        np.array([[1.0, 0, 10], [0, 1, 0]], np.float32),
        np.array([[0.5, 0, 0], [0, 0.5, 0]], np.float32),
    ])
    out = twarp.warp_affine(_t(img), Ms, (64, 64)).numpy()
    np.testing.assert_allclose(out[0], img[0], atol=1e-5)
    assert not np.allclose(out[1], img[1])


def _separable_case(rng):
    img = rng.uniform(0, 1, (4, 120, 160, 3)).astype(np.float32)
    centers = rng.uniform((40, 30), (120, 90), (4, 2)).astype(np.float32)
    scales = np.repeat(rng.uniform(0.3, 0.6, (4, 1)), 2, 1).astype(
        np.float32)
    return img, _crop(centers, scales, 0.0, (64, 64))


def test_separable_matches_gather(rng):
    img, M = _separable_case(rng)
    a = twarp.warp_affine(_t(img), M, (64, 64)).numpy()
    b = twarp.warp_affine_separable(_t(img), M, (64, 64)).numpy()
    np.testing.assert_allclose(a, b, atol=1e-4)


def test_separable_matches_cv2(rng):
    img = _blurred(rng, (240, 320, 3), 1.5)
    M = _crop([160.0, 120.0], [0.8, 0.8], 0.0, (128, 128))
    oracle = cv2.warpAffine(img, M, (128, 128), flags=cv2.INTER_LINEAR)
    ours = twarp.warp_affine_separable(_t(img[None]), M, (128, 128))[0]
    diff = np.abs(ours.numpy() - oracle)
    assert np.median(diff) < 0.5 and (diff < 2.0).mean() > 0.97


# ------------------------------------------------------ against the JAX
def _jax_case(name, rng):
    """(images, M, output size) of each case above."""
    if name.startswith("cv2_crop"):
        rot = float(name.split("_")[-1])
        img = _blurred(rng, (480, 640, 3), 2.0)[None]
        return img, _crop([320.0, 240.0], [1.1, 1.1], rot, (256, 256)), \
            (256, 256)
    if name == "identity":
        return (rng.uniform(0, 1, (2, 32, 32, 1)).astype(np.float32),
                np.array([[1.0, 0, 0], [0, 1, 0]], np.float32), (32, 32))
    if name == "translation":
        return (np.ones((1, 8, 8, 1), np.float32),
                np.array([[1.0, 0, 4], [0, 1, 0]], np.float32), (8, 8))
    if name == "batched":
        return (rng.uniform(0, 1, (3, 64, 64, 2)).astype(np.float32),
                np.stack([np.array([[1.0, 0, 0], [0, 1, 0]], np.float32),
                          np.array([[1.0, 0, 10], [0, 1, 0]], np.float32),
                          np.array([[0.5, 0, 0], [0, 0.5, 0]], np.float32)]),
                (64, 64))
    if name == "separable":
        img, M = _separable_case(rng)
        return img, M, (64, 64)
    img = _blurred(rng, (240, 320, 3), 1.5)[None]
    return img, _crop([160.0, 120.0], [0.8, 0.8], 0.0, (128, 128)), \
        (128, 128)


CASES = ["cv2_crop_0", "cv2_crop_15", "cv2_crop_-40", "identity",
         "translation", "batched", "separable", "separable_cv2"]
ROTATED = ("cv2_crop_15", "cv2_crop_-40")
# the separable warp takes rotation-free maps only
JAX_CASES = [("warp_affine", c) for c in CASES] + [
    ("warp_affine_separable", c) for c in CASES if c not in ROTATED]


@pytest.mark.parametrize("fn,case", JAX_CASES)
def test_matches_jax(fn, case, rng):
    img, M, size = _jax_case(case, rng)
    want = np.asarray(getattr(jwarp, fn)(jnp.asarray(img), jnp.asarray(M),
                                         size))
    got = getattr(twarp, fn)(_t(img), M, size).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(img).max()))


def test_separable_ignores_the_matmul_precision(rng):
    img, M = _separable_case(rng)
    before = torch.get_float32_matmul_precision()
    outs = []
    try:
        for precision in ("highest", "medium"):
            torch.set_float32_matmul_precision(precision)
            outs.append(twarp.warp_affine_separable(_t(img), M,
                                                    (64, 64)).numpy())
    finally:
        torch.set_float32_matmul_precision(before)
    np.testing.assert_array_equal(outs[0], outs[1])
