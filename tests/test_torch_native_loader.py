"""The port's native loader (``native/fastloader.cpp`` in the port, the
port's decoder inside it, no libjpeg) against the JAX package's
(``native/fastloader.cpp`` at the repo root, the system's libjpeg-turbo).

- The build: the port's source and flags, no libjpeg named or linked.
- ``decode_warp_batch`` (uint8 and float32), ``decode_warp2_batch`` (a
  full-size and a half-size teacher crop) on frames of every sampling,
  baseline and progressive, through affines whose shrink runs from 1.2 to
  9, so that ``pick_scale_num`` gives 8, 4, 3, 2 and 1: uint8 crops equal
  bit for bit, float32 crops within one float32 spacing at 1.0, the
  tolerance of ``tests/test_torch_data.py`` (the JAX build has
  ``-march=native`` and fuses multiply-adds on an FMA host; the port's
  geometry and warp take their FMA clone there, so they are equal);
  ``warp_batch`` likewise.
- The library's counts of decodes by scale, of failures by kind and of
  decodes with a libjpeg warning; a failed decode's zero crop; a
  truncated frame's crop; 4x4-subsampled chroma decoded at 3/8.

``tests/test_torch_image_modes.py`` holds the loader to the JAX one on
the files of ``tests/data/jpeg/modes/``.
"""

import subprocess
import zlib

import numpy as np
import pytest

import jpeg_fixtures as jf
from epipolarpose_tpu.geometry.affine import get_affine_transform_np
from epipolarpose_tpu_torch.data import cxx_library, jpeg
from epipolarpose_tpu_torch.data import fastloader as tfast

SIZE = (40, 32)                         # crop (W, H)
SHRINKS = (1.2, 2.0, 2.7, 3.5, 4.5, 6.0, 9.0)
SAMPLINGS = jf.SAMPLINGS + ("gray",)


def _jfast():
    """The JAX package's loader, or a skip where it cannot build (no g++
    or jpeglib.h)."""
    from epipolarpose_tpu.data import fastloader as jfast
    if not jfast.available():
        pytest.skip("the JAX native loader cannot build (no jpeglib.h)")
    return jfast


def _frames(progressive: bool) -> list:
    """One 120 x 160 frame of each sampling (OpenCV), and Pillow's
    optimized 4:4:4 and a restart-interval file, baseline or
    progressive."""
    out = []
    for s in SAMPLINGS:
        img = jf.render(120, 160, zlib.crc32(s.encode()), noise=8.0)
        if s == "gray":
            out.append(jf.cv2_encode(img[..., 1], 90,
                                     progressive=progressive))
        else:
            out.append(jf.cv2_encode(img, 90, s, progressive=progressive))
    img = jf.render(120, 160, 99, noise=15.0)
    out.append(jf.pil_encode(img, quality=85, subsampling=0, optimize=True,
                             progressive=progressive))
    out.append(jf.cv2_encode(img, 85, "420", restart=3,
                             progressive=progressive))
    return out


def _affines(n: int, shrink: float, size, seed: int, rot: bool = True):
    """Crops of ``size`` whose boxes are ``shrink`` source pixels a crop
    pixel, centred around the frame, rotated."""
    rng = np.random.default_rng(seed)
    c = rng.uniform((50, 40), (110, 80), (n, 2)).astype(np.float32)
    s = np.full((n, 2), shrink * size[0] / 200.0, np.float32)
    r = rng.uniform(-30, 30, n).astype(np.float32) * rot
    return get_affine_transform_np(c, s, r, size)


def test_loader_builds_from_the_port_without_libjpeg():
    assert tfast.available(), tfast.build_error()
    path = tfast.library_path()
    assert path.parent.name.startswith("fastloader-")
    assert path.parent.parent == cxx_library.BUILD_DIR
    assert tfast.SOURCE.parent == jpeg.SOURCE.parent   # the port's native/
    assert tfast._LIB.includes == (jpeg.SOURCE,)
    flags = " ".join(tfast.CXX_FLAGS + tfast.LD_FLAGS)
    assert "jpeg" not in flags and "-march" not in flags
    for src in (tfast.SOURCE, jpeg.SOURCE):
        assert "jpeglib" not in src.read_text()
    ldd = subprocess.run(["ldd", str(path)], capture_output=True, text=True)
    assert ldd.returncode == 0 and "libjpeg" not in ldd.stdout


@pytest.mark.parametrize("mode", ["baseline", "progressive"])
@pytest.mark.parametrize("route", ["u8", "f32", "warp2", "warp2_half"])
def test_crops_match_the_jax_loader(route, mode):
    jfast = _jfast()
    bufs = _frames(mode == "progressive")
    n = len(bufs)
    tfast.reset_counts()
    for k, shrink in enumerate(SHRINKS):
        M = _affines(n, shrink, SIZE, seed=k)
        if route.startswith("warp2"):
            half = route == "warp2_half"
            size1 = (SIZE[0] // 2, SIZE[1] // 2) if half else SIZE
            M1 = _affines(n, shrink, size1, seed=k, rot=False)
            got = tfast.decode_warp2_batch(bufs, M1, M, SIZE, size1)
            want = jfast.decode_warp2_batch(bufs, M1, M, SIZE, size1)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b, err_msg=str(shrink))
            continue
        dtype = np.uint8 if route == "u8" else np.float32
        got = tfast.decode_warp_batch(bufs, M, SIZE, dtype=dtype)
        want = jfast.decode_warp_batch(bufs, M, SIZE, dtype=dtype)
        assert got.dtype == want.dtype and got.shape == want.shape
        if dtype == np.uint8:
            np.testing.assert_array_equal(got, want, err_msg=str(shrink))
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=np.spacing(np.float32(1.0)))
    counts = tfast.decode_counts()
    assert counts["failed"] == 0
    assert sorted(counts["scale"]) == [1, 2, 3, 4, 8]
    assert sum(counts["scale"].values()) == n * len(SHRINKS)


def test_warp_batch_matches_the_jax_loader(rng):
    jfast = _jfast()
    imgs = rng.integers(0, 256, (6, 70, 90, 3), dtype=np.uint8)
    M = _affines(6, 1.7, SIZE, seed=3)
    got = tfast.warp_batch(imgs, M, SIZE)
    want = jfast.warp_batch(imgs, M, SIZE)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=np.spacing(np.float32(1.0)))


def test_the_decode_is_the_port_decoders():
    """An identity crop (every decoded pixel copied) gives the port's
    decoder's bits, progressive included."""
    eye = np.array([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]], np.float32)
    for name in ("s422_37x29.jpg", "progressive_64x48.jpg",
                 "progressive_gray_48x32.jpg"):
        buf = (jf.FIXTURE_DIR / name).read_bytes()
        w, h, _ = jpeg.jpeg_info(buf)
        np.testing.assert_array_equal(
            tfast.decode_warp_batch([buf], eye, (w, h))[0], jpeg.decode(buf))


def test_counts_failures_and_their_zero_crops():
    """A frame that fails (not a JPEG: corrupt; CMYK: a mode the JAX
    loader's libjpeg refuses too) gives a zero crop and is counted, by
    kind; a truncated frame is decoded as libjpeg fills it and counted
    among the decodes with a warning, its crop the JAX loader's."""
    bufs = _frames(False)[:3]
    bad = bufs[1][:len(bufs[1]) // 2]               # truncated
    cmyk = (jf.MODES_DIR / "ycck_420_48x40.jpg").read_bytes()
    frames = [bufs[0], bad, bufs[2], b"not a jpeg", cmyk]
    M = _affines(5, 3.0, SIZE, seed=1)
    tfast.reset_counts()
    out = tfast.decode_warp_batch(frames, M, SIZE)
    assert not out[3].any() and not out[4].any()
    assert out[0].any() and out[1].any() and out[2].any()
    assert tfast.decode_counts() == {"scale": {3: 3}, "failed": 2,
                                     "unsupported": 1, "warned": 1}
    from epipolarpose_tpu.data import fastloader as jfast
    if jfast.available():
        np.testing.assert_array_equal(
            out, jfast.decode_warp_batch(frames, M, SIZE, dtype=np.uint8))
    tfast.reset_counts()
    assert tfast.decode_counts() == {"scale": {}, "failed": 0,
                                     "unsupported": 0, "warned": 0}


def test_a_scale_without_its_idct_is_served_at_full_size():
    """The name is historical: 4x4-subsampled chroma at 3/8 needs
    jidctint.c's 12x12 IDCT, which the decoder once lacked, and the loader
    then decoded that frame at 8/8. It has the IDCT now, so the frame is
    decoded at 3/8, as the JAX loader (libjpeg) decodes it, and counted
    there; no frame is served at another scale than its affine's."""
    buf = jf.encode_separate_scans(jf.render(64, 64, 3), 85, (4, 4))
    M = _affines(1, 8 / 3, (24, 24), seed=2, rot=False)
    tfast.reset_counts()
    got = tfast.decode_warp_batch([buf], M, (24, 24))
    assert tfast.decode_counts() == {"scale": {3: 1}, "failed": 0,
                                     "unsupported": 0, "warned": 0}
    jfast = _jfast()
    np.testing.assert_array_equal(
        got, jfast.decode_warp_batch([buf], M, (24, 24), dtype=np.uint8))
