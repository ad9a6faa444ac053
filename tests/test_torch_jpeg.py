"""The port's JPEG decoder (``native/jpegdec.cpp``, ``data/jpeg.py``)
against libjpeg-turbo, bit for bit.

Two libjpeg-turbo builds are the reference: OpenCV's (``cv2.imdecode``,
converted to RGB, EXIF orientation ignored; its reduced reads for the DCT
scales 1/8, 2/8 and 4/8) and the system's, through the JAX package's
native loader (``native/fastloader.cpp``, libjpeg; its crop by 3/8 reads
the 3/8 decode, ``jpeg_fixtures.libjpeg_rgb_3_8``). Every committed
fixture (``tests/data/jpeg/``, its manifest's hashes at every scale
included) and every seeded case (each sampling and grayscale at four
sizes and three qualities, restart intervals, 16-bit quantization
tables, components in separate scans, chroma interleaved in a scan of its
own, saturated pixels, Pillow's optimized Huffman tables, progressive
files of OpenCV and Pillow in 4:2:0, 4:4:4, 4:2:2, grayscale and with a
restart interval) must decode to equal arrays, at full size and at the
scales 1/8, 2/8 and 4/8; 3/8 on the cases whose sides are multiples of 8.
Truncated or corrupt bytes raise IOError (a truncated file's, which
libjpeg decodes with a warning, holds that decode); lossless,
hierarchical and 12-bit files are refused by name in the libjpeg flavour
(and by the native loader), as libjpeg-turbo 2.1 refuses them, and
hierarchical and 12-bit ones in OpenCV's too, where lossless files
(``tests/data/images/jpeg_lossless_*``, written by
``jpeg_fixtures.encode_lossless``) decode as OpenCV 5 decodes them; the
modes once refused decode as OpenCV decodes them; neither the source nor
the build names libjpeg. ``tests/test_torch_image_modes.py`` holds the
files of those modes (``tests/data/jpeg/modes/``) to libjpeg and to the
JAX package's readers.
"""

import json
import sys
import zlib

import cv2
import numpy as np
import pytest

import image_fixtures as imf
import jpeg_fixtures as jf
from epipolarpose_tpu_torch.data import cxx_library, fastloader, jpeg
from epipolarpose_tpu_torch.data import zipreader as tzip

MANIFEST = json.loads((jf.FIXTURE_DIR / "manifest.json").read_text())
# the lossless JPEGs OpenCV reads, and the lossless and 12-bit ones it
# gives no image of
LOSSLESS = sorted(p.name for p in imf.FIXTURE_DIR.glob("jpeg_lossless_*")
                  if "refused" not in p.name and "truncated" not in p.name)
NO_IMAGE = sorted(p.name for p in imf.FIXTURE_DIR.glob("jpeg_*refused*"))


def _native_decode(buf: bytes):
    """The system libjpeg-turbo's decode through the JAX package's native
    loader (an identity warp), or None where it cannot build (no g++ or
    jpeglib.h)."""
    from epipolarpose_tpu.data import fastloader as jfast
    if not jfast.available():
        return None
    w, h, _ = jpeg.jpeg_info(buf)
    eye = np.array([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]], np.float32)
    return jfast.decode_warp_batch([buf], eye, (w, h), dtype=np.uint8)[0]


def _assert_decodes_as_libjpeg(buf: bytes, name: str):
    got = jpeg.decode(buf)
    np.testing.assert_array_equal(got, jf.libjpeg_rgb(buf), err_msg=name)
    native = _native_decode(buf)
    if native is not None:
        np.testing.assert_array_equal(got, native, err_msg=name)
    return got


def test_decoder_builds_without_libjpeg():
    assert jpeg.available(), jpeg.build_error()
    path = jpeg.library_path()
    assert path.parent.name.startswith("jpegdec-")
    assert path.parent.parent == cxx_library.BUILD_DIR
    flags = " ".join(jpeg.CXX_FLAGS)
    assert "jpeg" not in flags and "-march" not in flags
    src = jpeg.SOURCE.read_text()
    assert "jpeglib" not in src and "#include <jpeg" not in src


def test_manifest_matches_libjpeg_here():
    """A stale manifest fails here, not first on the card."""
    names = sorted(p.name for p in jf.FIXTURE_DIR.glob("*.jpg"))
    assert names == sorted(MANIFEST)
    total = 0
    for name, entry in MANIFEST.items():
        buf = (jf.FIXTURE_DIR / name).read_bytes()
        total += len(buf)
        assert entry["bytes"] == len(buf), name
        rgb = jf.libjpeg_rgb(buf)
        assert rgb.shape == (entry["height"], entry["width"], 3), name
        assert jf.rgb_sha256(rgb) == entry["rgb_sha256"], name
    assert total < 1.5e6


def test_manifest_scaled_hashes_match_libjpeg_here():
    """Every file's hashes at 1/8, 2/8 and 4/8 (OpenCV), and at 3/8 where
    its sides are multiples of 8 (the JAX native loader; skipped where it
    cannot build, after the others)."""
    third = []
    for name, entry in MANIFEST.items():
        buf = (jf.FIXTURE_DIR / name).read_bytes()
        scales = entry["scaled_rgb_sha256"]
        square8 = entry["width"] % 8 == 0 and entry["height"] % 8 == 0
        want = ["1", "2", "3", "4"] if square8 else ["1", "2", "4"]
        assert sorted(scales) == want, name
        for s, digest in scales.items():
            if s == "3":
                third.append((name, buf, digest))
                continue
            rgb = jf.libjpeg_rgb(buf, int(s))
            assert rgb.shape == (-(-entry["height"] * int(s) // 8),
                                 -(-entry["width"] * int(s) // 8), 3), name
            assert jf.rgb_sha256(rgb) == digest, (name, s)
    for name, buf, digest in third:
        try:
            rgb = jf.libjpeg_rgb_3_8(buf)
        except RuntimeError as e:
            pytest.skip(f"3/8 unchecked: {e}")
        assert jf.rgb_sha256(rgb) == digest, (name, "3")


DECODED = sorted(n for n, e in MANIFEST.items()
                 if not e["mode"].startswith("refused"))


@pytest.mark.parametrize("name", DECODED)
def test_fixture_decodes_as_libjpeg(name):
    buf = (jf.FIXTURE_DIR / name).read_bytes()
    got = _assert_decodes_as_libjpeg(buf, name)
    assert jf.rgb_sha256(got) == MANIFEST[name]["rgb_sha256"]
    comps = 1 if "grayscale" in MANIFEST[name]["mode"] else 3
    assert jpeg.jpeg_info(buf) == (got.shape[1], got.shape[0], comps)


@pytest.mark.parametrize("name", DECODED)
def test_fixture_decodes_to_the_manifest_at_each_scale(name):
    """The manifest's libjpeg-turbo hashes at each DCT scale (what the
    card's host checks), and the size ``jpeg_info`` gives for it."""
    buf = (jf.FIXTURE_DIR / name).read_bytes()
    entry = MANIFEST[name]
    for s, digest in entry["scaled_rgb_sha256"].items():
        got = jpeg.decode(buf, int(s))
        assert jf.rgb_sha256(got) == digest, (name, s)
        assert jpeg.jpeg_info(buf, int(s))[:2] == (got.shape[1],
                                                   got.shape[0])


def test_exif_orientation_is_not_applied():
    """OpenCV rotates by EXIF orientation; libjpeg (the native loader) and
    the port do not."""
    buf = (jf.FIXTURE_DIR / "exif_orientation6_40x24.jpg").read_bytes()
    rotated = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    assert rotated.shape == (40, 24, 3)
    assert jpeg.decode(buf).shape == (24, 40, 3)


def _seeded_cases():
    cases = [(s, hw, q) for s in jf.SAMPLINGS + ("gray",)
             for hw in ((1, 1), (7, 13), (16, 16), (257, 331))
             for q in (50, 90, 100)]
    return [f"{s}-{h}x{w}-q{q}" for s, (h, w), q in cases] + [
        "restart-1", "restart-7", "sof1_16bit", "separate_scans_444",
        "separate_scans_420_restart", "separate_scans_422_chroma_together",
        "separate_scans_440_chroma_together_restart", "saturated-q100-444",
        "saturated-q50-420", "saturated-q5-420", "pil_optimized_huffman",
        "pil_q100_444", "pil_gray"] + PROGRESSIVE_CASES


# progressive files: OpenCV's scans (jcparam.c jpeg_simple_progression)
# and Pillow's with optimized tables, 4:2:0, 4:4:4, 4:2:2, grayscale, a
# restart interval; sides multiples of 8 (the 3/8 read) and not
PROGRESSIVE_CASES = [f"prog_{lib}_{s}_{h}x{w}" for lib in ("cv2", "pil")
                     for s in ("420", "444", "422", "gray")
                     for h, w in ((48, 64), (37, 53))] + [
    "prog_cv2_420_restart-3", "prog_cv2_444_restart-1",
    "prog_saturated_420"]


def _seeded(case: str) -> bytes:
    seed = zlib.crc32(case.encode())
    if case.startswith("restart"):
        n = int(case.split("-")[1])
        return jf.cv2_encode(jf.render(75, 93, seed), 90, "420", restart=n)
    if case == "sof1_16bit":
        qt = np.random.default_rng(seed).integers(256, 2048, (2, 64))
        return jf.pil_encode(jf.render(40, 67, seed), qtables=qt.tolist(),
                             subsampling=2)
    if case.startswith("separate_scans"):
        img = jf.render(53, 71, seed)
        if case.endswith("444"):
            return jf.encode_separate_scans(img, 90, (1, 1))
        if case.endswith("420_restart"):
            return jf.encode_separate_scans(img, 75, (2, 2), restart=3)
        # Y alone, then Cb and Cr in one interleaved scan
        if case.endswith("422_chroma_together"):
            return jf.encode_separate_scans(img, 80, (2, 1),
                                            chroma_together=True)
        return jf.encode_separate_scans(img, 80, (1, 2), restart=4,
                                        chroma_together=True)
    if case.startswith("saturated"):
        # black and white pixels: IDCT outputs far past 0..255, through the
        # range-limit table
        _, q, smp = case.split("-")
        img = np.random.default_rng(seed).integers(0, 2, (61, 83, 3)) * 255
        return jf.cv2_encode(img.astype(np.uint8), int(q[1:]), smp)
    if case.startswith("prog_"):
        return _progressive(case, seed)
    if case.startswith("pil_"):
        img = jf.render(47, 77, seed, noise=20.0)
        if case == "pil_gray":
            return jf.pil_encode(img[..., 0], quality=75)
        if case == "pil_q100_444":
            return jf.pil_encode(img, quality=100, subsampling=0)
        return jf.pil_encode(img, quality=85, optimize=True)
    s, hw, q = case.split("-")
    h, w = map(int, hw.split("x"))
    img = jf.render(h, w, seed, noise=8.0)
    if s == "gray":
        return jf.cv2_encode(img[..., 1], int(q[1:]))
    return jf.cv2_encode(img, int(q[1:]), s)


def _progressive(case: str, seed: int) -> bytes:
    if case == "prog_saturated_420":
        img = np.random.default_rng(seed).integers(0, 2, (61, 83, 3)) * 255
        return jf.cv2_encode(img.astype(np.uint8), 75, "420",
                             progressive=True)
    _, lib, s, size = case.split("_")
    if "-" in size:                            # a restart interval
        n = int(size.split("-")[1])
        return jf.cv2_encode(jf.render(75, 93, seed), 90, s, restart=n,
                             progressive=True)
    h, w = map(int, size.split("x"))
    img = jf.render(h, w, seed, noise=12.0)
    if lib == "cv2":
        if s == "gray":
            return jf.cv2_encode(img[..., 1], 85, progressive=True)
        return jf.cv2_encode(img, 85, s, progressive=True)
    kw = dict(quality=85, progressive=True, optimize=True)
    if s == "gray":
        return jf.pil_encode(img[..., 1], **kw)
    return jf.pil_encode(img, subsampling={"444": 0, "422": 1,
                                           "420": 2}[s], **kw)


@pytest.mark.parametrize("case", _seeded_cases())
def test_seeded_case_decodes_as_libjpeg(case):
    buf = _seeded(case)
    if case == "sof1_16bit":
        assert b"\xff\xc1" in buf                  # SOF1 with 16-bit DQT
    if case.startswith("prog"):
        assert b"\xff\xc2" in buf                  # SOF2
    _assert_decodes_as_libjpeg(buf, case)


@pytest.mark.parametrize("case", _seeded_cases())
def test_seeded_case_decodes_as_libjpeg_at_each_scale(case):
    """1/8 (IDCT 1x1, no fancy upsampling), 2/8 and 4/8 (jidctred.c's
    reduced IDCTs, chroma scaled up by IDCT where that makes upsampling
    1:1) against OpenCV's reduced reads."""
    buf = _seeded(case)
    for s in jf.SCALES:
        np.testing.assert_array_equal(jpeg.decode(buf, s),
                                      jf.libjpeg_rgb(buf, s),
                                      err_msg=f"{case} at {s}/8")


# every sampling, baseline and progressive, with sides multiples of 8
THREE_EIGHTHS = [f"{mode}_{s}" for mode in ("baseline", "progressive")
                 for s in jf.SAMPLINGS + ("gray",)] + [
    "restart_420", "pil_progressive_444", "separate_scans_420"]


def _three_eighths_case(case: str) -> bytes:
    img = jf.render(48, 72, zlib.crc32(case.encode()), noise=12.0)
    if case == "restart_420":
        return jf.cv2_encode(img, 90, "420", restart=2)
    if case == "pil_progressive_444":
        return jf.pil_encode(img, quality=90, subsampling=0,
                             progressive=True, optimize=True)
    if case == "separate_scans_420":
        return jf.encode_separate_scans(img, 85, (2, 2), restart=3)
    mode, s = case.split("_")
    kw = dict(progressive=mode == "progressive")
    if s == "gray":
        return jf.cv2_encode(img[..., 0], 90, **kw)
    return jf.cv2_encode(img, 90, s, **kw)


@pytest.mark.parametrize("case", THREE_EIGHTHS)
def test_three_eighths_matches_the_jax_native_loader(case):
    """3/8 (jidctint.c's 3x3, and 6x6 for 4:2:0 chroma) against the
    system's libjpeg-turbo, read through the JAX native loader's exact
    3/8 crop."""
    buf = _three_eighths_case(case)
    try:
        want = jf.libjpeg_rgb_3_8(buf)
    except RuntimeError as e:
        pytest.skip(str(e))
    got = jpeg.decode(buf, 3)
    assert got.shape == (18, 27, 3)
    np.testing.assert_array_equal(got, want, err_msg=case)


def _scan_offsets(buf: bytes) -> list:
    return [i for i in range(len(buf) - 1) if buf[i:i + 2] == b"\xff\xda"]


@pytest.mark.parametrize("how", ["half", "headers", "before_eoi", "garbage",
                                 "empty", "bad_huffman", "bad_rst",
                                 "progressive_half", "progressive_bad_band",
                                 "progressive_bad_al"])
def test_truncated_or_corrupt_bytes_raise(how):
    buf = jf.cv2_encode(jf.render(48, 64, 7), 90, restart=2)
    sos = buf.index(b"\xff\xda")
    if how.startswith("progressive"):
        buf = jf.cv2_encode(jf.render(48, 64, 7), 90, restart=2,
                            progressive=True)
        # the second scan, an AC scan of one component: its header's Ss,
        # Se and Ah/Al follow the marker, the length, Ns and one selector
        ss = _scan_offsets(buf)[1] + 7
    if how == "progressive_half":
        bad = buf[:len(buf) // 2]
    elif how == "progressive_bad_band":
        bad = buf[:ss] + bytes([buf[ss + 1] + 1, buf[ss + 1]]) + buf[ss + 2:]
    elif how == "progressive_bad_al":
        bad = buf[:ss + 2] + b"\x0e" + buf[ss + 3:]        # Al 14
    elif how == "half":
        bad = buf[:len(buf) // 2]
    elif how == "headers":
        bad = buf[:sos + 6]
    elif how == "before_eoi":
        bad = buf[:-2]
    elif how == "garbage":
        bad = b"\xff\xd8not a jpeg"
    elif how == "empty":
        bad = b""
    elif how == "bad_huffman":
        # every DHT code count set to 255: an over-full code space
        dht = buf.index(b"\xff\xc4")
        bad = buf[:dht + 5] + b"\xff" * 16 + buf[dht + 21:]
    else:
        rst = buf.index(b"\xff\xd0", sos)
        bad = buf[:rst + 1] + b"\xd5" + buf[rst + 2:]   # RST5 for RST0
    with pytest.raises(IOError) as e:
        jpeg.decode(bad)
    assert not isinstance(e.value, jpeg.UnsupportedJpeg)


def _refused_cases():
    img = jf.render(24, 32, 3)
    prog = jf.cv2_encode(img, 90, progressive=True)
    sof = prog.index(b"\xff\xc2")
    base = jf.cv2_encode(img, 90)
    sof0 = base.index(b"\xff\xc0")
    # the file cut after its DC refinement scan: AC coefficients 1-9 are
    # left unfinished, which libjpeg block-smooths
    unfinished = prog[:_scan_offsets(prog)[7]] + b"\xff\xd9"
    sub44 = jf.encode_separate_scans(jf.render(64, 64, 3), 85, (4, 4))
    return {
        # refused, naming the mode, as libjpeg-turbo 2.1 refuses them
        "lossless": (base[:sof0 + 1] + b"\xc3" + base[sof0 + 2:],
                     "lossless (SOF3)"),
        "hierarchical": (base[:sof0 + 1] + b"\xc5" + base[sof0 + 2:],
                         "hierarchical (SOF5)"),
        "12-bit": (prog[:sof + 1] + b"\xc0" + prog[sof + 2:sof + 4] + b"\x0c"
                   + prog[sof + 5:], "12-bit samples"),
        # decoded as libjpeg decodes them: Huffman data read as arithmetic
        # coding (progressive, and sequential, whose later scans libjpeg
        # refuses after the first), CMYK, block smoothing, the 12x12 IDCT
        "progressive": (prog[:sof + 1] + b"\xca" + prog[sof + 2:], None),
        "arithmetic": (prog[:sof + 1] + b"\xc9" + prog[sof + 2:], None),
        "cmyk": (jf.pil_cmyk(img), None),
        "block_smoothing": (unfinished, None),
        "idct_12": (sub44, None),
    }


def _opencv_rgb(buf: bytes, scale_num: int):
    """OpenCV's (reduced) read, RGB, EXIF orientation ignored; None where
    it gives no image."""
    flag = {1: cv2.IMREAD_REDUCED_COLOR_8, 2: cv2.IMREAD_REDUCED_COLOR_4,
            4: cv2.IMREAD_REDUCED_COLOR_2, 8: cv2.IMREAD_COLOR}[scale_num]
    img = cv2.imdecode(np.frombuffer(buf, np.uint8),
                       flag | cv2.IMREAD_IGNORE_ORIENTATION)
    return None if img is None else img[..., ::-1]


@pytest.mark.parametrize("mode", ["progressive", "arithmetic", "12-bit",
                                  "cmyk", "block_smoothing", "idct_12",
                                  "lossless", "hierarchical"])
def test_refused_modes_are_named(mode):
    """Lossless, hierarchical and 12-bit files are refused, naming the
    mode, as libjpeg-turbo 2.1 refuses them. The name is historical for
    the others, which the decoder once refused: each decodes now to
    OpenCV's bits at 1/8, 2/8, 4/8 and 8/8 (its flavour: libjpeg-turbo
    3.1's block smoothing, and the first scan of a one-scan file kept),
    and the 12x12 IDCT at 3/8 to the JAX native loader's 3/8 read."""
    buf, named = _refused_cases()[mode]
    if named:
        with pytest.raises(jpeg.UnsupportedJpeg) as e:
            jpeg.decode(buf, flavour="libjpeg")
        assert e.value.mode == named
        assert isinstance(e.value, IOError)
        return
    for s in (*jf.SCALES, 8):
        np.testing.assert_array_equal(
            jf.port_rgb(buf, s, "opencv"),
            _opencv_rgb(buf, s), err_msg=f"{mode} at {s}/8")
    if mode == "idct_12":
        try:
            want = jf.libjpeg_rgb_3_8(buf)
        except RuntimeError as e:
            pytest.skip(str(e))
        np.testing.assert_array_equal(jpeg.decode(buf, 3), want)


def test_unfinished_progressive_files_are_what_libjpeg_smooths():
    """Each cut of a progressive file before its last scan leaves
    coefficients unfinished, and libjpeg block-smooths it: OpenCV's bits
    in its flavour at each scale, the JAX native loader's (libjpeg-turbo
    2.1) at 3/8 in the default one; the whole file needs no smoothing."""
    prog = jf.cv2_encode(jf.render(40, 56, 5), 90, "444", progressive=True)
    scans = _scan_offsets(prog)
    assert len(scans) == 10
    for k in scans[1:]:
        cut = prog[:k] + b"\xff\xd9"
        for s in (*jf.SCALES, 8):
            np.testing.assert_array_equal(
                jpeg.decode(cut, s, flavour="opencv"), _opencv_rgb(cut, s))
        try:
            want = jf.libjpeg_rgb_3_8(cut)
        except RuntimeError:
            continue
        np.testing.assert_array_equal(jpeg.decode(cut, 3), want)
    np.testing.assert_array_equal(jpeg.decode(prog), jf.libjpeg_rgb(prog))


@pytest.mark.parametrize("scale_num", [0, 9])
def test_scales_outside_one_to_eight_are_bad_arguments(scale_num):
    buf = (jf.FIXTURE_DIR / "s420_37x29.jpg").read_bytes()
    with pytest.raises(IOError, match="not in 1..8") as e:
        jpeg.decode(buf, scale_num)
    assert not isinstance(e.value, jpeg.UnsupportedJpeg)


def test_decode_counter_counts_decodes():
    buf = (jf.FIXTURE_DIR / "s420_37x29.jpg").read_bytes()
    jpeg.reset_count()
    for _ in range(3):
        jpeg.decode(buf)
    with pytest.raises(IOError):
        jpeg.decode(buf[:100])
    assert jpeg.decode_count() == 3


def test_imread_takes_the_decoder_without_the_native_loader(tmp_path):
    """imread decodes with the port's decoder, never through the native
    loader's library (which holds the same decoder)."""
    name = "h36m_1000x1000.jpg"
    path = tmp_path / name
    path.write_bytes((jf.FIXTURE_DIR / name).read_bytes())
    jpeg.reset_count()
    fastloader.reset_counts()
    rgb = tzip.imread(str(path), rgb=True)
    bgr = tzip.imread(str(path))
    assert jpeg.decode_count() == 2
    assert fastloader.decode_counts() == {"scale": {}, "failed": 0,
                                         "unsupported": 0, "warned": 0}
    assert jf.rgb_sha256(rgb) == MANIFEST[name]["rgb_sha256"]
    np.testing.assert_array_equal(bgr, rgb[..., ::-1])


def test_imread_sends_a_refused_mode_to_opencv(tmp_path, monkeypatch):
    """A JPEG mode the decoder refuses (12-bit) went to OpenCV, which gives
    no image of it either: the port raises IOError itself, naming the
    mode, with OpenCV (as OpenCV's None) and without it (fault C8), and
    never imports OpenCV for it. CMYK and progressive files no longer go
    there, nor does a PNG (the port's PNG decoder reads it, not counted
    as a JPEG decode)."""
    png = tmp_path / "frame_32x24.png"
    img = jf.render(24, 32, 3)
    png.write_bytes(cv2.imencode(".png", img[..., ::-1])[1].tobytes())
    twelve = tmp_path / "twelve_bit_32x24.jpg"
    twelve.write_bytes(_refused_cases()["12-bit"][0])
    cmyk = tmp_path / "cmyk_32x24.jpg"
    cmyk.write_bytes(_refused_cases()["cmyk"][0])
    assert cv2.imread(str(twelve), cv2.IMREAD_COLOR) is None
    with pytest.raises(IOError, match="12-bit") as e:
        tzip.imread(str(twelve))
    assert not isinstance(e.value, ImportError)
    jpeg.reset_count()
    np.testing.assert_array_equal(tzip.imread(str(png), rgb=True), img)
    want_cmyk = _opencv_rgb(cmyk.read_bytes(), 8)
    prog = tmp_path / "progressive_64x48.jpg"
    prog.write_bytes((jf.FIXTURE_DIR / prog.name).read_bytes())
    want = jf.libjpeg_rgb(prog.read_bytes())
    monkeypatch.setitem(sys.modules, "cv2", None)
    tzip.reset_route_counts()
    np.testing.assert_array_equal(tzip.imread(str(prog), rgb=True), want)
    np.testing.assert_array_equal(tzip.imread(str(cmyk), rgb=True),
                                  want_cmyk)
    assert jpeg.decode_count() == 2            # the PNG not counted
    with pytest.raises(IOError, match="12-bit") as e:
        tzip.imread(str(twelve))
    assert str(twelve) in str(e.value)
    assert tzip.route_counts()["opencv"] == 0
    np.testing.assert_array_equal(tzip.imread(str(png), rgb=True), img)
    assert jpeg.decode_count() == 2


@pytest.fixture(scope="module")
def sanitized_fuzz(tmp_path_factory):
    """``tests/jpeg_fuzz.cpp`` built once with AddressSanitizer and
    UndefinedBehaviorSanitizer."""
    import shutil
    import subprocess
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++")
    exe = tmp_path_factory.mktemp("fuzz") / "jpeg_fuzz"
    build = subprocess.run(
        [cxx, "-O1", "-g", "-std=c++17", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=undefined", "-I", str(jpeg.SOURCE.parent),
         str(jf.FIXTURE_DIR.parents[1] / "jpeg_fuzz.cpp"), "-o", str(exe)],
        capture_output=True, text=True)
    if build.returncode:
        pytest.skip(f"g++ cannot build with sanitizers: {build.stderr[-300:]}")
    return exe


def test_mutated_files_fail_cleanly_under_sanitizers(sanitized_fuzz):
    """Mutated and truncated fixtures, the progressive ones among them
    (EOB runs, refinement scans) and those of ``modes/`` (arithmetic
    coding, block smoothing, truncated data, 4x4 sampling, YCCK), through
    the decoder built with AddressSanitizer and UndefinedBehaviorSanitizer
    (``tests/jpeg_fuzz.cpp``), each at full size and at a DCT scale of 1/8
    to 4/8, in every flavour: every call returns a status, none faults."""
    import subprocess
    exe = sanitized_fuzz
    files = [str(jf.FIXTURE_DIR / n) for n, e in MANIFEST.items()
             if e["bytes"] < 5000]
    progressive = [f for f in files if "progressive" in f]
    assert len(progressive) >= 4
    modes = json.loads((jf.MODES_DIR / "manifest.json").read_text())
    mode_files = [str(jf.MODES_DIR / n) for n, e in modes.items()
                  if e["bytes"] < 5000]
    for kind in ("arith_", "smooth_", "trunc_", "s4x4_", "ycck_"):
        assert sum(kind in f for f in mode_files) >= 2, kind
    # 300 mutations of each fixture, 60 of each file of modes/
    for count, names in (("300", files), ("60", mode_files)):
        run = subprocess.run([str(exe), count, *names], capture_output=True,
                             text=True, timeout=120)
        assert run.returncode == 0, run.stderr[-2000:]
        ok, refused, ok_scaled = map(int, run.stdout.split()[1::2])
        assert ok > len(names) and refused > len(names)
        assert ok_scaled > len(names)


def test_parallel_decodes_match_the_manifest():
    """Decodes on 8 threads at once (the datasets' thread pool) give the
    serial bits: the decoder keeps no shared mutable state."""
    from concurrent.futures import ThreadPoolExecutor
    names = [n for n, e in MANIFEST.items()
             if not e["mode"].startswith("refused")] * 2
    bufs = [(jf.FIXTURE_DIR / n).read_bytes() for n in names]
    with ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(jpeg.decode, bufs))
    for name, rgb in zip(names, outs):
        assert jf.rgb_sha256(rgb) == MANIFEST[name]["rgb_sha256"], name


@pytest.mark.parametrize("name", LOSSLESS)
def test_lossless_files_decode_as_opencv_reads_them(name):
    """Each lossless fixture OpenCV reads: OpenCV's flavour gives its
    bits (libjpeg-turbo 3.1's predictors, point transform, restarts and
    replicated chroma; RGB as coded, CMYK converted as OpenCV converts
    it), the size ``jpeg_info`` gives is its size, and the libjpeg flavour
    refuses the file by name, as libjpeg-turbo 2.1 does."""
    buf = (imf.FIXTURE_DIR / name).read_bytes()
    want = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    got = jpeg.decode(buf, flavour="opencv")
    np.testing.assert_array_equal(got, want[..., ::-1])
    assert jpeg.jpeg_info(buf, 8, "opencv")[:2] == (got.shape[1],
                                                     got.shape[0])
    with pytest.raises(jpeg.UnsupportedJpeg) as e:
        jpeg.decode(buf, flavour="libjpeg")
    assert e.value.mode == "lossless (SOF3)"


@pytest.mark.parametrize("name", NO_IMAGE)
def test_modes_opencv_reads_none_of_are_refused_by_name(name):
    """Lossless files of other colour spaces or precisions and 12-bit
    files (SOF1 at 12 bits, 16-bit quantization tables), which OpenCV 5
    gives no image of: refused in both flavours, naming the mode, before
    any pixel is decoded; hierarchical files too. A restart interval of
    part of an MCU row is an error (libjpeg-turbo 3.1 refuses it)."""
    buf = (imf.FIXTURE_DIR / name).read_bytes()
    assert cv2.imdecode(np.frombuffer(buf, np.uint8),
                        cv2.IMREAD_COLOR) is None
    for flavour in ("libjpeg", "opencv"):
        with pytest.raises(IOError) as e:
            jpeg.decode(buf, flavour=flavour)
        if "restart" in name:
            assert flavour == "libjpeg" or "restart interval" in str(e.value)
            continue
        assert isinstance(e.value, jpeg.UnsupportedJpeg)
        words = ("lossless", "12-bit", "16-bit")
        assert any(w in e.value.mode for w in words), e.value.mode
    base = jf.encode_lossless([np.zeros((8, 8), np.uint8)] * 3)
    sof = base.index(b"\xff\xc3")
    for kind in (5, 6, 7):
        hier = base[:sof + 1] + bytes([0xC0 + kind]) + base[sof + 2:]
        for flavour in ("libjpeg", "opencv"):
            with pytest.raises(jpeg.UnsupportedJpeg, match="hierarchical"):
                jpeg.decode(hier, flavour=flavour)


def test_the_native_loader_refuses_lossless_and_12bit_frames():
    """The native loader decodes with the libjpeg flavour: a lossless or
    12-bit frame gives a zero crop and counts as unsupported, as the JAX
    loader's libjpeg-turbo 2.1 refuses it; an ordinary frame beside it
    is decoded."""
    frames = [(imf.FIXTURE_DIR / n).read_bytes()
              for n in ("jpeg_lossless_psv1.jpg",
                        "jpeg_12bit_sof1_refused.jpg",
                        "jpeg_8bit_twin_of_12bit.jpg")]
    M = np.tile(np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32),
                (3, 1, 1))
    fastloader.reset_counts()
    out = fastloader.decode_warp_batch(frames, M, (16, 16))
    assert not out[0].any() and not out[1].any() and out[2].any()
    assert fastloader.decode_counts() == {"scale": {8: 1}, "failed": 2,
                                         "unsupported": 2, "warned": 0}
    from epipolarpose_tpu.data import fastloader as jfast
    if jfast.available():
        np.testing.assert_array_equal(
            out, jfast.decode_warp_batch(frames, M, (16, 16),
                                         dtype=np.uint8))


def test_the_fixture_encoders_write_valid_files():
    """``encode_dct`` writes what OpenCV reads at 8 bits (within the
    quantization's error), so its 12-bit files differ from valid ones in
    the precision and the tables only; ``encode_lossless`` round-trips
    through OpenCV exactly."""
    img = jf.render(21, 26, 3)
    buf = jf.encode_dct(img, 8, 2, ids=jf.RGB_IDS)
    got = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    assert np.abs(got[..., ::-1].astype(int) - img).max() <= 3
    twelve = (imf.FIXTURE_DIR / "jpeg_12bit_sof1_refused.jpg").read_bytes()
    sof = twelve.index(b"\xff\xc1")
    assert twelve[sof + 4] == 12
    buf = jf.encode_lossless([img[..., c] for c in range(3)], psv=4)
    got = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(got[..., ::-1], img)


def test_lossless_files_fail_cleanly_under_sanitizers(sanitized_fuzz):
    """Mutated and truncated lossless fixtures (restarts, subsampling, a
    scan a component, CMYK, 2-7 bits) through the decoder built with
    AddressSanitizer and UndefinedBehaviorSanitizer
    (``tests/jpeg_fuzz.cpp``), in every flavour: every call returns a
    status, none faults."""
    import subprocess
    files = [str(imf.FIXTURE_DIR / n) for n in LOSSLESS]
    run = subprocess.run([str(sanitized_fuzz), "150", *files],
                         capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    ok, refused, _ = map(int, run.stdout.split()[1::2])
    assert ok > len(files) and refused > len(files)
