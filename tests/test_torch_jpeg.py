"""The port's JPEG decoder (``native/jpegdec.cpp``, ``data/jpeg.py``)
against libjpeg-turbo, bit for bit.

Two libjpeg-turbo builds are the reference: OpenCV's (``cv2.imdecode``,
converted to RGB, EXIF orientation ignored) and the system's, through the
native loader built from ``native/fastloader.cpp``. Every committed
fixture (``tests/data/jpeg/``, its manifest's hashes included) and every
seeded case (each sampling and grayscale at four sizes and three
qualities, restart intervals, 16-bit quantization tables, components in
separate scans, chroma interleaved in a scan of its own, saturated
pixels, Pillow's optimized Huffman tables) must decode to equal arrays. Truncated or corrupt bytes
raise IOError; refused modes name themselves; neither the source nor the
build names libjpeg.
"""

import io
import json
import sys
import zlib

import cv2
import numpy as np
import pytest

import jpeg_fixtures as jf
from epipolarpose_tpu_torch.data import cxx_library, fastloader, jpeg
from epipolarpose_tpu_torch.data import zipreader as tzip

MANIFEST = json.loads((jf.FIXTURE_DIR / "manifest.json").read_text())


def _native_decode(buf: bytes):
    """The system libjpeg-turbo's decode, or None where the native loader
    cannot build (no g++ or jpeglib.h)."""
    return fastloader.decode(buf) if fastloader.available() else None


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


@pytest.mark.parametrize("name", sorted(n for n, e in MANIFEST.items()
                                        if not e["mode"].startswith("refused")))
def test_fixture_decodes_as_libjpeg(name):
    buf = (jf.FIXTURE_DIR / name).read_bytes()
    got = _assert_decodes_as_libjpeg(buf, name)
    assert jf.rgb_sha256(got) == MANIFEST[name]["rgb_sha256"]
    assert jpeg.jpeg_info(buf) == (got.shape[1], got.shape[0],
                                   1 if name.startswith("gray") else 3)


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
        "pil_q100_444", "pil_gray"]


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


@pytest.mark.parametrize("case", _seeded_cases())
def test_seeded_case_decodes_as_libjpeg(case):
    buf = _seeded(case)
    if case == "sof1_16bit":
        assert b"\xff\xc1" in buf                  # SOF1 with 16-bit DQT
    _assert_decodes_as_libjpeg(buf, case)


@pytest.mark.parametrize("how", ["half", "headers", "before_eoi", "garbage",
                                 "empty", "bad_huffman", "bad_rst"])
def test_truncated_or_corrupt_bytes_raise(how):
    buf = jf.cv2_encode(jf.render(48, 64, 7), 90, restart=2)
    sos = buf.index(b"\xff\xda")
    if how == "half":
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
    return {
        "progressive": (prog, "progressive (SOF2)"),
        "arithmetic": (prog[:sof + 1] + b"\xc9" + prog[sof + 2:],
                       "arithmetic coding (SOF9)"),
        "12-bit": (prog[:sof + 1] + b"\xc0" + prog[sof + 2:sof + 4] + b"\x0c"
                   + prog[sof + 5:], "12-bit samples"),
        "cmyk": (_pil_cmyk(img), "CMYK/YCCK (4 components)"),
    }


def _pil_cmyk(rgb):
    from PIL import Image
    bio = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(bio, "JPEG", quality=90)
    return bio.getvalue()


@pytest.mark.parametrize("mode", ["progressive", "arithmetic", "12-bit",
                                  "cmyk"])
def test_refused_modes_are_named(mode):
    buf, named = _refused_cases()[mode]
    with pytest.raises(jpeg.UnsupportedJpeg) as e:
        jpeg.decode(buf)
    assert e.value.mode == named
    assert isinstance(e.value, IOError)


def test_decode_counter_counts_decodes():
    buf = (jf.FIXTURE_DIR / "s420_37x29.jpg").read_bytes()
    jpeg.reset_count()
    for _ in range(3):
        jpeg.decode(buf)
    with pytest.raises(IOError):
        jpeg.decode(buf[:100])
    assert jpeg.decode_count() == 3


def test_imread_takes_the_decoder_without_the_native_loader(tmp_path,
                                                            monkeypatch):
    name = "h36m_1000x1000.jpg"
    path = tmp_path / name
    path.write_bytes((jf.FIXTURE_DIR / name).read_bytes())
    monkeypatch.setattr(fastloader, "available", lambda: False)
    jpeg.reset_count()
    rgb = tzip.imread(str(path), rgb=True)
    bgr = tzip.imread(str(path))
    assert jpeg.decode_count() == 2
    assert jf.rgb_sha256(rgb) == MANIFEST[name]["rgb_sha256"]
    np.testing.assert_array_equal(bgr, rgb[..., ::-1])


def test_imread_sends_a_refused_mode_to_opencv(tmp_path, monkeypatch):
    """Progressive goes to OpenCV; without OpenCV it raises with the path
    and the mode."""
    name = "progressive_64x48.jpg"
    path = tmp_path / name
    path.write_bytes((jf.FIXTURE_DIR / name).read_bytes())
    monkeypatch.setattr(fastloader, "available", lambda: False)
    np.testing.assert_array_equal(tzip.imread(str(path), rgb=True),
                                  jf.libjpeg_rgb(path.read_bytes()))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="progressive") as e:
        tzip.imread(str(path))
    assert str(path) in str(e.value) and "OpenCV" in str(e.value)


def test_mutated_files_fail_cleanly_under_sanitizers(tmp_path):
    """Mutated and truncated fixtures through the decoder built with
    AddressSanitizer and UndefinedBehaviorSanitizer (``tests/jpeg_fuzz.cpp``):
    every call returns a status, none faults."""
    import shutil
    import subprocess
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++")
    exe = tmp_path / "jpeg_fuzz"
    build = subprocess.run(
        [cxx, "-O1", "-g", "-std=c++17", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=undefined", "-I", str(jpeg.SOURCE.parent),
         str(jf.FIXTURE_DIR.parents[1] / "jpeg_fuzz.cpp"), "-o", str(exe)],
        capture_output=True, text=True)
    if build.returncode:
        pytest.skip(f"g++ cannot build with sanitizers: {build.stderr[-300:]}")
    files = [str(jf.FIXTURE_DIR / n) for n, e in MANIFEST.items()
             if e["bytes"] < 5000]
    run = subprocess.run([str(exe), "300", *files], capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    ok, refused = map(int, run.stdout.split()[1::2])
    assert ok > len(files) and refused > len(files)


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
