"""TIFF files give the JAX package's pixels in the port, without OpenCV.

The JAX package reads every image through OpenCV 5 (libtiff 4.7 for
TIFF); the card's machine has no OpenCV, so the port reads TIFF itself
(``data/tiff.py``, with LZW, PackBits and the predictor in
``native/imgdec.cpp``). ``tests/test_torch_image_formats.py`` holds each
fixture of ``tests/data/images/`` (``tiff_*``) to ``cv2.imread``,
``cv2.imdecode`` and the JAX imread; this file holds the rest: what the
fixtures cover, seeded damage (truncations and byte changes of each kind
of file, against OpenCV from a path and from memory), the files the port
leaves to OpenCV and those OpenCV refuses, without OpenCV, the route and
decode counts, threads, a large frame, and the codecs under AddressSanitizer
and UndefinedBehaviorSanitizer.
"""

import json
import shutil
import struct
import subprocess
import sys
import zipfile
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest

import image_fixtures as imf
import jpeg_fixtures as jf
from epipolarpose_tpu_torch.data import imgformats, jpeg, png, tiff
from epipolarpose_tpu_torch.data import zipreader as tzip

MANIFEST = json.loads((imf.FIXTURE_DIR / "manifest.json").read_text())
TIFFS = sorted(n for n in MANIFEST if n.startswith("tiff_"))
# the bases of the damage check: one file of each layout and codec
DAMAGED = ("tiff_rgb8_lzw_II_planar1.tif", "tiff_rgb16_lzw_MM_planar2.tif",
           "tiff_grey8_black_packbits.tif", "tiff_grey1_white_none.tif",
           "tiff_tiles16x16_lzw.tif", "tiff_tiles16x16_lzw_planar.tif",
           "tiff_palette4_16bit_map.tif", "tiff_bigtiff_MM.tif",
           "tiff_rgba8_unassociated_planar2.tif", "tiff_cv2_lzw.tif",
           "tiff_orientation6_11x7.tif", "tiff_jpeg_ycbcr420_strips.tif",
           "tiff_rgb8_deflate_II_planar1.tif", "tiff_tiles32x32_none.tif")
MUTATIONS = 50


def _opencv(read):
    try:
        return read()
    except cv2.error:
        return "raises"


def _port(path: str):
    """The port's image, None for IOError, "raises" for OpenCV's size
    limits, "opencv" where the port leaves the file to OpenCV."""
    try:
        img, orientation = tiff.decode(tzip.read_file_bytes(path),
                                       not tzip.is_zip_path(path))
        return tzip.apply_orientation(img, orientation)[..., ::-1]
    except imgformats.NeedsOpenCV:
        return "opencv"
    except imgformats.ImageTooLarge:
        return "raises"
    except IOError:
        return None


def _same(got, want) -> bool:
    if isinstance(got, np.ndarray) and isinstance(want, np.ndarray):
        return got.shape == want.shape and bool((got == want).all())
    return type(got) is type(want) and (got is None or got == want)


def _fields(name: str) -> dict:
    d = tiff._Directory((imf.FIXTURE_DIR / name).read_bytes())
    return {tag: d.read(tag)[1] for tag in d.entries if d.read(tag)}


def test_the_fixtures_cover_what_opencv_reads():
    """Among the TIFFs OpenCV reads: every compression the port decodes,
    both byte orders, BigTIFF, tiles and strips, planar, 1 to 16 bits,
    grey (both photometrics), RGB, palette, alpha of each kind, the
    Orientation tag 1-8 and JPEG with JPEGTables; and files OpenCV gives
    no image of, one it raises on, and one it alone reads."""
    read = [n for n in TIFFS if MANIFEST[n]["imread_sha256"]
            not in (None, "raises") and not MANIFEST[n]["needs_opencv"]]
    seen = {"compression": set(), "photometric": set(), "bits": set(),
            "planar": set(), "orientation": set(), "extra": set()}
    tiled = big = motorola = tables = 0
    for name in read:
        f = _fields(name)
        buf = (imf.FIXTURE_DIR / name).read_bytes()
        seen["compression"].add(f.get(tiff.COMPRESSION, (1,))[0])
        seen["photometric"].add(f[tiff.PHOTOMETRIC][0])
        seen["bits"].add(f.get(tiff.BITS, (1,))[0])
        seen["planar"].add(f.get(tiff.PLANAR, (1,))[0])
        seen["orientation"].add(f.get(tiff.ORIENTATION, (1,))[0])
        seen["extra"].update(f.get(tiff.EXTRA_SAMPLES, ()))
        tiled += tiff.TILE_WIDTH in f
        big += buf[2:4] in (b"+\0", b"\0+")
        motorola += buf[:2] == b"MM"
        tables += tiff.JPEG_TABLES in f
    assert seen["compression"] == set(tiff.DECODED)
    assert seen["photometric"] >= {0, 1, 2, 3, 6}
    assert seen["bits"] == {1, 4, 8, 16}
    assert seen["planar"] == {1, 2} and seen["extra"] == {0, 1, 2}
    assert seen["orientation"] == set(range(9))
    assert tiled >= 6 and big == 2 and motorola >= 8 and tables >= 4
    outcomes = [MANIFEST[n]["imread_sha256"] for n in TIFFS]
    assert outcomes.count(None) >= 15 and outcomes.count("raises") == 1
    assert [n for n in TIFFS if MANIFEST[n]["needs_opencv"]] \
        == ["tiff_pillow_g4.tif"]
    # from memory OpenCV turns a non-square image by Orientation 5-8,
    # from a file it gives none
    for o in range(5, 9):
        entry = MANIFEST[f"tiff_orientation{o}_11x7.tif"]
        assert entry["imread_sha256"] is None
        assert entry["imdecode_sha256"] is not None


def test_the_writers_round_trip():
    """The fixtures' LZW and PackBits writers against the port's
    decoders, on data that fills the LZW table several times over."""
    rng = np.random.default_rng(3)
    data = (rng.integers(0, 4, 200_000).astype(np.uint8).tobytes()
            + bytes(5000) + rng.integers(0, 256, 9000).astype(np.uint8)
            .tobytes())
    for fn, coder in (("epk_tiff_lzw", imf.tiff_lzw),
                      ("epk_tiff_packbits", imf.packbits)):
        out = np.zeros(len(data), np.uint8)
        written, whole = tiff._native(fn, coder(data), out)
        assert whole and written == len(data) and out.tobytes() == data


def _mutations(buf: bytes, seed: int):
    """Seeded truncations and changes of one to three bytes, half of the
    changes in the first 64 bytes and the directory (the header and the
    tags), half anywhere."""
    rng = np.random.default_rng(seed)
    ifd = tiff._Directory(buf)
    head = [k for k in range(len(buf)) if k < 64] + list(range(
        min(e[2] for e in ifd.entries.values()) - 12, len(buf)))
    for k in range(MUTATIONS):
        b = bytearray(buf)
        if k % 4 == 0:
            yield bytes(b[:rng.integers(8, len(b))])
            continue
        for _ in range(1 + k % 3):
            i = int(rng.choice(head)) if k % 2 else \
                int(rng.integers(4, len(b)))
            i = min(max(i, 4), len(b) - 1)
            b[i] = int(rng.choice([rng.integers(0, 256), b[i] ^ 1,
                                   b[i] ^ 0x80, 0, 255]))
        yield bytes(b)


@pytest.mark.parametrize("name", DAMAGED)
def test_damaged_tiffs_read_as_opencv_reads_them(name, tmp_path):
    """Truncations and byte changes: wherever OpenCV gives no image the
    port raises IOError, wherever it raises the port raises
    ImageTooLarge, wherever it reads the file the port gives its bits,
    from a path and from a zip member (libtiff's reader shows a strip
    whose data runs out with zeros past what it decoded). The damage the
    port leaves to OpenCV (a corrupt Deflate or JPEG stream, an
    irregular directory) is a minority of the cases."""
    base = (imf.FIXTURE_DIR / name).read_bytes()
    zpath = tmp_path / "m.zip"
    cases = list(_mutations(base, seed=len(name)))
    with zipfile.ZipFile(zpath, "w") as z:
        for i, b in enumerate(cases):
            (tmp_path / f"{i}.tif").write_bytes(b)
            z.writestr(f"{i}.tif", b)
    decided = refused = 0
    for i, b in enumerate(cases):
        for where, read in (
                (str(tmp_path / f"{i}.tif"),
                 lambda: cv2.imread(str(tmp_path / f"{i}.tif"),
                                    cv2.IMREAD_COLOR)),
                (f"{zpath}@/{i}.tif",
                 lambda: cv2.imdecode(np.frombuffer(b, np.uint8),
                                      cv2.IMREAD_COLOR))):
            got = _port(where)
            if isinstance(got, str) and got == "opencv":
                continue
            want = _opencv(read)
            assert _same(got, want), (i, where)
            decided += 1
            refused += want is None
    assert refused > 0
    assert decided >= 1.2 * len(cases), (decided, len(cases))


def _hand_tiff(compression: int, photometric: int, c: int = 3,
               tags=None) -> bytes:
    img = jf.render(12, 16, 3)[..., :c]
    return imf.tiff_bytes(img, 8, photometric, compression=compression,
                          tags=tags or {})


@pytest.mark.parametrize("what,buf", [
    ("CCITT G4 compression",
     (imf.FIXTURE_DIR / "tiff_pillow_g4.tif").read_bytes()),
    ("old-style JPEG compression", None),
    ("uncompressed YCbCr", None), ("PhotometricInterpretation 5", None),
    ("FillOrder 2", None)])
def test_tiffs_left_to_opencv_name_themselves(what, buf, tmp_path,
                                              monkeypatch):
    """What the port leaves to OpenCV goes there (the JAX package's
    pixels, the ``opencv`` route); without OpenCV the ImportError names
    the file and what it holds."""
    if buf is None:
        buf = {"old-style JPEG compression":
               _hand_tiff(6, 6, tags={530: (3, [1, 1])}),
               "uncompressed YCbCr": _hand_tiff(1, 6,
                                                tags={530: (3, [1, 1])}),
               "PhotometricInterpretation 5": imf.tiff_bytes(
                   jf.render(12, 16, 3).astype(np.int64)[..., [0, 1, 2, 0]],
                   8, 5),
               "FillOrder 2": _hand_tiff(1, 2, tags={266: (3, [2])})}[what]
    path = tmp_path / "frame.tif"
    path.write_bytes(buf)
    with pytest.raises(imgformats.NeedsOpenCV, match=what):
        tiff.decode(buf)
    want = _opencv(lambda: cv2.imread(str(path), cv2.IMREAD_COLOR))
    tzip.reset_route_counts()
    try:
        got = tzip.imread(str(path))
    except IOError:
        got = None
    assert _same(got, want)
    assert tzip.route_counts()["tiff"] == 0
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match=f"a TIFF file .*{what}") as e:
        tzip.imread(str(path))
    assert str(path) in str(e.value)


@pytest.mark.parametrize("name", [
    "tiff_zstd_refused.tif", "tiff_lzma_refused.tif", "tiff_webp_refused.tif",
    "tiff_cv2_float32.tif", "tiff_grey12_refused.tif",
    "tiff_predictor3_refused.tif", "tiff_lzw_strip_empty_refused.tif"])
def test_tiffs_opencv_refuses_raise_ioerror_without_opencv(name,
                                                           monkeypatch):
    """Where OpenCV gives no image (a compression its libtiff has no
    codec for, float samples, 12 bits, Predictor 3 of integers, a strip
    of no bytes) the port
    raises IOError itself, without OpenCV too: no ImportError."""
    assert MANIFEST[name]["imread_sha256"] is None
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(IOError) as e:
        tzip.imread(str(imf.FIXTURE_DIR / name))
    assert not isinstance(e.value, ImportError)


def test_tiffs_take_the_ports_route_without_opencv(tmp_path, monkeypatch):
    """Every TIFF the port reads goes through ``data/tiff.py`` (counted)
    and never to OpenCV, from a path and a zip member, whatever its
    suffix; JPEG-compressed ones through the port's JPEG decoder (a
    decode a strip); OpenCV's hashes from the manifest."""
    zpath = tmp_path / "t.zip"
    names = [n for n in TIFFS if not MANIFEST[n]["needs_opencv"] and all(
        MANIFEST[n][k] not in (None, "raises")
        for k in ("imread_sha256", "imdecode_sha256"))]
    with zipfile.ZipFile(zpath, "w") as z:
        for n in names:
            z.write(imf.FIXTURE_DIR / n, f"in/{n[:-4]}.jpg")
    monkeypatch.setitem(sys.modules, "cv2", None)
    tzip.reset_route_counts()
    tiff.reset_count()
    jpeg.reset_count()
    for n in names:
        img = tzip.imread(str(imf.FIXTURE_DIR / n))
        assert imf.sha256(img) == MANIFEST[n]["imread_sha256"], n
        img = tzip.imread(f"{zpath}@/in/{n[:-4]}.jpg")
        assert imf.sha256(img) == MANIFEST[n]["imdecode_sha256"], n
    assert tzip.route_counts() == dict(jpeg=0, png=0, pnm=0, bmp=0,
                                       tiff=2 * len(names), opencv=0)
    assert tiff.decode_count() == 2 * len(names)
    strips = sum(len(tiff._Image(tiff._Directory(
        (imf.FIXTURE_DIR / n).read_bytes()), True).offsets)
        for n in names if "jpeg" in n)
    assert jpeg.decode_count() == 2 * strips > 0


def test_tiff_decodes_the_same_on_threads():
    """The pool loader's threads decode TIFFs side by side (the native
    pass and zlib release the interpreter lock); the images are the
    serial ones."""
    bufs = [(imf.FIXTURE_DIR / n).read_bytes() for n in TIFFS
            if MANIFEST[n]["imread_sha256"] not in (None, "raises")
            and not MANIFEST[n]["needs_opencv"]]
    serial = [tiff.decode(b)[0] for b in bufs]
    with ThreadPoolExecutor(8) as pool:
        for got, want in zip(pool.map(tiff.decode, bufs), serial):
            np.testing.assert_array_equal(got[0], want)


@pytest.mark.parametrize("compression,predictor", [(5, 2), (8, 2), (32773, 1)])
def test_a_large_frame(compression, predictor):
    """A 512 x 384 frame in strips of 16 rows (the card's check decodes
    2048 x 2048): OpenCV's bits; ``times`` splits the decode."""
    img = jf.render(384, 512, 5)
    buf = imf.tiff_bytes(img, 8, 2, compression=compression,
                         predictor=predictor, rows_per_strip=16)
    times = {}
    got, orientation = tiff.decode(buf, times=times)
    assert orientation == 1 and set(times) == {"directory_ms", "decode_ms"}
    want = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(got, want[..., ::-1])
    np.testing.assert_array_equal(got, img)


def _strips(name: str) -> list:
    """(codec byte, decoded size, data) of each strip or tile of a
    fixture."""
    buf = (imf.FIXTURE_DIR / name).read_bytes()
    img = tiff._Image(tiff._Directory(buf), True)
    codec = 5 if img.compression == tiff.LZW else 0x80
    size = img.ch * img.row_bytes
    return [bytes([codec]) + struct.pack("<I", size) + buf[o:o + c]
            for o, c in zip(img.offsets, img.counts)]


def test_tiff_codecs_under_sanitizers(tmp_path):
    """Mutated and truncated LZW and PackBits strips of the fixtures
    (8 and 16 bits, both byte orders, tiles, a palette), through the
    native pass built with AddressSanitizer and UndefinedBehaviorSanitizer
    (``tests/imgdec_fuzz.cpp``), into buffers of their size and of other
    sizes, the predictor undone over the result: every call returns a
    status, none faults."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++")
    exe = tmp_path / "imgdec_fuzz"
    build = subprocess.run(
        [cxx, "-O1", "-g", "-std=c++17", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=undefined", "-I", str(png.SOURCE.parent),
         str(imf.FIXTURE_DIR.parents[1] / "imgdec_fuzz.cpp"), "-o",
         str(exe)], capture_output=True, text=True)
    if build.returncode:
        pytest.skip(f"g++ cannot build with sanitizers: {build.stderr[-300:]}")
    streams = []
    for name in ("tiff_rgb8_lzw_II_planar1.tif", "tiff_rgb16_lzw_MM_planar2.tif",
                 "tiff_tiles16x16_lzw.tif", "tiff_palette4_16bit_map.tif",
                 "tiff_grey8_black_packbits.tif", "tiff_rgb16_packbits_MM_planar1.tif",
                 "tiff_cv2_lzw.tif"):
        streams += _strips(name)[:3]
    paths = []
    for i, s in enumerate(streams):
        paths.append(str(tmp_path / f"{i}.bin"))
        (tmp_path / f"{i}.bin").write_bytes(s)
    run = subprocess.run([str(exe), "200", *paths], capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    whole, short = map(int, run.stdout.split()[1::2])
    assert whole > len(paths) and short > len(paths)
