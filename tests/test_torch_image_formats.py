"""Images that are not JPEG, and lossless and 12-bit JPEGs, give the same
pixels in the port as in the JAX package, and imread picks its decoder
by the file's first bytes.

The files are ``tests/data/images/`` (``tests/image_fixtures.py`` writes
them and their manifest): PNG at every colour type and bit depth, Adam7,
each filter type, several IDATs, tRNS, palette indices past PLTE,
gAMA/iCCP/sRGB, eXIf orientations 1-8 in both byte orders, an APNG; PNM
P1-P6 at maxvals 1, 100, 255, 1000 and 65535; BMP core/INFO/V4/V5 at 1,
4, 8, 16, 24 and 32 bits, top-down, RLE8 and RLE4; TIFF of every layout
and compression OpenCV reads (``tests/test_torch_tiff.py`` holds the
rest of TIFF); lossless JPEGs (every predictor, point transforms,
restarts, subsampling, 2-8 bits, RGB and CMYK, and the modes OpenCV
gives no image of) and 12-bit ones; and damaged files of each. Equal
bits, BGR and ``rgb=True``, on plain and ``zip@`` paths, against

- ``cv2.imread`` and ``cv2.imdecode`` (OpenCV 5.0.0, the JAX package's
  reader), live and through the manifest's hashes (what the card's run
  checks, with no OpenCV there);
- the JAX package's ``zipreader.imread``;

and where OpenCV gives no image the port raises IOError, on the fixtures
and on seeded truncations and single-byte mutations of each format.
"""

import json
import sys
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest

import image_fixtures as imf
import jpeg_fixtures as jf
from epipolarpose_tpu.data import zipreader as jzip
from epipolarpose_tpu_torch.data import imgformats, jpeg, png
from epipolarpose_tpu_torch.data import zipreader as tzip

MANIFEST = json.loads((imf.FIXTURE_DIR / "manifest.json").read_text())
# the bases of the mutation check: one file of each kind of decode (not
# an animation: its damage is OpenCV's to read, and OpenCV's reads of a
# damaged animation may differ from one call to the next)
MUTATED = ("png_filter4.png", "png_ct3_d4_adam7_11x13.png",
           "png_exif6_II.png", "png_ct4_d16_plain_5x3.png",
           "png_gama_iccp_srgb.png",
           "pnm_p5_comments.pgm", "pnm_p3_max1000.ppm", "pnm_p1_packed.pbm",
           "bmp_4bit_v5_topdown.bmp", "bmp_16bit_565_bitfields.bmp",
           "bmp_32bit_v4_10bit_masks.bmp", "bmp_rle8.bmp", "bmp_rle4.bmp",
           "jpeg_lossless_restart2.jpg", "jpeg_lossless_sub422_restart.jpg",
           "jpeg_lossless_separate_scans.jpg", "jpeg_lossless_cmyk.jpg")
MUTATIONS = 50


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """Every fixture as a zip member."""
    path = tmp_path_factory.mktemp("images") / "images.zip"
    with zipfile.ZipFile(path, "w") as z:
        for name in MANIFEST:
            z.write(imf.FIXTURE_DIR / name, f"sub/{name}")
    return path


def _opencv(read):
    """cv2's image, None, or "raises" (its size limits)."""
    try:
        return read()
    except cv2.error:
        return "raises"


def _port(path: str, rgb: bool = False):
    """The port's image, None where it raises IOError, or "raises" for
    OpenCV's size limits."""
    try:
        return tzip.imread(path, rgb=rgb)
    except imgformats.ImageTooLarge:
        return "raises"
    except IOError:
        return None


def _same(got, want) -> bool:
    if isinstance(got, np.ndarray) and isinstance(want, np.ndarray):
        return got.shape == want.shape and bool((got == want).all())
    return type(got) is type(want) and (got is None or got == want)


def test_the_fixtures_cover_every_case():
    names = set(MANIFEST)
    for ct, (_, depths) in imf.PNG_COLOR_TYPES.items():
        for d in depths:
            for il in ("plain", "adam7"):
                assert f"png_ct{ct}_d{d}_{il}_5x3.png" in names, (ct, d, il)
    assert all(f"png_filter{t}.png" in names for t in range(5))
    assert all(f"png_exif{o}_{b}.png" in names for o in range(1, 9)
               for b in ("MM", "II"))
    for kind in (2, 3, 5, 6):
        for mv in (1, 100, 255, 1000, 65535):
            assert any(n.startswith(f"pnm_p{kind}_max{mv}.") for n in names)
    for bpp in (1, 4, 8):
        for hdr in imf.BMP_HEADERS:
            assert f"bmp_{bpp}bit_{hdr}.bmp" in names, (bpp, hdr)
    outcomes = {str(e["imread_sha256"])[:6] for e in MANIFEST.values()}
    assert {"None", "raises"} <= outcomes
    assert sum(e["bytes"] for e in MANIFEST.values()) < 1_000_000
    on_disk = {p.name for p in imf.FIXTURE_DIR.iterdir()} - {"manifest.json"}
    assert on_disk == names


def test_the_writer_gives_the_committed_files():
    """The fixtures are what ``image_fixtures.py`` writes now."""
    for name, buf in imf.fixture_set().items():
        assert (imf.FIXTURE_DIR / name).read_bytes() == buf, name


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_imread_is_opencvs_and_the_jax_imread(name, archive):
    """The port's imread against OpenCV's reads (live and the manifest's
    hashes) and the JAX package's imread, from a path and a zip member,
    BGR and RGB; None -> IOError, OpenCV's size limits -> ImageTooLarge;
    the files the port leaves to OpenCV are the manifest's."""
    entry, path = MANIFEST[name], imf.FIXTURE_DIR / name
    buf = np.frombuffer(path.read_bytes(), np.uint8)
    for where, key, read in (
            (str(path), "imread_sha256",
             lambda: cv2.imread(str(path), cv2.IMREAD_COLOR)),
            (f"{archive}@/sub/{name}", "imdecode_sha256",
             lambda: cv2.imdecode(buf, cv2.IMREAD_COLOR))):
        want = _opencv(read)
        got = _port(where)
        assert _same(got, want), where
        assert (got if isinstance(got, str) else imf.sha256(got)) \
            == entry[key]
        rgb = _port(where, rgb=True)
        assert _same(rgb, want if not isinstance(want, np.ndarray)
                     else np.ascontiguousarray(want[..., ::-1]))
        try:
            jax_img = jzip.imread(where)
        except IOError:
            jax_img = None
        except cv2.error:
            jax_img = "raises"
        assert _same(got, jax_img), where
    assert imf.needs_opencv(buf.tobytes()) == entry["needs_opencv"]


def _chunk_at(buf: bytes, i: int):
    """(start, length) of the PNG chunk whose name or body holds byte
    ``i``, or None."""
    pos = 8
    while pos + 8 <= len(buf):
        n = int.from_bytes(buf[pos:pos + 4], "big")
        if pos + 4 <= i < pos + 8 + n:
            return pos, n
        pos += 12 + n
    return None


def _mutations(buf: bytes, seed: int):
    """Seeded truncations and single-byte changes of ``buf``; in a PNG,
    every third change is followed by its chunk's CRC, recomputed (so
    that what is checked is the change, not the CRC)."""
    rng = np.random.default_rng(seed)
    for k in range(MUTATIONS):
        b = bytearray(buf)
        if k % 4 == 0:
            yield bytes(b[:rng.integers(2, len(b))])
            continue
        i = int(rng.integers(2, len(b)))
        b[i] = int(rng.choice([rng.integers(0, 256), b[i] ^ 1, b[i] ^ 0x20,
                               0, 255, ord(" "), ord("#"), ord("7")]))
        chunk = _chunk_at(buf, i) if buf[:8] == imf.PNG_SIGNATURE else None
        if chunk and k % 3 == 0:
            pos, n = chunk
            b[pos + 8 + n:pos + 12 + n] = zlib.crc32(
                bytes(b[pos + 4:pos + 8 + n])).to_bytes(4, "big")
        yield bytes(b)


@pytest.mark.parametrize("name", MUTATED)
def test_damage_gives_ioerror_where_opencv_gives_none(name, tmp_path):
    """Truncations and single-byte mutations: wherever OpenCV returns
    None the port raises IOError, wherever it reads the file the port
    gives its bits, from a path and from a zip member."""
    base = (imf.FIXTURE_DIR / name).read_bytes()
    zpath = tmp_path / "m.zip"
    cases = list(_mutations(base, seed=len(name)))
    with zipfile.ZipFile(zpath, "w") as z:
        for i, b in enumerate(cases):
            (tmp_path / f"{i}.bin").write_bytes(b)
            z.writestr(f"{i}.bin", b)
    refused = 0
    for i, b in enumerate(cases):
        want = _opencv(lambda: cv2.imread(str(tmp_path / f"{i}.bin"),
                                          cv2.IMREAD_COLOR))
        assert _same(_port(str(tmp_path / f"{i}.bin")), want), i
        want = _opencv(lambda: cv2.imdecode(np.frombuffer(b, np.uint8),
                                            cv2.IMREAD_COLOR))
        assert _same(_port(f"{zpath}@/{i}.bin"), want), i
        refused += want is None
    assert refused > 0


def _routes_without_opencv(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)   # import cv2 fails
    tzip.reset_route_counts()
    jpeg.reset_count()
    png.reset_count()


@pytest.mark.parametrize("suffix", [".png", ".jpe", ".jfif", ".Jpg", ""])
def test_a_jpeg_under_any_name_takes_the_ports_decoder(suffix, tmp_path,
                                                       monkeypatch):
    """C7: the route is the signature's, not the suffix's. A JPEG named
    ``.png``, ``.jpe``, ``.jfif`` or ``.Jpg``, or with no suffix, goes
    through the port's JPEG decoder (one decode more) and never to
    OpenCV, from a path and a zip member, with OpenCV's pixels."""
    src = jf.FIXTURE_DIR / "s420_37x29.jpg"
    path = tmp_path / f"frame{suffix}"
    path.write_bytes(src.read_bytes())
    zpath = tmp_path / "a.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        z.write(path, f"in/frame{suffix}")
    want = cv2.imread(str(src), cv2.IMREAD_COLOR)
    _routes_without_opencv(monkeypatch)
    for where in (str(path), f"{zpath}@/in/frame{suffix}"):
        before = jpeg.decode_count()
        np.testing.assert_array_equal(tzip.imread(where), want)
        assert jpeg.decode_count() == before + 1
    assert tzip.route_counts() == dict(jpeg=2, png=0, pnm=0, bmp=0,
                                       tiff=0, opencv=0)


def test_a_png_named_jpg_gives_the_jax_pixels(tmp_path, monkeypatch):
    """C7: a PNG named ``.jpg`` was sent to the JPEG decoder, which
    refused it; it is the PNG decoder's now, with the JAX package's
    pixels, from a path and a zip member."""
    src = imf.FIXTURE_DIR / "png_filter4.png"
    path = tmp_path / "png_named.jpg"
    path.write_bytes(src.read_bytes())
    zpath = tmp_path / "a.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        z.write(path, "png_named.jpg")
    wants = [jzip.imread(str(path)), jzip.imread(f"{zpath}@/png_named.jpg")]
    _routes_without_opencv(monkeypatch)
    for where, want in zip((str(path), f"{zpath}@/png_named.jpg"), wants):
        np.testing.assert_array_equal(tzip.imread(where), want)
    assert png.decode_count() == 2
    assert tzip.route_counts()["png"] == 2


def test_opencv_also_picks_its_decoder_by_signature(tmp_path):
    """Each fixture under another format's suffix reads the same through
    OpenCV, and no file matches two of the port's signatures (nor does a
    near miss match any: OpenCV has no decoder for it either)."""
    for name in ("png_filter0.png", "pnm_p6_max255.ppm", "bmp_24bit_v5.bmp"):
        buf = (imf.FIXTURE_DIR / name).read_bytes()
        want = cv2.imread(str(imf.FIXTURE_DIR / name), cv2.IMREAD_COLOR)
        for suffix in (".jpg", ".bmp", ".png", ".tif"):
            p = tmp_path / f"x{suffix}"
            p.write_bytes(buf)
            np.testing.assert_array_equal(cv2.imread(str(p)), want)
    kinds = [imgformats.sniff((imf.FIXTURE_DIR / n).read_bytes())
             for n in MANIFEST]
    assert set(kinds) == {"png", "pnm", "bmp", "tiff", "jpeg"}
    for near in (b"P7\n1 1\n", b"P5x", b"P0 1 1 1\n", b"B", b"\xff\xd8\x00",
                 b"\x89PNG\r\n\x1a\x00", b"II*\x01", b"MM*\x00",
                 b"II\x00*", b"MM\x00,", b"II,\x00"):
        assert imgformats.sniff(near) is None
        assert cv2.imdecode(np.frombuffer(near + bytes(64), np.uint8),
                            cv2.IMREAD_COLOR) is None


@pytest.mark.parametrize("what,buf", [
    ("a TIFF file", None), ("a WebP file", None),
    ("a lossless JPEG", None), ("an animated PNG", None)])
def test_without_opencv_the_error_names_the_format(what, buf, tmp_path,
                                                   monkeypatch):
    """Where OpenCV is still needed and missing, the ImportError names the
    format found (a TIFF the port leaves to OpenCV names its compression
    too). A lossless JPEG needs OpenCV no longer: the port reads one that
    OpenCV reads, and refuses one that OpenCV gives no image of (16-bit)
    with IOError, naming it, not ImportError."""
    img = jf.render(16, 16, 3)
    if what == "a TIFF file":
        buf = (imf.FIXTURE_DIR / "tiff_pillow_g4.tif").read_bytes()
        what = "a TIFF file with CCITT G4 compression"
    elif what == "a WebP file":
        ok, enc = cv2.imencode(".webp", img)
        buf = enc.tobytes()
    elif what == "a lossless JPEG":
        buf = (imf.FIXTURE_DIR / "jpeg_lossless_psv4.jpg").read_bytes()
        want = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
        refused = (imf.FIXTURE_DIR
                   / "jpeg_lossless_16bit_refused.jpg").read_bytes()
    else:
        buf = (imf.FIXTURE_DIR / "png_apng_hidden_default.png").read_bytes()
    path = tmp_path / "x.jpg"
    path.write_bytes(buf)
    monkeypatch.setitem(sys.modules, "cv2", None)
    if what == "a lossless JPEG":
        np.testing.assert_array_equal(tzip.imread(str(path)), want)
        path.write_bytes(refused)
        with pytest.raises(IOError, match="lossless, 16-bit") as e:
            tzip.imread(str(path))
        assert not isinstance(e.value, ImportError)
        return
    with pytest.raises(ImportError, match=what):
        tzip.imread(str(path))


def test_png_decodes_the_same_on_threads():
    """The pool loader's threads decode PNGs side by side (the native pass
    and zlib release the interpreter lock); the images are the serial
    ones."""
    bufs = [(imf.FIXTURE_DIR / n).read_bytes() for n in sorted(MANIFEST)
            if n.startswith("png_") and MANIFEST[n]["imread_sha256"]
            not in (None, "raises") and not MANIFEST[n]["needs_opencv"]]
    serial = [png.decode(b)[0] for b in bufs]
    with ThreadPoolExecutor(8) as pool:
        for _ in range(3):
            for got, want in zip(pool.map(lambda b: png.decode(b)[0], bufs),
                                 serial):
                np.testing.assert_array_equal(got, want)


def test_a_large_frame_with_every_filter(tmp_path):
    """A 512 x 384 frame, filter types 0-4 row by row (the card's check
    writes 2048 x 2048): OpenCV's bits; ``times`` splits the decode."""
    img = jf.render(384, 512, 5)
    buf = imf.png_bytes(img, 2, 8, filters=(0, 1, 2, 3, 4))
    times = {}
    got, orientation = png.decode(buf, times=times)
    np.testing.assert_array_equal(got, img)
    assert orientation == 1 and set(times) == {"inflate_ms", "native_ms"}
    want = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(got, want[..., ::-1])
