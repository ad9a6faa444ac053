"""Every JPEG the JAX package reads gives the same pixels in the port: the
modes OpenCV and Pillow do not write and the ways a file goes wrong,
against the JAX package's readers, bit for bit.

The files are ``tests/data/jpeg/modes/`` (``tests/jpeg_fixtures.py``
writes them with ``tests/jpeg_writer.c`` and Pillow): arithmetic coding,
sequential and progressive, every sampling, restart intervals, DAC
conditioning; progressive scans left unfinished, which libjpeg
block-smooths (libjpeg-turbo 2.1, the JAX native loader's, and OpenCV's
3.1 differ there); 4x4-subsampled chroma (the 12x12 IDCT at 3/8); CMYK and
YCCK; truncated data, with and without EOI after the cut; a lost restart
marker; coefficients past the IDCTs' 16-bit lanes; EXIF orientations 1-8
(big- and little-endian EXIF blocks).
Equal bits everywhere, against

- the manifest's sha256 of libjpeg-turbo 2.1's decode at 8/8 and 1/8-4/8,
  and its warning (the decoder in its ``libjpeg`` flavour);
- this host's libjpeg through the JAX native loader's exact crops at each
  scale, which holds the manifest to it;
- OpenCV's reads at 1/8, 2/8, 4/8 and 8/8 (the ``opencv`` flavour);
- the JAX package's imread, on plain and ``zip@`` paths;
- the JAX package's native loader's crops and failures
  (``decode_warp_batch``, ``decode_warp2_batch``) at scales 8, 4, 3, 2, 1,
  live and through the manifest's crop hashes (what the card's run
  checks, with no libjpeg there).
"""

import json
import zipfile

import cv2
import numpy as np
import pytest

import jpeg_fixtures as jf
from epipolarpose_tpu.geometry.affine import get_affine_transform_np
from epipolarpose_tpu_torch.data import fastloader as tfast
from epipolarpose_tpu_torch.data import jpeg
from epipolarpose_tpu_torch.data import zipreader as tzip

MODES = json.loads((jf.MODES_DIR / "manifest.json").read_text())
OLD = json.loads((jf.FIXTURE_DIR / "manifest.json").read_text())
SMALL = sorted(n for n, e in MODES.items() if e["bytes"] < 20000)
SCALES = (1, 2, 3, 4)


def _jfast():
    from epipolarpose_tpu.data import fastloader as jfast
    if not jfast.available():
        pytest.skip("the JAX native loader cannot build (no jpeglib.h)")
    return jfast


def _read(name: str) -> bytes:
    return (jf.MODES_DIR / name).read_bytes()


def _warning(buf: bytes, scale_num: int = 8):
    try:
        jpeg.decode(buf, scale_num)
    except jpeg.JpegWarning as e:
        return "ended" if e.ended else "warned"
    return None


def test_the_fixtures_cover_every_mode():
    names = " ".join(MODES)
    for s in ("444", "420", "422", "411", "gray"):
        for kind in ("seq", "prog"):
            assert f"arith_{kind}_{s}_" in names, (kind, s)
    assert all(f"exif_orientation{o}_" in names for o in range(1, 9))
    kinds = {e["warning"] for e in MODES.values()}
    assert kinds == {None, "warned", "ended"}
    assert {e["components"] for e in MODES.values()} == {1, 3, 4}
    assert sum(e["bytes"] for n, e in MODES.items() if "2048" not in n) < 2e5
    assert sorted(p.name for p in jf.MODES_DIR.glob("*.jpg")) == sorted(MODES)


@pytest.mark.parametrize("name", sorted(MODES))
def test_decodes_to_the_manifest_at_each_scale(name):
    """libjpeg-turbo 2.1's bits at 8/8 and each scale, its warning, and
    the size ``jpeg_info`` gives; no mode is refused."""
    buf, entry = _read(name), MODES[name]
    for s in (8, *SCALES):
        got = jf.port_rgb(buf, s)
        want = (entry["rgb_sha256"] if s == 8
                else entry["scaled_rgb_sha256"][str(s)])
        assert jf.rgb_sha256(got) == want, (name, s)
        assert jpeg.jpeg_info(buf, s) == (got.shape[1], got.shape[0],
                                          entry["components"])
    assert _warning(buf) == entry["warning"]


@pytest.mark.parametrize("name", SMALL)
def test_manifest_is_this_hosts_libjpeg(name):
    """The JAX native loader's exact crops (an identity at 8/8, a 1/8-4/8
    read where the sides are multiples of 8) give the manifest's hashes;
    a four-component file, which that loader refuses, is held to OpenCV's
    reads instead, which share its conversion."""
    buf, entry = _read(name), MODES[name]
    w, h = entry["width"], entry["height"]
    if entry["components"] == 4:
        for s, flag in ((8, cv2.IMREAD_COLOR), (4, cv2.IMREAD_REDUCED_COLOR_2),
                        (2, cv2.IMREAD_REDUCED_COLOR_4),
                        (1, cv2.IMREAD_REDUCED_COLOR_8)):
            img = cv2.imdecode(np.frombuffer(buf, np.uint8), flag)
            want = (entry["rgb_sha256"] if s == 8
                    else entry["scaled_rgb_sha256"][str(s)])
            assert jf.rgb_sha256(img[..., ::-1]) == want, (name, s)
        return
    jfast = _jfast()
    eye = np.array([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]], np.float32)
    crop = jfast.decode_warp_batch([buf], eye, (w, h), dtype=np.uint8)[0]
    assert jf.rgb_sha256(crop) == entry["rgb_sha256"]
    if w % 8 or h % 8:
        return
    for s in SCALES:
        r = s / 8
        M = np.array([[[r, 0, (r - 1) / 2], [0, r, (r - 1) / 2]]], np.float32)
        crop = jfast.decode_warp_batch([buf], M, (w * s // 8, h * s // 8),
                                       dtype=np.uint8)[0]
        assert jf.rgb_sha256(crop) == entry["scaled_rgb_sha256"][str(s)], s


@pytest.mark.parametrize("name", SMALL)
def test_opencv_flavour_is_opencvs_read(name, tmp_path):
    """OpenCV's reads from the file at 1/8, 2/8, 4/8 and 8/8 (EXIF
    orientation ignored), libjpeg-turbo 3.1's block smoothing included."""
    path = jf.MODES_DIR / name
    buf = path.read_bytes()
    for s, flag in ((8, cv2.IMREAD_COLOR), (4, cv2.IMREAD_REDUCED_COLOR_2),
                    (2, cv2.IMREAD_REDUCED_COLOR_4),
                    (1, cv2.IMREAD_REDUCED_COLOR_8)):
        want = cv2.imread(str(path), flag | cv2.IMREAD_IGNORE_ORIENTATION)
        got = jf.port_rgb(buf, s, "opencv")
        np.testing.assert_array_equal(got, want[..., ::-1], err_msg=str(s))


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """Every fixture, old and new, in one zip, as H36M's images ship."""
    path = tmp_path_factory.mktemp("modes") / "fixtures.zip"
    with zipfile.ZipFile(path, "w") as z:
        for root, names in ((jf.MODES_DIR, MODES), (jf.FIXTURE_DIR, OLD)):
            for name in names:
                z.write(root / name, f"{root.name}/{name}")
    return path


def _imread(module, path):
    try:
        return module.imread(path)
    except IOError as e:
        return type(e)


@pytest.mark.parametrize("name", sorted(MODES) + sorted(OLD))
def test_imread_is_the_jax_imread(name, archive):
    """The port's imread gives the JAX package's (OpenCV's) image, EXIF
    orientation applied, on a plain path and on a ``zip@`` path; where
    that raises (a truncated file from memory), so does the port's. The
    manifest's imread hashes are these."""
    from epipolarpose_tpu.data import zipreader as jzip
    root = jf.MODES_DIR if name in MODES else jf.FIXTURE_DIR
    paths = (str(root / name), f"{archive}@/{root.name}/{name}")
    for path, key in zip(paths, ("imread_sha256", "imdecode_sha256")):
        want, got = _imread(jzip, path), _imread(tzip, path)
        if want is IOError or got is IOError:
            assert want is got is IOError, path
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
        if name in MODES:
            digest = (None if got is IOError
                      else jf.rgb_sha256(got[..., ::-1]))
            assert digest == MODES[name][key], key


@pytest.mark.parametrize(
    "name", sorted(n for n in MODES if n.startswith("exif_orientation")))
def test_exif_orientation_is_applied_by_imread_only(name):
    """imread turns the image upright as OpenCV does (5-8 transpose it),
    from a big-endian (MM, Pillow's) or a little-endian (II) EXIF block;
    the decoder and the native loader, as libjpeg, do not."""
    orientation = int(name[len("exif_orientation")])
    buf = _read(name)
    exif = buf.index(b"Exif\0\0") + 6
    assert buf[exif:exif + 2] == (b"II" if "_ii_" in name else b"MM")
    assert tzip.exif_orientation(buf) == orientation
    assert jpeg.decode(buf).shape == (24, 40, 3)
    img = tzip.imread(str(jf.MODES_DIR / name), rgb=True)
    assert img.shape == ((40, 24, 3) if orientation >= 5 else (24, 40, 3))
    np.testing.assert_array_equal(
        img, tzip.apply_orientation(jpeg.decode(buf, flavour="opencv"),
                                    orientation))


@pytest.mark.parametrize("route", ["u8", "f32", "warp2_half"])
def test_native_loader_is_the_jax_loader(route):
    """All the small fixtures in one batch through affines that pick the
    scales 8, 4, 3, 2 and 1: the JAX loader's crops (float32 within one
    float32 spacing at 1.0, as in ``tests/test_torch_native_loader.py``),
    a zero crop and a counted failure for each file it refuses (the four
    CMYK/YCCK ones), the truncated ones decoded as libjpeg fills them, and
    the 4x4-subsampled frames counted at 3/8 where their affine asks for
    it."""
    jfast = _jfast()
    names = SMALL
    bufs = [_read(n) for n in names]
    n = len(bufs)
    fails = [i for i, k in enumerate(names) if MODES[k]["loader"] == "fails"]
    warned = sum(MODES[k]["warning"] is not None for k in names)
    assert len(fails) == 4 and warned >= 6
    size = (24, 24)
    for k, shrink in enumerate((1.0, 2.0, 2.7, 4.5, 9.0)):
        rng = np.random.default_rng(k)
        c = np.array([[MODES[x]["width"] / 2, MODES[x]["height"] / 2]
                      for x in names], np.float32)
        c += rng.uniform(-3, 3, (n, 2)).astype(np.float32)
        s = np.full((n, 2), shrink * size[0] / 200.0, np.float32)
        r = rng.uniform(-20, 20, n).astype(np.float32)
        M = get_affine_transform_np(c, s, r, size)
        tfast.reset_counts()
        if route == "warp2_half":
            M1 = get_affine_transform_np(c, s, 0 * r, (12, 12))
            got = tfast.decode_warp2_batch(bufs, M1, M, size, (12, 12))
            want = jfast.decode_warp2_batch(bufs, M1, M, size, (12, 12))
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b, err_msg=str(shrink))
            got = got[1]
        else:
            dtype = np.uint8 if route == "u8" else np.float32
            got = tfast.decode_warp_batch(bufs, M, size, dtype=dtype)
            want = jfast.decode_warp_batch(bufs, M, size, dtype=dtype)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=np.spacing(np.float32(1.0)))
        assert not got[fails].any()
        counts = tfast.decode_counts()
        assert counts["failed"] == len(fails)
        assert sum(counts["scale"].values()) == n - len(fails)
        assert counts["unsupported"] == len(fails)
        assert counts["warned"] == warned
        if shrink == 2.7:
            assert counts["scale"] == {3: n - len(fails)}


@pytest.mark.parametrize("name", sorted(MODES))
def test_native_loader_crops_are_the_manifests(name):
    """The port's loader through the manifest's affines gives the JAX
    loader's crops recorded there, fails where it failed, and decodes the
    4x4-subsampled frames at 3/8 where the affine asks for it."""
    entry = MODES[name]
    affines = np.asarray(entry["loader_affines"], np.float32)
    assert len(affines) == len(jf.LOADER_SHRINKS)
    tfast.reset_counts()
    crops = tfast.decode_warp_batch([_read(name)] * len(affines), affines,
                                    jf.LOADER_CROP)
    assert [jf.rgb_sha256(c) for c in crops] == entry["loader_crop_sha256"]
    counts = tfast.decode_counts()
    fails = entry["loader"] == "fails"
    assert counts["failed"] == (len(affines) if fails else 0)
    if not fails:
        assert counts["scale"] == {8: 1, 4: 1, 3: 1, 2: 1, 1: 1}
