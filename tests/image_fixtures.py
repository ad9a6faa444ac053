"""PNG, PNM, BMP and TIFF test images, and lossless and 12-bit JPEGs:
writers, the committed fixtures and their manifest.

    python tests/image_fixtures.py     # rewrites tests/data/images/

The writers here set every field by hand, so that the fixtures cover what
OpenCV's readers take and how they take it: PNG at every colour type and
bit depth, Adam7 and not, each filter type forced, PLTE and tRNS,
palette indices past PLTE's end, several IDATs and an empty one,
gAMA/iCCP/sRGB, eXIf orientations 1-8 in both byte orders and an APNG;
PNM P1-P6 at several maxvals, with comments; BMP with core (OS/2), INFO,
V4 and V5 headers at 1, 4, 8, 16 (555 and 565), 24 and 32 bits, bottom-up
and top-down, RLE4 and RLE8 with their escapes; TIFF (``tiff_*``) of
every layout, depth and compression OpenCV reads (strips and tiles,
planar, both byte orders, BigTIFF, LZW, PackBits, Deflate, JPEG with
JPEGTables, Predictor 2, grey, RGB, alpha, palette, the Orientation tag),
by the writer here, OpenCV and Pillow, with the files OpenCV gives no
image of and damaged ones; lossless and 12-bit JPEGs (``jpeg_*``, the
encoders of ``jpeg_fixtures.py``).

``manifest.json`` gives, for each file, the sha256 of what OpenCV 5's
``cv2.imread(path, IMREAD_COLOR)`` returns (BGR, EXIF orientation
applied), or null where it returns None, the same for ``cv2.imdecode``
of the bytes, and the image's shape. The card's machine has no OpenCV:
the smoke run holds the port's reads to these hashes there.
"""

from __future__ import annotations

import hashlib
import io
import json
import pathlib
import struct
import zlib

import numpy as np

FIXTURE_DIR = pathlib.Path(__file__).resolve().parent / "data" / "images"
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> (channels, the bit depths it allows)
PNG_COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
                   3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7: (x0, y0, dx, dy) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def sha256(img) -> str | None:
    if img is None:
        return None
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


# ----------------------------------------------------------------- PNG
def png_chunk(kind: bytes, data: bytes, crc: int | None = None) -> bytes:
    """One chunk; ``crc`` overrides the right one."""
    if crc is None:
        crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples -> (h, row bytes) uint8: bits MSB first below 8,
    big-endian at 16."""
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * c)
    per = 8 // depth
    flat = samples.reshape(h, w * c).astype(np.uint8)
    pad = (-flat.shape[1]) % per
    flat = np.pad(flat, ((0, 0), (0, pad)))
    flat = flat.reshape(h, -1, per)
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    return np.bitwise_or.reduce(flat << shifts, axis=2).astype(np.uint8)


def filter_rows(rows: np.ndarray, bpp: int, filters) -> bytes:
    """Filter each row of (h, n) bytes with its type from ``filters`` (a
    sequence, cycled) and prefix the type byte."""
    h, n = rows.shape
    x = rows.astype(np.int32)
    up = np.vstack([np.zeros((1, n), np.int32), x[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int32), x[:, :-bpp]])[:, :n]
    upleft = np.hstack([np.zeros((h, bpp), np.int32), up[:, :-bpp]])[:, :n]
    p = left + up - upleft
    pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    preds = (0, left, up, (left + up) // 2, paeth)
    types = np.array([filters[y % len(filters)] for y in range(h)])
    out = np.empty((h, n + 1), np.uint8)
    out[:, 0] = types
    for t in set(types.tolist()):
        sel = types == t
        out[sel, 1:] = ((x - preds[t])[sel] & 0xFF).astype(np.uint8)
    return out.tobytes()


def png_scanlines(samples: np.ndarray, depth: int, interlace: bool = False,
                  filters=(0,)) -> bytes:
    """The filtered scanlines (the zlib stream's contents) of (h, w, c)
    samples, Adam7 when ``interlace``; empty passes have no rows."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    if not interlace:
        return filter_rows(_pack_rows(samples, depth), bpp, filters)
    out = b""
    for x0, y0, dx, dy in ADAM7:
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] and sub.shape[1]:
            out += filter_rows(_pack_rows(sub, depth), bpp, filters)
    return out


def png_bytes(samples: np.ndarray, color_type: int, depth: int, *,
              interlace: bool = False, filters=(0,), palette=None,
              trns: bytes | None = None, before_idat=(), after_idat=(),
              idat_sizes=None, stream: bytes | None = None,
              ihdr: bytes | None = None) -> bytes:
    """A PNG of (h, w[, c]) ``samples`` (palette indices for colour type
    3). ``palette``: (n, 3) RGB entries; ``before_idat``/``after_idat``:
    extra chunks (bytes, each a whole chunk); ``idat_sizes``: the sizes of
    the IDAT chunks the stream is split into (the rest goes in one more);
    ``stream``: the zlib stream itself; ``ihdr``: IHDR's body itself."""
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, _ = samples.shape
    if ihdr is None:
        ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0,
                           int(interlace))
    if stream is None:
        stream = zlib.compress(png_scanlines(samples, depth, interlace,
                                             filters))
    idats, pos = [], 0
    for n in idat_sizes or ():
        idats.append(png_chunk(b"IDAT", stream[pos:pos + n]))
        pos += n
    idats.append(png_chunk(b"IDAT", stream[pos:]))
    out = PNG_SIGNATURE + png_chunk(b"IHDR", ihdr)
    if palette is not None:
        out += png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += png_chunk(b"tRNS", trns)
    out += b"".join(before_idat) + b"".join(idats) + b"".join(after_idat)
    return out + png_chunk(b"IEND", b"")


def tiff_orientation_block(orientation: int, order: str = "MM") -> bytes:
    """A TIFF block (what eXIf holds, what follows ``Exif\\0\\0`` in a
    JPEG) whose IFD0 holds one entry, tag 0x0112 = ``orientation``."""
    e = ">" if order == "MM" else "<"
    return (order.encode() + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))


# ----------------------------------------------------------------- PNM
def pnm_bytes(kind: int, pixels: np.ndarray, maxval: int = 255) -> bytes:
    """P1-P6 of (h, w) or (h, w, 3) ``pixels`` (0/1 for P1, P4)."""
    h, w = pixels.shape[:2]
    header = f"P{kind}\n{w} {h}\n".encode()
    if kind not in (1, 4):
        header += f"{maxval}\n".encode()
    if kind in (1, 2, 3):
        rows = pixels.reshape(h, -1)
        body = b"\n".join(b" ".join(str(int(v)).encode() for v in r)
                          for r in rows) + b"\n"
    elif kind == 4:
        body = np.packbits(pixels.astype(np.uint8), axis=1).tobytes()
    else:
        dt = ">u2" if maxval > 255 else np.uint8
        body = pixels.astype(dt).tobytes()
    return header + body


# ----------------------------------------------------------------- BMP
BMP_HEADERS = {"core": 12, "info": 40, "v4": 108, "v5": 124}
BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3


def bmp_bytes(pixel_rows: bytes, width: int, height: int, bpp: int, *,
              header: str = "info", compression: int = BI_RGB,
              palette=None, masks=None, top_down: bool = False) -> bytes:
    """A BMP around ``pixel_rows`` (rows already packed, padded and in
    file order). ``palette``: (n, 3) BGR entries; ``masks``: the R, G, B
    (and A) bit masks, written after an INFO header or inside a V4/V5
    one."""
    size = BMP_HEADERS[header]
    h = -height if top_down else height
    if header == "core":
        info = struct.pack("<IHHHH", size, width, height, 1, bpp)
        pal = b"" if palette is None else np.asarray(
            palette, np.uint8)[:, :3].tobytes()
    else:
        n = len(palette) if palette is not None else 0
        info = struct.pack("<IiiHHIIiiII", size, width, h, 1, bpp,
                           compression, len(pixel_rows), 2835, 2835,
                           n, 0)
        m = list(masks or ())
        if header == "info":
            tail = b"".join(struct.pack("<I", v) for v in m)
        else:
            m = (m + [0, 0, 0, 0])[:4]
            tail = struct.pack("<IIII", *m) + b"sRGB" + bytes(36) + bytes(12)
            if header == "v5":
                tail += bytes(16)
            info += tail
            tail = b""
        pal = b"" if palette is None else np.concatenate(
            [np.asarray(palette, np.uint8)[:, :3],
             np.zeros((len(palette), 1), np.uint8)], 1).tobytes()
        info += tail
    off = 14 + len(info) + len(pal)
    return (b"BM" + struct.pack("<IHHI", off + len(pixel_rows), 0, 0, off)
            + info + pal + pixel_rows)


def bmp_rows(samples: np.ndarray, bpp: int, top_down: bool = False) -> bytes:
    """(h, w) indices at 1/4/8 bits, (h, w) uint16 at 16, (h, w, 3|4)
    bytes at 24/32 -> rows padded to 4 bytes, bottom row first unless
    ``top_down``."""
    h, w = samples.shape[:2]
    if bpp in (1, 4):
        rows = _pack_rows(samples.reshape(h, w, 1), bpp)
    elif bpp == 16:
        rows = samples.astype("<u2").view(np.uint8).reshape(h, w * 2)
    else:
        rows = samples.astype(np.uint8).reshape(h, -1)
    rows = np.pad(rows, ((0, 0), (0, (-rows.shape[1]) % 4)))
    return (rows if top_down else rows[::-1]).tobytes()


def bmp_rle(ops) -> bytes:
    """An RLE stream from ops: ("run", n, value), ("abs", values),
    ("eol",), ("eof",), ("delta", dx, dy). Absolute runs are padded to a
    word; RLE4 values are the two-index byte or nibble lists as given."""
    out = bytearray()
    for op in ops:
        if op[0] == "run":
            out += bytes([op[1], op[2]])
        elif op[0] == "abs":
            vals, count = op[1], op[2] if len(op) > 2 else len(op[1])
            body = bytes(vals)
            out += bytes([0, count]) + body + bytes(len(body) % 2)
        elif op[0] == "eol":
            out += b"\0\0"
        elif op[0] == "eof":
            out += b"\0\1"
        else:
            out += bytes([0, 2, op[1], op[2]])
    return bytes(out)


# ------------------------------------------------------------ fixtures
def smooth_frame(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth (h, w, 3) uint8 frame with a little noise, from ``seed``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([255 * xx / max(w - 1, 1), 255 * yy / max(h - 1, 1),
                    128 + 100 * np.sin(xx / 3.0 + yy / 5.0)], -1)
    img += rng.normal(0, 6, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _png_set(rng: np.random.Generator) -> dict:
    C = png_chunk
    out = {}
    for ct, (c, depths) in PNG_COLOR_TYPES.items():
        for d in depths:
            for il in (False, True):
                for h, w in ((13, 11), (3, 5)):
                    top = 2 ** d
                    if ct == 3:
                        n = min(top, 6)         # indices past PLTE's end
                        pal = rng.integers(0, 256, (n, 3))
                        s = rng.integers(0, top, (h, w))
                        b = png_bytes(s, 3, d, interlace=il, palette=pal,
                                      filters=(0, 1, 2, 3, 4))
                    else:
                        s = rng.integers(0, top, (h, w, c))
                        b = png_bytes(s, ct, d, interlace=il,
                                      filters=(4, 3, 2, 1, 0))
                    out[f"png_ct{ct}_d{d}_{'adam7' if il else 'plain'}_"
                        f"{w}x{h}.png"] = b
    for h, w in ((1, 1), (2, 3), (7, 5)):       # Adam7 with empty passes
        out[f"png_adam7_{w}x{h}.png"] = png_bytes(
            rng.integers(0, 256, (h, w, 3)), 2, 8, interlace=True,
            filters=(1, 4))
    frame = smooth_frame(24, 32, 1)
    for ft in range(5):
        out[f"png_filter{ft}.png"] = png_bytes(frame, 2, 8, filters=(ft,))
        out[f"png_filter{ft}_grey16.png"] = png_bytes(
            rng.integers(0, 65536, (9, 7)), 0, 16, filters=(ft,))
    out["png_idats.png"] = png_bytes(frame, 2, 8, filters=(4,),
                                     idat_sizes=[0, 1, 100, 0, 7])
    out["png_trns_grey.png"] = png_bytes(
        rng.integers(0, 256, (6, 9)), 0, 8, trns=b"\0\x10")
    out["png_trns_rgb.png"] = png_bytes(
        frame, 2, 8, trns=bytes([0, frame[0, 0, 0], 0, frame[0, 0, 1], 0,
                                 frame[0, 0, 2]]))
    out["png_trns_palette.png"] = png_bytes(
        rng.integers(0, 4, (6, 9)), 3, 2, palette=rng.integers(0, 256, (4, 3)),
        trns=bytes([0, 128, 255]))
    out["png_gama_iccp_srgb.png"] = png_bytes(frame, 2, 8, before_idat=[
        C(b"gAMA", struct.pack(">I", 100000)),
        C(b"iCCP", b"profile\0\0" + zlib.compress(b"\0" * 128)),
        C(b"cHRM", bytes(32))])
    out["png_rgba_srgb.png"] = png_bytes(
        np.dstack([frame, frame[..., :1]]), 6, 8,
        before_idat=[C(b"sRGB", b"\0"), C(b"gAMA", struct.pack(">I", 45455))])
    for o in range(1, 9):
        for order in ("MM", "II"):
            out[f"png_exif{o}_{order}.png"] = png_bytes(
                frame[:10, :6], 2, 8,
                before_idat=[C(b"eXIf", tiff_orientation_block(o, order))])
    out["png_exif6_after_idat.png"] = png_bytes(
        frame[:10, :6], 2, 8,
        after_idat=[C(b"eXIf", tiff_orientation_block(6, "II"))])
    # an APNG: the default image is its first frame; a second, fdAT frame
    second = zlib.compress(png_scanlines(frame[::-1], 8))
    fctl = (lambda seq: C(b"fcTL", struct.pack(">IIIIIHHBB", seq, 32, 24, 0,
                                                0, 1, 10, 0, 0)))
    out["png_apng.png"] = png_bytes(
        frame, 2, 8, before_idat=[C(b"acTL", struct.pack(">II", 2, 0)),
                                  fctl(0)],
        after_idat=[fctl(1), C(b"fdAT", struct.pack(">I", 2) + second)])
    # OpenCV applies an animation's orientation reading a file, not memory
    out["png_apng_exif6.png"] = png_bytes(
        frame, 2, 8, before_idat=[C(b"acTL", struct.pack(">II", 2, 0)),
                                  fctl(0), C(b"eXIf", tiff_orientation_block(
                                      6, "MM"))],
        after_idat=[fctl(1), C(b"fdAT", struct.pack(">I", 2) + second)])
    # an APNG whose default image is not a frame: OpenCV shows frame 1
    # reading a file, the default image reading memory
    out["png_apng_hidden_default.png"] = png_bytes(
        frame, 2, 8, before_idat=[C(b"acTL", struct.pack(">II", 2, 0))],
        after_idat=[fctl(0), C(b"fdAT", struct.pack(">I", 1) + second),
                    fctl(2), C(b"fdAT", struct.pack(">I", 3) + second)])
    # damaged files: the ones OpenCV reads all the same, and the others
    good = out["png_filter4.png"]
    out["png_bad_text_crc.png"] = png_bytes(
        frame, 2, 8, before_idat=[C(b"tEXt", b"k\0v", crc=0)])
    out["png_extra_after_iend.png"] = good + b"trailing bytes"
    raw = png_scanlines(frame, 8)
    out["png_too_much_data.png"] = png_bytes(
        frame, 2, 8, stream=zlib.compress(raw + bytes(50)))
    out["png_bad_adler_next_idat.png"] = png_bytes(
        frame, 2, 8, stream=_bad_adler(raw), idat_sizes=[
            len(_bad_adler(raw)) - 4])
    out["png_bad_adler.png"] = png_bytes(frame, 2, 8, stream=_bad_adler(raw))
    out["png_truncated.png"] = good[:len(good) // 2]
    out["png_no_iend.png"] = good[:-12]
    out["png_bad_idat_crc.png"] = png_bytes(frame, 2, 8, idat_sizes=[40])[
        :-12 - 4] + b"\0\0\0\0" + good[-12:]
    out["png_too_little_data.png"] = png_bytes(
        frame, 2, 8, stream=zlib.compress(raw[:-10]))
    out["png_bad_filter.png"] = png_bytes(frame, 2, 8, stream=zlib.compress(
        b"\x05" + raw[1:]))
    out["png_no_plte.png"] = png_bytes(rng.integers(0, 4, (3, 3)), 3, 2)
    out["png_over_opencv_limits.png"] = png_bytes(
        frame, 2, 8, ihdr=struct.pack(">IIBBBBB", 40000, 40000, 8, 2, 0, 0, 0))
    return out


def _bad_adler(raw: bytes) -> bytes:
    st = zlib.compress(raw)
    return st[:-1] + bytes([st[-1] ^ 0x55])


def _pnm_set(rng: np.random.Generator) -> dict:
    out = {}
    h, w = 5, 7
    for kind in (1, 4):
        out[f"pnm_p{kind}.pbm"] = pnm_bytes(kind, rng.integers(0, 2, (h, w)))
    for kind in (2, 3, 5, 6):
        ext = "pgm" if kind in (2, 5) else "ppm"
        for mv in (1, 100, 255, 1000, 65535):
            shape = (h, w, 3) if kind in (3, 6) else (h, w)
            px = rng.integers(0, mv + 1, shape)
            px.flat[0] = mv
            out[f"pnm_p{kind}_max{mv}.{ext}"] = pnm_bytes(kind, px, mv)
    out["pnm_p2_over_maxval.pgm"] = b"P2\n3 1\n100\n50 100 150\n"
    out["pnm_p5_comments.pgm"] = (b"P5\n# a comment\r5 # another\n 2\t\n"
                                  b"255\n" + bytes(range(0, 250, 25)))
    out["pnm_p1_packed.pbm"] = b"P1\n4 2\n0110\n1001\n"
    out["pnm_p2_no_final_space.pgm"] = b"P2\n2 1\n255\n7 200"
    out["pnm_p6_truncated.ppm"] = pnm_bytes(6, rng.integers(0, 256, (h, w, 3)))[
        :-4]
    out["pnm_p5_over_opencv_limits.pgm"] = b"P5\n40000 40000\n255\n"
    return out


def _bmp_set(rng: np.random.Generator) -> dict:
    out = {}
    h, w = 6, 9
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    for bpp in (1, 4, 8):
        n = 1 << bpp
        idx = rng.integers(0, n, (h, w))
        for hdr in BMP_HEADERS:
            for td in ((False,) if hdr == "core" else (False, True)):
                out[f"bmp_{bpp}bit_{hdr}{'_topdown' if td else ''}.bmp"] = \
                    bmp_bytes(bmp_rows(idx, bpp, td), w, h, bpp, header=hdr,
                              palette=pal[:n], top_down=td)
    idx = rng.integers(0, 256, (h, w))
    out["bmp_8bit_short_palette.bmp"] = bmp_bytes(
        bmp_rows(idx % 20, 8), w, h, 8, palette=pal[:12])
    v = rng.integers(0, 65536, (h, w))
    out["bmp_16bit_555.bmp"] = bmp_bytes(bmp_rows(v, 16), w, h, 16)
    out["bmp_16bit_555_bitfields.bmp"] = bmp_bytes(
        bmp_rows(v, 16), w, h, 16, compression=BI_BITFIELDS,
        masks=[0x7C00, 0x3E0, 0x1F])
    out["bmp_16bit_565_bitfields.bmp"] = bmp_bytes(
        bmp_rows(v, 16), w, h, 16, compression=BI_BITFIELDS,
        masks=[0xF800, 0x7E0, 0x1F])
    px = smooth_frame(h, w, 3)[..., ::-1]
    for hdr in BMP_HEADERS:
        out[f"bmp_24bit_{hdr}.bmp"] = bmp_bytes(bmp_rows(px, 24), w, h, 24,
                                                header=hdr)
    out["bmp_24bit_topdown.bmp"] = bmp_bytes(bmp_rows(px, 24, True), w, h, 24,
                                             top_down=True)
    px4 = np.dstack([px, rng.integers(0, 256, (h, w))])
    out["bmp_32bit.bmp"] = bmp_bytes(bmp_rows(px4, 32), w, h, 32)
    out["bmp_32bit_v5_bitfields.bmp"] = bmp_bytes(
        bmp_rows(px4, 32), w, h, 32, header="v5", compression=BI_BITFIELDS,
        masks=[0xFF0000, 0xFF00, 0xFF, 0xFF000000])
    out["bmp_32bit_v4_10bit_masks.bmp"] = bmp_bytes(
        bmp_rows(px4, 32), w, h, 32, header="v4", compression=BI_BITFIELDS,
        masks=[0x3FF00000, 0xFFC00, 0x3FF, 0])
    rle8 = bmp_rle([("run", 4, 7), ("abs", [1, 2, 3, 4, 5]), ("eol",),
                    ("delta", 2, 1), ("run", 5, 9), ("run", 2, 3),
                    ("abs", [10, 11, 12, 13, 14, 15, 16, 17, 18]),
                    ("eol",), ("run", 9, 5), ("eof",)])
    out["bmp_rle8.bmp"] = bmp_bytes(rle8, w, h, 8, compression=BI_RLE8,
                                    palette=pal)
    rle4 = bmp_rle([("run", 5, 0x12), ("abs", [0x34, 0x56], 4), ("eol",),
                    ("delta", 3, 7), ("run", 6, 0x9A), ("eof",),
                    ("abs", [0x12, 0x34, 0x56, 0x78, 0x90], 9), ("eol",),
                    ("eol",), ("eol",), ("eol",)])
    out["bmp_rle4.bmp"] = bmp_bytes(rle4, w, h, 4, compression=BI_RLE4,
                                    palette=pal[:16])
    out["bmp_rle8_run_past_line.bmp"] = bmp_bytes(
        bmp_rle([("run", 10, 1), ("eof",)]), w, h, 8, compression=BI_RLE8,
        palette=pal)
    out["bmp_rle8_ends_early.bmp"] = bmp_bytes(
        bmp_rle([("run", 9, 1), ("eol",)]), w, h, 8, compression=BI_RLE8,
        palette=pal)
    out["bmp_truncated.bmp"] = out["bmp_24bit_info.bmp"][:-10]
    out["bmp_16bit_v4_bitfields.bmp"] = bmp_bytes(   # masks read after V4
        bmp_rows(v, 16), w, h, 16, header="v4", compression=BI_BITFIELDS,
        masks=[0xF800, 0x7E0, 0x1F])
    return out


# ---------------------------------------------------------------- TIFF
# field type -> (struct code, size)
TIFF_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4),
              7: ("B", 1), 16: ("Q", 8)}


def packbits(data: bytes) -> bytes:
    """PackBits: runs of three or more equal bytes replicated, the rest
    literal, 128 bytes at most a packet."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i + 1
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out.append(j - i - 1)
        out += data[i:j]
        i = j
    return bytes(out)


def tiff_lzw(data: bytes) -> bytes:
    """TIFF's LZW: MSB-first codes of 9-12 bits that widen one code early
    (as libtiff reads them), CLEAR first and when the table fills, EOI
    last. The table maps (prefix code, byte) to a code."""
    out = bytearray()
    acc = nacc = 0
    width = 9

    def put(code: int):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1
    put(256)
    table: dict = {}
    nxt, w = 258, -1
    for b in data:
        if w < 0:
            w = b
            continue
        code = table.get((w << 8) | b)
        if code is not None:
            w = code
            continue
        put(w)
        table[(w << 8) | b] = nxt
        nxt += 1
        # the reader adds the entry a code later, then widens past 2^n - 2
        width = 9 if nxt <= 511 else 10 if nxt <= 1023 else \
            11 if nxt <= 2047 else 12
        w = b
        if nxt >= 4093:
            put(w)
            width = 12
            put(256)
            table.clear()
            nxt, w, width = 258, -1, 9
    if w >= 0:
        put(w)
        nxt += 1
        width = 9 if nxt <= 511 else 10 if nxt <= 1023 else \
            11 if nxt <= 2047 else 12
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def _tiff_pack(a: np.ndarray, bits: int, order: str) -> bytes:
    """(rows, n) samples -> bytes, each row padded to a byte; 16-bit
    samples in the file's byte order."""
    if bits == 8:
        return a.astype(np.uint8).tobytes()
    if bits == 16:
        return a.astype(("<" if order == "II" else ">") + "u2").tobytes()
    h, n = a.shape
    shifts = np.arange(bits - 1, -1, -1)
    bitrows = ((a[..., None] >> shifts) & 1).reshape(h, n * bits)
    return np.packbits(bitrows.astype(np.uint8), axis=1).tobytes()


def tiff_bytes(samples: np.ndarray, bits: int = 8,
               photometric: int | None = None, *, order: str = "II",
               big: bool = False, compression: int = 1, predictor: int = 1,
               planar: int = 1, rows_per_strip: int | None = None,
               tile: tuple | None = None, extra_samples=None,
               colormap=None, orientation: int | None = None,
               tags: dict | None = None, drop=(), chunks=None,
               pages: int = 1) -> bytes:
    """A TIFF of (h, w[, c]) integer ``samples``: strips of
    ``rows_per_strip`` rows or ``tile`` (width, length) tiles, planar or
    not, compression 1, 5 (LZW), 8/32946 (Deflate) or 32773 (PackBits)
    with Predictor 2 where asked; ``colormap``: (2^bits, 3) entries;
    ``tags``: fields to add or replace (tag -> (type, values));
    ``drop``: tags to leave out; ``chunks``: the strips' or tiles' data
    itself; ``pages``: directories, the first one's image repeated."""
    s = np.asarray(samples).astype(np.int64)
    if s.ndim == 2:
        s = s[..., None]
    h, w, c = s.shape
    if photometric is None:
        photometric = 1 if c <= 2 else 2
    e = "<" if order == "II" else ">"
    coders = {1: lambda b: b, 5: tiff_lzw, 8: zlib.compress,
              32946: zlib.compress, 32773: packbits}

    def rows_of(a: np.ndarray) -> bytes:
        r, cols, cc = a.shape
        if predictor == 2:
            d = a.copy()
            d[:, 1:] = a[:, 1:] - a[:, :-1]
            a = d & ((1 << bits) - 1)
        return _tiff_pack(a.reshape(r, cols * cc), bits, order)
    planes = [s] if planar == 1 else [s[..., i:i + 1] for i in range(c)]
    data = []
    for pl in planes:
        if tile:
            tw, th = tile
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    t = np.zeros((th, tw, pl.shape[2]), np.int64)
                    part = pl[ty:ty + th, tx:tx + tw]
                    t[:part.shape[0], :part.shape[1]] = part
                    data.append(rows_of(t))
        else:
            rps = rows_per_strip or h
            data += [rows_of(pl[y:y + rps]) for y in range(0, h, rps)]
    data = chunks if chunks is not None else \
        [coders.get(compression, bytes)(d) for d in data]
    wide = 4 if max(w, h) > 65535 else 3
    fields = {256: (wide, [w]), 257: (wide, [h]), 258: (3, [bits] * c),
              259: (3, [compression]), 262: (3, [photometric]),
              277: (3, [c]), 284: (3, [planar])}
    if predictor != 1:
        fields[317] = (3, [predictor])
    if extra_samples is not None:
        fields[338] = (3, list(extra_samples))
    if colormap is not None:
        fields[320] = (3, np.asarray(colormap).T.reshape(-1).tolist())
    if orientation is not None:
        fields[274] = (3, [orientation])
    if tile:
        fields[322], fields[323] = (3, [tile[0]]), (3, [tile[1]])
    else:
        fields[278] = (3, [rows_per_strip or h])
    head = 16 if big else 8
    body, offsets = bytearray(), []
    for d in data:
        offsets.append(head + len(body))
        body += d + b"\0" * (len(d) % 2)
    off_type = 16 if big else 4
    fields[324 if tile else 273] = (off_type, offsets)
    fields[325 if tile else 279] = (off_type, [len(d) for d in data])
    fields.update(tags or {})
    for tag in drop:
        fields.pop(tag, None)
    entry, inline = (20, 8) if big else (12, 4)
    ifd_len = (8 if big else 2) + len(fields) * entry + (8 if big else 4)
    out_ifds, extra = bytearray(), bytearray()
    starts = [head + len(body) + k * ifd_len for k in range(pages)]
    extra_at = head + len(body) + pages * ifd_len
    for k in range(pages):
        ifd = bytearray(struct.pack(e + ("Q" if big else "H"), len(fields)))
        for tag in sorted(fields):
            typ, vals = fields[tag]
            if isinstance(vals, bytes):
                payload = vals
            else:
                code = TIFF_TYPES[typ][0]
                payload = struct.pack(f"{e}{len(vals)}{code}", *vals)
            count = len(payload) // TIFF_TYPES[typ][1]
            if len(payload) <= inline:
                value = payload.ljust(inline, b"\0")
            else:
                value = struct.pack(e + ("Q" if big else "I"),
                                    extra_at + len(extra))
                extra += payload + b"\0" * (len(payload) % 2)
            ifd += struct.pack(e + "HH" + ("Q" if big else "I"), tag, typ,
                               count) + value
        nxt = starts[k + 1] if k + 1 < pages else 0
        ifd += struct.pack(e + ("Q" if big else "I"), nxt)
        out_ifds += ifd
    magic = (b"II" if order == "II" else b"MM")
    if big:
        magic += struct.pack(e + "HHHQ", 43, 8, 0, starts[0])
    else:
        magic += struct.pack(e + "HI", 42, starts[0])
    return bytes(magic + body + out_ifds + extra)


def _jpeg_tables_and_stream(jpg: bytes) -> tuple[bytes, bytes]:
    """A JPEG split as libtiff keeps it: the tables (SOI, DQT, DHT, EOI)
    for JPEGTables, and the abbreviated stream without them (APPn
    dropped)."""
    pos, tables, rest = 2, bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8")
    while True:
        marker = jpg[pos + 1]
        length = int.from_bytes(jpg[pos + 2:pos + 4], "big")
        seg = jpg[pos:pos + 2 + length]
        if marker == 0xDA:
            rest += jpg[pos:]
            break
        if marker in (0xDB, 0xC4):
            tables += seg
        elif not 0xE0 <= marker <= 0xEF:
            rest += seg
        pos += 2 + length
    return bytes(tables + b"\xff\xd9"), bytes(rest)


def tiff_ycbcr_jpeg(rgb: np.ndarray, rows_per_strip: int | None = 16,
                    tile: tuple | None = None, sub: str = "420",
                    quality: int = 90, **kw) -> bytes:
    """A JPEG-compressed YCbCr TIFF (Photometric 6) of the kind libtiff
    writes: each strip or tile an abbreviated stream that OpenCV's
    encoder made, the tables in JPEGTables, YCbCrSubsampling given."""
    import cv2
    h, w, _ = rgb.shape
    flag = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}[sub]
    parts = []
    if tile:
        tw, th = tile
        for ty in range(0, h, th):
            for tx in range(0, w, tw):
                t = np.zeros((th, tw, 3), np.uint8)
                part = rgb[ty:ty + th, tx:tx + tw]
                t[:part.shape[0], :part.shape[1]] = part
                parts.append(t)
    else:
        parts = [rgb[y:y + rows_per_strip] for y in range(0, h,
                                                          rows_per_strip)]
    chunks, tables = [], b""
    for part in parts:
        ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(part[..., ::-1]),
                               [cv2.IMWRITE_JPEG_QUALITY, quality,
                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])
        tables, stream = _jpeg_tables_and_stream(enc.tobytes())
        chunks.append(stream)
    factors = {"420": [2, 2], "422": [2, 1], "444": [1, 1]}[sub]
    tags = {530: (3, factors), 347: (7, tables), **kw.pop("tags", {})}
    return tiff_bytes(rgb, 8, 6, compression=7, rows_per_strip=rows_per_strip,
                      tile=tile, chunks=chunks, tags=tags, **kw)


def _pil_tiff(img: np.ndarray, **kwargs) -> bytes:
    from PIL import Image
    out = io.BytesIO()
    Image.fromarray(img).save(out, format="TIFF", **kwargs)
    return out.getvalue()


def _cv2_tiff(img: np.ndarray, *params) -> bytes:
    import cv2
    return cv2.imencode(".tif", img, list(params))[1].tobytes()


def _tiff_set(rng: np.random.Generator) -> dict:
    """TIFFs of every layout, depth and compression OpenCV reads, by the
    hand writer above, OpenCV and Pillow; those it gives no image of; and
    those the port leaves to it."""
    out = {}
    h, w = 13, 10
    frame = smooth_frame(24, 20, 7)
    for bits in (1, 8, 16):
        for ph, pname in ((0, "white"), (1, "black")):
            g = rng.integers(0, 1 << bits, (h, w))
            for comp, cname in ((1, "none"), (5, "lzw"), (32773, "packbits"),
                                (8, "deflate"), (32946, "adobe")):
                pred = 2 if comp in (5, 8) and bits > 1 else 1
                out[f"tiff_grey{bits}_{pname}_{cname}.tif"] = tiff_bytes(
                    g, bits, ph, compression=comp, predictor=pred,
                    rows_per_strip=4)
    for bits in (8, 16):
        v = rng.integers(0, 1 << bits, (h, w, 3))
        for comp, cname in ((1, "none"), (5, "lzw"), (8, "deflate"),
                            (32773, "packbits")):
            for order in ("II", "MM"):
                for planar in (1, 2):
                    pred = 2 if comp in (5, 8) else 1
                    out[f"tiff_rgb{bits}_{cname}_{order}_planar{planar}.tif"] = \
                        tiff_bytes(v, bits, 2, order=order, compression=comp,
                                   predictor=pred, planar=planar,
                                   rows_per_strip=5)
        a = rng.integers(0, 1 << bits, (h, w, 1))
        for es, ename in ((0, "unspecified"), (1, "associated"),
                          (2, "unassociated")):
            for planar in (1, 2):
                out[f"tiff_rgba{bits}_{ename}_planar{planar}.tif"] = \
                    tiff_bytes(np.concatenate([v, a], -1), bits, 2,
                               extra_samples=[es], planar=planar,
                               compression=5)
        g = rng.integers(0, 1 << bits, (h, w, 1))
        for ph in (0, 1):
            for planar in (1, 2):
                out[f"tiff_grey{bits}_alpha_ph{ph}_planar{planar}.tif"] = \
                    tiff_bytes(np.concatenate([g, a], -1), bits, ph,
                               extra_samples=[2], planar=planar)
    for bits in (1, 4, 8):
        idx = rng.integers(0, 1 << bits, (h, w))
        big = rng.integers(0, 65536, (1 << bits, 3))
        small = rng.integers(0, 256, (1 << bits, 3))
        out[f"tiff_palette{bits}_16bit_map.tif"] = tiff_bytes(
            idx, bits, 3, colormap=big, compression=5)
        out[f"tiff_palette{bits}_8bit_map.tif"] = tiff_bytes(
            idx, bits, 3, colormap=small, compression=32773)
    v = rng.integers(0, 256, (40, 37, 3))
    for tile, comp, cname in (((16, 16), 1, "none"), ((32, 32), 1, "none"),
                              ((16, 16), 5, "lzw"), ((32, 16), 8, "deflate"),
                              ((64, 64), 32773, "packbits")):
        out[f"tiff_tiles{tile[0]}x{tile[1]}_{cname}.tif"] = tiff_bytes(
            v, 8, 2, tile=tile, compression=comp,
            predictor=2 if comp in (5, 8) else 1)
    out["tiff_tiles16x16_lzw_planar.tif"] = tiff_bytes(
        v, 8, 2, tile=(16, 16), compression=5, planar=2)
    for o in range(1, 9):
        out[f"tiff_orientation{o}_11x7.tif"] = tiff_bytes(
            rng.integers(0, 256, (11, 7, 3)), 8, 2, orientation=o,
            rows_per_strip=4, compression=5)
        out[f"tiff_orientation{o}_square.tif"] = tiff_bytes(
            rng.integers(0, 256, (9, 9, 3)), 8, 2, orientation=o,
            tile=(16, 16), compression=5)
    out["tiff_orientation0_reads_as_1.tif"] = tiff_bytes(
        frame, 8, 2, orientation=0, compression=5)
    for order in ("II", "MM"):
        out[f"tiff_bigtiff_{order}.tif"] = tiff_bytes(
            rng.integers(0, 65536, (20, 17, 3)), 16, 2, big=True,
            order=order, compression=8, predictor=2, rows_per_strip=3)
    out["tiff_two_pages.tif"] = tiff_bytes(frame, 8, 2, compression=5,
                                           pages=2)
    # JPEG compression: libtiff's abbreviated YCbCr streams, Pillow's RGB
    # and grey ones
    jframe = smooth_frame(48, 40, 11)
    for sub in ("420", "422", "444"):
        out[f"tiff_jpeg_ycbcr{sub}_strips.tif"] = tiff_ycbcr_jpeg(
            jframe, 16, sub=sub)
    out["tiff_jpeg_ycbcr420_tiles.tif"] = tiff_ycbcr_jpeg(
        jframe, None, tile=(32, 32))
    out["tiff_jpeg_ycbcr420_last_strip_short.tif"] = tiff_ycbcr_jpeg(
        jframe[:44], 16)
    out["tiff_jpeg_pillow_rgb.tif"] = _pil_tiff(jframe.astype(np.uint8),
                                                compression="jpeg")
    out["tiff_jpeg_pillow_grey.tif"] = _pil_tiff(
        jframe[..., 0].astype(np.uint8), compression="jpeg")
    # OpenCV's and Pillow's other writers
    bgr = frame[..., ::-1].astype(np.uint8)
    out["tiff_cv2_lzw.tif"] = _cv2_tiff(bgr)
    out["tiff_cv2_grey.tif"] = _cv2_tiff(bgr[..., 0])
    out["tiff_cv2_16bit.tif"] = _cv2_tiff(bgr.astype(np.uint16) * 257 + 3)
    out["tiff_cv2_bgra.tif"] = _cv2_tiff(np.dstack([bgr, bgr[..., :1]]))
    out["tiff_cv2_float32.tif"] = _cv2_tiff(bgr.astype(np.float32) / 255)
    out["tiff_pillow_lzw.tif"] = _pil_tiff(frame.astype(np.uint8),
                                           compression="tiff_lzw")
    out["tiff_pillow_palette.tif"] = _pil_tiff(
        (frame[..., 0] // 40).astype(np.uint8), compression="packbits")
    out["tiff_pillow_bilevel.tif"] = _pil_tiff(frame[..., 0] > 100)
    out["tiff_pillow_g4.tif"] = _pil_tiff(frame[..., 0] > 100,
                                          compression="group4")
    out["tiff_pillow_orientation6.tif"] = _pil_tiff(
        frame.astype(np.uint8), compression="tiff_lzw", tiffinfo={274: 6})
    # what OpenCV gives no image of
    g = rng.integers(0, 4, (h, w))
    out["tiff_grey2_refused.tif"] = tiff_bytes(g, 2, 1)
    out["tiff_grey4_refused.tif"] = tiff_bytes(g, 4, 1)
    out["tiff_rgb4_refused.tif"] = tiff_bytes(
        rng.integers(0, 16, (h, w, 3)), 4, 2)
    # a ColorMap of the wrong size is dropped, and a palette image of 8
    # bits or more without one is grey
    out["tiff_palette16_bad_map_is_grey.tif"] = tiff_bytes(
        g, 16, 3, tags={320: (3, rng.integers(0, 65536, 48).tolist())})
    out["tiff_grey12_refused.tif"] = tiff_bytes(g, 16, 1,
                                                tags={258: (3, [12])})
    for code, cname in ((50000, "zstd"), (34925, "lzma"), (50001, "webp")):
        out[f"tiff_{cname}_refused.tif"] = tiff_bytes(
            frame, 8, 2, compression=code, chunks=[b"\x28\xb5\x2f\xfd" * 8])
    out["tiff_predictor3_refused.tif"] = tiff_bytes(
        frame, 8, 2, compression=5, predictor=3)
    out["tiff_predictor2_1bit_refused.tif"] = tiff_bytes(
        frame[..., 0] > 100, 1, 1, compression=5, predictor=2)
    out["tiff_no_photometric_refused.tif"] = tiff_bytes(frame, 8, 2,
                                                        drop=(262,))
    out["tiff_rows_per_strip0_refused.tif"] = tiff_bytes(
        frame, 8, 2, tags={278: (3, [0])})
    out["tiff_too_wide.tif"] = tiff_bytes(
        frame[:1], 8, 2, tags={256: (4, [(1 << 20) + 1])})
    # damage: libtiff shows a strip whose data runs out with zeros after
    # what it decoded, fails a strip it cannot read at all, and computes
    # the byte counts of uncompressed strips itself where they disagree
    lzw = tiff_bytes(frame, 8, 2, compression=5, predictor=2,
                     rows_per_strip=6)
    counts = _strip_counts(lzw)
    for k, name in ((1, "short"), (2, "empty_refused")):
        bad = list(counts)
        bad[k] = bad[k] // 2 if name == "short" else 0
        out[f"tiff_lzw_strip_{name}.tif"] = tiff_bytes(
            frame, 8, 2, compression=5, predictor=2, rows_per_strip=6,
            tags={279: (4, bad)})
    counts = _strip_counts(tiff_bytes(frame, 8, 2, compression=32773,
                                      rows_per_strip=6))
    out["tiff_packbits_strip_short.tif"] = tiff_bytes(
        frame, 8, 2, compression=32773, rows_per_strip=6,
        tags={279: (4, [c - 7 for c in counts])})
    out["tiff_truncated.tif"] = lzw[:len(lzw) // 2]
    out["tiff_none_counts_recomputed.tif"] = tiff_bytes(
        frame, 8, 2, rows_per_strip=6, tags={279: (4, [360, 999, 360, 360])})
    return out


def _strip_counts(buf: bytes) -> list:
    """StripByteCounts of a little-endian classic TIFF of the writer
    above (LONG values after the directory)."""
    ifd = int.from_bytes(buf[4:8], "little")
    n = int.from_bytes(buf[ifd:ifd + 2], "little")
    for k in range(n):
        tag, typ, count, value = struct.unpack_from("<HHII", buf,
                                                    ifd + 2 + 12 * k)
        if tag == 279:
            at = ifd + 2 + 12 * k + 8 if count == 1 else value
            return list(struct.unpack_from(f"<{count}I", buf, at))
    raise ValueError("no StripByteCounts")


def _jpeg_mode_set(rng: np.random.Generator) -> dict:
    """Lossless and 12-bit JPEGs (the encoders of ``jpeg_fixtures.py``):
    the lossless files OpenCV reads (RGB and CMYK at 2-8 bits, every
    predictor, point transforms, restarts, subsampling, a scan a
    component, component ids 1-3 without markers, which libjpeg-turbo
    takes for RGB in lossless files) and those it gives no image of
    (greyscale, YCbCr, YCCK, over 8 bits, a restart interval of part of
    a row), and 12-bit files."""
    import jpeg_fixtures as jf
    out = {}
    img = jf.render(21, 26, 3)
    rgb = [img[..., c] for c in range(3)]
    for psv in range(1, 8):
        out[f"jpeg_lossless_psv{psv}.jpg"] = jf.encode_lossless(rgb, psv=psv)
    out["jpeg_lossless_pt3.jpg"] = jf.encode_lossless(rgb, psv=4, pt=3)
    out["jpeg_lossless_restart2.jpg"] = jf.encode_lossless(
        rgb, psv=6, restart_rows=2)
    out["jpeg_lossless_separate_scans.jpg"] = jf.encode_lossless(
        rgb, psv=5, separate=True)
    out["jpeg_lossless_adobe_rgb.jpg"] = jf.encode_lossless(
        rgb, ids=(1, 2, 3), app=jf.ADOBE_RGB)
    for bits in (2, 5, 7):
        out[f"jpeg_lossless_{bits}bit.jpg"] = jf.encode_lossless(
            [c >> (8 - bits) for c in rgb], precision=bits, psv=7)
    out["jpeg_lossless_sub420.jpg"] = jf.encode_lossless(
        [rgb[0], rgb[1][::2, ::2], rgb[2][::2, ::2]],
        sampling=[(2, 2), (1, 1), (1, 1)], size=(21, 26), psv=4)
    out["jpeg_lossless_sub422_restart.jpg"] = jf.encode_lossless(
        [rgb[0], rgb[1][:, ::2], rgb[2][:, ::2]],
        sampling=[(2, 1), (1, 1), (1, 1)], size=(21, 26), psv=1,
        restart_rows=3)
    k = rng.integers(0, 256, (21, 26))
    out["jpeg_lossless_cmyk.jpg"] = jf.encode_lossless(
        rgb + [k], ids=(67, 77, 89, 75), app=jf.ADOBE_RGB)
    out["jpeg_lossless_grey_refused.jpg"] = jf.encode_lossless(rgb[:1])
    out["jpeg_lossless_ids123_is_rgb.jpg"] = jf.encode_lossless(
        rgb, ids=(1, 2, 3), psv=2)
    out["jpeg_lossless_adobe_ycbcr_refused.jpg"] = jf.encode_lossless(
        rgb, ids=(1, 2, 3), app=jf.ADOBE_YCC)
    out["jpeg_lossless_jfif_refused.jpg"] = jf.encode_lossless(
        rgb, app=jf.JFIF)
    out["jpeg_lossless_ycck_refused.jpg"] = jf.encode_lossless(
        rgb + [k], ids=(1, 2, 3, 4), app=jf.ADOBE_YCCK)
    wide = [c.astype(np.int64) * 16 for c in rgb]
    out["jpeg_lossless_12bit_refused.jpg"] = jf.encode_lossless(
        wide, precision=12, psv=1)
    out["jpeg_lossless_16bit_refused.jpg"] = jf.encode_lossless(
        [c * 257 for c in wide], precision=16, psv=7)
    bad = bytearray(jf.encode_lossless(rgb, restart_rows=1))
    dri = bad.index(b"\xff\xdd")
    bad[dri + 4:dri + 6] = (27).to_bytes(2, "big")   # not a whole row
    out["jpeg_lossless_restart_part_row_refused.jpg"] = bytes(bad)
    whole = jf.encode_lossless(rgb, psv=6, restart_rows=3)
    out["jpeg_lossless_truncated.jpg"] = whole[:len(whole) * 2 // 3]
    twelve = img.astype(np.int64) * 16 + 7
    out["jpeg_12bit_sof1_refused.jpg"] = jf.encode_dct(twelve, 12, 8)
    out["jpeg_12bit_grey_refused.jpg"] = jf.encode_dct(twelve[..., 0], 12, 8)
    out["jpeg_8bit_twin_of_12bit.jpg"] = jf.encode_dct(img, 8, 2,
                                                       ids=jf.RGB_IDS)
    return out


def fixture_set() -> dict:
    """name -> bytes of every fixture, from fixed seeds."""
    rng = np.random.default_rng(20261018)
    return {**_png_set(rng), **_pnm_set(rng), **_bmp_set(rng),
            **_tiff_set(np.random.default_rng(20)),
            **_jpeg_mode_set(np.random.default_rng(21))}


def opencv_entry(path: pathlib.Path) -> dict:
    """What OpenCV 5 makes of a file: the sha256 of ``cv2.imread`` (a
    path) and ``cv2.imdecode`` (its bytes), BGR, or null for None, or
    ``"raises"`` where it raises; the shape."""
    import cv2

    def outcome(read):
        try:
            img = read()
        except cv2.error:
            return "raises", None
        return sha256(img), None if img is None else list(img.shape)
    buf = np.frombuffer(path.read_bytes(), np.uint8)
    imread, shape = outcome(lambda: cv2.imread(str(path), cv2.IMREAD_COLOR))
    imdecode, _ = outcome(lambda: cv2.imdecode(buf, cv2.IMREAD_COLOR))
    return dict(bytes=int(buf.size), imread_sha256=imread,
                imdecode_sha256=imdecode, shape=shape)


def needs_opencv(buf: bytes) -> str | None:
    """What the port's decoder leaves to OpenCV in this file (its
    NeedsOpenCV), or None."""
    from epipolarpose_tpu_torch.data import imgformats, png, tiff
    decoders = {"png": png.decode, "tiff": tiff.decode}
    decode = decoders.get(imgformats.sniff(buf))
    if decode is None:
        return None
    try:
        decode(buf)
    except imgformats.NeedsOpenCV as e:
        return e.what
    except IOError:
        pass
    return None


def write_fixtures(root: pathlib.Path = FIXTURE_DIR) -> dict:
    """Write every fixture and ``manifest.json`` under ``root``. Each
    entry also names what the port's imread leaves to OpenCV
    (``needs_opencv``: the reason, or null)."""
    root.mkdir(parents=True, exist_ok=True)
    for old in root.iterdir():
        old.unlink()
    manifest = {}
    for name, buf in sorted(fixture_set().items()):
        (root / name).write_bytes(buf)
        entry = opencv_entry(root / name)
        entry["needs_opencv"] = needs_opencv(buf)
        manifest[name] = entry
    (root / "manifest.json").write_text(json.dumps(manifest, indent=1,
                                                   sort_keys=True) + "\n")
    return manifest


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    m = write_fixtures()
    total = sum(e["bytes"] for e in m.values())
    print(f"{len(m)} files, {total} bytes, in {FIXTURE_DIR}")
