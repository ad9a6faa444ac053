"""PNG, PNM and BMP test images: writers, the committed fixtures and
their manifest.

    python tests/image_fixtures.py     # rewrites tests/data/images/

The writers here set every field by hand, so that the fixtures cover what
OpenCV's readers take and how they take it: PNG at every colour type and
bit depth, Adam7 and not, each filter type forced, PLTE and tRNS,
palette indices past PLTE's end, several IDATs and an empty one,
gAMA/iCCP/sRGB, eXIf orientations 1-8 in both byte orders and an APNG;
PNM P1-P6 at several maxvals, with comments; BMP with core (OS/2), INFO,
V4 and V5 headers at 1, 4, 8, 16 (555 and 565), 24 and 32 bits, bottom-up
and top-down, RLE4 and RLE8 with their escapes.

``manifest.json`` gives, for each file, the sha256 of what OpenCV 5's
``cv2.imread(path, IMREAD_COLOR)`` returns (BGR, EXIF orientation
applied), or null where it returns None, the same for ``cv2.imdecode``
of the bytes, and the image's shape. The card's machine has no OpenCV:
the smoke run holds the port's reads to these hashes there.
"""

from __future__ import annotations

import hashlib
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


def fixture_set() -> dict:
    """name -> bytes of every fixture, from fixed seeds."""
    rng = np.random.default_rng(20261018)
    return {**_png_set(rng), **_pnm_set(rng), **_bmp_set(rng)}


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


def write_fixtures(root: pathlib.Path = FIXTURE_DIR) -> dict:
    """Write every fixture and ``manifest.json`` under ``root``. Each
    entry also names what the port's imread leaves to OpenCV
    (``needs_opencv``: the reason, or null)."""
    from epipolarpose_tpu_torch.data import imgformats, png
    root.mkdir(parents=True, exist_ok=True)
    for old in root.iterdir():
        old.unlink()
    manifest = {}
    for name, buf in sorted(fixture_set().items()):
        (root / name).write_bytes(buf)
        entry = opencv_entry(root / name)
        needs = None
        if imgformats.sniff(buf) == "png":
            try:
                png.decode(buf)
            except imgformats.NeedsOpenCV as e:
                needs = e.what
            except IOError:
                pass
        entry["needs_opencv"] = needs
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
