"""The port's TIFF reader: what OpenCV 5's ``IMREAD_COLOR`` read gives,
without OpenCV or libtiff.

OpenCV reads a TIFF's first directory through libtiff 4.7 and, for an
8-bit colour result, libtiff's RGBA interface (``TIFFReadRGBAStrip`` and
``TIFFReadRGBATile``, tif_getimage.c). :func:`decode` follows both:

- classic TIFF and BigTIFF in either byte order; the first directory
  only, so a multi-page file gives its first page;
- strips and tiles, PlanarConfiguration 1 and 2;
- compression none, LZW and PackBits (``native/imgdec.cpp``, libtiff's
  own decoders), Deflate (8 and 32946; Python's ``zlib``) and JPEG (7,
  with JPEGTables; the port's JPEG decoder, OpenCV's flavour, YCbCr
  converted to RGB as libtiff asks libjpeg to, other photometrics taken
  as coded); Predictor 2 after LZW and Deflate (libtiff ignores it
  after none and PackBits);
- BitsPerSample 1 (grey, palette), 4 (palette), 8 and 16 (grey, RGB;
  palette 8); grey through libtiff's map (``x * 255 / max``, inverted for
  MinIsWhite, 16-bit samples as their high byte), 16-bit RGB as
  ``(v + 128) / 257``, a palette's 16-bit entries as their high byte (or
  as they stand when none is over 255); unassociated alpha multiplied
  in (``(v * a + 127) / 255``) where libtiff does, other extra samples
  dropped; planar grey as libtiff's separate route takes it (its raw
  samples, not the map);
- the Orientation tag, 1-8 (others read as 1), returned for the caller
  to turn the image as a JPEG's EXIF orientation turns it; from a file
  OpenCV gives no image for 5-8 unless the image is square
  (``cv::imread``'s check that the decoder kept its buffer), from memory
  it turns every one.

Where OpenCV gives no image :func:`decode` raises :class:`TiffError`
(OpenCV's own header checks: BitsPerSample 1, 4 for a palette, 8, 10,
12, 14, 16, 32 or 64; then libtiff's: 1, 2, 4, 8 or 16 bits, no float
samples, compressions it has a codec for, and which it can convert); over
OpenCV's size limits :class:`imgformats.ImageTooLarge`; and what this
reader leaves to OpenCV raises :class:`imgformats.NeedsOpenCV`, naming
it: CCITT and old-style JPEG compression, uncompressed YCbCr, CMYK and
the other photometrics, FillOrder 2, signed or complex samples, a
directory whose byte counts are missing or do not match its strips, JPEG
strips of another size or sampling than the directory says, and data
that a codec fails on in the middle (a Deflate or JPEG stream that is
corrupt, not cut short). A strip whose data runs out decodes as libtiff
decodes it: what was decoded, then zeros.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import time
import zlib

import numpy as np

from epipolarpose_tpu_torch.data import jpeg
from epipolarpose_tpu_torch.data.imgformats import (ImageFormatError,
                                                    NeedsOpenCV, check_size)

# the field types libtiff reads, by their codes: (struct code, size)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4),
          5: ("II", 8), 6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4),
          10: ("ii", 8), 11: ("f", 4), 12: ("d", 8), 13: ("I", 4),
          16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
FILL_ORDER, STRIP_OFFSETS, ORIENTATION, SAMPLES = 266, 273, 274, 277
ROWS_PER_STRIP, STRIP_BYTES, PLANAR, PREDICTOR = 278, 279, 284, 317
COLORMAP, TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS = 320, 322, 323, 324
TILE_BYTES, EXTRA_SAMPLES, SAMPLE_FORMAT, JPEG_TABLES = 325, 338, 339, 347
YCBCR_SUBSAMPLING = 530
MINISWHITE, MINISBLACK, RGB, PALETTE, YCBCR = 0, 1, 2, 3, 6
# compressions libtiff 4.7 as OpenCV builds it decodes, those the port
# decodes among them, and those it lacks the codec of (ZSTD, LZMA, WebP)
NONE, LZW, JPEG, DEFLATE, ADOBE_DEFLATE, PACKBITS = 1, 5, 7, 8, 32946, 32773
DECODED = (NONE, LZW, JPEG, DEFLATE, ADOBE_DEFLATE, PACKBITS)
UNCONFIGURED = {50000: "ZSTD", 34925: "LZMA", 50001: "WebP"}
COMPRESSION_NAMES = {2: "CCITT RLE", 3: "CCITT G3", 4: "CCITT G4",
                     6: "old-style JPEG", 32771: "CCITT RLEW",
                     32809: "ThunderScan", 34676: "SGI LogLuv",
                     34677: "SGI LogL", 32908: "PixarLog",
                     32909: "PixarLog", 34712: "JPEG 2000",
                     34887: "LERC", **UNCONFIGURED}
# OpenCV's readHeader: the bit depths it gives a type (4 only to a
# palette); libtiff's TIFFRGBAImageOK: those it converts
OPENCV_BITS = (1, 4, 8, 10, 12, 14, 16, 32, 64)
RGBA_BITS = (1, 2, 4, 8, 16)
# grfmt_tiff.cpp's limits on a strip or tile: 2^24 a side, and under 1 GiB
# as the 32-bit RGBA raster TIFFReadRGBA* fills
TILE_MAX_SIDE = 1 << 24
TILE_MAX_BYTES = 1 << 30
ALL_ROWS = 0xFFFFFFFF

_count_lock = threading.Lock()
# decodes since the last reset_count() (read by the smoke run)
_count = 0


class TiffError(ImageFormatError):
    """A TIFF that OpenCV gives no image for."""


def decode_count() -> int:
    """TIFFs decoded since the last :func:`reset_count`."""
    return _count


def reset_count() -> None:
    global _count
    with _count_lock:
        _count = 0


# the integer types a SHORT or LONG field may come as (libtiff converts
# them, checking the range), IFD types only to LONG fields
_INTS = (1, 3, 4, 6, 8, 9, 16, 17)
_INTS32 = _INTS + (13, 18)
# the fields whose bad value fails the whole directory
# (TIFFReadDirectory); a bad value of any other is ignored
_FATAL = (WIDTH, LENGTH, COMPRESSION, SAMPLES, BITS, SAMPLE_FORMAT, PLANAR,
          ROWS_PER_STRIP, TILE_WIDTH, TILE_LENGTH, EXTRA_SAMPLES)
# the fields libtiff keeps in 32 bits (the rest in 16)
_WIDE = (WIDTH, LENGTH, ROWS_PER_STRIP, TILE_WIDTH, TILE_LENGTH)


class _Directory:
    """The first IFD's entries, their values read on demand
    (:meth:`read`) as libtiff reads them."""

    def __init__(self, buf: bytes):
        self.buf = buf
        order = {b"II": "<", b"MM": ">"}.get(buf[:2])
        if order is None or len(buf) < 8:
            raise TiffError("not a TIFF file")
        self.e = order
        magic = self._u(2, "H")
        if magic == 42:
            self.big, ifd = False, self._u(4, "I")
        elif magic == 43:
            if len(buf) < 16 or self._u(4, "H") != 8 or self._u(6, "H"):
                raise TiffError("bad BigTIFF header")
            self.big, ifd = True, self._u(8, "Q")
        else:
            raise TiffError("not a TIFF file (bad version number)")
        count_size, entry, inline = (8, 20, 8) if self.big else (2, 12, 4)
        if ifd < 8 or ifd + count_size > len(buf):
            raise TiffError("cannot read the TIFF directory count")
        n = self._u(ifd, "Q" if self.big else "H")
        if ifd + count_size + n * entry > len(buf):
            raise TiffError("cannot read the TIFF directory")
        # tag -> (type, count, offset of its values); tags in file order
        self.entries: dict[int, tuple] = {}
        self.order: list[int] = []
        self.twice = False
        for i in range(n):
            at = ifd + count_size + i * entry
            tag, typ = struct.unpack_from(order + "HH", buf, at)
            count = self._u(at + 4, "Q" if self.big else "I")
            if tag in self.entries:
                self.twice = True
                continue
            where = at + (12 if self.big else 8)
            if typ in _TYPES and count * _TYPES[typ][1] > inline:
                where = self._u(where, "Q" if self.big else "I")
            self.entries[tag] = (typ, count, where)
            self.order.append(tag)
        self._cache: dict = {}

    def _u(self, at: int, fmt: str) -> int:
        return struct.unpack_from(self.e + fmt, self.buf, at)[0]

    def has(self, tag: int) -> bool:
        return tag in self.entries

    def read(self, tag: int, limit: int | None = None) -> tuple | None:
        """(type, values) of a field, its first ``limit`` values only
        where given (libtiff reads no more of the strip arrays than it
        needs); None where libtiff cannot read it: a type it does not
        know, or values past the end of the file."""
        if tag not in self.entries:
            return None
        key = (tag, limit)
        if key not in self._cache:
            typ, count, where = self.entries[tag]
            n = count if limit is None else min(count, limit)
            got = None
            if typ in _TYPES and n <= 1 << 28 and count < 1 << 63:
                fmt, size = _TYPES[typ]
                if where + n * size <= len(self.buf):
                    if typ in (2, 7):
                        got = (typ, (self.buf[where:where + n * size],))
                    else:
                        got = (typ, struct.unpack_from(
                            f"{self.e}{n * len(fmt)}{fmt[0]}", self.buf,
                            where))
            self._cache[key] = got
        return self._cache[key]

    def before(self, first: int, then: int) -> bool:
        """Both tags present, ``first`` earlier in the directory."""
        return first in self.order and then in self.order \
            and self.order.index(first) < self.order.index(then)

    def _bad(self, tag: int, default):
        if tag in _FATAL:
            raise TiffError(f"TIFF directory with a bad tag {tag}")
        return default

    def one(self, tag: int, default: int | None = None,
            per_sample: int = 0) -> int | None:
        """A field of one integer value as libtiff reads it: SHORT
        (LONG for the sizes), from any integer type in range; with
        ``per_sample`` samples a pixel, as many equal values are read as
        one. A bad one fails the directory for a tag of ``_FATAL`` and is
        ignored (``default``) for the rest."""
        if tag not in self.entries:
            return default
        field = self.read(tag)
        if field is None:
            return self._bad(tag, default)
        typ, vals = field
        if typ not in (_INTS32 if tag in _WIDE else _INTS):
            return self._bad(tag, default)
        if len(vals) != 1:
            if not per_sample or len(vals) < per_sample \
                    or len(set(vals[:per_sample])) > 1:
                return self._bad(tag, default)
        v = int(vals[0])
        if not 0 <= v < (1 << (32 if tag in _WIDE else 16)):
            return self._bad(tag, default)
        return v

    def ints(self, tag: int, limit: int | None = None) -> list[int] | None:
        """An array of integers (offsets, byte counts, ColorMap,
        ExtraSamples, YCbCrSubsampling), None where libtiff cannot read
        it; NeedsOpenCV for a type it would convert."""
        field = self.read(tag, limit)
        if field is None:
            return None
        typ, vals = field
        if typ not in _INTS32 or any(v < 0 for v in vals):
            raise NeedsOpenCV(f"a TIFF file whose tag {tag} has type {typ}")
        return [int(v) for v in vals]


class _Image:
    """What the directory says of the image, checked as OpenCV and
    libtiff check it."""

    def __init__(self, d: _Directory, from_file: bool):
        self.d = d
        if d.twice:
            raise NeedsOpenCV("a TIFF file whose directory has a tag twice")
        self.spp = d.one(SAMPLES, 1)
        if self.spp == 0:
            raise TiffError("TIFF with no samples per pixel")
        self.width, self.height = d.one(WIDTH), d.one(LENGTH)
        if self.width is None or self.height is None:
            raise TiffError("TIFF directory is missing the image size")
        if self.width == 0 or self.height == 0:
            raise TiffError("TIFF image of no size")
        self.compression = d.one(COMPRESSION, NONE, self.spp)
        self.bits = d.one(BITS, 1, self.spp)
        sf = d.one(SAMPLE_FORMAT, 1, self.spp)
        if not 1 <= sf <= 6:
            raise TiffError(f"TIFF SampleFormat {sf}")
        self.photometric = d.one(PHOTOMETRIC)
        if self.photometric is None:
            raise TiffError("TIFF with no PhotometricInterpretation")
        self.tiled = d.has(TILE_WIDTH) or d.has(TILE_OFFSETS)
        offsets_tag = TILE_OFFSETS if self.tiled else STRIP_OFFSETS
        if not d.has(offsets_tag):
            raise TiffError("TIFF directory is missing its data offsets")
        self.planar = d.one(PLANAR, 1)
        if self.planar not in (1, 2):
            raise TiffError(f"TIFF PlanarConfiguration {self.planar}")
        # the rest of the fields whose bad value fails the directory
        self.rps = d.one(ROWS_PER_STRIP, ALL_ROWS)
        if self.rps == 0:
            raise TiffError("TIFF of RowsPerStrip 0")
        self.tile = (d.one(TILE_WIDTH), d.one(TILE_LENGTH))
        self.extra = d.ints(EXTRA_SAMPLES) if d.has(EXTRA_SAMPLES) else []
        if self.extra is None or len(self.extra) > self.spp \
                or any(e > 2 for e in self.extra):
            raise TiffError("TIFF with bad ExtraSamples")
        self._layout(from_file)
        # OpenCV's readHeader
        if self.bits not in OPENCV_BITS:
            raise TiffError(f"OpenCV reads no {self.bits}-bit TIFF")
        if self.bits == 4 and self.photometric != PALETTE:
            raise TiffError("OpenCV reads 4-bit TIFFs only with a palette")
        if self.bits == 1 and sf not in (1, 2):
            raise TiffError("1-bit TIFF samples that are not integers")
        check_size(self.width, self.height)
        # the rest is OpenCV's readData and libtiff's RGBA interface
        if self.ch > TILE_MAX_SIDE or self.cw > TILE_MAX_SIDE:
            raise TiffError("TIFF strip or tile over 2^24 a side")
        if self.cw * self.ch * 4 >= TILE_MAX_BYTES * 95 // 100:
            # OpenCV reads such an image a row at a time (or refuses it)
            raise NeedsOpenCV("a TIFF file whose strips or tiles hold "
                              "nearly 1 GiB as RGBA")
        if self.spp > 4:
            raise TiffError(f"TIFF of {self.spp} samples a pixel")
        if self.compression in UNCONFIGURED:
            raise TiffError(f"TIFF {UNCONFIGURED[self.compression]} "
                            "compression: OpenCV's libtiff has no codec")
        if self.bits not in RGBA_BITS:
            raise TiffError(f"libtiff converts no {self.bits}-bit samples")
        if sf == 3:
            raise TiffError("TIFF float samples: libtiff converts none")
        if sf != 1:
            raise NeedsOpenCV(f"a TIFF file of SampleFormat {sf}")
        if self.compression not in DECODED:
            name = COMPRESSION_NAMES.get(self.compression,
                                         f"compression {self.compression}")
            raise NeedsOpenCV(f"a TIFF file with {name} compression")
        if d.one(FILL_ORDER, 1) != 1:
            raise NeedsOpenCV("a TIFF file of FillOrder 2")
        # tif_dirread.c: the samples past the photometric's colours are
        # extra samples (of unspecified kind) whatever ExtraSamples says
        colours = {MINISWHITE: 1, MINISBLACK: 1, PALETTE: 1, 4: 1, RGB: 3,
                   YCBCR: 3, 8: 3, 9: 3, 10: 3, 5: 4}.get(self.photometric)
        if colours and self.spp - len(self.extra) > colours:
            self.extra += [0] * (self.spp - colours - len(self.extra))
        if self.photometric == PALETTE:
            # then a palette image without its ColorMap is grey (or RGB,
            # its extra samples kept) from 8 bits up, and fails below
            # (libtiff reads a ColorMap only after BitsPerSample)
            self.cmap = d.ints(COLORMAP) if d.before(BITS, COLORMAP) \
                else None
            if self.cmap is None or len(self.cmap) != 3 << self.bits \
                    or max(self.cmap) > 65535:
                if self.bits < 8:
                    raise TiffError("palette TIFF without its ColorMap")
                self.photometric = RGB if self.spp == 3 else MINISBLACK
        self.colors = self.spp - len(self.extra)
        if self.spp == 1:
            self.planar = 1
        self.predictor = d.one(PREDICTOR, 1)
        if self.compression not in (LZW, DEFLATE, ADOBE_DEFLATE):
            self.predictor = 1
        if self.predictor == 2 and self.bits not in (8, 16):
            raise TiffError("horizontal differencing of "
                            f"{self.bits}-bit samples")
        if self.predictor not in (1, 2):
            raise TiffError(f"TIFF Predictor {self.predictor}")
        self._check_photometric()
        self.orientation = d.one(ORIENTATION, 1)
        if not 1 <= self.orientation <= 8:
            self.orientation = 1
        if from_file and self.orientation >= 5 \
                and self.width != self.height:
            raise TiffError("OpenCV reads no turned TIFF (orientation "
                            f"{self.orientation}) of a non-square image "
                            "from a file")

    def _check_photometric(self) -> None:
        """TIFFRGBAImageOK and the put routines libtiff picks."""
        ph, bits = self.photometric, self.bits
        if ph in (MINISWHITE, MINISBLACK, PALETTE):
            if self.planar == 1 and self.spp != 1 and bits < 8:
                raise TiffError("libtiff cannot convert contiguous "
                                f"{bits}-bit samples of {self.spp} a pixel")
        if ph == RGB and self.colors < 3:
            raise TiffError("an RGB TIFF of fewer than three colours")
        if ph == YCBCR:
            if self.compression != JPEG:
                raise NeedsOpenCV("a TIFF file of uncompressed YCbCr")
            if self.planar != 1:
                raise NeedsOpenCV("a TIFF file of planar YCbCr")
        elif ph not in (MINISWHITE, MINISBLACK, RGB, PALETTE):
            raise NeedsOpenCV(f"a TIFF file of PhotometricInterpretation {ph}")
        if ph == PALETTE:
            if self.planar != 1 or bits == 16:
                raise TiffError("libtiff cannot convert this palette TIFF")
        elif ph in (RGB, YCBCR) and bits < 8:
            raise TiffError(f"libtiff cannot convert {bits}-bit RGB")
        elif self.planar == 2 and bits < 8:
            raise TiffError(f"libtiff cannot convert planar {bits}-bit "
                            "samples")
        # the alpha libtiff sees: the first extra sample, unspecified
        # taken as associated past three samples a pixel
        self.alpha = 0
        if self.extra:
            if self.extra[0] in (1, 2):
                self.alpha = self.extra[0]
            elif self.extra[0] == 0 and self.spp > 3:
                self.alpha = 1
        if self.compression == JPEG and (self.bits != 8 or self.planar != 1
                                         or self.spp not in (1, 3)):
            raise NeedsOpenCV("a TIFF file of JPEG-compressed pixels other "
                              "than 8-bit grey or colour")

    def _layout(self, from_file: bool) -> None:
        """Chunk (strip or tile) sizes, offsets and byte counts, as
        libtiff's directory reading takes them."""
        d = self.d
        if self.tiled:
            if not (d.has(TILE_WIDTH) and d.has(TILE_LENGTH)):
                raise NeedsOpenCV("a TIFF file without its tile size")
            self.cw, self.ch = self.tile
            if self.cw == 0 or self.ch == 0 or self.cw % 16 \
                    or self.ch % 16:
                raise NeedsOpenCV("a TIFF file of irregular tiles")
            across = -(-self.width // self.cw)
            down = -(-self.height // self.ch)
            counts_tag, offsets_tag = TILE_BYTES, TILE_OFFSETS
        else:
            rps = self.rps
            self.cw = self.width
            self.ch = self.height if rps == ALL_ROWS else rps
            across, down = 1, -(-self.height // min(self.ch, self.height))
            counts_tag, offsets_tag = STRIP_BYTES, STRIP_OFFSETS
        planes = self.spp if self.planar == 2 else 1
        self.across, self.down = across, down
        n = across * down * planes
        self.offsets = d.ints(offsets_tag, n)
        if self.offsets is None:
            raise TiffError("TIFF data offsets past the end of the file")
        self.counts = d.ints(counts_tag, n) if d.has(counts_tag) else None
        if self.counts is None:
            raise NeedsOpenCV("a TIFF file without its byte counts")
        if len(self.offsets) != n or len(self.counts) != n:
            raise NeedsOpenCV(f"a TIFF file of {len(self.offsets)} data "
                              f"offsets for {n} strips or tiles")
        per_pixel = 1 if self.planar == 2 else self.spp
        self.row_bytes = -(-self.cw * per_pixel * self.bits // 8)
        self.from_file = from_file
        self._estimate_counts()

    def _estimate_counts(self) -> None:
        """tif_dirread.c: the byte counts libtiff ignores and computes
        itself (EstimateStripByteCounts) where they look wrong."""
        n = len(self.counts)
        if n == 1 and not self.tiled:
            c, off = self.counts[0], self.offsets[0]
            if off == 0:
                return
            if c == 0 and self.compression != NONE:
                raise NeedsOpenCV("a TIFF file whose one strip has no "
                                  "byte count")
            if self.compression == NONE and (
                    c == 0 or (off <= len(self.d.buf)
                               and c > len(self.d.buf) - off)
                    or c < self.row_bytes * self.height):
                self.counts = [self.row_bytes * self.height]
        elif self.planar == 1 and n > 2 and self.compression == NONE \
                and self.counts[0] != self.counts[1] \
                and self.counts[0] and self.counts[1]:
            size = self.ch * self.row_bytes if self.tiled \
                else self.row_bytes * (self.height // n)
            self.counts = [size] * n


def _inflate(data: bytes, occ: int) -> tuple[bytes, bool]:
    """tif_zip.c ZIPDecode: (the bytes inflated, at most ``occ``; whether
    the strip decoded whole). A stream that ends early is short; a
    corrupt one is OpenCV's to read."""
    z = zlib.decompressobj()
    try:
        out = z.decompress(data, occ)
    except zlib.error as e:
        raise NeedsOpenCV(f"a TIFF file whose Deflate data is corrupt ({e})") \
            from e
    return out, len(out) == occ


def _native(fn: str, data: bytes, out: np.ndarray) -> tuple[int, bool]:
    from epipolarpose_tpu_torch.data import png
    written = ctypes.c_size_t()
    status = getattr(png.LIBRARY.load(), fn)(data, len(data),
                                             out.ctypes.data, out.size,
                                             ctypes.byref(written))
    if status == 2:
        raise NeedsOpenCV("a TIFF file of old-style LZW")
    return written.value, status == 0


def _jpeg_frame(data: bytes) -> tuple | None:
    """(width, height, [(h, v) sampling of each component]) from a JPEG
    stream's frame header; None without one."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            seg = data[pos + 4:pos + 2 + length]
            if len(seg) < 6 or len(seg) < 6 + 3 * seg[5]:
                return None
            return (int.from_bytes(seg[3:5], "big"),
                    int.from_bytes(seg[1:3], "big"),
                    [(seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15)
                     for i in range(seg[5])])
        pos += 2 + length
    return None


def _jpeg_chunk(img: _Image, data: bytes, rows: int, cols: int) \
        -> np.ndarray:
    """One JPEG strip or tile -> (rows, cols, spp) samples as libjpeg
    gives them to libtiff: YCbCr converted to RGB (fancy upsampling), the
    rest as coded."""
    field = img.d.read(JPEG_TABLES)
    tables = field[1][0] if field and field[0] == 7 else b""
    if tables[:2] == b"\xff\xd8" and tables[-2:] == b"\xff\xd9" \
            and data[:2] == b"\xff\xd8":
        data = tables[:-2] + data[2:]
    sub = [1, 1]
    if img.photometric == YCBCR:
        sub = (img.d.ints(YCBCR_SUBSAMPLING) or [2, 2])[:2] \
            if img.d.has(YCBCR_SUBSAMPLING) else [2, 2]
    frame = _jpeg_frame(data)
    if frame is None or frame[:2] != (cols, rows) \
            or len(frame[2]) != img.spp or frame[2][0] != tuple(sub) \
            or any(f != (1, 1) for f in frame[2][1:]):
        raise NeedsOpenCV("a TIFF file whose JPEG strips or tiles are not the "
                          "size and sampling it says")
    flavour = "tiff_ycbcr" if img.photometric == YCBCR else "tiff_raw"
    try:
        rgb = jpeg.decode(data, 8, flavour)
    except IOError as e:          # JpegWarning among them
        raise NeedsOpenCV(f"a TIFF file whose JPEG data is damaged ({e})") \
            from e
    return rgb if img.spp == 3 else rgb[..., :1]


class _ReadFailed(Exception):
    """libtiff fails a strip or tile before decoding it (its data cannot
    be read): the whole read where it is the first plane's."""


def _chunk(img: _Image, index: int, rows: int) -> tuple[np.ndarray, bool]:
    """Strip or tile ``index`` decoded as libtiff's reader leaves it:
    (rows x row_bytes bytes, decoded whole); raises :class:`_ReadFailed`
    where libtiff cannot read its data (tif_read.c TIFFFillStrip and
    TIFFFillTile)."""
    buf = img.d.buf
    off, count = img.offsets[index], img.counts[index]
    occ = rows * img.row_bytes
    full = img.ch * img.row_bytes
    out = np.zeros(occ, np.uint8)
    if count == 0:
        raise _ReadFailed(f"TIFF strip or tile {index} of no bytes")
    if count > 1 << 20 and (count - 4096) // 10 > full:
        count = full * 10 + 4096             # "Limiting to ..."
    if img.compression == NONE and img.tiled:
        # libtiff reads an uncompressed tile whole, and from memory
        # (OpenCV's imdecode) takes its byte count in 1 KiB steps
        got = count if img.from_file else -(-count // 1024) * 1024
        if got != full:
            raise _ReadFailed(f"tile {index} of {count} bytes (taken as "
                              f"{got}), not {full}")
    if off + count > len(buf):
        raise _ReadFailed(f"TIFF strip or tile {index} past the end")
    data = buf[off:off + count]
    if img.compression == NONE:
        if count < occ:                     # DumpModeDecode: not enough
            return out, False
        out[:] = np.frombuffer(data, np.uint8, occ)
        return out, True
    if img.compression == JPEG:
        samples = _jpeg_chunk(img, data, rows, img.cw)
        return samples.reshape(-1), True
    if img.compression in (DEFLATE, ADOBE_DEFLATE):
        raw, whole = _inflate(data, occ)
        out[:len(raw)] = np.frombuffer(raw, np.uint8)
        return out, whole
    fn = "epk_tiff_lzw" if img.compression == LZW else "epk_tiff_packbits"
    _, whole = _native(fn, data, out)
    return out, whole


def _unpredict(img: _Image, raw: np.ndarray, rows: int) -> None:
    from epipolarpose_tpu_torch.data import png
    per_pixel = 1 if img.planar == 2 else img.spp
    png.LIBRARY.load().epk_tiff_unpredict(
        raw.ctypes.data, rows, img.cw * per_pixel, per_pixel, img.bits // 8,
        int(img.bits == 16 and img.d.e == ">"))


def _samples(img: _Image, raw: np.ndarray, rows: int, native: bool) \
        -> np.ndarray:
    """Decoded bytes -> (rows, cw, samples) integers; ``native``: 16-bit
    samples already in this machine's (little-endian) order."""
    per_pixel = 1 if img.planar == 2 else img.spp
    if img.bits == 16:
        dt = "<u2" if native else img.d.e + "u2"
        v = raw[:rows * img.row_bytes].view(dt)
        return v.reshape(rows, img.cw, per_pixel)
    if img.bits == 8:
        return raw[:rows * img.row_bytes].reshape(rows, img.cw, per_pixel)
    rowbits = np.unpackbits(raw[:rows * img.row_bytes]
                            .reshape(rows, img.row_bytes), axis=1)
    n = img.cw * per_pixel
    bits = rowbits[:, :n * img.bits].reshape(rows, n, img.bits)
    weights = 1 << np.arange(img.bits - 1, -1, -1, dtype=np.uint16)
    v = (bits * weights).sum(2).astype(np.uint16)
    return v.reshape(rows, img.cw, per_pixel)


def _hi16(v: np.ndarray) -> np.ndarray:
    """tif_getimage.c's Bitdepth16To8: (v + 128) / 257."""
    return ((v.astype(np.uint32) + 128) // 257).astype(np.uint8)


def _premultiply(c: np.ndarray, a: np.ndarray) -> np.ndarray:
    """tif_getimage.c's UaToAa: (v * a + 127) / 255."""
    return ((c.astype(np.uint32) * a + 127) // 255).astype(np.uint8)


def _contig_rgb(img: _Image, s: np.ndarray) -> np.ndarray:
    """libtiff's contiguous put routines: (rows, cols, spp) -> RGB."""
    ph, bits = img.photometric, img.bits
    if img.compression == JPEG and ph == YCBCR:
        ph = RGB                  # libjpeg gave RGB
    if ph == PALETTE:
        cmap = np.array(img.cmap, np.uint32) \
            .reshape(3, 1 << bits)
        if (cmap >= 256).any():
            cmap = cmap >> 8
        return cmap.T.astype(np.uint8)[s[..., 0]]
    if ph in (MINISWHITE, MINISBLACK):
        top = 255 if bits == 16 else (1 << bits) - 1
        x = np.arange(top + 1, dtype=np.uint32)
        lut = ((top - x if ph == MINISWHITE else x) * 255 // top) \
            .astype(np.uint8)
        g = s[..., 0] >> 8 if bits == 16 else s[..., 0]
        return np.repeat(lut[g][..., None], 3, axis=2)
    rgb = s[..., :3]
    alpha = s[..., 3] if img.spp >= 4 else None
    if bits == 16:
        rgb = _hi16(rgb)
        if alpha is not None:
            alpha = _hi16(alpha)
    if img.alpha == 2 and alpha is not None:
        return _premultiply(rgb, alpha[..., None])
    return rgb.astype(np.uint8)


def _separate_rgb(img: _Image, planes: list) -> np.ndarray:
    """libtiff's separate put routines: the colour planes (one for grey,
    taken for all three, raw) and the alpha plane when there is one ->
    RGB, unassociated alpha multiplied in."""
    if img.bits == 16:
        planes = [_hi16(p) for p in planes]
    colours = planes[:3] if img.colors >= 3 else planes[:1] * 3
    rgb = np.stack([p.astype(np.uint8) for p in colours], -1)
    if img.alpha == 2:
        return _premultiply(rgb, planes[-1].astype(np.uint32)[..., None])
    return rgb


def _plane(img: _Image, index: int, rows: int, first: bool) \
        -> np.ndarray:
    """One strip or tile of one plane as (rows, cw, samples) integers.
    libtiff's RGBA reader fails the image when the first plane's data
    cannot be read, and shows the others' zeros then."""
    try:
        if not first and img.compression == NONE and not img.tiled \
                and not img.from_file:
            # TIFFReadEncodedStrip from memory (not mapped) reads an
            # uncompressed strip's bytes straight from its offset, what
            # is there of them, whatever its byte count
            raw = np.zeros(rows * img.row_bytes, np.uint8)
            got = img.d.buf[img.offsets[index]:][:raw.size]
            raw[:len(got)] = np.frombuffer(got, np.uint8)
            whole = len(got) == raw.size
        else:
            raw, whole = _chunk(img, index, rows)
    except _ReadFailed as e:
        if first:
            raise TiffError(str(e)) from e
        raw, whole = np.zeros(rows * img.row_bytes, np.uint8), False
    if img.compression == JPEG:
        return raw.reshape(rows, img.cw, -1)
    native = not whole            # a failed read swabs nothing
    if whole and img.predictor == 2:
        _unpredict(img, raw, rows)
        native = True
    return _samples(img, raw, rows, native)


def _read(img: _Image) -> np.ndarray:
    """Every strip or tile through libtiff's reader and put routines ->
    (H, W, 3) RGB, rows as the file stores them. Of planar data libtiff
    reads the colour planes (one for grey) and the alpha plane only."""
    out = np.zeros((img.height, img.width, 3), np.uint8)
    planes = [0]
    if img.planar == 2:
        planes = [0, 1, 2] if img.colors >= 3 else [0]
        if img.alpha:
            planes.append(img.colors)
    per_plane = img.across * img.down
    for ty in range(img.down):
        y0 = ty * img.ch
        rows = min(img.ch, img.height - y0)
        # a strip holds its rows only, a tile all of its own
        read_rows = img.ch if img.tiled else rows
        for tx in range(img.across):
            x0 = tx * img.cw
            cols = min(img.cw, img.width - x0)
            got = [_plane(img, p * per_plane + ty * img.across + tx,
                          read_rows, p == 0)[:rows, :cols]
                   for p in planes]
            if img.planar == 1:
                rgb = _contig_rgb(img, got[0])
            else:
                rgb = _separate_rgb(img, [g[..., 0] for g in got])
            out[y0:y0 + rows, x0:x0 + cols] = rgb
    return out


def decode(buf: bytes, from_file: bool = True,
           times: dict | None = None) -> tuple[np.ndarray, int]:
    """A TIFF's first image -> ((H, W, 3) uint8 RGB as stored, its
    Orientation tag, 1-8), which OpenCV's ``IMREAD_COLOR`` read turns as
    it turns a JPEG by its EXIF orientation, from a file
    (``from_file``) or from memory. Raises :class:`TiffError` where
    OpenCV gives no image, :class:`imgformats.ImageTooLarge` where it
    raises, and :class:`imgformats.NeedsOpenCV` for what only OpenCV
    reads. ``times`` receives the ms of the directory walk and of the
    strips' decode."""
    global _count
    t0 = time.perf_counter()
    img = _Image(_Directory(buf), from_file)
    t1 = time.perf_counter()
    out = _read(img)
    if times is not None:
        times["directory_ms"] = (t1 - t0) * 1e3
        times["decode_ms"] = (time.perf_counter() - t1) * 1e3
    with _count_lock:
        _count += 1
    return out, img.orientation
