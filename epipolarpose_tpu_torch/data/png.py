"""The port's PNG reader: what OpenCV 5's ``IMREAD_COLOR`` read gives,
without OpenCV or libpng.

The card's machine has neither. Python walks the chunks, checks their
CRCs with ``zlib.crc32`` and inflates the IDAT stream with the standard
library's ``zlib``; the native pass (``native/imgdec.cpp``, built with
``g++`` alone through ``data/cxx_library.py``, as the JPEG decoder is)
undoes the filters, de-interlaces Adam7 and converts to 8 bits, three
channels, as OpenCV asks libpng to: 16-bit samples give their high byte,
grey is copied into every channel, palette indices past PLTE are black,
alpha is dropped (not composited), and gAMA, iCCP, sRGB and the like
leave the pixels as they are. :func:`decode` gives no image exactly where
OpenCV gives none (``PngError``), following libpng 1.6's sequential
reader and OpenCV's own pass over the chunks before IDAT:

- chunk structure: IHDR first and 13 bytes long; names of letters only,
  the third upper case;
  every chunk up to IEND present; a CRC error fails a critical chunk
  (IHDR, PLTE, IDAT) and drops an ancillary one (and IEND's is ignored);
  an unknown critical chunk fails;
- IHDR's fields as png_check_IHDR takes them, with libpng's limit of
  1,000,000 a side; a palette image needs one PLTE of 1-256 entries
  before IDAT;
- the IDAT stream as png_read_IDAT_data reads it: rows are inflated from
  8,192-byte reads of the first run of IDAT chunks, so a zlib error fails
  the image if it comes while rows are read (the check value included,
  when its bytes are already in the read) and is ignored after them; the
  stream must end inside that run; too much data is ignored;
- OpenCV's own checks: acTL of 8 bytes, once, before fcTL and with frames;
  fcTL of 26 bytes inside the image with known dispose and blend ops;
  bKGD of 1, 2 or 6 bytes; no chunk over 8,000,000 bytes before IDAT
  but PLTE, tRNS, tEXt and fdAT.

An image over OpenCV's size limits (``CV_IO_MAX_IMAGE_PIXELS``; OpenCV
raises there) raises :class:`imgformats.ImageTooLarge` before anything is
allocated. The orientation of the first eXIf chunk libpng accepts (its
TIFF block in either byte order), before or after IDAT, is returned for
the caller to apply, as OpenCV applies it. An APNG gives its default
image. OpenCV decodes an animation's first frame through libpng's
progressive reader instead, whose handling of damage differs; so an
animated file (acTL of two frames or more) is decoded here only where its
first frame is the default image and covers it, and nothing in it is
damaged; other animated files raise :class:`imgformats.NeedsOpenCV`.
"""

from __future__ import annotations

import ctypes
import pathlib
import struct
import threading
import time
import zlib

import numpy as np

from epipolarpose_tpu_torch.data.cxx_library import CxxLibrary
from epipolarpose_tpu_torch.data.imgformats import (PNG_SIGNATURE,
                                                    NeedsOpenCV,
                                                    check_size,
                                                    tiff_orientation)

PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR / "native" / "imgdec.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
ERR_LEN = 256
SIGNATURE = PNG_SIGNATURE
# libpng's PNG_USER_WIDTH_MAX and PNG_USER_HEIGHT_MAX
USER_SIZE_MAX = 1_000_000
# libpng's PNG_USER_CHUNK_MALLOC_MAX: OpenCV refuses a chunk larger than
# this (its 12 bytes of length, name and CRC included) before IDAT, but
# for the kinds OPENCV_SIZED
CHUNK_MALLOC_MAX = 8_000_000
# libpng's PNG_IDAT_READ_SIZE: the IDAT bytes a read hands to inflate
IDAT_READ_SIZE = 8192
# colour type -> (channels, the bit depths it allows)
COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
               3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
OPENCV_SIZED = (b"PLTE", b"tRNS", b"tEXt", b"fdAT")

_c = ctypes.c_char_p
_i = ctypes.c_int
SIGNATURES = {
    "epk_png_unfilter": (_i, (_c, ctypes.c_size_t, _i, _i, _i, _i, _i, _c,
                              ctypes.c_void_p, _c, _i)),
    "epk_bmp_rle": (_i, (_c, ctypes.c_size_t, _i, _i, _i, ctypes.c_void_p,
                         _c, _i)),
    "epk_tiff_lzw": (_i, (_c, ctypes.c_size_t, ctypes.c_void_p,
                          ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t))),
    "epk_tiff_packbits": (_i, (_c, ctypes.c_size_t, ctypes.c_void_p,
                               ctypes.c_size_t,
                               ctypes.POINTER(ctypes.c_size_t))),
    "epk_tiff_unpredict": (_i, (ctypes.c_void_p, ctypes.c_size_t,
                                ctypes.c_size_t, _i, _i, _i)),
}
# the native library of the non-JPEG readers (PNG here, BMP's RLE in
# imgformats.py, TIFF's LZW, PackBits and predictor in tiff.py)
LIBRARY = CxxLibrary("imgdec", SOURCE, CXX_FLAGS, (), SIGNATURES,
                     "image decoder")
_count_lock = threading.Lock()
# decodes since the last reset_count() (read by the smoke run)
_count = 0


class PngError(IOError):
    """A PNG that OpenCV gives no image for."""


def available() -> bool:
    """True when the native library is built (or builds now) and loads."""
    return LIBRARY.available()


def build_error() -> str | None:
    return LIBRARY.build_error()


def decode_count() -> int:
    """PNGs decoded since the last :func:`reset_count`."""
    return _count


def reset_count() -> None:
    global _count
    with _count_lock:
        _count = 0


def _u32(b: bytes, at: int = 0) -> int:
    return int.from_bytes(b[at:at + 4], "big")


class _Header:
    """IHDR's fields and what follows from them."""

    def __init__(self, body: bytes):
        (self.width, self.height, self.depth, self.color_type,
         self.compression, self.filter, self.interlace) = struct.unpack(
            ">IIBBBBB", body)
        self.channels = COLOR_TYPES.get(self.color_type, (0, ()))[0]

    def valid(self) -> bool:
        """png_check_IHDR, with libpng's default user limits."""
        _, depths = COLOR_TYPES.get(self.color_type, (0, ()))
        return (0 < self.width <= USER_SIZE_MAX
                and 0 < self.height <= USER_SIZE_MAX
                and self.depth in depths and self.compression == 0
                and self.filter == 0 and self.interlace in (0, 1))

    def row_sizes(self) -> list[int]:
        """The bytes of each scanline in stream order, its filter byte
        included."""
        bits = self.channels * self.depth
        passes = ADAM7 if self.interlace else ((0, 0, 1, 1),)
        sizes = []
        for x0, y0, dx, dy in passes:
            if x0 >= self.width or y0 >= self.height:
                continue
            pw = (self.width - x0 + dx - 1) // dx
            ph = (self.height - y0 + dy - 1) // dy
            sizes += [1 + (pw * bits + 7) // 8] * ph
        return sizes


class _Chunks:
    """The file's chunks as libpng and OpenCV read them, up to IEND."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = len(SIGNATURE)

    def next(self) -> tuple[bytes, bytes, bool]:
        """(name, body, crc_ok) of the next chunk; PngError where the
        file ends first or the header is bad."""
        buf, pos = self.buf, self.pos
        if pos + 8 > len(buf):
            raise PngError("the data ends before IEND")
        length, name = _u32(buf, pos), buf[pos + 4:pos + 8]
        if length > 0x7FFFFFFF:
            raise PngError("PNG unsigned integer out of range")
        # letters only, the third upper case (its reserved bit clear)
        if not all(65 <= c <= 90 or 97 <= c <= 122 for c in name) \
                or name[2] > 90:
            raise PngError(f"bad chunk type {name!r}")
        end = pos + 8 + length
        if end + 4 > len(buf):
            raise PngError(f"{name!r} ends past the data")
        body = buf[pos + 8:end]
        crc_ok = zlib.crc32(buf[pos + 4:end]) == _u32(buf, end)
        self.pos = end + 4
        return name, body, crc_ok


class _Parsed:
    """What decode needs from the chunks: the header, the palette, the
    first run of IDAT chunks, the eXIf block; and whether the file holds
    anything that libpng only warns about."""

    def __init__(self):
        self.hdr: _Header | None = None
        self.after_idat = False
        self.palette = np.zeros((256, 3), np.uint8)
        self.idat: list[bytes] = []
        self.exif: bytes | None = None
        self.frames = 0             # acTL's count
        self.first_fctl: bytes | None = None
        self.irregular = False


def _parse(buf: bytes, out: _Parsed) -> None:
    """Walk the chunks up to IEND into ``out``; PngError where libpng or
    OpenCV refuses the file, ImageTooLarge where OpenCV raises."""
    chunks = _Chunks(buf)
    name, body, crc_ok = chunks.next()
    if name != b"IHDR" or len(body) != 13:
        raise PngError("IHDR chunk shall be first")
    hdr = out.hdr = _Header(body)
    if not crc_ok:
        raise PngError("IHDR: CRC error")
    if not hdr.valid():
        raise PngError("invalid IHDR data")
    have_plte = in_run = False
    next_fctl = None                # the first fcTL after IDAT
    while True:
        name, body, crc_ok = chunks.next()
        if not out.after_idat and name != b"IDAT":
            _opencv_checks(name, body, hdr, out)
        if name == b"IDAT":
            if not out.after_idat:
                if hdr.color_type == 3 and not have_plte:
                    raise PngError("Missing PLTE before IDAT")
                check_size(hdr.width, hdr.height)
                out.after_idat = in_run = True
            if not crc_ok:
                raise PngError("IDAT: CRC error")
            if in_run:
                out.idat.append(body)
            else:
                out.irregular = True        # "Too many IDATs found"
            continue
        in_run = False
        if name == b"IEND":
            out.irregular |= not crc_ok or bool(body)
            break
        if name == b"IHDR":
            raise PngError("IHDR: out of place")
        if name == b"PLTE":
            if hdr.color_type == 3:
                n = len(body) // 3
                if not crc_ok or have_plte or not body or len(body) % 3 \
                        or n > 256:
                    raise PngError("PLTE: invalid")
                n = min(n, 1 << hdr.depth)
                out.palette[:n] = np.frombuffer(body, np.uint8)[:3 * n] \
                    .reshape(n, 3)
            else:
                out.irregular |= have_plte or out.after_idat or not crc_ok \
                    or not body or len(body) % 3 > 0 or len(body) > 768
            have_plte = True
            continue
        if name[0] < 97:                    # an unknown critical chunk
            raise PngError(f"{name!r}: unhandled critical chunk")
        if not crc_ok:
            out.irregular = True
            continue
        if name == b"fcTL" and out.after_idat and next_fctl is None:
            next_fctl = body
        if name == b"eXIf":
            if len(body) >= 2 and body[0] == body[1] and body[:1] in b"IM" \
                    and out.exif is None:
                out.exif = body
            else:
                out.irregular = True
    if out.frames >= 2 and next_fctl is not None:
        _fctl_check(next_fctl, hdr)


def _opencv_checks(name: bytes, body: bytes, hdr: _Header,
                   out: _Parsed) -> None:
    """What OpenCV's own pass over the chunks before IDAT refuses (it
    reads them whatever their CRC)."""
    if name == b"acTL":
        if len(body) != 8 or out.frames or out.first_fctl is not None \
                or _u32(body) == 0:
            raise PngError("bad acTL")
        out.frames = _u32(body)
    elif name == b"fcTL":
        _fctl_check(body, hdr)
        if out.first_fctl is None:
            out.first_fctl = body
    elif name == b"bKGD":
        if len(body) not in (1, 2, 6):
            raise PngError("bad bKGD size")
    elif len(body) + 12 > CHUNK_MALLOC_MAX and name not in OPENCV_SIZED:
        raise PngError(f"{name!r} is too large")


def _fctl_check(body: bytes, hdr: _Header) -> None:
    if len(body) != 26:
        raise PngError("bad fcTL size")
    w, h, x, y = struct.unpack(">IIII", body[4:20])
    if w + x > hdr.width or h + y > hdr.height or body[24] > 2 \
            or body[25] > 1:
        raise PngError("bad fcTL")


def _inflate_exact(idat: list[bytes], rows: list[int]) -> bytes:
    """The scanlines as libpng's png_read_IDAT_data reads them: each row
    inflated from IDAT_READ_SIZE-byte reads of the IDAT run; a zlib error
    or the stream's end before the last row fails, and after the rows the
    stream must end within the run (an error there is only a warning)."""
    reads = [c[i:i + IDAT_READ_SIZE] for c in idat
             for i in range(0, len(c), IDAT_READ_SIZE)]
    d = zlib.decompressobj(0)
    out, tail, k = [], b"", 0
    for need in rows:
        got = b""
        while len(got) < need:
            if not tail:
                if k == len(reads):
                    raise PngError("Not enough image data")
                tail, k = reads[k], k + 1
            if d.eof:
                raise PngError("Not enough image data")
            try:
                got += d.decompress(tail, need - len(got))
            except zlib.error as e:
                raise PngError(f"IDAT: {e}") from e
            tail = d.unconsumed_tail if not d.eof else b""
        out.append(got)
    while not d.eof:                        # png_read_finish_IDAT
        if not tail:
            if k == len(reads):
                raise PngError("Not enough image data")
            tail, k = reads[k], k + 1
        try:
            d.decompress(tail, 1 << 20)
        except zlib.error:
            break
        tail = d.unconsumed_tail
    return b"".join(out)


def _inflate(idat: list[bytes], rows: list[int]) -> tuple[bytes, bool]:
    """The first ``sum(rows)`` bytes of the IDAT stream, or PngError
    where libpng refuses it, and whether the stream held exactly those
    bytes and ended with the run: one inflate of the whole run where it
    ends cleanly with enough data (libpng then reads it too), libpng's
    own order of reads otherwise."""
    need = sum(rows)
    d = zlib.decompressobj(0)
    try:
        data = d.decompress(b"".join(idat))
        if d.eof and len(data) >= need:
            return data[:need], len(data) == need and not d.unused_data
    except zlib.error:
        pass
    return _inflate_exact(idat, rows), False


def decode(buf: bytes, from_file: bool = True,
           times: dict | None = None) -> tuple[np.ndarray, int]:
    """One PNG -> ((H, W, 3) uint8 RGB, its EXIF orientation, 1-8). Of an
    animation OpenCV applies the orientation when it reads a file but not
    when it reads memory: ``from_file`` says which this is. Raises :class:`PngError` where OpenCV gives no
    image, :class:`imgformats.ImageTooLarge` where it raises, and
    :class:`imgformats.NeedsOpenCV` for the animations decoded only
    there. ``times`` receives the ms of the inflate and the native pass."""
    global _count
    if buf[:8] != SIGNATURE:
        raise PngError("not a PNG")
    lib = LIBRARY.load()
    t0 = time.perf_counter()
    parsed = _Parsed()
    try:
        _parse(buf, parsed)
        hdr = parsed.hdr
        rows = hdr.row_sizes()
        data, clean = _inflate(parsed.idat, rows)
    except PngError as e:
        if parsed.frames >= 2 and parsed.after_idat:
            raise NeedsOpenCV("a damaged animated PNG") from e
        raise
    if parsed.frames >= 2:
        first = parsed.first_fctl
        if first is None or struct.unpack(">IIII", first[4:20]) != (
                hdr.width, hdr.height, 0, 0):
            raise NeedsOpenCV("an animated PNG whose first frame is not "
                              "its whole default image")
        if parsed.irregular or not clean:
            raise NeedsOpenCV("a damaged animated PNG")
    t1 = time.perf_counter()
    out = np.empty((hdr.height, hdr.width, 3), np.uint8)
    err = ctypes.create_string_buffer(ERR_LEN)
    status = lib.epk_png_unfilter(data, len(data), hdr.width, hdr.height,
                                  hdr.depth, hdr.color_type, hdr.interlace,
                                  parsed.palette.tobytes(), out.ctypes.data,
                                  err, ERR_LEN)
    if status:
        raise PngError(err.value.decode(errors="replace")
                       or f"bad arguments ({status})")
    if times is not None:
        times["inflate_ms"] = (t1 - t0) * 1e3
        times["native_ms"] = (time.perf_counter() - t1) * 1e3
    with _count_lock:
        _count += 1
    exif = parsed.exif if parsed.frames < 2 or from_file else None
    return out, tiff_orientation(exif) if exif else 1
