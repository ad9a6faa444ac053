"""The image formats the port reads without OpenCV, told apart by their
first bytes as OpenCV's ``findDecoder`` tells them apart, and the PNM and
BMP readers.

:func:`sniff` names the decoder for a file's leading bytes: JPEG
``FF D8 FF``, PNG's eight-byte signature, PNM ``P1``-``P6`` followed by
white space, BMP ``BM``, TIFF ``II*\\0``/``MM\\0*`` and BigTIFF's
``II+\\0``/``MM\\0+``. No two of these can match the same bytes, so the
order in which OpenCV tries its decoders does not matter among them;
anything else is OpenCV's (:func:`format_name` names what it is for the
error raised where OpenCV is missing).

:func:`decode_pnm` follows OpenCV 5's ``grfmt_pxm.cpp`` and
:func:`decode_bmp` its ``grfmt_bmp.cpp``, with numpy (BMP's RLE in
``native/imgdec.cpp``): they give the image OpenCV's ``IMREAD_COLOR``
gives, and raise :class:`ImageFormatError` where it gives none and
:class:`ImageTooLarge` where it raises (its ``CV_IO_MAX_IMAGE_*``
limits), before anything is allocated.
"""

from __future__ import annotations

import ctypes

import numpy as np

# OpenCV's CV_IO_MAX_IMAGE_WIDTH, _HEIGHT and _PIXELS
MAX_IMAGE_SIDE = 1 << 20
MAX_IMAGE_PIXELS = 1 << 30
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# C's isspace
_SPACE = b" \t\n\v\f\r"


class ImageFormatError(IOError):
    """A file OpenCV gives no image for."""


class ImageTooLarge(IOError):
    """An image over OpenCV's size limits, where OpenCV raises
    (``validateInputImageSize``) rather than returning no image."""


class NeedsOpenCV(Exception):
    """A file only OpenCV reads; ``what`` names it."""

    def __init__(self, what: str):
        super().__init__(what)
        self.what = what


def check_size(width: int, height: int) -> None:
    """OpenCV's validateInputImageSize."""
    if not (0 < width <= MAX_IMAGE_SIDE and 0 < height <= MAX_IMAGE_SIDE
            and width * height <= MAX_IMAGE_PIXELS):
        raise ImageTooLarge(f"{width}x{height} is over OpenCV's limits "
                            f"({MAX_IMAGE_SIDE} a side, {MAX_IMAGE_PIXELS} "
                            "pixels)")


TIFF_SIGNATURES = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")


def sniff(buf: bytes) -> str | None:
    """'jpeg', 'png', 'pnm', 'bmp' or 'tiff' by the leading bytes; None
    for the rest."""
    if buf[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if buf[:8] == PNG_SIGNATURE:
        return "png"
    if len(buf) >= 3 and buf[:1] == b"P" and 49 <= buf[1] <= 54 \
            and buf[2] in _SPACE:
        return "pnm"
    if buf[:2] == b"BM":
        return "bmp"
    if buf[:4] in TIFF_SIGNATURES:
        return "tiff"
    return None


def format_name(buf: bytes) -> str:
    """What a file the port does not read is, by its leading bytes."""
    if buf[:4] in TIFF_SIGNATURES:
        return "a TIFF file"
    if buf[:4] == b"RIFF" and buf[8:12] == b"WEBP":
        return "a WebP file"
    if buf[4:8] == b"ftyp" and buf[8:12] in (b"avif", b"avis"):
        return "an AVIF file"
    if buf[:4] == b"\xff\x4f\xff\x51" or buf[4:8] == b"jP  ":
        return "a JPEG 2000 file"
    if buf[:6] in (b"GIF87a", b"GIF89a"):
        return "a GIF file"
    if buf[:6] == b"#?RGBE" or buf[:10] == b"#?RADIANCE":
        return "a Radiance HDR file"
    if buf[:4] == b"\x59\xa6\x6a\x95":
        return "a Sun raster file"
    if buf[:2] in (b"PF", b"Pf"):
        return "a PFM file"
    if buf[:2] == b"P7":
        return "a PAM file"
    return "an image of no format the port reads"


def tiff_orientation(t: bytes) -> int:
    """The orientation (1-8) in a TIFF block as OpenCV's ExifReader reads
    it: either byte order, the first entry of tag 0x0112 in IFD0, whose
    16-bit value sits at the entry's offset 8 whatever its type; 1 when
    any of that is missing, cut short or out of 1-8."""
    order = {b"II": "little", b"MM": "big"}.get(t[:2])
    if order is None or len(t) < 8:
        return 1

    def u(at: int, size: int) -> int | None:
        if at + size > len(t):
            return None
        return int.from_bytes(t[at:at + size], order)
    if u(2, 2) != 42:
        return 1
    ifd = u(4, 4)
    count = u(ifd, 2)
    for i in range(count or 0):
        entry = ifd + 2 + 12 * i
        tag = u(entry, 2)
        if tag is None:
            break
        if tag == 0x0112:
            value = u(entry + 8, 2)
            return value if value is not None and 1 <= value <= 8 else 1
    return 1


# ----------------------------------------------------------------- PNM
class _Stream:
    """OpenCV's RLByteStream over bytes: a read past the end fails the
    file."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf, self.pos = buf, pos

    def byte(self) -> int:
        if self.pos >= len(self.buf):
            raise ImageFormatError("Unexpected end of input stream")
        self.pos += 1
        return self.buf[self.pos - 1]

    def bytes(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.buf):
            raise ImageFormatError("Unexpected end of input stream")
        self.pos += n
        return self.buf[self.pos - n:self.pos]

    def number(self, maxdigits: int = 0) -> int:
        """grfmt_pxm.cpp's ReadNumber: skip white space and ``#``
        comments, read decimal digits (``maxdigits`` of them at most),
        and consume the byte after them unless the digits ran out."""
        code = self.byte()
        while not 48 <= code <= 57:
            if code == 35:                              # '#'
                while code not in (10, 13):
                    code = self.byte()
                code = self.byte()
            elif code in _SPACE:
                while code in _SPACE:
                    code = self.byte()
            else:
                raise ImageFormatError(f"PXM: unexpected code {code:#x}")
        val = digits = 0
        while True:
            val = val * 10 + code - 48
            if val > 0x7FFFFFFF:
                raise ImageFormatError("PXM: number too large")
            digits += 1
            if maxdigits and digits >= maxdigits:
                return val
            code = self.byte()
            if not 48 <= code <= 57:
                return val


def decode_pnm(buf: bytes) -> np.ndarray:
    """P1-P6 -> (H, W, 3) uint8 RGB as OpenCV reads it: ASCII 8-bit
    values clamped to maxval and rescaled to 255 (``v * 255 // maxval``),
    binary 8-bit values as they stand, 16-bit values (maxval over 255)
    shifted right by 8 (ASCII ones clamped first), bitmaps 1 = black."""
    s = _Stream(buf, 1)
    kind = s.byte() - 48
    if not 1 <= kind <= 6:
        raise ImageFormatError("not a PNM file")
    bpp = {1: 1, 4: 1, 2: 8, 5: 8, 3: 24, 6: 24}[kind]
    binary = kind >= 4
    width, height = s.number(), s.number()
    maxval = 1 if bpp == 1 else s.number()
    if maxval > 65535:
        raise ImageFormatError("PXM: maxval over 65535")
    if width <= 0 or height <= 0 or maxval <= 0:
        raise ImageFormatError("PXM: empty image")
    check_size(width, height)
    channels = 3 if bpp == 24 else 1
    n = width * channels
    if bpp == 1:
        if binary:
            pitch = (width + 7) // 8
            rows = np.frombuffer(s.bytes(pitch * height), np.uint8)
            bits = np.unpackbits(rows.reshape(height, pitch), axis=1)
            v = bits[:, :width]
        else:
            v = np.array([s.number(1) != 0 for _ in range(width * height)],
                         np.uint8).reshape(height, width)
        grey = np.where(v != 0, 0, 255).astype(np.uint8)
        return np.repeat(grey[..., None], 3, axis=2)
    wide = maxval > 255
    if binary:
        dtype = ">u2" if wide else np.uint8
        size = n * height * (2 if wide else 1)
        v = np.frombuffer(s.bytes(size), dtype).astype(np.int64)
        out = v >> 8 if wide else v
    else:
        v = np.minimum(np.array([s.number() for _ in range(n * height)],
                                np.int64), maxval)
        out = v >> 8 if wide else v * 255 // maxval
    out = out.astype(np.uint8).reshape(height, width, channels)
    return out if channels == 3 else np.repeat(out, 3, axis=2)


# ----------------------------------------------------------------- BMP
BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3


def _le(buf: bytes, at: int, size: int, signed: bool = False) -> int:
    if at + size > len(buf):
        raise ImageFormatError("Unexpected end of input stream")
    return int.from_bytes(buf[at:at + size], "little", signed=signed)


def decode_bmp(buf: bytes) -> np.ndarray:
    """A BMP -> (H, W, 3) uint8 RGB as OpenCV reads it: core (OS/2),
    INFO, V4 and V5 headers; 1, 4 and 8 bits through the palette (read
    right after the header; entries past the ones given are black), 16
    as 5-5-5 or, with 5-6-5 BI_BITFIELDS masks after the header, 5-6-5
    (the bits shifted up, not scaled), 24, and 32 with alpha dropped or,
    given a V4/V5 header's BI_BITFIELDS masks for all three colours, each
    channel scaled to 8 bits by its mask (in float32, truncated); rows bottom-up unless the
    height is negative; RLE8 and RLE4 as ``native/imgdec.cpp`` decodes
    them."""
    offset = _le(buf, 10, 4)
    size = _le(buf, 14, 4, signed=True)
    if size <= 0:
        raise ImageFormatError("BMP: bad header size")
    masks = None
    palette = np.zeros((256, 3), np.uint8)             # RGB
    if size >= 36:
        width = _le(buf, 18, 4, signed=True)
        height = _le(buf, 22, 4, signed=True)
        bpp = _le(buf, 26, 4) >> 16
        rle = _le(buf, 30, 4, signed=True)
        if not BI_RGB <= rle <= BI_BITFIELDS:
            raise ImageFormatError("BMP: unknown compression")
        clr_used = _le(buf, 46, 4, signed=True)
        if bpp == 32 and rle == BI_BITFIELDS and size >= 56:
            masks = [_le(buf, 54 + 4 * i, 4) for i in range(3)]  # R, G, B
        end = 14 + size
        if bpp <= 8:
            if not 0 <= clr_used <= 256:
                raise ImageFormatError("BMP: bad palette size")
            n = clr_used or 1 << bpp
            if end + 4 * n > len(buf):
                raise ImageFormatError("Unexpected end of input stream")
            entries = np.frombuffer(buf, np.uint8, 4 * n, end).reshape(n, 4)
            palette[:n] = entries[:, 2::-1]
        elif bpp == 16 and rle == BI_BITFIELDS:
            r, g, b = (_le(buf, end + 4 * i, 4) for i in range(3))
            if (r, g, b) == (0x7C00, 0x3E0, 0x1F):
                bpp = 15
            elif (r, g, b) != (0xF800, 0x7E0, 0x1F):
                raise ImageFormatError("BMP: unsupported 16-bit masks")
        elif bpp == 16 and rle == BI_RGB:
            bpp = 15
    elif size == 12:
        width, height = _le(buf, 18, 2), _le(buf, 20, 2)
        bpp = _le(buf, 22, 4) >> 16
        rle = BI_RGB
        if bpp <= 8:
            n = 1 << bpp
            if 26 + 3 * n > len(buf):
                raise ImageFormatError("Unexpected end of input stream")
            palette[:n] = np.frombuffer(buf, np.uint8, 3 * n, 26) \
                .reshape(n, 3)[:, ::-1]
    else:
        raise ImageFormatError("BMP: unsupported header")
    ok = width > 0 and height != 0 and (
        (bpp in (1, 4, 8, 15, 24, 32) and rle == BI_RGB)
        or (bpp in (15, 16, 32) and rle == BI_BITFIELDS)
        or (bpp == 4 and rle == BI_RLE4) or (bpp == 8 and rle == BI_RLE8))
    if not ok:
        raise ImageFormatError("BMP: unsupported mode")
    top_down, height = height < 0, abs(height)
    check_size(width, height)
    if rle in (BI_RLE4, BI_RLE8):
        rows = _rle(buf, offset, width, height, 8 if rle == BI_RLE8 else 4)
        out = palette[rows]
    else:
        pitch = ((width * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
        if offset + pitch * height > len(buf):
            raise ImageFormatError("Unexpected end of input stream")
        rows = np.frombuffer(buf, np.uint8, pitch * height, offset) \
            .reshape(height, pitch)
        out = _bmp_pixels(rows, width, bpp, palette, masks)
    return np.ascontiguousarray(out if top_down else out[::-1])


def _bmp_pixels(rows: np.ndarray, width: int, bpp: int,
                palette: np.ndarray, masks) -> np.ndarray:
    """Uncompressed rows in file order -> (rows, width, 3) RGB."""
    if bpp <= 8:
        idx = np.unpackbits(rows, axis=1) if bpp < 8 else rows
        if bpp == 4:
            idx = (idx.reshape(len(rows), -1, 4)
                   * np.array([8, 4, 2, 1], np.uint8)).sum(2)
        return palette[idx[:, :width]]
    if bpp in (15, 16):
        v = rows[:, :2 * width].copy().view("<u2").astype(np.uint16)
        b = (v << 3) & 0xF8
        g = (v >> 2) & 0xF8 if bpp == 15 else (v >> 3) & 0xFC
        r = (v >> 7) & 0xF8 if bpp == 15 else (v >> 8) & 0xF8
        return np.stack([r, g, b], -1).astype(np.uint8)
    n = bpp // 8
    px = rows[:, :n * width].reshape(len(rows), width, n)
    if bpp == 32 and masks is not None and all(masks):
        v = px.copy().view("<u4")[..., 0]
        chans = []
        for m in masks:          # float32 v * (255 / max), truncated
            shift = (m & -m).bit_length() - 1
            scale = np.float32(255) / np.float32(m >> shift)
            chans.append((((v & m) >> shift).astype(np.float32) * scale)
                         .astype(np.uint8))
        return np.stack(chans, -1)
    return px[..., 2::-1]


def _rle(buf: bytes, offset: int, width: int, height: int,
         bits: int) -> np.ndarray:
    """RLE8/RLE4 data -> (height, width) palette indices, file order."""
    from epipolarpose_tpu_torch.data import png
    data = buf[offset:] if offset <= len(buf) else b""
    out = np.empty((height, width), np.uint8)
    err = ctypes.create_string_buffer(256)
    status = png.LIBRARY.load().epk_bmp_rle(data, len(data), width, height,
                                            bits, out.ctypes.data, err, 256)
    if status:
        raise ImageFormatError(f"BMP: {err.value.decode(errors='replace')}")
    return out
