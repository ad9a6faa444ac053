"""JPEG test images: the committed fixtures and the seeded cases.

    python tests/jpeg_fixtures.py      # rewrites tests/data/jpeg/

Frames are the port's synthetic renders (one Gaussian blob a joint, as
``data/synthetic.py`` draws them) over a smooth background, with mild
noise so that every Huffman code length occurs. OpenCV and Pillow
encode them (both with libjpeg-turbo), so the fixtures cover what those
write: each sampling, grayscale, a restart interval, 16-bit quantization
tables (SOF1), an Adobe RGB file, EXIF orientation and progressive files
(OpenCV's and Pillow's optimized ones, grayscale, a restart interval, and
a progressive twin of the 2048 x 2048 frame for the card's timing).
Neither library writes a sequential image whose components arrive in
separate scans, so :func:`encode_separate_scans` does (a small baseline
encoder: float DCT, optimal Huffman tables; Y alone, then Cb and Cr alone
or interleaved together). Nor do they write lossless or 12-bit JPEGs:
:func:`encode_lossless` (SOF3: any precision, predictor, point
transform, sampling and restart interval, one scan or a scan a
component) and :func:`encode_dct` (SOF1 at 12 bits, 16-bit quantization
tables) write those of ``tests/data/images`` (``image_fixtures.py``).

``manifest.json`` gives each file's size, its mode and the sha256 of
libjpeg-turbo's RGB decode (``cv2.imdecode``, EXIF orientation ignored,
as the native loader ignores it), and ``scaled_rgb_sha256``, the same at
libjpeg's DCT scales ``scale_num``/8 (:func:`libjpeg_rgb`): 1, 2 and 4
for every file, 3 for files whose sides are multiples of 8.

``modes/`` holds the files of the modes OpenCV and Pillow do not write
and of the ways a file can go wrong (:func:`mode_fixture_set`):
arithmetic coding, progressive files whose scans leave coefficients
unfinished (libjpeg block-smooths them), 4x4-subsampled chroma (the 12x12
IDCT at 3/8), CMYK and YCCK, truncated data, a lost restart marker,
coefficients far out of range, a file without Huffman tables, and EXIF
orientations 1-8 (both TIFF byte orders), written by
``tests/jpeg_writer.c`` (the system's
libjpeg, built here by ``gcc -ljpeg``) and Pillow. Its ``manifest.json``
gives the sha256 of libjpeg-turbo 2.1's decode (the JAX package's native
loader's library, through that program) at 8/8 and at each scale 1-4,
the warning libjpeg gives (``warned``, or ``ended`` where the data ends
before EOI), ``imread_sha256`` and ``imdecode_sha256``, the sha256 of
what the JAX package's imread gives from a plain path and from a zip
member (OpenCV from a file and from memory; null where it raises),
``loader``, whether the JAX package's loader decodes the file, and
``loader_crop_sha256``, the sha256 of its 24 x 24 crops through
``loader_affines`` (:data:`LOADER_SHRINKS`).
"""

from __future__ import annotations

import hashlib
import io
import json
import pathlib
import shutil
import subprocess
import tempfile
import zlib

import numpy as np

FIXTURE_DIR = pathlib.Path(__file__).resolve().parent / "data" / "jpeg"
MODES_DIR = FIXTURE_DIR / "modes"
WRITER_SOURCE = pathlib.Path(__file__).resolve().parent / "jpeg_writer.c"

# the frames of the datasets: MPI-INF-3DHP studio (TS1-4) and outdoor
# (TS5-6) cameras, H36M
FRAME_SIZES = {"3dhp_studio": (2048, 2048), "3dhp_outdoor": (1080, 1920),
               "h36m": (1000, 1000)}
SAMPLINGS = ("444", "422", "420", "440", "411")


def render(h: int, w: int, seed: int, noise: float = 3.0) -> np.ndarray:
    """(h, w, 3) uint8 RGB: 17 joint blobs of the port's synthetic
    renderer on a smooth gradient, plus Gaussian noise of ``noise`` grey
    levels."""
    from epipolarpose_tpu_torch.data.synthetic import _render_blobs
    rng = np.random.default_rng(seed)
    joints = rng.uniform((0.25 * w, 0.15 * h), (0.75 * w, 0.85 * h),
                         (17, 2)).astype(np.float32)
    blobs = _render_blobs(joints, (h, w), 17,
                          blob_sigma=max(min(h, w) / 60.0, 1.0))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    bg = np.stack([0.2 + 0.3 * xx / max(w, 1), 0.3 + 0.2 * yy / max(h, 1),
                   0.25 + 0.1 * (xx + yy) / max(h + w, 1)], -1)
    img = 255.0 * np.clip(0.6 * bg + blobs, 0.0, 1.0)
    img += rng.normal(0.0, noise, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def cv2_encode(rgb: np.ndarray, quality: int = 90, sampling: str = "420",
               restart: int = 0, progressive: bool = False) -> bytes:
    """OpenCV's encode of an RGB (or 2-D grayscale) image."""
    import cv2
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if rgb.ndim == 3:
        rgb = rgb[..., ::-1]                       # OpenCV writes BGR
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(rgb), params)
    assert ok
    return enc.tobytes()


def pil_encode(rgb: np.ndarray, **kwargs) -> bytes:
    """Pillow's encode (``qtables``, ``keep_rgb``, ``exif``, ...)."""
    from PIL import Image
    bio = io.BytesIO()
    Image.fromarray(rgb).save(bio, "JPEG", **kwargs)
    return bio.getvalue()


# OpenCV's reduced reads set libjpeg's scale_denom: 1/8, 2/8, 4/8
SCALES = (1, 2, 4)
# the scale OpenCV cannot ask for, read through the JAX native loader
SCALE_3 = 3


def libjpeg_rgb(buf: bytes, scale_num: int = 8) -> np.ndarray:
    """libjpeg-turbo's RGB decode at its DCT scale ``scale_num``/8, EXIF
    orientation ignored: OpenCV's (reduced) read at 1, 2, 4 and 8; at 3
    the JAX package's native loader (the system's libjpeg-turbo) through
    :func:`libjpeg_rgb_3_8`."""
    import cv2
    if scale_num == SCALE_3:
        return libjpeg_rgb_3_8(buf)
    flag = {1: cv2.IMREAD_REDUCED_COLOR_8, 2: cv2.IMREAD_REDUCED_COLOR_4,
            4: cv2.IMREAD_REDUCED_COLOR_2, 8: cv2.IMREAD_COLOR}[scale_num]
    img = cv2.imdecode(np.frombuffer(buf, np.uint8),
                       flag | cv2.IMREAD_IGNORE_ORIENTATION)
    assert img is not None
    return np.ascontiguousarray(img[..., ::-1])


def libjpeg_rgb_3_8(buf: bytes) -> np.ndarray:
    """libjpeg-turbo's 3/8 decode of a frame whose sides are multiples of
    8, read back through the JAX native loader's crop by
    ``x' = 0.375 x - 0.3125`` (and so for y): its shrink of 8/3 picks
    ``scale_num`` 3 (8 / 2.6666666666666665 rounds to 3.0 in double), and
    the remap onto the scaled grid samples the 3/8 decode at whole
    pixels. Raises ValueError for other sides, RuntimeError where that
    loader cannot build."""
    from epipolarpose_tpu.data import fastloader as jfast
    from epipolarpose_tpu_torch.data.jpeg import jpeg_info
    w, h, _ = jpeg_info(buf)
    if w % 8 or h % 8:
        raise ValueError(f"{w}x{h}: a 3/8 read needs sides that are "
                         "multiples of 8")
    if not jfast.available():
        raise RuntimeError("the JAX native loader cannot build here")
    M = np.array([[[0.375, 0.0, -0.3125], [0.0, 0.375, -0.3125]]],
                 np.float32)
    return jfast.decode_warp_batch([buf], M, (w * 3 // 8, h * 3 // 8),
                                   dtype=np.uint8)[0]


def port_rgb(buf: bytes, scale_num: int = 8,
             flavour: str = "libjpeg") -> np.ndarray:
    """The port's decode, also where libjpeg warns (``JpegWarning.image``)."""
    from epipolarpose_tpu_torch.data import jpeg
    try:
        return jpeg.decode(buf, scale_num, flavour)
    except jpeg.JpegWarning as w:
        return w.image


def rgb_sha256(rgb: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


# ----------------------------------------- an encoder of separate scans
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# the example tables of the standard (Annex K.1), natural order
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.array([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4
                     + [24, 26, 56] + [99] * 5 + [47, 66] + [99] * 38)


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    c = np.sqrt(2 / 8) * np.cos((2 * n + 1) * k * np.pi / 16)
    c[0] /= np.sqrt(2)
    return c


def _category(v: int) -> int:
    return int(abs(v)).bit_length()


def _block_symbols(coefs: np.ndarray, prev_dc: int):
    """One quantized block (zig-zag order) -> ((table, symbol, bits,
    nbits), ...) and its DC."""
    out = []
    diff = int(coefs[0]) - prev_dc
    s = _category(diff)
    out.append(("dc", s, diff if diff >= 0 else diff + (1 << s) - 1, s))
    run = 0
    last = max([i for i in range(1, 64) if coefs[i]] or [0])
    for i in range(1, last + 1):
        v = int(coefs[i])
        if v == 0:
            run += 1
            continue
        while run > 15:
            out.append(("ac", 0xF0, 0, 0))
            run -= 16
        s = _category(v)
        out.append(("ac", (run << 4) | s, v if v >= 0 else v + (1 << s) - 1,
                    s))
        run = 0
    if last < 63:
        out.append(("ac", 0x00, 0, 0))
    return out, int(coefs[0])


def _huffman_table(freq: dict) -> tuple[list, list]:
    """Optimal code lengths limited to 16 bits (Annex K.2, with the
    reserved all-ones code) -> (counts[1..16], symbols)."""
    f = np.zeros(257, np.int64)
    for s, n in freq.items():
        f[s] = n
    f[256] = 1
    size = np.zeros(257, int)
    others = np.full(257, -1)
    while True:
        live = [i for i in range(257) if f[i] > 0]
        if len(live) < 2:
            break
        live.sort(key=lambda i: (f[i], -i))
        v1, v2 = live[0], live[1]
        f[v1] += f[v2]
        f[v2] = 0
        size[v1] += 1
        while others[v1] >= 0:
            v1 = others[v1]
            size[v1] += 1
        others[v1] = v2
        size[v2] += 1
        while others[v2] >= 0:
            v2 = others[v2]
            size[v2] += 1
    bits = np.zeros(33, int)
    for i in range(257):
        if size[i]:
            bits[size[i]] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1                                   # the reserved code
    symbols = [s for length in range(1, 33) for s in range(256)
               if size[s] == length]
    return [int(b) for b in bits[1:17]], symbols


def _codes(counts: list, symbols: list) -> dict:
    code, k, out = 0, 0, {}
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            out[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, nbits: int):
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.n += nbits
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") \
        + payload


def encode_separate_scans(rgb: np.ndarray, quality: int = 85,
                          luma_sampling: tuple[int, int] = (2, 2),
                          restart: int = 0,
                          chroma_together: bool = False) -> bytes:
    """A baseline JPEG (SOF0, YCbCr, JFIF) whose components arrive in
    separate scans: Y alone, then Cb and Cr alone or (``chroma_together``)
    in one interleaved scan of the two; ``luma_sampling`` is Y's (h, v)
    against chroma 1x1 (so the chroma block grids of both kinds of scan
    coincide); ``restart`` MCUs between RST markers."""
    h, w = rgb.shape[:2]
    x = rgb.astype(np.float64)
    ycc = np.stack([
        0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2],
        128 - 0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2],
        128 + 0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2],
    ], -1)
    hy, vy = luma_sampling
    scale = 5000 / quality if quality < 50 else 200 - 2 * quality
    qts = [np.clip((q * scale + 50) // 100, 1, 255).astype(int)
           for q in (_Q_LUMA, _Q_CHROMA)]
    cmat = _dct_matrix()
    comps = []
    for c in range(3):
        fh, fv = (1, 1) if c == 0 else (hy, vy)
        dw, dh = -(-w // fh), -(-h // fv)
        src = np.pad(ycc[..., c], ((0, dh * fv - h), (0, dw * fh - w)),
                     mode="edge")
        plane = src.reshape(dh, fv, dw, fh).mean(axis=(1, 3))
        bw, bh = -(-dw // 8), -(-dh // 8)
        plane = np.pad(plane, ((0, bh * 8 - dh), (0, bw * 8 - dw)),
                       mode="edge") - 128.0
        blocks = plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coefs = cmat @ blocks @ cmat.T
        q = qts[0 if c == 0 else 1].reshape(8, 8)
        quant = np.rint(coefs / q).astype(int).reshape(bh * bw, 64)
        comps.append(quant[:, _ZIGZAG])
    # symbols and tables: luma tables for Y, chroma tables for Cb and Cr;
    # a scan is (its components, its symbols)
    groups = [[0], [1, 2]] if chroma_together else [[0], [1], [2]]
    scans, freqs = [], [({}, {}), ({}, {})]
    for group in groups:
        t = 0 if group == [0] else 1
        syms, prev = [], {c: 0 for c in group}
        for b in range(len(comps[group[0]])):
            if restart and b and b % restart == 0:
                syms.append(("rst", (b // restart - 1) & 7, 0, 0))
                prev = {c: 0 for c in group}
            for c in group:
                s, prev[c] = _block_symbols(comps[c][b], prev[c])
                syms += s
        for kind, sym, _, _ in syms:
            if kind != "rst":
                d = freqs[t][0 if kind == "dc" else 1]
                d[sym] = d.get(sym, 0) + 1
        scans.append((group, syms))
    tables = [[_huffman_table(d) for d in pair] for pair in freqs]
    out = bytearray(b"\xff\xd8")
    out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for i, q in enumerate(qts):
        out += _segment(0xDB, bytes([i]) + bytes(q[_ZIGZAG].tolist()))
    sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + b"\x03"
    sof += bytes([1, (hy << 4) | vy, 0, 2, 0x11, 1, 3, 0x11, 1])
    out += _segment(0xC0, sof)
    for t, (dc, ac) in enumerate(tables):
        for cls, (counts, symbols) in ((0, dc), (1, ac)):
            out += _segment(0xC4, bytes([(cls << 4) | t] + counts + symbols))
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    for group, syms in scans:
        t = 0 if group == [0] else 1
        codes = [_codes(*tables[t][0]), _codes(*tables[t][1])]
        sel = [x for c in group for x in (c + 1, (t << 4) | t)]
        out += _segment(0xDA, bytes([len(group)] + sel + [0, 63, 0]))
        bw = _BitWriter()
        for kind, sym, bits, nbits in syms:
            if kind == "rst":
                bw.flush()
                bw.out += bytes([0xFF, 0xD0 + sym])
                continue
            code, length = codes[0 if kind == "dc" else 1][sym]
            bw.put(code, length)
            if nbits:
                bw.put(bits, nbits)
        bw.flush()
        out += bw.out
    out += b"\xff\xd9"
    return bytes(out)


# ------------------------------------------- lossless and 12-bit JPEG
# neither OpenCV nor Pillow writes these modes: the encoders below do,
# with tables made for each file (optimal Huffman codes, Annex K.2)
ADOBE_RGB = _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
ADOBE_YCC = _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x01")
ADOBE_YCCK = _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x02")
JFIF = _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
RGB_IDS = (82, 71, 66)          # 'R', 'G', 'B': libjpeg's RGB guess


def _predict(plane: np.ndarray, psv: int, initial: int,
             restart_rows: int) -> np.ndarray:
    """T.81 H.1.2.1's differences of one component (int64, already
    shifted by the point transform): the first row of the scan and of each
    restart interval predicts from the left (``initial`` for its first
    sample), the first column from above, the rest by predictor ``psv``."""
    x = plane.astype(np.int64)
    h, w = x.shape
    pred = np.empty_like(x)
    ra = np.zeros_like(x)
    ra[:, 1:] = x[:, :-1]
    rb = np.zeros_like(x)
    rb[1:] = x[:-1]
    rc = np.zeros_like(x)
    rc[1:, 1:] = x[:-1, :-1]
    pred[:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
               5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
               7: (ra + rb) >> 1}[psv]
    pred[:, 0] = rb[:, 0]
    for y in range(h):
        if y == 0 or (restart_rows and y % restart_rows == 0):
            pred[y, 1:] = x[y, :-1]
            pred[y, 0] = initial
    return ((x - pred + 32768) & 0xFFFF) - 32768


def encode_lossless(planes, precision: int = 8, psv: int = 1, pt: int = 0,
                    sampling=None, ids=RGB_IDS, restart_rows: int = 0,
                    separate: bool = False, app: bytes = b"",
                    size: tuple | None = None) -> bytes:
    """A lossless JPEG (SOF3, Huffman) of ``planes`` (one 2-D array of
    samples a component, each at its own sampling): precision 2-16,
    predictor ``psv`` 1-7, point transform ``pt``, ``sampling`` (h, v)
    per component, restarts every ``restart_rows`` MCU rows, one
    interleaved scan or (``separate``) a scan a component; ``app``:
    segments after SOI; ``size``: the image's (height, width) where the
    planes are subsampled."""
    n = len(planes)
    sampling = sampling or [(1, 1)] * n
    ids = list(ids)[:n] if n > 1 else [1]
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    height, width = size or planes[0].shape
    diffs = []
    for c, plane in enumerate(planes):
        rows = restart_rows * (1 if separate else sampling[c][1])
        diffs.append(_predict(np.asarray(plane).astype(np.int64) >> pt, psv,
                              1 << (precision - pt - 1), rows))
    groups = [[c] for c in range(n)] if separate else [list(range(n))]
    scans, freq = [], {}
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    for group in groups:
        if len(group) == 1:
            shape = [(1, 1)]
            ny, nx = diffs[group[0]].shape
        else:
            shape = [sampling[c] for c in group]
            ny, nx = mcuy, mcux
        syms = []
        for my in range(ny):
            if restart_rows and my and my % restart_rows == 0:
                syms.append(("rst", (my // restart_rows - 1) & 7))
            for mx in range(nx):
                for c, (hh, vv) in zip(group, shape):
                    d = diffs[c]
                    for y in range(vv):
                        for x in range(hh):
                            yy, xx = my * vv + y, mx * hh + x
                            v = int(d[yy, xx]) if yy < d.shape[0] \
                                and xx < d.shape[1] else 0
                            s = 16 if v == -32768 else _category(v)
                            syms.append(("d", s, v))
                            freq[s] = freq.get(s, 0) + 1
        scans.append((group, mcux if len(group) > 1 else nx, syms))
    counts, symbols = _huffman_table(freq)
    codes = _codes(counts, symbols)
    out = bytearray(b"\xff\xd8") + app
    sof = bytes([precision]) + height.to_bytes(2, "big") \
        + width.to_bytes(2, "big") + bytes([n])
    for c in range(n):
        sof += bytes([ids[c], (sampling[c][0] << 4) | sampling[c][1], 0])
    out += _segment(0xC3, sof)
    out += _segment(0xC4, bytes([0] + counts + symbols))
    for group, per_row, syms in scans:
        if restart_rows:
            out += _segment(0xDD, (restart_rows * per_row).to_bytes(2, "big"))
        sel = [x for c in group for x in (ids[c], 0)]
        out += _segment(0xDA, bytes([len(group)] + sel + [psv, 0, pt]))
        bw = _BitWriter()
        for sym in syms:
            if sym[0] == "rst":
                bw.flush()
                bw.out += bytes([0xFF, 0xD0 + sym[1]])
                continue
            _, s, v = sym
            bw.put(*codes[s])
            if 0 < s < 16:
                bw.put(v if v >= 0 else v + (1 << s) - 1, s)
        bw.flush()
        out += bw.out
    return bytes(out + b"\xff\xd9")


def encode_dct(samples: np.ndarray, precision: int = 12, quant: int = 2,
               sof: int = 0xC1, ids=(1, 2, 3)) -> bytes:
    """A sequential Huffman JPEG (``sof`` 0xC0 or 0xC1) of ``samples``
    ((h, w) or (h, w, c), 1x1 sampling, no colour transform) at
    ``precision`` 8 or 12 bits, one 16-bit quantization table of
    ``quant`` everywhere, optimal Huffman tables, one interleaved scan.
    At 8 bits it is an ordinary file OpenCV reads (the check of the
    encoder); at 12 bits OpenCV reads none."""
    x = np.asarray(samples).astype(np.float64)
    if x.ndim == 2:
        x = x[..., None]
    h, w, n = x.shape
    cmat = _dct_matrix()
    bh, bw_ = -(-h // 8), -(-w // 8)
    comps = []
    for c in range(n):
        plane = np.pad(x[..., c], ((0, bh * 8 - h), (0, bw_ * 8 - w)),
                       mode="edge") - (1 << (precision - 1))
        blocks = plane.reshape(bh, 8, bw_, 8).transpose(0, 2, 1, 3)
        coefs = cmat @ blocks @ cmat.T
        q = np.rint(coefs / quant).astype(int).reshape(bh * bw_, 64)
        comps.append(q[:, _ZIGZAG])
    syms, prev = [], [0] * n
    for b in range(bh * bw_):
        for c in range(n):
            s, prev[c] = _block_symbols(comps[c][b], prev[c])
            syms += s
    freqs = ({}, {})
    for kind, sym, _, _ in syms:
        d = freqs[0 if kind == "dc" else 1]
        d[sym] = d.get(sym, 0) + 1
    tables = [_huffman_table(d) for d in freqs]
    out = bytearray(b"\xff\xd8")
    out += _segment(0xDB, bytes([0x10]) + b"".join(
        quant.to_bytes(2, "big") for _ in range(64)))
    frame = bytes([precision]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
    frame += bytes([n]) + b"".join(bytes([ids[c], 0x11, 0])
                                   for c in range(n))
    out += _segment(sof, frame)
    for cls, (counts, symbols) in enumerate(tables):
        out += _segment(0xC4, bytes([cls << 4] + counts + symbols))
    out += _segment(0xDA, bytes([n] + [x for c in range(n)
                                       for x in (ids[c], 0)] + [0, 63, 0]))
    codes = [_codes(*t) for t in tables]
    bw = _BitWriter()
    for kind, sym, bits, nbits in syms:
        code, length = codes[0 if kind == "dc" else 1][sym]
        bw.put(code, length)
        if nbits:
            bw.put(bits, nbits)
    bw.flush()
    return bytes(out + bw.out + b"\xff\xd9")


# ---------------------------------------------------------------- fixtures
def fixture_set() -> dict:
    """name -> (bytes, mode); mode is what the file exercises (a mode the
    port refuses starts with ``refused:``)."""
    out = {}
    for i, (name, (h, w)) in enumerate(FRAME_SIZES.items()):
        out[f"{name}_{w}x{h}.jpg"] = (
            cv2_encode(render(h, w, seed=i, noise=1.2), 90),
            f"baseline 4:2:0 q90, a {name} frame")
    small = render(29, 37, seed=10)
    for s in SAMPLINGS:
        out[f"s{s}_37x29.jpg"] = (cv2_encode(small, 90, s),
                                  f"baseline {s[0]}:{s[1]}:{s[2]} q90")
    out["gray_45x31.jpg"] = (cv2_encode(render(31, 45, seed=11)[..., 1], 90),
                             "baseline grayscale")
    out["restart_61x43.jpg"] = (cv2_encode(render(43, 61, seed=12), 90,
                                           restart=2),
                                "baseline 4:2:0, restart interval 2")
    rng = np.random.default_rng(13)
    qt = [rng.integers(256, 1024, 64).tolist() for _ in range(2)]
    out["sof1_16bit_dqt_91x57.jpg"] = (
        pil_encode(render(57, 91, seed=14), qtables=qt, subsampling=2),
        "extended sequential (SOF1), 16-bit quantization tables")
    out["adobe_rgb_33x21.jpg"] = (
        pil_encode(render(21, 33, seed=15), quality=90, keep_rgb=True),
        "Adobe APP14 transform 0: RGB")
    out["separate_scans_50x35.jpg"] = (
        encode_separate_scans(render(35, 50, seed=16), 85, restart=5),
        "baseline 4:2:0, one scan a component, restart interval 5")
    from PIL import Image
    exif = Image.Exif()
    exif[0x0112] = 6                          # rotate 90 degrees to view
    out["exif_orientation6_40x24.jpg"] = (
        pil_encode(render(24, 40, seed=17), quality=90,
                   exif=exif.tobytes()),
        "EXIF orientation 6 (OpenCV rotates; libjpeg and the port do not)")
    out["progressive_64x48.jpg"] = (
        cv2_encode(render(48, 64, seed=18), 90, progressive=True),
        "progressive (SOF2) 4:2:0 q90, OpenCV's scans")
    out["progressive_pil_444_56x40.jpg"] = (
        pil_encode(render(40, 56, seed=19, noise=12.0), quality=85,
                   subsampling=0, progressive=True, optimize=True),
        "progressive (SOF2) 4:4:4, Pillow's optimized tables")
    out["progressive_gray_48x32.jpg"] = (
        cv2_encode(render(32, 48, seed=20)[..., 0], 90, progressive=True),
        "progressive (SOF2) grayscale")
    out["progressive_restart_422_72x40.jpg"] = (
        cv2_encode(render(40, 72, seed=21), 90, "422", restart=2,
                   progressive=True),
        "progressive (SOF2) 4:2:2, restart interval 2")
    out["3dhp_studio_progressive_2048x2048.jpg"] = (
        cv2_encode(render(2048, 2048, seed=0, noise=1.2), 90,
                   progressive=True),
        "progressive (SOF2) 4:2:0 q90, the 3dhp_studio frame's twin")
    return out


def write_fixtures(root: pathlib.Path = FIXTURE_DIR) -> dict:
    root.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for name, (buf, mode) in fixture_set().items():
        (root / name).write_bytes(buf)
        rgb = libjpeg_rgb(buf)
        scales = SCALES + ((SCALE_3,) if rgb.shape[0] % 8 == 0
                           and rgb.shape[1] % 8 == 0 else ())
        manifest[name] = {"width": int(rgb.shape[1]),
                          "height": int(rgb.shape[0]), "bytes": len(buf),
                          "mode": mode, "rgb_sha256": rgb_sha256(rgb),
                          "scaled_rgb_sha256": {
                              str(s): rgb_sha256(libjpeg_rgb(buf, s))
                              for s in sorted(scales)}}
    (root / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    return manifest


# ------------------------------------------- libjpeg through jpeg_writer.c
_TOOL: list = []


def libjpeg_tool() -> pathlib.Path:
    """``tests/jpeg_writer.c`` built against the system's libjpeg, once a
    process, in a temporary directory; RuntimeError without gcc or
    jpeglib.h."""
    if not _TOOL:
        gcc = shutil.which("gcc")
        if gcc is None:
            raise RuntimeError("jpeg_writer needs gcc")
        exe = pathlib.Path(tempfile.mkdtemp(prefix="jpeg_writer_")) / "jpeg_writer"
        run = subprocess.run([gcc, "-O2", str(WRITER_SOURCE), "-ljpeg", "-o",
                              str(exe)], capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"jpeg_writer does not build: {run.stderr[-500:]}")
        _TOOL.append(exe)
    return _TOOL[0]


def libjpeg_encode(pixels: np.ndarray, *options: str) -> bytes:
    """libjpeg's encode of (H, W) grey, (H, W, 3) RGB or (H, W, 4) CMYK
    pixels, with ``jpeg_writer encode``'s options."""
    h, w = pixels.shape[:2]
    c = 1 if pixels.ndim == 2 else pixels.shape[2]
    run = subprocess.run(
        [str(libjpeg_tool()), "encode", str(w), str(h), str(c), *options],
        input=np.ascontiguousarray(pixels, np.uint8).tobytes(),
        capture_output=True)
    if run.returncode:
        raise RuntimeError(f"jpeg_writer {options}: {run.stderr.decode()}")
    return run.stdout


def libjpeg_coefficients(table: np.ndarray, coefs: np.ndarray) -> bytes:
    """libjpeg's greyscale file of quantized ``coefs`` (block rows, block
    columns, 64 in natural order) under the quantization ``table``
    (natural order; libjpeg keeps its entries to 32767)."""
    bh, bw = coefs.shape[:2]
    run = subprocess.run(
        [str(libjpeg_tool()), "coefwrite", str(bw), str(bh)],
        input=np.asarray(table, np.uint16).tobytes()
        + np.asarray(coefs, np.int16).tobytes(), capture_output=True)
    if run.returncode:
        raise RuntimeError(f"jpeg_writer coefwrite: {run.stderr.decode()}")
    return run.stdout


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """OpenCV's reading of libjpeg's CMYK samples (its
    icvCvt_CMYK2BGR_8u_C4C3R, in RGB order): each of R, G, B is
    ``k - ((255 - s) * k >> 8)`` of its C, M, Y sample ``s``."""
    c = cmyk.astype(np.int32)
    k = c[..., 3:]
    return (k - (((255 - c[..., :3]) * k) >> 8)).astype(np.uint8)


def libjpeg_decode(buf: bytes, scale_num: int = 8):
    """The system libjpeg-turbo's decode of ``buf`` at ``scale_num``/8,
    from memory as the JAX package's native loader reads it: (RGB, or the
    RGB OpenCV makes of a four-component file's CMYK, or None where
    libjpeg fails; libjpeg's warnings, one a line)."""
    run = subprocess.run([str(libjpeg_tool()), "decode", str(scale_num)],
                         input=buf, capture_output=True)
    warnings = run.stderr.decode(errors="replace").strip()
    if run.returncode:
        return None, warnings
    head, _, body = run.stdout.partition(b"\n")
    w, h, c = map(int, head.split())
    img = np.frombuffer(body, np.uint8).reshape(h, w, c)
    return (cmyk_to_rgb(img) if c == 4 else img.copy()), warnings


def opencv_rgb(buf: bytes, from_file: bool = True):
    """What the JAX package's imread gives, as RGB (OpenCV's
    ``IMREAD_COLOR``: EXIF orientation applied): from a plain path
    (``cv2.imread``), or ``from_file`` false from a zip member
    (``cv2.imdecode``); None where OpenCV gives no image."""
    import cv2
    if from_file:
        with tempfile.TemporaryDirectory() as tmp:
            path = pathlib.Path(tmp) / "image.jpg"
            path.write_bytes(buf)
            img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    else:
        img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    return None if img is None else np.ascontiguousarray(img[..., ::-1])


SAMPLING_FACTORS = {"444": "1x1,1x1,1x1", "420": "2x2,1x1,1x1",
                    "422": "2x1,1x1,1x1", "411": "4x1,1x1,1x1",
                    "4x4": "4x4,1x1,1x1"}
# a scan a component: 4x4-subsampled luma fills 16 blocks of an MCU, over
# the 10 an interleaved scan may hold
SEPARATE_SCANS = "0:0-63:0:0;1:0-63:0:0;2:0-63:0:0"
SEPARATE_PROGRESSIVE = ("0:0-0:0:0;1:0-0:0:0;2:0-0:0:0;0:1-5:0:0;"
                        "0:6-63:0:0;1:1-63:0:0;2:1-63:0:0")
# scan scripts that leave coefficients 1-9 unfinished (libjpeg smooths)
UNFINISHED = {
    "dc_only": "0,1,2:0-0:0:0",
    "dc_al1": "0,1,2:0-0:0:1",
    "ac5_al2": "0,1,2:0-0:0:0;0:1-5:0:2;1:1-63:0:0;2:1-63:0:0",
    "refine": ("0,1,2:0-0:0:1;0:1-5:0:2;0:1-5:2:1;1:1-9:0:1;2:1-63:0:0;"
               "0,1,2:0-0:1:0"),
    "ac2": "0,1,2:0-0:0:0;0:1-2:0:0;1:1-2:0:0;2:1-2:0:0",
    "gray_dc_al1": "0:0-0:0:1;0:1-9:0:1",
    "4x4": "0:0-0:0:0;1:0-0:0:0;2:0-0:0:0;0:1-5:0:1;1:1-63:0:0",
    # libjpeg's default progression without its last three scans
    "frame": ("0,1,2:0-0:0:1;0:1-5:0:2;2:1-63:0:1;1:1-63:0:1;0:6-63:0:2;"
              "0:1-63:2:1;0,1,2:0-0:1:0"),
}


def cut(buf: bytes, seed: int, eoi: bool = False) -> bytes:
    """``buf`` cut inside the entropy-coded data of one of its scans, at
    a seeded place (and EOI appended when ``eoi``)."""
    rng = np.random.default_rng(seed)
    sos = [i for i in range(len(buf) - 1) if buf[i:i + 2] == b"\xff\xda"]
    k = int(rng.integers(len(sos)))
    start = sos[k] + 2 + int.from_bytes(buf[sos[k] + 2:sos[k] + 4], "big")
    stop = start                            # the scan's data ends at a marker
    while not (buf[stop] == 0xFF and buf[stop + 1] not in (0x00, 0xFF)
               and not 0xD0 <= buf[stop + 1] <= 0xD7):
        stop += 1
    at = start + int(rng.uniform(0.2, 0.9) * (stop - start))
    return buf[:at] + (b"\xff\xd9" if eoi else b"")


def mode_fixture_set(frames: bool = True) -> dict:
    """name -> (bytes, mode) of ``modes/`` (module docstring); ``frames``
    adds the arithmetic and the block-smoothed twins of the 2048 x 2048
    frame, which the card's run times."""
    out = {}
    enc = libjpeg_encode
    smp = SAMPLING_FACTORS

    def img(h, w, name, noise=8.0):
        return render(h, w, zlib.crc32(name.encode()), noise)

    # arithmetic coding: sequential (SOF9) and progressive (SOF10), every
    # sampling, restart intervals, conditioning tables other than T.81's
    for kind, flags in (("seq", ()), ("prog", ("-prog",))):
        for s, (h, w) in (("444", (32, 40)), ("420", (40, 48)),
                          ("422", (40, 56)), ("411", (24, 64)),
                          ("gray", (32, 48))):
            name = f"arith_{kind}_{s}_{w}x{h}.jpg"
            pix = img(h, w, name)
            opts = ["-arith", *flags]
            if s == "gray":
                pix = pix[..., 1]
            else:
                opts += ["-samp", smp[s]]
            out[name] = (enc(pix, *opts), f"arithmetic {kind} {s}")
    name = "arith_seq_420_restart_dac_37x29.jpg"
    out[name] = (enc(img(29, 37, name), "-arith", "-restart", "2", "-dac",
                     "1,3,10"),
                 "arithmetic seq 420, restart interval 2, DAC L1 U3 K10")
    name = "arith_prog_422_restart_53x37.jpg"
    out[name] = (enc(img(37, 53, name), "-arith", "-prog", "-samp",
                     smp["422"], "-restart", "3"),
                 "arithmetic prog 422, restart interval 3")
    # unfinished progressive scans: libjpeg's block smoothing
    for s, script, (h, w), extra in (
            ("420", "dc_only", (48, 64), ()), ("444", "ac5_al2", (32, 40), ()),
            ("422", "refine", (40, 56), ()), ("411", "ac2", (32, 64), ()),
            ("gray", "gray_dc_al1", (32, 48), ()),
            ("420", "refine", (40, 56), ("-restart", "2")),
            ("420", "dc_al1", (48, 16), ()),         # two blocks wide
            ("4x4", "4x4", (64, 64), ())):
        name = f"smooth_{s}_{script}{'_restart' if extra else ''}_{w}x{h}.jpg"
        pix = img(h, w, name)
        opts = ["-prog", "-scans", UNFINISHED[script], *extra]
        if s == "gray":
            pix = pix[..., 1]
        else:
            opts += ["-samp", smp[s]]
        out[name] = (enc(pix, *opts), f"progressive {s}, scans {script} "
                     "(unfinished: libjpeg smooths)")
    name = "smooth_arith_420_refine_48x40.jpg"
    out[name] = (enc(img(40, 48, name), "-arith", "-prog", "-scans",
                     UNFINISHED["refine"]),
                 "arithmetic progressive 420, scans refine (unfinished)")
    # 4x4-subsampled chroma: the 12x12 IDCT at 3/8
    for kind, opts in (("seq", ("-scans", SEPARATE_SCANS)),
                       ("prog", ("-prog", "-scans", SEPARATE_PROGRESSIVE)),
                       ("arith", ("-arith", "-scans", SEPARATE_SCANS))):
        name = f"s4x4_{kind}_64x48.jpg"
        out[name] = (enc(img(48, 64, name), "-samp", smp["4x4"], *opts),
                     f"4x4-subsampled chroma, {kind}, a scan a component")
    # CMYK and YCCK
    name = "cmyk_pil_adobe_40x32.jpg"
    out[name] = (pil_cmyk(img(32, 40, name)),
                 "CMYK, Adobe-inverted (Pillow)")
    rng = np.random.default_rng(31)
    cmyk = np.concatenate([img(40, 48, "cmyk"), rng.integers(
        0, 256, (40, 48, 1)).astype(np.uint8)], -1)
    out["ycck_420_48x40.jpg"] = (
        enc(cmyk, "-ycck", "-samp", "2x2,1x1,1x1,2x2"),
        "YCCK (Adobe transform 2), 4:2:0")
    out["ycck_prog_48x40.jpg"] = (enc(cmyk, "-ycck", "-prog"),
                                  "YCCK, progressive")
    out["cmyk_no_adobe_48x40.jpg"] = (enc(cmyk, "-noadobe"),
                                      "CMYK without an Adobe marker")
    # truncated data: cut inside a scan, with and without EOI after it
    for name, base, seed, eoi in (
            ("trunc_420_ended_64x48.jpg",
             cv2_encode(img(48, 64, "t420"), 90, "420"), 1, False),
            ("trunc_411_eoi_64x48.jpg",
             cv2_encode(img(48, 64, "t411"), 90, "411"), 2, True),
            ("trunc_restart_ended_64x48.jpg",
             cv2_encode(img(48, 64, "trst"), 90, "420", restart=2), 3, False),
            ("trunc_prog_ended_64x48.jpg",
             cv2_encode(img(48, 64, "tprog"), 90, "420", progressive=True),
             4, False),
            ("trunc_prog_eoi_56x40.jpg",
             cv2_encode(img(40, 56, "tprog2"), 90, "422", progressive=True),
             5, True),
            ("trunc_arith_ended_48x40.jpg",
             enc(img(40, 48, "tarith"), "-arith", "-restart", "2"), 6, False),
            ("trunc_arith_prog_eoi_48x40.jpg",
             enc(img(40, 48, "tarithp"), "-arith", "-prog"), 7, True),
            ("trunc_gray_ended_48x32.jpg",
             cv2_encode(img(32, 48, "tgray")[..., 0], 90), 8, False)):
        out[name] = (cut(base, seed, eoi),
                     f"truncated{' (EOI after the cut)' if eoi else ''}")
    base = cv2_encode(img(48, 64, "rst"), 90, "420", restart=2)
    sos = base.index(b"\xff\xda")
    rst = base.index(b"\xff\xd1", sos)
    out["restart_lost_64x48.jpg"] = (base[:rst + 1] + b"\xd5" + base[rst + 2:],
                                     "RST5 where RST1 belongs (libjpeg "
                                     "resynchronizes)")
    # no DHT (a Motion-JPEG frame): libjpeg gives the standard tables
    out["no_huffman_tables_64x48.jpg"] = (
        without_dht(cv2_encode(img(48, 64, "mjpeg"), 90, "420")),
        "baseline 4:2:0 without DHT (Motion-JPEG): T.81's standard tables")
    # coefficients far out of range (as a corrupt scan decodes to): the
    # IDCTs' 16-bit lanes in libjpeg-turbo's SIMD build
    for q_max, lim in ((255, 1023), (32767, 60)):
        name = f"idct_extremes_q{q_max}_64x48.jpg"
        rng = np.random.default_rng(q_max)
        table = rng.integers(1, q_max + 1, 64)
        coefs = np.zeros((6, 8, 64), np.int64)
        coefs[..., 0] = rng.integers(-1000, 1000, (6, 8))
        coefs[..., 1:24] = rng.integers(-lim, lim + 1, (6, 8, 23))
        coefs[::2, ::3, 1:] = 0                    # DC-only blocks
        out[name] = (libjpeg_coefficients(table, coefs),
                     f"greyscale, quantizers to {q_max}, coefficients to "
                     f"{lim}: IDCT inputs past 16 bits")
    # EXIF orientation 1-8 in a big-endian (MM) TIFF block, Pillow's
    # default, and 6 and 8 (the portrait photos) little-endian (II)
    from PIL import Image
    for o, order in [*((o, ">") for o in range(1, 9)), (6, "<"), (8, "<")]:
        exif = Image.Exif()
        exif.endian = order
        exif[0x0112] = o
        name = f"exif_orientation{o}{'_ii' if order == '<' else ''}_40x24.jpg"
        out[name] = (pil_encode(img(24, 40, name), quality=90,
                                exif=exif.tobytes()),
                     f"EXIF orientation {o}, "
                     f"{'little' if order == '<' else 'big'}-endian TIFF")
    if frames:
        frame = render(2048, 2048, seed=0, noise=1.2)
        out["3dhp_studio_arith_2048x2048.jpg"] = (
            enc(frame, "-arith"), "arithmetic seq 420 q90, the 3dhp_studio "
            "frame's twin")
        out["3dhp_studio_smoothed_2048x2048.jpg"] = (
            enc(frame, "-prog", "-scans", UNFINISHED["frame"]),
            "progressive 420 q90 without its last scans (libjpeg "
            "smooths), the 3dhp_studio frame's twin")
    return out


def without_dht(buf: bytes) -> bytes:
    """``buf`` with its DHT segments before the first scan left out."""
    out, pos = bytearray(buf[:2]), 2
    while buf[pos + 1] != 0xDA:
        end = pos + 2 + int.from_bytes(buf[pos + 2:pos + 4], "big")
        if buf[pos + 1] != 0xC4:
            out += buf[pos:end]
        pos = end
    return bytes(out + buf[pos:])


def pil_cmyk(rgb: np.ndarray) -> bytes:
    """Pillow's CMYK encode of RGB pixels (Adobe-inverted, its APP14)."""
    from PIL import Image
    bio = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(bio, "JPEG", quality=90)
    return bio.getvalue()


def frame_components(buf: bytes) -> int:
    """The component count of the frame header (the marker segments
    walked from SOI)."""
    pos = 2
    while buf[pos] == 0xFF:
        marker = buf[pos + 1]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return buf[pos + 9]
        pos += 2 + int.from_bytes(buf[pos + 2:pos + 4], "big")
    raise ValueError("no frame header before the first non-marker byte")


def warning_kind(warnings: str) -> str | None:
    """``ended`` where libjpeg found the data ending before EOI, else
    ``warned`` for any other warning, None for none."""
    if "Premature end of JPEG file" in warnings:
        return "ended"
    return "warned" if warnings else None


# the native loader's crops of each file of modes/: 24 x 24, the frame
# shrunk by each of these about its centre, so that the loader decodes at
# 8/8, 4/8, 3/8, 2/8 and 1/8
LOADER_SHRINKS = (1.0, 2.0, 2.7, 4.5, 9.0)
LOADER_CROP = (24, 24)


def loader_affines(w: int, h: int) -> np.ndarray:
    """(len(LOADER_SHRINKS), 2, 3) float32 source -> crop affines."""
    out = []
    for shrink in LOADER_SHRINKS:
        a = 1.0 / shrink
        out.append([[a, 0.0, LOADER_CROP[0] / 2 - a * w / 2],
                    [0.0, a, LOADER_CROP[1] / 2 - a * h / 2]])
    return np.asarray(out, np.float32)


def jax_loader_crops(buf: bytes, affines: np.ndarray) -> list:
    """sha256 of the JAX package's native loader's uint8 crop of ``buf``
    through each affine (a zero crop where it fails)."""
    from epipolarpose_tpu.data import fastloader as jfast
    crops = jfast.decode_warp_batch([buf] * len(affines), affines,
                                    LOADER_CROP, dtype=np.uint8)
    return [rgb_sha256(c) for c in crops]


def mode_entry(buf: bytes, mode: str) -> dict:
    rgb, warnings = libjpeg_decode(buf)
    comps = frame_components(buf)
    imread, imdecode = opencv_rgb(buf), opencv_rgb(buf, from_file=False)
    affines = loader_affines(rgb.shape[1], rgb.shape[0])
    return {"width": int(rgb.shape[1]), "height": int(rgb.shape[0]),
            "bytes": len(buf), "mode": mode, "components": int(comps),
            "rgb_sha256": rgb_sha256(rgb),
            "scaled_rgb_sha256": {str(s): rgb_sha256(libjpeg_decode(buf, s)[0])
                                  for s in (1, 2, 3, 4)},
            "warning": warning_kind(warnings),
            "imread_sha256": None if imread is None else rgb_sha256(imread),
            "imdecode_sha256": (None if imdecode is None
                                else rgb_sha256(imdecode)),
            "loader": "fails" if comps == 4 else "decodes",
            "loader_affines": [[float(v) for v in m.ravel()] for m in affines],
            "loader_crop_sha256": jax_loader_crops(buf, affines)}


def write_mode_fixtures(root: pathlib.Path = MODES_DIR) -> dict:
    root.mkdir(parents=True, exist_ok=True)
    manifest = {name: mode_entry(buf, mode)
                for name, (buf, mode) in mode_fixture_set().items()}
    for name, (buf, _) in mode_fixture_set().items():
        (root / name).write_bytes(buf)
    (root / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    return manifest


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(FIXTURE_DIR.parents[2]))
    for m in (write_fixtures(), write_mode_fixtures()):
        total = sum(v["bytes"] for v in m.values())
        for k, v in m.items():
            print(f"{k}: {v['bytes']} bytes, {v['mode']}")
        print(f"{len(m)} files, {total} bytes")
