"""JPEG test images: the committed fixtures and the seeded cases.

    python tests/jpeg_fixtures.py      # rewrites tests/data/jpeg/

Frames are the port's synthetic renders (one Gaussian blob a joint, as
``data/synthetic.py`` draws them) over a smooth background, with mild
noise so that every Huffman code length occurs. OpenCV and Pillow
encode them (both with libjpeg-turbo), so the fixtures cover what those
write: each sampling, grayscale, a restart interval, 16-bit quantization
tables (SOF1), an Adobe RGB file, EXIF orientation and a progressive
file, which the port refuses. Neither library writes a sequential image
whose components arrive in separate scans, so :func:`encode_separate_scans`
does (a small baseline encoder: float DCT, optimal Huffman tables; Y
alone, then Cb and Cr alone or interleaved together).

``manifest.json`` gives each file's size, its mode and the sha256 of
libjpeg-turbo's RGB decode (``cv2.imdecode``, EXIF orientation ignored,
as the native loader ignores it).
"""

from __future__ import annotations

import hashlib
import io
import json
import pathlib

import numpy as np

FIXTURE_DIR = pathlib.Path(__file__).resolve().parent / "data" / "jpeg"

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


def libjpeg_rgb(buf: bytes) -> np.ndarray:
    """libjpeg-turbo's RGB decode through OpenCV, EXIF orientation
    ignored."""
    import cv2
    img = cv2.imdecode(np.frombuffer(buf, np.uint8),
                       cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    assert img is not None
    return np.ascontiguousarray(img[..., ::-1])


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
        "refused: progressive (SOF2)")
    return out


def write_fixtures(root: pathlib.Path = FIXTURE_DIR) -> dict:
    root.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for name, (buf, mode) in fixture_set().items():
        (root / name).write_bytes(buf)
        rgb = libjpeg_rgb(buf)
        manifest[name] = {"width": int(rgb.shape[1]),
                          "height": int(rgb.shape[0]), "bytes": len(buf),
                          "mode": mode, "rgb_sha256": rgb_sha256(rgb)}
    (root / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    return manifest


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(FIXTURE_DIR.parents[2]))
    m = write_fixtures()
    total = sum(v["bytes"] for v in m.values())
    for k, v in m.items():
        print(f"{k}: {v['bytes']} bytes, {v['mode']}")
    print(f"{len(m)} files, {total} bytes")
