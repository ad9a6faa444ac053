// jpegdec: a baseline JPEG decoder in standard C++17, no libjpeg.
//
// Its RGB output equals libjpeg-turbo's default decode bit for bit (what
// OpenCV's imdecode and the native loader's libjpeg give): the same
// Huffman decode, the integer IDCT of jidctint.c (jpeg_idct_islow) with
// its range-limit table, the "fancy" triangle upsampling of jdsample.c
// (h2v1, h2v2, h1v2; plain replication for other factors and for
// components two samples wide or less), the fixed-point YCbCr -> RGB of
// jdcolor.c, and libjpeg's colour-space guess (JFIF, Adobe APP14, the
// component ids). Grayscale is replicated into three channels.
//
// Supported: SOF0 and SOF1 at 8-bit precision with 1 or 3 components,
// interleaved and non-interleaved scans, any integral sampling factors,
// DQT with 8- or 16-bit entries, DRI with RST0-7. Refused with a status
// that names the mode: progressive, lossless, hierarchical, arithmetic
// coding, 12-bit samples, CMYK/YCCK and other component counts. Truncated
// or corrupt data is an error: every read is bounds-checked, a scan that
// runs past its data fails, and images over 2^28 pixels are refused
// before any allocation. EXIF orientation is not applied (libjpeg does
// not apply it either).
//
// C interface (status 0 ok, 1 corrupt or truncated, 2 unsupported mode,
// 3 bad arguments; ``err`` receives the message):
//   int epk_jpeg_info(buf, n, &w, &h, &comps, err, errlen)
//   int epk_jpeg_decode_rgb(buf, n, out, w, h, err, errlen)
// Thread-safe: no mutable global state, so callers may decode in parallel.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

enum Status { kOk = 0, kCorrupt = 1, kUnsupported = 2, kBadArgs = 3 };

struct Failure {
    Status status;
    std::string msg;
};

[[noreturn]] void fail(Status s, const std::string& msg) {
    throw Failure{s, msg};
}

[[noreturn]] void corrupt(const std::string& msg) { fail(kCorrupt, msg); }

constexpr int64_t kMaxPixels = int64_t(1) << 28;

// zig-zag index -> natural (row-major) index of an 8x8 block
constexpr int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ------------------------------------------------------------------ tables
// jdmaster.c prepare_range_limit_table, post-IDCT part: indexed by the
// IDCT's output & RANGE_MASK (1023), it maps v -> clamp(v + 128, 0, 255)
// for v in [-512, 511] and wraps beyond, as libjpeg does.
struct IdctLimit {
    uint8_t t[1024];
    IdctLimit() {
        for (int i = 0; i < 1024; ++i) {
            int v;
            if (i < 128) v = 128 + i;          // 0..127 -> 128..255
            else if (i < 512) v = 255;         // 128..511 saturate high
            else if (i < 896) v = 0;           // -512..-129 saturate low
            else v = i - 896;                  // -128..-1 -> 0..127
            t[i] = static_cast<uint8_t>(v);
        }
    }
};

// jdcolor.c build_ycc_rgb_table (SCALEBITS 16), computed inline: every
// term fits in 32 bits, and the loop vectorizes where the table lookups
// would not. cr_r(x) = (FIX(1.402) x + 2^15) >> 16 and so on, x = c - 128.
constexpr int kFixCrR = 91881;      // FIX(1.40200)
constexpr int kFixCbB = 116130;     // FIX(1.77200)
constexpr int kFixCrG = 46802;      // FIX(0.71414)
constexpr int kFixCbG = 22554;      // FIX(0.34414)
constexpr int kHalf16 = 1 << 15;

const IdctLimit& idct_limit() {
    static const IdctLimit t;
    return t;
}

inline uint8_t clamp255(int v) {
    return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// jdcolor.c ycc_rgb_convert on one row: the three channels apart, then
// interleaved.
void ycc_rgb_row(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                 uint8_t* tmp, uint8_t* out, size_t n) {
    uint8_t* R = tmp;
    uint8_t* G = tmp + n;
    uint8_t* B = tmp + 2 * n;
    for (size_t x = 0; x < n; ++x) {
        const int Y = y[x], u = cb[x] - 128, v = cr[x] - 128;
        R[x] = clamp255(Y + ((kFixCrR * v + kHalf16) >> 16));
        G[x] = clamp255(Y + ((-kFixCbG * u - kFixCrG * v + kHalf16) >> 16));
        B[x] = clamp255(Y + ((kFixCbB * u + kHalf16) >> 16));
    }
    for (size_t x = 0; x < n; ++x) {
        out[3 * x] = R[x];
        out[3 * x + 1] = G[x];
        out[3 * x + 2] = B[x];
    }
}

// ------------------------------------------------------------------- IDCT
// jidctint.c jpeg_idct_islow, transcribed: CONST_BITS 13, PASS1_BITS 2,
// 64-bit JLONG products, the quantizer as a 16-bit multiplier (libjpeg-
// turbo's ISLOW_MULT_TYPE), and both zero shortcuts.
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t F0_298631336 = 2446;
constexpr int64_t F0_390180644 = 3196;
constexpr int64_t F0_541196100 = 4433;
constexpr int64_t F0_765366865 = 6270;
constexpr int64_t F0_899976223 = 7373;
constexpr int64_t F1_175875602 = 9633;
constexpr int64_t F1_501321110 = 12299;
constexpr int64_t F1_847759065 = 15137;
constexpr int64_t F1_961570560 = 16069;
constexpr int64_t F2_053119869 = 16819;
constexpr int64_t F2_562915447 = 20995;
constexpr int64_t F3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
    return (x + (int64_t(1) << (n - 1))) >> n;
}

void idct_islow(const int16_t* coef, const int16_t* quant, uint8_t* out,
                int stride) {
    const uint8_t* limit = idct_limit().t;
    int ws[64];
    for (int c = 0; c < 8; ++c) {
        const int16_t* in = coef + c;
        const int16_t* q = quant + c;
        int* w = ws + c;
        if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
            in[40] == 0 && in[48] == 0 && in[56] == 0) {
            const int dc = static_cast<int>(
                static_cast<uint32_t>(int(in[0]) * int(q[0])) << kPass1Bits);
            for (int r = 0; r < 8; ++r) w[r * 8] = dc;
            continue;
        }
        int64_t z2 = int64_t(in[16]) * q[16];
        int64_t z3 = int64_t(in[48]) * q[48];
        int64_t z1 = (z2 + z3) * F0_541196100;
        int64_t tmp2 = z1 + z3 * (-F1_847759065);
        int64_t tmp3 = z1 + z2 * F0_765366865;
        z2 = int64_t(in[0]) * q[0];
        z3 = int64_t(in[32]) * q[32];
        int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
        int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
        const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

        tmp0 = int64_t(in[56]) * q[56];
        tmp1 = int64_t(in[40]) * q[40];
        tmp2 = int64_t(in[24]) * q[24];
        tmp3 = int64_t(in[8]) * q[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        const int64_t z5 = (z3 + z4) * F1_175875602;
        tmp0 *= F0_298631336;
        tmp1 *= F2_053119869;
        tmp2 *= F3_072711026;
        tmp3 *= F1_501321110;
        z1 *= -F0_899976223;
        z2 *= -F2_562915447;
        z3 *= -F1_961570560;
        z4 *= -F0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;

        constexpr int s = kConstBits - kPass1Bits;
        w[0] = static_cast<int>(descale(tmp10 + tmp3, s));
        w[56] = static_cast<int>(descale(tmp10 - tmp3, s));
        w[8] = static_cast<int>(descale(tmp11 + tmp2, s));
        w[48] = static_cast<int>(descale(tmp11 - tmp2, s));
        w[16] = static_cast<int>(descale(tmp12 + tmp1, s));
        w[40] = static_cast<int>(descale(tmp12 - tmp1, s));
        w[24] = static_cast<int>(descale(tmp13 + tmp0, s));
        w[32] = static_cast<int>(descale(tmp13 - tmp0, s));
    }
    for (int r = 0; r < 8; ++r) {
        const int* w = ws + r * 8;
        uint8_t* o = out + static_cast<size_t>(r) * stride;
        if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
            w[6] == 0 && w[7] == 0) {
            const uint8_t v =
                limit[static_cast<int>(descale(w[0], kPass1Bits + 3)) & 1023];
            std::memset(o, v, 8);
            continue;
        }
        int64_t z2 = w[2], z3 = w[6];
        int64_t z1 = (z2 + z3) * F0_541196100;
        int64_t tmp2 = z1 + z3 * (-F1_847759065);
        int64_t tmp3 = z1 + z2 * F0_765366865;
        int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
        int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
        const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        const int64_t z5 = (z3 + z4) * F1_175875602;
        tmp0 *= F0_298631336;
        tmp1 *= F2_053119869;
        tmp2 *= F3_072711026;
        tmp3 *= F1_501321110;
        z1 *= -F0_899976223;
        z2 *= -F2_562915447;
        z3 *= -F1_961570560;
        z4 *= -F0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;

        constexpr int s = kConstBits + kPass1Bits + 3;
        o[0] = limit[static_cast<int>(descale(tmp10 + tmp3, s)) & 1023];
        o[7] = limit[static_cast<int>(descale(tmp10 - tmp3, s)) & 1023];
        o[1] = limit[static_cast<int>(descale(tmp11 + tmp2, s)) & 1023];
        o[6] = limit[static_cast<int>(descale(tmp11 - tmp2, s)) & 1023];
        o[2] = limit[static_cast<int>(descale(tmp12 + tmp1, s)) & 1023];
        o[5] = limit[static_cast<int>(descale(tmp12 - tmp1, s)) & 1023];
        o[3] = limit[static_cast<int>(descale(tmp13 + tmp0, s)) & 1023];
        o[4] = limit[static_cast<int>(descale(tmp13 - tmp0, s)) & 1023];
    }
}

// ---------------------------------------------------------------- Huffman
struct Huffman {
    bool defined = false;
    int nsym = 0;
    uint8_t vals[256] = {};
    int32_t maxcode[18] = {};
    int32_t valoffset[18] = {};
    // codes of up to kLook bits decode from one table lookup
    static constexpr int kLook = 9;
    uint8_t look_len[1 << kLook] = {};
    uint8_t look_sym[1 << kLook] = {};

    // jdhuff.c jpeg_make_d_derived_tbl
    void build(const uint8_t counts[17], const uint8_t* symbols, bool dc) {
        int sizes[257], codes[256];
        int p = 0;
        for (int l = 1; l <= 16; ++l) {
            if (p + counts[l] > 256) corrupt("bad Huffman table");
            for (int i = 0; i < counts[l]; ++i) sizes[p++] = l;
        }
        sizes[p] = 0;
        nsym = p;
        int code = 0, si = sizes[0];
        p = 0;
        while (sizes[p]) {
            while (sizes[p] == si) codes[p++] = code++;
            if (code >= (1 << si)) corrupt("bad Huffman table");
            code <<= 1;
            ++si;
        }
        p = 0;
        for (int l = 1; l <= 16; ++l) {
            if (counts[l]) {
                valoffset[l] = p - codes[p];
                p += counts[l];
                maxcode[l] = codes[p - 1];
            } else {
                maxcode[l] = -1;
            }
        }
        valoffset[17] = 0;
        maxcode[17] = 0xFFFFF;
        std::memcpy(vals, symbols, static_cast<size_t>(nsym));
        std::memset(look_len, 0, sizeof(look_len));
        p = 0;
        for (int l = 1; l <= kLook; ++l) {
            for (int i = 0; i < counts[l]; ++i, ++p) {
                const int base = codes[p] << (kLook - l);
                for (int k = 0; k < (1 << (kLook - l)); ++k) {
                    look_len[base + k] = static_cast<uint8_t>(l);
                    look_sym[base + k] = vals[p];
                }
            }
        }
        if (dc) {
            for (int i = 0; i < nsym; ++i)
                if (vals[i] > 15) corrupt("bad DC Huffman table");
        }
        defined = true;
    }
};

// Entropy-coded data: 0xFF00 stuffing removed, stopping at a marker or at
// the end of the buffer. Past either it feeds zero bits and counts them;
// a decode that consumes one of those bits ran off its data.
class BitReader {
  public:
    BitReader(const uint8_t* p, const uint8_t* end) : p_(p), end_(end) {}

    uint32_t peek(int n) {
        if (nbits_ < n) refill();
        return static_cast<uint32_t>(acc_ >> (64 - n));
    }
    void skip(int n) {
        acc_ <<= n;
        nbits_ -= n;
    }
    int bits(int n) {   // n in 1..16
        const uint32_t v = peek(n);
        skip(n);
        return static_cast<int>(v);
    }
    int decode(const Huffman& h) {
        const uint32_t look = peek(16) >> (16 - Huffman::kLook);
        int l = h.look_len[look];
        if (l) {
            skip(l);
            return h.look_sym[look];
        }
        l = Huffman::kLook + 1;
        uint32_t top = peek(16);
        int32_t code = static_cast<int32_t>(top >> (16 - l));
        while (code > h.maxcode[l]) {
            if (++l > 16) corrupt("corrupt Huffman code");
            code = static_cast<int32_t>(top >> (16 - l));
        }
        const int idx = code + h.valoffset[l];
        if (idx < 0 || idx >= h.nsym) corrupt("corrupt Huffman code");
        skip(l);
        return h.vals[idx];
    }
    // zero bits consumed past the data?
    bool overrun() const { return nbits_ < fill_; }
    // drop the buffered bits; the reader then stands at the next marker
    // (or the end of the data)
    const uint8_t* byte_align_to_marker() {
        acc_ = 0;
        nbits_ = 0;
        fill_ = 0;
        if (!at_marker_) {
            // data bytes left before the marker: skip them, as libjpeg
            // does (with a warning)
            while (p_ < end_) {
                if (*p_ == 0xFF) {
                    const uint8_t* q = p_ + 1;
                    while (q < end_ && *q == 0xFF) ++q;
                    if (q < end_ && *q != 0x00) break;
                    p_ = q + 1;
                } else {
                    ++p_;
                }
            }
        }
        at_marker_ = false;
        return p_;
    }
    void restart_at(const uint8_t* p) {
        p_ = p;
        acc_ = 0;
        nbits_ = 0;
        fill_ = 0;
        at_marker_ = false;
    }

  private:
    void refill() {
        while (nbits_ <= 56) {
            uint64_t c = 0;
            if (at_marker_ || p_ >= end_) {
                fill_ += 8;
            } else if (*p_ != 0xFF) {
                c = *p_++;
            } else {
                const uint8_t* q = p_ + 1;
                while (q < end_ && *q == 0xFF) ++q;
                if (q < end_ && *q == 0x00) {
                    c = 0xFF;
                    p_ = q + 1;
                } else {
                    at_marker_ = true;   // p_ stays on the marker's 0xFF
                    fill_ += 8;
                }
            }
            acc_ |= c << (56 - nbits_);
            nbits_ += 8;
        }
    }

    const uint8_t* p_;
    const uint8_t* end_;
    uint64_t acc_ = 0;
    int nbits_ = 0;
    int fill_ = 0;
    bool at_marker_ = false;
};

inline int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ------------------------------------------------------------------ frame
struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int td = 0, ta = 0;             // Huffman tables of the current scan
    int dw = 0, dh = 0;             // downsampled width and height
    int bw = 0, bh = 0;             // blocks of a non-interleaved scan
    int stride = 0, rows = 0;       // plane size (MCU-padded)
    bool quant_latched = false, decoded = false;
    int16_t quant[64] = {};         // natural order
    std::vector<uint8_t> plane;
    int last_dc = 0;
};

struct Decoder {
    const uint8_t* buf;
    const uint8_t* end;
    const uint8_t* p;

    int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
    bool have_frame = false;
    Component comp[3];
    uint16_t qt[4][64] = {};        // natural order
    bool qt_defined[4] = {};
    Huffman dc_tab[4], ac_tab[4];
    int restart_interval = 0;
    bool saw_jfif = false, saw_adobe = false;
    int adobe_transform = 0;
    int mcux = 0, mcuy = 0;
    mutable std::vector<int> colsum;   // the h2v2 upsampler's row of sums

    Decoder(const uint8_t* b, size_t n) : buf(b), end(b + n), p(b) {}

    int u8() {
        if (p >= end) corrupt("truncated JPEG (inside a marker segment)");
        return *p++;
    }
    int u16() {
        const int hi = u8();
        return (hi << 8) | u8();
    }

    // the next marker code, past fill bytes and, as libjpeg skips them
    // with a warning, any other bytes before it
    int next_marker() {
        while (p < end && *p != 0xFF) ++p;
        while (p < end && *p == 0xFF) ++p;
        if (p >= end) corrupt("truncated JPEG (no EOI marker)");
        return *p++;
    }

    // a segment's payload as [start, stop); p moves past it
    std::pair<const uint8_t*, const uint8_t*> segment() {
        const int len = u16();
        if (len < 2) corrupt("bad marker segment length");
        if (end - p < len - 2) corrupt("truncated JPEG (marker segment)");
        const uint8_t* s = p;
        p += len - 2;
        return {s, p};
    }

    void read_app(int marker) {
        auto [s, e] = segment();
        const size_t n = static_cast<size_t>(e - s);
        if (marker == 0xE0 && n >= 14 && std::memcmp(s, "JFIF\0", 5) == 0)
            saw_jfif = true;
        if (marker == 0xEE && n >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = s[11];
        }
    }

    void read_dqt() {
        auto [s, e] = segment();
        const uint8_t* q = s;
        while (q < e) {
            const int pq = *q >> 4, tq = *q & 15;
            ++q;
            if (tq > 3) corrupt("bad quantization table id");
            if (pq > 1) corrupt("bad quantization table precision");
            const int need = pq ? 128 : 64;
            if (e - q < need) corrupt("truncated quantization table");
            for (int i = 0; i < 64; ++i) {
                const int v = pq ? (q[2 * i] << 8) | q[2 * i + 1] : q[i];
                qt[tq][kNatural[i]] = static_cast<uint16_t>(v);
            }
            q += need;
            qt_defined[tq] = true;
        }
    }

    void read_dht() {
        auto [s, e] = segment();
        const uint8_t* q = s;
        while (q < e) {
            const int tc = *q >> 4, th = *q & 15;
            ++q;
            if (tc > 1 || th > 3) corrupt("bad Huffman table id");
            if (e - q < 16) corrupt("truncated Huffman table");
            uint8_t counts[17] = {};
            int total = 0;
            for (int l = 1; l <= 16; ++l) {
                counts[l] = q[l - 1];
                total += counts[l];
            }
            q += 16;
            if (total > 256 || e - q < total)
                corrupt("bad Huffman table length");
            (tc ? ac_tab : dc_tab)[th].build(counts, q, tc == 0);
            q += total;
        }
    }

    void read_dri() {
        auto [s, e] = segment();
        if (e - s != 2) corrupt("bad DRI segment");
        restart_interval = (s[0] << 8) | s[1];
    }

    void read_sof(int marker) {
        static const char* const kModes[16] = {
            nullptr, nullptr, "progressive (SOF2)", "lossless (SOF3)",
            nullptr, "hierarchical (SOF5)", "hierarchical progressive (SOF6)",
            "hierarchical lossless (SOF7)", nullptr,
            "arithmetic coding (SOF9)",
            "progressive arithmetic coding (SOF10)",
            "lossless arithmetic coding (SOF11)", nullptr,
            "hierarchical arithmetic coding (SOF13)",
            "hierarchical progressive arithmetic coding (SOF14)",
            "hierarchical lossless arithmetic coding (SOF15)"};
        const int kind = marker - 0xC0;
        if (kind != 0 && kind != 1)
            fail(kUnsupported, std::string("unsupported JPEG mode: ") +
                                   kModes[kind]);
        if (have_frame) corrupt("more than one frame header");
        auto [s, e] = segment();
        if (e - s < 6) corrupt("truncated frame header");
        const int precision = s[0];
        height = (s[1] << 8) | s[2];
        width = (s[3] << 8) | s[4];
        ncomp = s[5];
        if (precision != 8)
            fail(kUnsupported, "unsupported JPEG mode: " +
                                   std::to_string(precision) +
                                   "-bit samples");
        if (ncomp == 4)
            fail(kUnsupported,
                 "unsupported JPEG mode: CMYK/YCCK (4 components)");
        if (ncomp != 1 && ncomp != 3)
            fail(kUnsupported, "unsupported JPEG mode: " +
                                   std::to_string(ncomp) + " components");
        if (height == 0)
            fail(kUnsupported,
                 "unsupported JPEG mode: height given by a DNL marker");
        if (width == 0) corrupt("image width 0");
        if (int64_t(width) * height > kMaxPixels)
            fail(kUnsupported, "image of " + std::to_string(width) + "x" +
                                   std::to_string(height) +
                                   " pixels exceeds 2^28");
        if (e - s != 6 + 3 * ncomp) corrupt("bad frame header length");
        hmax = vmax = 1;
        for (int c = 0; c < ncomp; ++c) {
            Component& k = comp[c];
            k.id = s[6 + 3 * c];
            k.h = s[7 + 3 * c] >> 4;
            k.v = s[7 + 3 * c] & 15;
            k.tq = s[8 + 3 * c];
            if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4)
                corrupt("bad sampling factors");
            if (k.tq > 3) corrupt("bad quantization table id");
            hmax = std::max(hmax, k.h);
            vmax = std::max(vmax, k.v);
        }
        mcux = (width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (int c = 0; c < ncomp; ++c) {
            Component& k = comp[c];
            if (hmax % k.h || vmax % k.v)
                fail(kUnsupported,
                     "unsupported JPEG mode: non-integral sampling factors");
            k.dw = static_cast<int>((int64_t(width) * k.h + hmax - 1) / hmax);
            k.dh = static_cast<int>((int64_t(height) * k.v + vmax - 1) / vmax);
            k.bw = (k.dw + 7) / 8;
            k.bh = (k.dh + 7) / 8;
            k.stride = mcux * k.h * 8;
            k.rows = mcuy * k.v * 8;
        }
        have_frame = true;
    }

    void decode_block(BitReader& br, Component& k, int bx, int by) {
        int16_t block[64] = {};
        const Huffman& dc = dc_tab[k.td];
        const Huffman& ac = ac_tab[k.ta];
        int s = br.decode(dc);
        int diff = 0;
        if (s) diff = extend(br.bits(s), s);
        k.last_dc = static_cast<int>(static_cast<uint32_t>(k.last_dc) +
                                     static_cast<uint32_t>(diff));
        block[0] = static_cast<int16_t>(k.last_dc);
        for (int i = 1; i < 64; ++i) {
            const int rs = br.decode(ac);
            const int r = rs >> 4;
            s = rs & 15;
            if (s) {
                i += r;
                if (i > 63) corrupt("corrupt data: coefficient index > 63");
                block[kNatural[i]] = static_cast<int16_t>(extend(br.bits(s), s));
            } else {
                if (r != 15) break;
                i += 15;
            }
        }
        idct_islow(block, k.quant,
                   k.plane.data() + static_cast<size_t>(by) * 8 * k.stride +
                       static_cast<size_t>(bx) * 8,
                   k.stride);
    }

    void read_scan() {
        if (!have_frame) corrupt("scan before the frame header");
        auto [s, e] = segment();
        if (e - s < 1) corrupt("truncated scan header");
        const int ns = s[0];
        if (ns < 1 || ns > ncomp || e - s != 4 + 2 * ns)
            corrupt("bad scan header");
        Component* in_scan[3];
        for (int i = 0; i < ns; ++i) {
            const int id = s[1 + 2 * i], t = s[2 + 2 * i];
            Component* k = nullptr;
            for (int c = 0; c < ncomp; ++c)
                if (comp[c].id == id) k = &comp[c];
            if (!k) corrupt("scan names an unknown component");
            for (int j = 0; j < i; ++j)
                if (in_scan[j] == k) corrupt("component twice in a scan");
            k->td = t >> 4;
            k->ta = t & 15;
            if (k->td > 3 || k->ta > 3) corrupt("bad Huffman table id");
            if (!dc_tab[k->td].defined || !ac_tab[k->ta].defined)
                corrupt("scan uses an undefined Huffman table");
            if (!k->quant_latched) {
                // libjpeg latches the table when the component's first
                // scan starts
                if (!qt_defined[k->tq])
                    corrupt("component uses an undefined quantization table");
                for (int j = 0; j < 64; ++j)
                    k->quant[j] = static_cast<int16_t>(qt[k->tq][j]);
                k->quant_latched = true;
            }
            if (k->plane.empty())
                k->plane.assign(static_cast<size_t>(k->stride) * k->rows, 0);
            k->last_dc = 0;
            in_scan[i] = k;
        }
        // Ss, Se, Ah/Al of a sequential scan are not checked (libjpeg
        // only warns)
        int blocks = 0;
        for (int i = 0; i < ns; ++i) blocks += in_scan[i]->h * in_scan[i]->v;
        if (ns > 1 && blocks > 10) corrupt("too many blocks in an MCU");

        BitReader br(p, end);
        const int64_t nx = ns == 1 ? in_scan[0]->bw : mcux;
        const int64_t ny = ns == 1 ? in_scan[0]->bh : mcuy;
        const int64_t total = nx * ny;
        int next_rst = 0;
        for (int64_t m = 0; m < total; ++m) {
            if (restart_interval && m && m % restart_interval == 0) {
                const uint8_t* q = br.byte_align_to_marker();
                if (end - q < 2 || q[0] != 0xFF)
                    corrupt("missing restart marker");
                while (q < end && *q == 0xFF) ++q;
                if (q >= end || *q != 0xD0 + next_rst)
                    corrupt("missing or wrong restart marker");
                br.restart_at(q + 1);
                next_rst = (next_rst + 1) & 7;
                for (int i = 0; i < ns; ++i) in_scan[i]->last_dc = 0;
            }
            const int mx = static_cast<int>(m % nx), my = static_cast<int>(m / nx);
            if (ns == 1) {
                decode_block(br, *in_scan[0], mx, my);
            } else {
                for (int i = 0; i < ns; ++i) {
                    Component& k = *in_scan[i];
                    for (int y = 0; y < k.v; ++y)
                        for (int x = 0; x < k.h; ++x)
                            decode_block(br, k, mx * k.h + x, my * k.v + y);
                }
            }
            if (br.overrun()) corrupt("truncated or corrupt entropy-coded data");
        }
        for (int i = 0; i < ns; ++i) in_scan[i]->decoded = true;
        p = br.byte_align_to_marker();
    }

    // parse markers from where the last call stopped: up to the frame
    // header when ``headers_only``, else through EOI
    void run(bool headers_only) {
        if (p == buf) {
            if (end - p < 2 || p[0] != 0xFF || p[1] != 0xD8)
                corrupt("not a JPEG (no SOI marker)");
            p += 2;
        }
        for (;;) {
            const int m = next_marker();
            if (m == 0xD9) break;                         // EOI
            if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 &&
                m != 0xCC) {
                read_sof(m);
                if (headers_only) return;
            } else if (m == 0xC4) {
                read_dht();
            } else if (m == 0xCC) {
                fail(kUnsupported,
                     "unsupported JPEG mode: arithmetic coding (DAC)");
            } else if (m == 0xDB) {
                read_dqt();
            } else if (m == 0xDD) {
                read_dri();
            } else if (m == 0xDA) {
                read_scan();
            } else if (m == 0xDC) {
                fail(kUnsupported, "unsupported JPEG mode: DNL marker");
            } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
                read_app(m);
            } else if (m >= 0xD0 && m <= 0xD7) {
                corrupt("restart marker outside a scan");
            } else if (m == 0xD8) {
                corrupt("second SOI marker");
            } else if (m == 0x01 || m == 0x00) {
                corrupt("bad marker");
            } else {
                segment();                                // skip others
            }
        }
        if (!have_frame) corrupt("no frame header");
        if (headers_only) return;
        for (int c = 0; c < ncomp; ++c)
            if (!comp[c].decoded) corrupt("a component has no scan");
    }

    // -------------------------------------------------------- upsampling
    // component row ``y`` of the image (clamped as libjpeg replicates the
    // first and last rows for context)
    const uint8_t* crow(const Component& k, int r) const {
        r = std::min(std::max(r, 0), k.dh - 1);
        return k.plane.data() + static_cast<size_t>(r) * k.stride;
    }

    // output row ``y`` of component ``k`` (``width`` samples): the plane's
    // row at full size, else upsampled into ``out``
    const uint8_t* upsample_row(const Component& k, int y, uint8_t* out) const {
        const int fh = hmax / k.h, fv = vmax / k.v;
        const int dw = k.dw;
        if (fh == 1 && fv == 1) return crow(k, y);
        if (fh == 2 && fv == 1 && dw > 2) {               // h2v1 fancy
            const uint8_t* in = crow(k, y);
            out[0] = in[0];
            out[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
            for (int c = 1; c < dw - 1; ++c) {
                const int v = in[c] * 3;
                out[2 * c] = static_cast<uint8_t>((v + in[c - 1] + 1) >> 2);
                out[2 * c + 1] = static_cast<uint8_t>((v + in[c + 1] + 2) >> 2);
            }
            const int l = dw - 1;
            out[2 * l] = static_cast<uint8_t>((in[l] * 3 + in[l - 1] + 1) >> 2);
            out[2 * l + 1] = in[l];
            return out;
        }
        if (fh == 1 && fv == 2) {                         // h1v2 fancy
            const int i = y >> 1;
            const bool below = y & 1;
            const uint8_t* near = crow(k, i);
            const uint8_t* far = crow(k, below ? i + 1 : i - 1);
            const int bias = below ? 2 : 1;
            for (int c = 0; c < dw; ++c)
                out[c] = static_cast<uint8_t>((near[c] * 3 + far[c] + bias) >> 2);
            return out;
        }
        if (fh == 2 && fv == 2 && dw > 2) {               // h2v2 fancy
            const int i = y >> 1;
            const bool below = y & 1;
            const uint8_t* near = crow(k, i);
            const uint8_t* far = crow(k, below ? i + 1 : i - 1);
            // column sums 3 * nearer row + further row, then libjpeg's
            // 9/16, 3/16, 3/16, 1/16 weights with biases 8 and 7
            int* sum = colsum.data();
            for (int c = 0; c < dw; ++c) sum[c] = near[c] * 3 + far[c];
            out[0] = static_cast<uint8_t>((sum[0] * 4 + 8) >> 4);
            out[1] = static_cast<uint8_t>((sum[0] * 3 + sum[1] + 7) >> 4);
            for (int c = 1; c < dw - 1; ++c) {
                out[2 * c] = static_cast<uint8_t>((sum[c] * 3 + sum[c - 1] + 8) >> 4);
                out[2 * c + 1] =
                    static_cast<uint8_t>((sum[c] * 3 + sum[c + 1] + 7) >> 4);
            }
            const int l = dw - 1;
            out[2 * l] = static_cast<uint8_t>((sum[l] * 3 + sum[l - 1] + 8) >> 4);
            out[2 * l + 1] = static_cast<uint8_t>((sum[l] * 4 + 7) >> 4);
            return out;
        }
        // plain replication (jdsample.c int_upsample, h2v1_upsample,
        // h2v2_upsample)
        const uint8_t* in = crow(k, y / fv);
        for (int x = 0; x < width; ++x) out[x] = in[x / fh];
        return out;
    }

    void to_rgb(uint8_t* rgb) const {
        const size_t W = static_cast<size_t>(width);
        if (ncomp == 1) {
            for (int y = 0; y < height; ++y) {
                const uint8_t* in = crow(comp[0], y);   // 1x1 in an image of one component
                uint8_t* o = rgb + y * W * 3;
                for (size_t x = 0; x < W; ++x)
                    o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = in[x];
            }
            return;
        }
        // jdapimin.c default_decompress_parms: the colour-space guess
        bool ycc = true;
        if (!saw_jfif) {
            if (saw_adobe) {
                ycc = adobe_transform != 0;
            } else if (comp[0].id == 82 && comp[1].id == 71 &&
                       comp[2].id == 66) {
                ycc = false;                               // 'R', 'G', 'B'
            }
        }
        // rows padded for the upsamplers, which may write 2 * dw samples
        const size_t pad = W + 16 * static_cast<size_t>(hmax);
        std::vector<uint8_t> rows(3 * pad);
        colsum.resize(pad);
        std::vector<uint8_t> rgbrow(3 * W);
        for (int y = 0; y < height; ++y) {
            const uint8_t* r0 = upsample_row(comp[0], y, rows.data());
            const uint8_t* r1 = upsample_row(comp[1], y, rows.data() + pad);
            const uint8_t* r2 = upsample_row(comp[2], y, rows.data() + 2 * pad);
            uint8_t* o = rgb + y * W * 3;
            if (ycc) {
                ycc_rgb_row(r0, r1, r2, rgbrow.data(), o, W);
            } else {
                for (size_t x = 0; x < W; ++x) {
                    o[3 * x] = r0[x];
                    o[3 * x + 1] = r1[x];
                    o[3 * x + 2] = r2[x];
                }
            }
        }
    }
};

int report(const Failure& f, char* err, int errlen) {
    if (err && errlen > 0) std::snprintf(err, errlen, "%s", f.msg.c_str());
    return f.status;
}

template <typename Body>
int guarded(char* err, int errlen, Body&& body) {
    if (err && errlen > 0) err[0] = 0;
    try {
        body();
        return kOk;
    } catch (const Failure& f) {
        return report(f, err, errlen);
    } catch (const std::bad_alloc&) {
        return report({kCorrupt, "out of memory"}, err, errlen);
    }
}

}  // namespace

extern "C" {

int epk_jpeg_info(const uint8_t* buf, size_t n, int* w, int* h, int* comps,
                  char* err, int errlen) {
    return guarded(err, errlen, [&] {
        if (!buf || !w || !h || !comps) fail(kBadArgs, "null argument");
        Decoder d(buf, n);
        d.run(true);
        *w = d.width;
        *h = d.height;
        *comps = d.ncomp;
    });
}

int epk_jpeg_decode_rgb(const uint8_t* buf, size_t n, uint8_t* out, int w,
                        int h, char* err, int errlen) {
    return guarded(err, errlen, [&] {
        if (!buf || !out) fail(kBadArgs, "null argument");
        Decoder d(buf, n);
        d.run(true);
        if (d.width != w || d.height != h)
            fail(kBadArgs, "output is " + std::to_string(w) + "x" +
                               std::to_string(h) + ", image is " +
                               std::to_string(d.width) + "x" +
                               std::to_string(d.height));
        d.run(false);
        d.to_rgb(out);
    });
}

}  // extern "C"
