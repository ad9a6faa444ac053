// jpegdec: a JPEG decoder in standard C++17, no libjpeg.
//
// Its RGB output equals libjpeg-turbo's default decode bit for bit (what
// OpenCV's imdecode and the JAX package's native loader give), at full
// size and at libjpeg's DCT-scaled sizes num/8: the same Huffman decode,
// sequential and progressive; the integer IDCTs with their range-limit
// table (jidctint.c jpeg_idct_islow at 8x8 and its 3x3 and 6x6 kernels,
// jidctred.c's reduced 4x4, 2x2 and 1x1, which drop the highest
// coefficient rows); jdmaster.c's choice of IDCT size per component
// (chroma scaled up by IDCT where that makes upsampling 1:1); the "fancy"
// triangle upsampling of jdsample.c (h2v1, h2v2, h1v2; plain replication
// for other factors, for components two samples wide or less, and at
// scale 1/8); the fixed-point YCbCr -> RGB of jdcolor.c, and libjpeg's
// colour-space guess (JFIF, Adobe APP14, the component ids). Grayscale is
// replicated into three channels.
//
// Supported: SOF0, SOF1 and SOF2 (progressive, Huffman-coded) at 8-bit
// precision with 1 or 3 components, interleaved and non-interleaved
// scans, any integral sampling factors, DQT with 8- or 16-bit entries,
// DRI with RST0-7, output scales num/8 whose IDCT sizes are among 1, 2, 3,
// 4, 6 and 8 (every num of 1-4 and 8 for the common samplings). Refused
// with a status that names the mode: lossless, hierarchical, arithmetic
// coding, 12-bit samples, CMYK/YCCK and other component counts, other IDCT
// sizes, and progressive files that end with some of AC coefficients 1-9
// unfinished (libjpeg smooths those blocks, jdcoefct.c; this decoder does
// not). Truncated or corrupt data is an error: every read is
// bounds-checked, a scan that runs past its data fails, a scan with bad
// progression parameters fails, and images over 2^28 pixels (or whose
// padded sample planes exceed 3 * 2^28 samples) are refused before any
// allocation. EXIF orientation is not applied (libjpeg does not apply it
// either).
//
// C interface (status 0 ok, 1 corrupt or truncated, 2 unsupported mode,
// 3 bad arguments; ``err`` receives the message; ``scale_num`` in 1..8
// selects the output scale scale_num/8, 8 the full size):
//   int epk_jpeg_info(buf, n, scale_num, &w, &h, &comps, err, errlen)
//   int epk_jpeg_decode_rgb(buf, n, scale_num, out, w, h, err, errlen)
// where w, h are the output size, ceil(W * scale_num / 8) and likewise
// for H. Thread-safe: no mutable global state, so callers may decode in
// parallel. C++ callers that include this file may use epk::decode_rgb.

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

// zig-zag index -> natural (row-major) index of an 8x8 block, with
// libjpeg's 16 extra entries (jutils.c jpeg_natural_order) that send a
// run past the band's end to coefficient 63
constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

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
// The quantizer is a 16-bit multiplier (libjpeg-turbo's ISLOW_MULT_TYPE),
// products and sums are 64-bit (JLONG), and the zero shortcuts are
// libjpeg's: each kernel gives its bits exactly.
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t F0_211164243 = 1730;
constexpr int64_t F0_298631336 = 2446;
constexpr int64_t F0_390180644 = 3196;
constexpr int64_t F0_509795579 = 4176;
constexpr int64_t F0_541196100 = 4433;
constexpr int64_t F0_601344887 = 4926;
constexpr int64_t F0_720959822 = 5906;
constexpr int64_t F0_765366865 = 6270;
constexpr int64_t F0_850430095 = 6967;
constexpr int64_t F0_899976223 = 7373;
constexpr int64_t F1_061594337 = 8697;
constexpr int64_t F1_175875602 = 9633;
constexpr int64_t F1_272758580 = 10426;
constexpr int64_t F1_451774981 = 11893;
constexpr int64_t F1_501321110 = 12299;
constexpr int64_t F1_847759065 = 15137;
constexpr int64_t F1_961570560 = 16069;
constexpr int64_t F2_053119869 = 16819;
constexpr int64_t F2_172734803 = 17799;
constexpr int64_t F2_562915447 = 20995;
constexpr int64_t F3_072711026 = 25172;
constexpr int64_t F3_624509785 = 29692;
// jidctint.c's FIX(x) for the 3- and 6-point kernels
constexpr int64_t F0_366025404 = 2998;
constexpr int64_t F0_707106781 = 5793;
constexpr int64_t F1_224744871 = 10033;

inline int64_t descale(int64_t x, int n) {
    return (x + (int64_t(1) << (n - 1))) >> n;
}

// LEFT_SHIFT: a shift of the two's-complement bits, as libjpeg's macro
inline int64_t lshift(int64_t x, int n) {
    return static_cast<int64_t>(static_cast<uint64_t>(x) << n);
}

inline int64_t dq(const int16_t* in, const int16_t* q, int i) {
    return int64_t(in[i]) * q[i];
}

inline uint8_t limit_at(const uint8_t* limit, int64_t v) {
    return limit[static_cast<int>(v) & 1023];
}

// the DC-only column of pass 1: DEQUANTIZE(dc) << PASS1_BITS, in int
inline int dc_pass1(const int16_t* in, const int16_t* q) {
    return static_cast<int>(
        static_cast<uint32_t>(int(in[0]) * int(q[0])) << kPass1Bits);
}

// An IDCT of one block (coefficients and quantizer in natural order) into
// ``size`` rows of ``size`` samples at ``out``, rows ``stride`` apart.
using Idct = void (*)(const int16_t* coef, const int16_t* quant,
                      uint8_t* out, int stride);

// jidctint.c jpeg_idct_islow
void idct_8x8(const int16_t* coef, const int16_t* quant, uint8_t* out,
              int stride) {
    const uint8_t* limit = idct_limit().t;
    int ws[64];
    for (int c = 0; c < 8; ++c) {
        const int16_t* in = coef + c;
        const int16_t* q = quant + c;
        int* w = ws + c;
        if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
            in[40] == 0 && in[48] == 0 && in[56] == 0) {
            const int dc = dc_pass1(in, q);
            for (int r = 0; r < 8; ++r) w[r * 8] = dc;
            continue;
        }
        int64_t z2 = dq(in, q, 16);
        int64_t z3 = dq(in, q, 48);
        int64_t z1 = (z2 + z3) * F0_541196100;
        int64_t tmp2 = z1 + z3 * (-F1_847759065);
        int64_t tmp3 = z1 + z2 * F0_765366865;
        z2 = dq(in, q, 0);
        z3 = dq(in, q, 32);
        int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
        int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
        const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

        tmp0 = dq(in, q, 56);
        tmp1 = dq(in, q, 40);
        tmp2 = dq(in, q, 24);
        tmp3 = dq(in, q, 8);
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
            std::memset(o, limit_at(limit, descale(w[0], kPass1Bits + 3)),
                        8);
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
        o[0] = limit_at(limit, descale(tmp10 + tmp3, s));
        o[7] = limit_at(limit, descale(tmp10 - tmp3, s));
        o[1] = limit_at(limit, descale(tmp11 + tmp2, s));
        o[6] = limit_at(limit, descale(tmp11 - tmp2, s));
        o[2] = limit_at(limit, descale(tmp12 + tmp1, s));
        o[5] = limit_at(limit, descale(tmp12 - tmp1, s));
        o[3] = limit_at(limit, descale(tmp13 + tmp0, s));
        o[4] = limit_at(limit, descale(tmp13 - tmp0, s));
    }
}

// jidctint.c jpeg_idct_6x6: cK is sqrt(2) cos(K pi / 12)
void idct_6x6(const int16_t* coef, const int16_t* quant, uint8_t* out,
              int stride) {
    const uint8_t* limit = idct_limit().t;
    int ws[36];
    for (int c = 0; c < 6; ++c) {
        const int16_t* in = coef + c;
        const int16_t* q = quant + c;
        int64_t tmp0 = lshift(dq(in, q, 0), kConstBits);
        tmp0 += int64_t(1) << (kConstBits - kPass1Bits - 1);
        int64_t tmp10 = dq(in, q, 32) * F0_707106781;            // c4
        int64_t tmp1 = tmp0 + tmp10;
        const int64_t tmp11 =
            (tmp0 - tmp10 - tmp10) >> (kConstBits - kPass1Bits);
        tmp0 = dq(in, q, 16) * F1_224744871;                     // c2
        tmp10 = tmp1 + tmp0;
        const int64_t tmp12 = tmp1 - tmp0;

        const int64_t z1 = dq(in, q, 8), z2 = dq(in, q, 24),
                      z3 = dq(in, q, 40);
        tmp1 = (z1 + z3) * F0_366025404;                         // c5
        tmp0 = tmp1 + lshift(z1 + z2, kConstBits);
        const int64_t tmp2 = tmp1 + lshift(z3 - z2, kConstBits);
        tmp1 = lshift(z1 - z2 - z3, kPass1Bits);

        constexpr int s = kConstBits - kPass1Bits;
        ws[6 * 0 + c] = static_cast<int>((tmp10 + tmp0) >> s);
        ws[6 * 5 + c] = static_cast<int>((tmp10 - tmp0) >> s);
        ws[6 * 1 + c] = static_cast<int>(tmp11 + tmp1);
        ws[6 * 4 + c] = static_cast<int>(tmp11 - tmp1);
        ws[6 * 2 + c] = static_cast<int>((tmp12 + tmp2) >> s);
        ws[6 * 3 + c] = static_cast<int>((tmp12 - tmp2) >> s);
    }
    for (int r = 0; r < 6; ++r) {
        const int* w = ws + 6 * r;
        uint8_t* o = out + static_cast<size_t>(r) * stride;
        int64_t tmp0 = int64_t(w[0]) + (int64_t(1) << (kPass1Bits + 2));
        tmp0 = lshift(tmp0, kConstBits);
        int64_t tmp10 = int64_t(w[4]) * F0_707106781;
        int64_t tmp1 = tmp0 + tmp10;
        const int64_t tmp11 = tmp0 - tmp10 - tmp10;
        tmp0 = int64_t(w[2]) * F1_224744871;
        tmp10 = tmp1 + tmp0;
        const int64_t tmp12 = tmp1 - tmp0;

        const int64_t z1 = w[1], z2 = w[3], z3 = w[5];
        tmp1 = (z1 + z3) * F0_366025404;
        tmp0 = tmp1 + lshift(z1 + z2, kConstBits);
        const int64_t tmp2 = tmp1 + lshift(z3 - z2, kConstBits);
        tmp1 = lshift(z1 - z2 - z3, kConstBits);

        constexpr int s = kConstBits + kPass1Bits + 3;
        o[0] = limit_at(limit, (tmp10 + tmp0) >> s);
        o[5] = limit_at(limit, (tmp10 - tmp0) >> s);
        o[1] = limit_at(limit, (tmp11 + tmp1) >> s);
        o[4] = limit_at(limit, (tmp11 - tmp1) >> s);
        o[2] = limit_at(limit, (tmp12 + tmp2) >> s);
        o[3] = limit_at(limit, (tmp12 - tmp2) >> s);
    }
}

// jidctred.c jpeg_idct_4x4: column 4 and row term 4 are dropped
void idct_4x4(const int16_t* coef, const int16_t* quant, uint8_t* out,
              int stride) {
    const uint8_t* limit = idct_limit().t;
    int ws[8 * 4] = {};
    for (int c = 0; c < 8; ++c) {
        if (c == 4) continue;
        const int16_t* in = coef + c;
        const int16_t* q = quant + c;
        int* w = ws + c;
        if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[40] == 0 &&
            in[48] == 0 && in[56] == 0) {
            const int dc = dc_pass1(in, q);
            for (int r = 0; r < 4; ++r) w[8 * r] = dc;
            continue;
        }
        const int64_t tmp0 = lshift(dq(in, q, 0), kConstBits + 1);
        const int64_t tmp2 =
            dq(in, q, 16) * F1_847759065 + dq(in, q, 48) * -F0_765366865;
        const int64_t tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;

        const int64_t z1 = dq(in, q, 56), z2 = dq(in, q, 40),
                      z3 = dq(in, q, 24), z4 = dq(in, q, 8);
        const int64_t o0 = z1 * -F0_211164243 + z2 * F1_451774981 +
                           z3 * -F2_172734803 + z4 * F1_061594337;
        const int64_t o2 = z1 * -F0_509795579 + z2 * -F0_601344887 +
                           z3 * F0_899976223 + z4 * F2_562915447;

        constexpr int s = kConstBits - kPass1Bits + 1;
        w[8 * 0] = static_cast<int>(descale(tmp10 + o2, s));
        w[8 * 3] = static_cast<int>(descale(tmp10 - o2, s));
        w[8 * 1] = static_cast<int>(descale(tmp12 + o0, s));
        w[8 * 2] = static_cast<int>(descale(tmp12 - o0, s));
    }
    for (int r = 0; r < 4; ++r) {
        const int* w = ws + 8 * r;
        uint8_t* o = out + static_cast<size_t>(r) * stride;
        if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[5] == 0 && w[6] == 0 &&
            w[7] == 0) {
            std::memset(o, limit_at(limit, descale(w[0], kPass1Bits + 3)),
                        4);
            continue;
        }
        const int64_t tmp0 = lshift(w[0], kConstBits + 1);
        const int64_t tmp2 =
            int64_t(w[2]) * F1_847759065 + int64_t(w[6]) * -F0_765366865;
        const int64_t tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;

        const int64_t z1 = w[7], z2 = w[5], z3 = w[3], z4 = w[1];
        const int64_t o0 = z1 * -F0_211164243 + z2 * F1_451774981 +
                           z3 * -F2_172734803 + z4 * F1_061594337;
        const int64_t o2 = z1 * -F0_509795579 + z2 * -F0_601344887 +
                           z3 * F0_899976223 + z4 * F2_562915447;

        constexpr int s = kConstBits + kPass1Bits + 3 + 1;
        o[0] = limit_at(limit, descale(tmp10 + o2, s));
        o[3] = limit_at(limit, descale(tmp10 - o2, s));
        o[1] = limit_at(limit, descale(tmp12 + o0, s));
        o[2] = limit_at(limit, descale(tmp12 - o0, s));
    }
}

// jidctint.c jpeg_idct_3x3: cK is sqrt(2) cos(K pi / 6)
void idct_3x3(const int16_t* coef, const int16_t* quant, uint8_t* out,
              int stride) {
    const uint8_t* limit = idct_limit().t;
    int ws[9];
    for (int c = 0; c < 3; ++c) {
        const int16_t* in = coef + c;
        const int16_t* q = quant + c;
        int64_t tmp0 = lshift(dq(in, q, 0), kConstBits);
        tmp0 += int64_t(1) << (kConstBits - kPass1Bits - 1);
        const int64_t tmp12 = dq(in, q, 16) * F0_707106781;      // c2
        const int64_t tmp10 = tmp0 + tmp12;
        const int64_t tmp2 = tmp0 - tmp12 - tmp12;
        const int64_t odd = dq(in, q, 8) * F1_224744871;         // c1

        constexpr int s = kConstBits - kPass1Bits;
        ws[3 * 0 + c] = static_cast<int>((tmp10 + odd) >> s);
        ws[3 * 2 + c] = static_cast<int>((tmp10 - odd) >> s);
        ws[3 * 1 + c] = static_cast<int>(tmp2 >> s);
    }
    for (int r = 0; r < 3; ++r) {
        const int* w = ws + 3 * r;
        uint8_t* o = out + static_cast<size_t>(r) * stride;
        int64_t tmp0 = int64_t(w[0]) + (int64_t(1) << (kPass1Bits + 2));
        tmp0 = lshift(tmp0, kConstBits);
        const int64_t tmp12 = int64_t(w[2]) * F0_707106781;
        const int64_t tmp10 = tmp0 + tmp12;
        const int64_t tmp2 = tmp0 - tmp12 - tmp12;
        const int64_t odd = int64_t(w[1]) * F1_224744871;

        constexpr int s = kConstBits + kPass1Bits + 3;
        o[0] = limit_at(limit, (tmp10 + odd) >> s);
        o[2] = limit_at(limit, (tmp10 - odd) >> s);
        o[1] = limit_at(limit, tmp2 >> s);
    }
}

// jidctred.c jpeg_idct_2x2: columns 2, 4, 6 and even row terms but the
// DC are dropped
void idct_2x2(const int16_t* coef, const int16_t* quant, uint8_t* out,
              int stride) {
    const uint8_t* limit = idct_limit().t;
    int ws[8 * 2] = {};
    for (int c = 0; c < 8; ++c) {
        if (c == 2 || c == 4 || c == 6) continue;
        const int16_t* in = coef + c;
        const int16_t* q = quant + c;
        int* w = ws + c;
        if (in[8] == 0 && in[24] == 0 && in[40] == 0 && in[56] == 0) {
            const int dc = dc_pass1(in, q);
            w[0] = w[8] = dc;
            continue;
        }
        const int64_t tmp10 = lshift(dq(in, q, 0), kConstBits + 2);
        const int64_t tmp0 = dq(in, q, 56) * -F0_720959822 +
                             dq(in, q, 40) * F0_850430095 +
                             dq(in, q, 24) * -F1_272758580 +
                             dq(in, q, 8) * F3_624509785;
        constexpr int s = kConstBits - kPass1Bits + 2;
        w[0] = static_cast<int>(descale(tmp10 + tmp0, s));
        w[8] = static_cast<int>(descale(tmp10 - tmp0, s));
    }
    for (int r = 0; r < 2; ++r) {
        const int* w = ws + 8 * r;
        uint8_t* o = out + static_cast<size_t>(r) * stride;
        if (w[1] == 0 && w[3] == 0 && w[5] == 0 && w[7] == 0) {
            o[0] = o[1] = limit_at(limit, descale(w[0], kPass1Bits + 3));
            continue;
        }
        const int64_t tmp10 = lshift(w[0], kConstBits + 2);
        const int64_t tmp0 =
            int64_t(w[7]) * -F0_720959822 + int64_t(w[5]) * F0_850430095 +
            int64_t(w[3]) * -F1_272758580 + int64_t(w[1]) * F3_624509785;
        constexpr int s = kConstBits + kPass1Bits + 3 + 2;
        o[0] = limit_at(limit, descale(tmp10 + tmp0, s));
        o[1] = limit_at(limit, descale(tmp10 - tmp0, s));
    }
}

// jidctred.c jpeg_idct_1x1: the block's mean, one eighth of the DC
void idct_1x1(const int16_t* coef, const int16_t* quant, uint8_t* out,
              int /*stride*/) {
    const int dc = int(coef[0]) * int(quant[0]);
    out[0] = limit_at(idct_limit().t, descale(dc, 3));
}

Idct idct_of_size(int size) {
    switch (size) {
        case 1: return idct_1x1;
        case 2: return idct_2x2;
        case 3: return idct_3x3;
        case 4: return idct_4x4;
        case 6: return idct_6x6;
        case 8: return idct_8x8;
        default:
            fail(kUnsupported, "unsupported JPEG mode: IDCT size " +
                                   std::to_string(size));
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

// v << n on the two's-complement bits, kept to a coefficient's 16 bits
inline int16_t coef_shift(int v, int n) {
    return static_cast<int16_t>(static_cast<uint32_t>(v) << n);
}

// ------------------------------------------------------------------ frame
struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int td = 0, ta = 0;             // Huffman tables of the current scan
    int bw = 0, bh = 0;             // blocks of a non-interleaved scan
    int gbw = 0, gbh = 0;           // blocks of the MCU-padded grid
    int ssize = 8;                  // IDCT output size (jdmaster.c)
    int sw = 0, sh = 0;             // downsampled size at that scale
    int stride = 0, rows = 0;       // plane size (MCU-padded)
    Idct idct = nullptr;
    bool quant_latched = false, decoded = false;
    int16_t quant[64] = {};         // natural order
    std::vector<uint8_t> plane;
    std::vector<int16_t> coef;      // progressive: every block, natural order
    int coef_bits[64];              // progressive: Al of the last scan, -1 none
    int last_dc = 0;

    int16_t* block(int bx, int by) {
        return coef.data() +
               (static_cast<size_t>(by) * gbw + static_cast<size_t>(bx)) * 64;
    }
    void idct_block(const int16_t* blk, int bx, int by) {
        idct(blk, quant,
             plane.data() + static_cast<size_t>(by) * ssize * stride +
                 static_cast<size_t>(bx) * ssize,
             stride);
    }
};

struct Decoder {
    const uint8_t* buf;
    const uint8_t* end;
    const uint8_t* p;
    const int scale_num;            // output scale scale_num / 8

    int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
    int out_w = 0, out_h = 0;       // output size at the scale
    bool have_frame = false, progressive = false;
    Component comp[3];
    uint16_t qt[4][64] = {};        // natural order
    bool qt_defined[4] = {};
    Huffman dc_tab[4], ac_tab[4];
    int restart_interval = 0;
    bool saw_jfif = false, saw_adobe = false;
    int adobe_transform = 0;
    int mcux = 0, mcuy = 0;
    int eobrun = 0;                 // progressive AC scans
    mutable std::vector<int> colsum;   // the h2v2 upsampler's row of sums

    Decoder(const uint8_t* b, size_t n, int scale)
        : buf(b), end(b + n), p(b), scale_num(scale) {}

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
            nullptr, nullptr, nullptr, "lossless (SOF3)",
            nullptr, "hierarchical (SOF5)", "hierarchical progressive (SOF6)",
            "hierarchical lossless (SOF7)", nullptr,
            "arithmetic coding (SOF9)",
            "progressive arithmetic coding (SOF10)",
            "lossless arithmetic coding (SOF11)", nullptr,
            "hierarchical arithmetic coding (SOF13)",
            "hierarchical progressive arithmetic coding (SOF14)",
            "hierarchical lossless arithmetic coding (SOF15)"};
        const int kind = marker - 0xC0;
        if (kind > 2)
            fail(kUnsupported, std::string("unsupported JPEG mode: ") +
                                   kModes[kind]);
        if (have_frame) corrupt("more than one frame header");
        progressive = kind == 2;
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
        // the padded sample planes (and a progressive file's coefficient
        // buffer, two bytes a sample) are bounded before any allocation
        int64_t padded = 0;
        for (int c = 0; c < ncomp; ++c)
            padded += int64_t(mcux) * comp[c].h * mcuy * comp[c].v * 64;
        if (padded > 3 * kMaxPixels)
            fail(kUnsupported, "image of " + std::to_string(width) + "x" +
                                   std::to_string(height) +
                                   " pixels pads to over 3 * 2^28 samples");
        // jdmaster.c jpeg_calc_output_dimensions: the output size, then
        // each component's IDCT size, doubled while that keeps its
        // upsampling integral
        out_w = static_cast<int>((int64_t(width) * scale_num + 7) / 8);
        out_h = static_cast<int>((int64_t(height) * scale_num + 7) / 8);
        for (int c = 0; c < ncomp; ++c) {
            Component& k = comp[c];
            if (hmax % k.h || vmax % k.v)
                fail(kUnsupported,
                     "unsupported JPEG mode: non-integral sampling factors");
            const int64_t dw = (int64_t(width) * k.h + hmax - 1) / hmax;
            const int64_t dh = (int64_t(height) * k.v + vmax - 1) / vmax;
            k.bw = static_cast<int>((dw + 7) / 8);
            k.bh = static_cast<int>((dh + 7) / 8);
            k.gbw = mcux * k.h;
            k.gbh = mcuy * k.v;
            int ss = scale_num;
            while (ss < 8 && (hmax * scale_num) % (k.h * ss * 2) == 0 &&
                   (vmax * scale_num) % (k.v * ss * 2) == 0)
                ss *= 2;
            k.ssize = ss;
            k.idct = idct_of_size(ss);
            k.sw = static_cast<int>((int64_t(width) * k.h * ss +
                                     int64_t(hmax) * 8 - 1) /
                                    (int64_t(hmax) * 8));
            k.sh = static_cast<int>((int64_t(height) * k.v * ss +
                                     int64_t(vmax) * 8 - 1) /
                                    (int64_t(vmax) * 8));
            k.stride = k.gbw * ss;
            k.rows = k.gbh * ss;
            std::fill(k.coef_bits, k.coef_bits + 64, -1);
        }
        have_frame = true;
    }

    // ------------------------------------------------ sequential blocks
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
        k.idct_block(block, bx, by);
    }

    // ----------------------------------------------- progressive blocks
    // jdphuff.c decode_mcu_DC_first, one block
    void dc_first(BitReader& br, Component& k, int16_t* blk, int al) {
        const int s = br.decode(dc_tab[k.td]);
        int diff = 0;
        if (s) diff = extend(br.bits(s), s);
        k.last_dc = static_cast<int>(static_cast<uint32_t>(k.last_dc) +
                                     static_cast<uint32_t>(diff));
        blk[0] = coef_shift(k.last_dc, al);
    }

    // decode_mcu_DC_refine, one block: the next bit of the DC
    static void dc_refine(BitReader& br, int16_t* blk, int al) {
        if (br.bits(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
    }

    // decode_mcu_AC_first
    void ac_first(BitReader& br, const Huffman& tab, int16_t* blk, int ss,
                  int se, int al) {
        if (eobrun > 0) {
            --eobrun;
            return;
        }
        for (int k = ss; k <= se; ++k) {
            const int rs = br.decode(tab);
            int r = rs >> 4;
            const int s = rs & 15;
            if (s) {
                k += r;
                blk[kNatural[k]] = coef_shift(extend(br.bits(s), s), al);
            } else if (r == 15) {
                k += 15;                                 // ZRL
            } else {                                     // EOBr
                eobrun = 1 << r;
                if (r) eobrun += br.bits(r);
                --eobrun;
                break;
            }
        }
    }

    // the correction bit of an already nonzero coefficient
    static void refine(BitReader& br, int16_t& c, int p1) {
        if (br.bits(1) && (c & p1) == 0)
            c = static_cast<int16_t>(c >= 0 ? c + p1 : c - p1);
    }

    // decode_mcu_AC_refine
    void ac_refine(BitReader& br, const Huffman& tab, int16_t* blk, int ss,
                   int se, int al) {
        const int p1 = 1 << al;
        int k = ss;
        if (eobrun == 0) {
            for (; k <= se; ++k) {
                const int rs = br.decode(tab);
                int r = rs >> 4;
                int s = rs & 15;
                if (s) {
                    // a newly nonzero coefficient (of size 1)
                    s = br.bits(1) ? p1 : -p1;
                } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) eobrun += br.bits(r);
                    break;             // the rest is the EOB run's
                }
                // past r zero coefficients, correcting nonzero ones
                do {
                    int16_t& c = blk[kNatural[k]];
                    if (c != 0) {
                        refine(br, c, p1);
                    } else if (--r < 0) {
                        break;
                    }
                    ++k;
                } while (k <= se);
                if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
            }
        }
        if (eobrun > 0) {
            for (; k <= se; ++k) {
                int16_t& c = blk[kNatural[k]];
                if (c != 0) refine(br, c, p1);
            }
            --eobrun;
        }
    }

    void read_scan() {
        if (!have_frame) corrupt("scan before the frame header");
        auto [s, e] = segment();
        if (e - s < 1) corrupt("truncated scan header");
        const int ns = s[0];
        if (ns < 1 || ns > ncomp || e - s != 4 + 2 * ns)
            corrupt("bad scan header");
        const int ss = s[1 + 2 * ns], se = s[2 + 2 * ns];
        const int ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
        const bool dc_band = ss == 0;
        if (progressive) {
            // jdphuff.c start_pass_phuff_decoder's checks
            bool bad = dc_band ? se != 0 : (ss > se || se > 63 || ns != 1);
            if (ah != 0 && al != ah - 1) bad = true;
            if (al > 13) bad = true;
            if (bad)
                corrupt("bad progression parameters Ss=" + std::to_string(ss) +
                        " Se=" + std::to_string(se) + " Ah=" +
                        std::to_string(ah) + " Al=" + std::to_string(al));
        }
        // which tables the scan decodes with
        const bool need_dc = !progressive || (dc_band && ah == 0);
        const bool need_ac = !progressive || !dc_band;
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
            if ((need_dc && !dc_tab[k->td].defined) ||
                (need_ac && !ac_tab[k->ta].defined))
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
            if (progressive) {
                if (k->coef.empty())
                    k->coef.assign(static_cast<size_t>(k->gbw) * k->gbh * 64,
                                   0);
                for (int c = ss; c <= se; ++c) k->coef_bits[c] = al;
            } else if (k->plane.empty()) {
                k->plane.assign(static_cast<size_t>(k->stride) * k->rows, 0);
            }
            k->last_dc = 0;
            in_scan[i] = k;
        }
        // Ss, Se, Ah/Al of a sequential scan are not checked (libjpeg
        // only warns)
        int blocks = 0;
        for (int i = 0; i < ns; ++i) blocks += in_scan[i]->h * in_scan[i]->v;
        if (ns > 1 && blocks > 10) corrupt("too many blocks in an MCU");

        // one block of the scan at (bx, by) of component k
        auto unit = [&](BitReader& br, Component& k, int bx, int by) {
            if (!progressive) return decode_block(br, k, bx, by);
            int16_t* blk = k.block(bx, by);
            if (dc_band) {
                if (ah == 0) dc_first(br, k, blk, al);
                else dc_refine(br, blk, al);
            } else if (ah == 0) {
                ac_first(br, ac_tab[k.ta], blk, ss, se, al);
            } else {
                ac_refine(br, ac_tab[k.ta], blk, ss, se, al);
            }
        };

        BitReader br(p, end);
        eobrun = 0;
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
                eobrun = 0;
            }
            const int mx = static_cast<int>(m % nx), my = static_cast<int>(m / nx);
            if (ns == 1) {
                unit(br, *in_scan[0], mx, my);
            } else {
                for (int i = 0; i < ns; ++i) {
                    Component& k = *in_scan[i];
                    for (int y = 0; y < k.v; ++y)
                        for (int x = 0; x < k.h; ++x)
                            unit(br, k, mx * k.h + x, my * k.v + y);
                }
            }
            if (br.overrun()) corrupt("truncated or corrupt entropy-coded data");
        }
        for (int i = 0; i < ns; ++i) in_scan[i]->decoded = true;
        p = br.byte_align_to_marker();
    }

    // jdcoefct.c smoothing_ok: libjpeg smooths the blocks of a progressive
    // file when some of AC coefficients 1-9 are unfinished (and their
    // quantizers nonzero); this decoder refuses such a file
    void refuse_smoothed() const {
        static const int kQ[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
        bool useful = false;
        for (int c = 0; c < ncomp; ++c) {
            const Component& k = comp[c];
            for (int i : kQ)
                if (k.quant[i] == 0) return;
            if (k.coef_bits[0] < 0) return;
            for (int i = 1; i < 10; ++i)
                if (k.coef_bits[i] != 0) useful = true;
        }
        if (useful)
            fail(kUnsupported,
                 "unsupported JPEG mode: progressive with unfinished AC "
                 "coefficients (libjpeg block smoothing)");
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
        if (progressive) {
            // the coefficient buffer through the IDCTs, as jdcoefct.c's
            // decompress_data: the component's own blocks
            refuse_smoothed();
            for (int c = 0; c < ncomp; ++c) {
                Component& k = comp[c];
                k.plane.assign(static_cast<size_t>(k.stride) * k.rows, 0);
                for (int by = 0; by < k.bh; ++by)
                    for (int bx = 0; bx < k.bw; ++bx)
                        k.idct_block(k.block(bx, by), bx, by);
                std::vector<int16_t>().swap(k.coef);
            }
        }
    }

    // -------------------------------------------------------- upsampling
    // component row ``r`` (clamped as libjpeg replicates the first and
    // last rows for context)
    const uint8_t* crow(const Component& k, int r) const {
        r = std::min(std::max(r, 0), k.sh - 1);
        return k.plane.data() + static_cast<size_t>(r) * k.stride;
    }

    // output row ``y`` of component ``k`` (``out_w`` samples): the plane's
    // row at full size, else upsampled into ``out`` (jdsample.c; no fancy
    // upsampling when the smallest IDCT size is 1)
    const uint8_t* upsample_row(const Component& k, int y, uint8_t* out) const {
        const int fh = hmax * scale_num / (k.h * k.ssize);
        const int fv = vmax * scale_num / (k.v * k.ssize);
        const int dw = k.sw;
        const bool fancy = scale_num > 1;
        if (fh == 1 && fv == 1) return crow(k, y);
        if (fancy && fh == 2 && fv == 1 && dw > 2) {      // h2v1 fancy
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
        if (fancy && fh == 1 && fv == 2) {                // h1v2 fancy
            const int i = y >> 1;
            const bool below = y & 1;
            const uint8_t* near = crow(k, i);
            const uint8_t* far = crow(k, below ? i + 1 : i - 1);
            const int bias = below ? 2 : 1;
            for (int c = 0; c < dw; ++c)
                out[c] = static_cast<uint8_t>((near[c] * 3 + far[c] + bias) >> 2);
            return out;
        }
        if (fancy && fh == 2 && fv == 2 && dw > 2) {      // h2v2 fancy
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
        for (int x = 0; x < out_w; ++x) out[x] = in[x / fh];
        return out;
    }

    void to_rgb(uint8_t* rgb) const {
        const size_t W = static_cast<size_t>(out_w);
        if (ncomp == 1) {
            for (int y = 0; y < out_h; ++y) {
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
        for (int y = 0; y < out_h; ++y) {
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

void check_scale(int scale_num) {
    if (scale_num < 1 || scale_num > 8)
        fail(kBadArgs, "scale_num " + std::to_string(scale_num) +
                           " is not in 1..8");
}

}  // namespace

namespace epk {

// Decode ``buf`` at scale_num/8 into ``out`` (resized to h * w * 3 RGB):
// a status as the C interface's; ``w``, ``h`` the output size and
// ``full_w``, ``full_h`` the image's.
inline int decode_rgb(const uint8_t* buf, size_t n, int scale_num,
                      std::vector<uint8_t>& out, int& w, int& h, int& full_w,
                      int& full_h, char* err = nullptr, int errlen = 0) {
    return guarded(err, errlen, [&] {
        check_scale(scale_num);
        if (!buf) fail(kBadArgs, "null argument");
        Decoder d(buf, n, scale_num);
        d.run(true);
        full_w = d.width;
        full_h = d.height;
        w = d.out_w;
        h = d.out_h;
        d.run(false);
        out.resize(static_cast<size_t>(w) * h * 3);
        d.to_rgb(out.data());
    });
}

}  // namespace epk

extern "C" {

int epk_jpeg_info(const uint8_t* buf, size_t n, int scale_num, int* w,
                  int* h, int* comps, char* err, int errlen) {
    return guarded(err, errlen, [&] {
        if (!buf || !w || !h || !comps) fail(kBadArgs, "null argument");
        check_scale(scale_num);
        Decoder d(buf, n, scale_num);
        d.run(true);
        *w = d.out_w;
        *h = d.out_h;
        *comps = d.ncomp;
    });
}

int epk_jpeg_decode_rgb(const uint8_t* buf, size_t n, int scale_num,
                        uint8_t* out, int w, int h, char* err, int errlen) {
    return guarded(err, errlen, [&] {
        if (!buf || !out) fail(kBadArgs, "null argument");
        check_scale(scale_num);
        Decoder d(buf, n, scale_num);
        d.run(true);
        if (d.out_w != w || d.out_h != h)
            fail(kBadArgs, "output is " + std::to_string(w) + "x" +
                               std::to_string(h) + ", image is " +
                               std::to_string(d.out_w) + "x" +
                               std::to_string(d.out_h) + " at " +
                               std::to_string(scale_num) + "/8");
        d.run(false);
        d.to_rgb(out);
    });
}

}  // extern "C"
