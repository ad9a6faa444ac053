// jpegdec: a JPEG decoder in standard C++17, no libjpeg.
//
// Its RGB output equals libjpeg-turbo's default decode bit for bit (what
// OpenCV's imdecode and the JAX package's native loader give), at full
// size and at libjpeg's DCT-scaled sizes num/8: the same Huffman and
// arithmetic (QM, T.81 Annex D; jdarith.c) decoding, sequential and
// progressive; the IDCTs of libjpeg-turbo's x86-64 build (jsimd's 8x8
// islow and reduced 4x4 and 2x2 on 16-bit lanes, the 8x8 through
// jidctint.c's C code where a block's coefficients are small enough for
// the two to agree; jidctint.c's 3x3, 6x6 and 12x12 and jidctred.c's 1x1
// with their range-limit table);
// jdmaster.c's choice of IDCT size per component (chroma scaled up by
// IDCT where that makes upsampling 1:1); jdcoefct.c's block smoothing of
// progressive files whose coefficients 1-9 are not all final, as
// libjpeg-turbo 2.1 or 3.1 (OpenCV's) does it, for they differ; the "fancy" triangle
// upsampling of jdsample.c (h2v1, h2v2, h1v2; plain replication for other
// factors, for components two samples wide or less, and at scale 1/8);
// the fixed-point YCbCr -> RGB of jdcolor.c, and libjpeg's colour-space
// guess (JFIF, Adobe APP14, the component ids). Grayscale is replicated
// into three channels; CMYK and YCCK (jdcolor.c's YCCK -> CMYK) become RGB
// as OpenCV converts them.
//
// Supported: SOF0, SOF1, SOF2, SOF9 and SOF10 at 8-bit precision with 1,
// 3 or 4 components, interleaved and non-interleaved scans, any integral
// sampling factors, DQT with 8- or 16-bit entries, DHT and DAC, DRI with
// RST0-7, and the output scales 1-4 and 8 of 8 (the IDCT sizes 1, 2, 3,
// 4, 6, 8 and 12; the others are bad arguments). In OpenCV's flavours
// also lossless (SOF3, Huffman-coded; jddiffct.c, jdlhuff.c and
// jdlossls.c of libjpeg-turbo 3.1) at 2-8 bits: predictors 1-7, the point
// transform, restart intervals of whole MCU rows, any integral sampling
// (upsampled by replication, as libjpeg-turbo upsamples lossless
// images), RGB and CMYK (libjpeg-turbo converts no other lossless colour
// space to OpenCV's BGR), at 8/8 only. Refused with a status that names
// the mode (as libjpeg-turbo 2.1 refuses them, and OpenCV's imread gives
// no image of them): hierarchical, lossless in the libjpeg flavour,
// lossless arithmetic coding, lossless of other precisions or colour
// spaces, and lossy samples of other than 8 bits (12-bit JPEG: OpenCV
// reads through libjpeg-turbo's 8-bit interface, which refuses it). Data
// that runs short decodes as libjpeg decodes it from memory
// (jpeg_mem_src): a scan that meets a marker early gets zeros for the
// rest of its interval, a lost restart marker is resynchronized
// (jpeg_resync_to_restart), data that ends before EOI reads as followed
// by EOI markers; such a decode returns a warning status. Corrupt data that libjpeg refuses is an error: every
// read is bounds-checked, and images over 2^28 pixels (or whose padded
// sample planes exceed 4 * 2^28 samples) are refused before any
// allocation. EXIF orientation is not applied (libjpeg does not apply it
// either).
//
// C interface (status 0 ok, 1 corrupt or cannot be decoded, 2 unsupported
// mode, 3 bad arguments, 4 decoded where libjpeg warns, 5 decoded where
// the data ended before EOI; ``err`` receives the message or the first
// warning; ``scale_num`` selects the output scale scale_num/8, 8 the
// full size; ``flavour`` 0 decodes as libjpeg-turbo 2.1 does for the
// JAX package's native loader, 1 as OpenCV's imread does, 2 and 3 as
// OpenCV's libtiff has libjpeg decode a TIFF's JPEG strips: YCbCr
// converted to RGB, and the samples as coded):
//   int epk_jpeg_info(buf, n, scale_num, &w, &h, &comps, flavour, err,
//                     errlen)
//   int epk_jpeg_decode_rgb(buf, n, scale_num, out, w, h, flavour, err,
//                           errlen)
// where w, h are the output size, ceil(W * scale_num / 8) and likewise
// for H. Thread-safe: no mutable global state, so callers may decode in
// parallel. C++ callers that include this file may use epk::decode_rgb.

#include <algorithm>
#include <cstdlib>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

// kWarned and kEnded: decoded, where libjpeg warns; kEnded when the data
// ended before its EOI marker (libjpeg's "Premature end of JPEG file")
enum Status {
    kOk = 0, kCorrupt = 1, kUnsupported = 2, kBadArgs = 3, kWarned = 4,
    kEnded = 5
};

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

// An IDCT of one block (coefficients and quantizer in natural order) into
// ``size`` rows of ``size`` samples at ``out``, rows ``stride`` apart.
using Idct = void (*)(const int16_t* coef, const int16_t* quant,
                      uint8_t* out, int stride);

// libjpeg-turbo's x86-64 SIMD IDCTs (jidctint-sse2/avx2.asm for 8x8,
// jidctred-sse2.asm for 4x4 and 2x2), which the JAX package's readers run:
// jidctint.c's and jidctred.c's arithmetic on 16-bit lanes. The
// dequantized coefficients keep their low 16 bits (pmullw), so do the
// sums formed before a multiply (paddw), the first pass's outputs
// saturate to 16 bits (packssdw) and the samples to 0..255 (packsswb),
// where the C kernels (kept for 1, 3, 6 and 12) wrap through the range
// limit table. On coefficients that stay in range the two agree.
inline int64_t wrap16(int64_t v) {
    return static_cast<int16_t>(static_cast<uint16_t>(v & 0xFFFF));
}
inline int sat16(int64_t v) {
    return static_cast<int>(std::min<int64_t>(std::max<int64_t>(v, -32768),
                                              32767));
}
inline uint8_t sat_sample(int64_t v) {
    return static_cast<uint8_t>(std::min<int64_t>(std::max<int64_t>(v, -128),
                                                  127) + 128);
}

// one coefficient dequantized to 16 bits (pmullw)
inline int dq16(const int16_t* coef, const int16_t* quant, int i) {
    return static_cast<int16_t>(static_cast<uint16_t>(
        static_cast<uint32_t>(coef[i]) * static_cast<uint32_t>(quant[i])));
}

// the dequantized block, 16-bit; true when rows ``rows`` (a bit mask of
// 1..7) hold only zero coefficients (the SIMD kernels' whole-block test)
inline bool dequant16(const int16_t* coef, const int16_t* quant, int* d,
                      int rows) {
    for (int i = 0; i < 64; ++i) d[i] = dq16(coef, quant, i);
    int any = 0;
    for (int r = 1; r < 8; ++r)
        if (rows >> r & 1)
            for (int c = 0; c < 8; ++c) any |= coef[8 * r + c];
    return any == 0;
}

// one 8-point pass of jidctint.c islow: ``in`` strided by ``step``,
// results before descaling into ``o``. In int64 no product overflows, so
// jidctint.c's grouping gives the SIMD kernel's pmaddwd sums; the sums
// that kernel forms in 16 bits before a multiply (paddw) wrap.
inline void islow_1d(const int* in, int step, int64_t o[8]) {
    int64_t z2 = in[2 * step], z3 = in[6 * step];
    int64_t z1 = (z2 + z3) * F0_541196100;
    int64_t tmp2 = z1 + z3 * (-F1_847759065);
    int64_t tmp3 = z1 + z2 * F0_765366865;
    int64_t tmp0 = lshift(wrap16(int64_t(in[0]) + in[4 * step]), kConstBits);
    int64_t tmp1 = lshift(wrap16(int64_t(in[0]) - in[4 * step]), kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = in[7 * step];
    tmp1 = in[5 * step];
    tmp2 = in[3 * step];
    tmp3 = in[step];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = wrap16(tmp0 + tmp2);
    int64_t z4 = wrap16(tmp1 + tmp3);
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
    o[0] = tmp10 + tmp3;
    o[7] = tmp10 - tmp3;
    o[1] = tmp11 + tmp2;
    o[6] = tmp11 - tmp2;
    o[2] = tmp12 + tmp1;
    o[5] = tmp12 - tmp1;
    o[3] = tmp13 + tmp0;
    o[4] = tmp13 - tmp0;
}

// the DC-only column of pass 1: DEQUANTIZE(dc) << PASS1_BITS, in int
inline int dc_pass1(const int16_t* in, const int16_t* q) {
    return static_cast<int>(
        static_cast<uint32_t>(int(in[0]) * int(q[0])) << kPass1Bits);
}

// jidctint.c jpeg_idct_islow as its C code computes it: int lanes, the
// range-limit table. Where the dequantized coefficients' magnitudes sum to
// at most kIntIdctLimit it gives idct_8x8's bits, faster: no 16-bit lane
// of the SIMD kernel wraps or saturates (a pass-1 output is at most
// 4 * 1.39 * 2048 + 1 < 2^14, so a sum of two fits 16 bits) and every
// sample before the range limit lies in -512..511, where the table clamps
// as the SIMD kernel saturates. So do the reduced 4x4 and 2x2 C kernels
// (idct_4x4_int, idct_2x2_int). The sequential Huffman decoder sums the
// magnitudes as it decodes a block and picks the kernel by that sum.
constexpr int64_t kIntIdctLimit = 2048;

void idct_8x8_int(const int16_t* coef, const int16_t* quant, uint8_t* out,
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

// jidctint.c jpeg_idct_islow as jsimd_idct_islow computes it. A column
// (pass 1) or row (pass 2) whose AC terms are all zero takes the value the
// full pass gives it, without the pass: sat16(dc << PASS1_BITS) and
// sat_sample((dc + 16) >> 5); a column is dequantized only when it needs
// the pass.
void idct_8x8(const int16_t* coef, const int16_t* quant, uint8_t* out,
              int stride) {
    int ws[64], d[8];
    int64_t o[8];
    int ac = 0;                         // the SIMD kernel's whole-block test
    for (int i = 8; i < 64; ++i) ac |= coef[i];
    for (int c = 0; c < 8; ++c) {
        const int16_t* in = coef + c;
        if (ac == 0 || (in[8] | in[16] | in[24] | in[32] | in[40] | in[48] |
                        in[56]) == 0) {
            const int64_t dc = lshift(dq16(coef, quant, c), kPass1Bits);
            const int v = ac == 0 ? static_cast<int>(wrap16(dc)) : sat16(dc);
            for (int r = 0; r < 8; ++r) ws[8 * r + c] = v;
            continue;
        }
        for (int k = 0; k < 8; ++k) d[k] = dq16(coef, quant, 8 * k + c);
        islow_1d(d, 1, o);
        for (int r = 0; r < 8; ++r)
            ws[8 * r + c] = sat16(descale(o[r], kConstBits - kPass1Bits));
    }
    for (int r = 0; r < 8; ++r) {
        const int* w = ws + 8 * r;
        uint8_t* row = out + static_cast<size_t>(r) * stride;
        if ((w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7]) == 0) {
            std::memset(row, sat_sample((int64_t(w[0]) + 16) >> 5), 8);
            continue;
        }
        islow_1d(w, 1, o);
        for (int x = 0; x < 8; ++x)
            row[x] = sat_sample(descale(o[x], kConstBits + kPass1Bits + 3));
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

// 32-bit lanes: a sum wraps, a descale shifts the wrapped sum
inline int64_t wrap32(int64_t v) {
    return static_cast<int32_t>(static_cast<uint32_t>(v & 0xFFFFFFFF));
}
inline int64_t desc32(int64_t x, int n) {
    return wrap32(wrap32(x) + (int64_t(1) << (n - 1))) >> n;
}
// pmaddwd of two pairs, then paddd
inline int64_t madd2(int64_t a, int64_t ca, int64_t b, int64_t cb,
                     int64_t c, int64_t cc, int64_t d, int64_t cd) {
    return wrap32(wrap32(a * ca + b * cb) + wrap32(c * cc + d * cd));
}

// jidctred.c jpeg_idct_4x4 (column 4 and row term 4 dropped), as
// jsimd_idct_4x4 computes it: one pass of ``in`` strided by ``step``,
// its outputs descaled by ``shift``
inline void red4_1d(const int* in, int step, int shift, int64_t o[4]) {
    const int64_t tmp0 = int64_t(in[0]) * (int64_t(1) << (kConstBits + 1));
    const int64_t tmp2 = wrap32(int64_t(in[2 * step]) * F1_847759065 +
                                int64_t(in[6 * step]) * -F0_765366865);
    const int64_t tmp10 = wrap32(tmp0 + tmp2), tmp12 = wrap32(tmp0 - tmp2);
    const int64_t z1 = in[7 * step], z2 = in[5 * step], z3 = in[3 * step],
                  z4 = in[step];
    const int64_t o0 = madd2(z4, F1_061594337, z3, -F2_172734803, z2,
                             F1_451774981, z1, -F0_211164243);
    const int64_t o2 = madd2(z4, F2_562915447, z3, F0_899976223, z2,
                             -F0_601344887, z1, -F0_509795579);
    o[0] = desc32(tmp10 + o2, shift);
    o[3] = desc32(tmp10 - o2, shift);
    o[1] = desc32(tmp12 + o0, shift);
    o[2] = desc32(tmp12 - o0, shift);
}

void idct_4x4(const int16_t* coef, const int16_t* quant, uint8_t* out,
              int stride) {
    int d[64], ws[8 * 4];
    int64_t o[4];
    if (dequant16(coef, quant, d, 0xEE)) {
        for (int c = 0; c < 8; ++c)
            for (int r = 0; r < 4; ++r)
                ws[8 * r + c] = static_cast<int>(wrap16(lshift(d[c], kPass1Bits)));
    } else {
        for (int c = 0; c < 8; ++c) {
            red4_1d(d + c, 8, kConstBits - kPass1Bits + 1, o);
            for (int r = 0; r < 4; ++r) ws[8 * r + c] = sat16(o[r]);
        }
    }
    for (int r = 0; r < 4; ++r) {
        red4_1d(ws + 8 * r, 1, kConstBits + kPass1Bits + 3 + 1, o);
        uint8_t* row = out + static_cast<size_t>(r) * stride;
        for (int x = 0; x < 4; ++x) row[x] = sat_sample(o[x]);
    }
}

// jidctred.c jpeg_idct_4x4 as its C code computes it (column 4 and row
// term 4 dropped): idct_4x4's bits where idct_8x8_int gives idct_8x8's
void idct_4x4_int(const int16_t* coef, const int16_t* quant, uint8_t* out,
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

// jidctred.c jpeg_idct_2x2 as its C code computes it (columns 2, 4, 6
// and even row terms but the DC dropped): idct_2x2's bits where
// idct_8x8_int gives idct_8x8's
void idct_2x2_int(const int16_t* coef, const int16_t* quant, uint8_t* out,
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

// jidctred.c jpeg_idct_2x2 (columns 2, 4, 6 and the even row terms but
// the DC dropped), as jsimd_idct_2x2 computes it: the first pass's
// column 0 reaches the second unsaturated, in 32 bits, the odd columns
// saturated to 16
inline int64_t red2_odd(int64_t w1, int64_t w3, int64_t w5, int64_t w7) {
    return madd2(w1, F3_624509785, w3, -F1_272758580, w5, F0_850430095, w7,
                 -F0_720959822);
}

void idct_2x2(const int16_t* coef, const int16_t* quant, uint8_t* out,
              int stride) {
    int d[64];
    dequant16(coef, quant, d, 0);
    int64_t ws[2][8] = {};
    for (int c : {0, 1, 3, 5, 7}) {
        const int64_t tmp10 = int64_t(d[c]) * (int64_t(1) << (kConstBits + 2));
        const int64_t tmp0 = red2_odd(d[8 + c], d[24 + c], d[40 + c], d[56 + c]);
        constexpr int s = kConstBits - kPass1Bits + 2;
        ws[0][c] = desc32(tmp10 + tmp0, s);
        ws[1][c] = desc32(tmp10 - tmp0, s);
    }
    for (int r = 0; r < 2; ++r) {
        const int64_t* w = ws[r];
        const int64_t tmp10 = wrap32(w[0] * (int64_t(1) << (kConstBits + 2)));
        const int64_t tmp0 = red2_odd(sat16(w[1]), sat16(w[3]), sat16(w[5]),
                                      sat16(w[7]));
        constexpr int s = kConstBits + kPass1Bits + 3 + 2;
        uint8_t* row = out + static_cast<size_t>(r) * stride;
        row[0] = sat_sample(desc32(tmp10 + tmp0, s));
        row[1] = sat_sample(desc32(tmp10 - tmp0, s));
    }
}

// jidctred.c jpeg_idct_1x1: the block's mean, one eighth of the DC
void idct_1x1(const int16_t* coef, const int16_t* quant, uint8_t* out,
              int /*stride*/) {
    const int dc = int(coef[0]) * int(quant[0]);
    out[0] = limit_at(idct_limit().t, descale(dc, 3));
}

// jidctint.c's FIX(x) for the 12-point kernel
constexpr int64_t fix(double x) {
    return static_cast<int64_t>(x * (1 << kConstBits) + 0.5);
}

// jidctint.c jpeg_idct_12x12 (a 4x4-subsampled plane at 3/8): cK is
// sqrt(2) cos(K pi / 24). ``z3`` arrives with its fudge factor; the
// result goes to ``o0``..``o11`` of ``out`` descaled by ``s``.
template <typename Store>
inline void idct12_1d(int64_t z3, int64_t z4, int64_t z1, int64_t z2,
                      int64_t o1, int64_t o3, int64_t o5, int64_t o7,
                      Store&& store) {
    // even part: z3 is in[0] << CONST_BITS, z4 in[4], z1 in[2], z2 in[6]
    z4 *= fix(1.224744871);                                  // c4
    int64_t tmp10 = z3 + z4, tmp11 = z3 - z4;
    const int64_t z4b = z1 * fix(1.366025404);               // c2
    z1 = lshift(z1, kConstBits);
    z2 = lshift(z2, kConstBits);
    int64_t tmp12 = z1 - z2;
    const int64_t tmp21 = z3 + tmp12, tmp24 = z3 - tmp12;
    tmp12 = z4b + z2;
    const int64_t tmp20 = tmp10 + tmp12, tmp25 = tmp10 - tmp12;
    tmp12 = z4b - z1 - z2;
    const int64_t tmp22 = tmp11 + tmp12, tmp23 = tmp11 - tmp12;

    // odd part
    int64_t a1 = o1, a2 = o3, a3 = o5, a4 = o7;
    tmp11 = a2 * fix(1.306562965);                           // c3
    int64_t tmp14 = a2 * -F0_541196100;                      // -c9
    tmp10 = a1 + a3;
    int64_t tmp15 = (tmp10 + a4) * fix(0.860918669);         // c7
    tmp12 = tmp15 + tmp10 * fix(0.261052384);                // c5-c7
    tmp10 = tmp12 + tmp11 + a1 * fix(0.280143716);           // c1-c5
    int64_t tmp13 = (a3 + a4) * -fix(1.045510580);           // -(c7+c11)
    tmp12 += tmp13 + tmp14 - a3 * fix(1.478575242);          // c1+c5-c7-c11
    tmp13 += tmp15 - tmp11 + a4 * fix(1.586706681);          // c1+c11
    tmp15 += tmp14 - a1 * fix(0.676326758) -                 // c7-c11
             a4 * fix(1.982889723);                          // c5+c7
    a1 -= a4;
    a2 -= a3;
    a3 = (a1 + a2) * F0_541196100;                           // c9
    tmp11 = a3 + a1 * F0_765366865;                          // c3-c9
    tmp14 = a3 - a2 * F1_847759065;                          // c3+c9

    store(0, tmp20 + tmp10);
    store(11, tmp20 - tmp10);
    store(1, tmp21 + tmp11);
    store(10, tmp21 - tmp11);
    store(2, tmp22 + tmp12);
    store(9, tmp22 - tmp12);
    store(3, tmp23 + tmp13);
    store(8, tmp23 - tmp13);
    store(4, tmp24 + tmp14);
    store(7, tmp24 - tmp14);
    store(5, tmp25 + tmp15);
    store(6, tmp25 - tmp15);
}

void idct_12x12(const int16_t* coef, const int16_t* quant, uint8_t* out,
                int stride) {
    const uint8_t* limit = idct_limit().t;
    int ws[8 * 12];
    for (int c = 0; c < 8; ++c) {
        const int16_t* in = coef + c;
        const int16_t* q = quant + c;
        int64_t z3 = lshift(dq(in, q, 0), kConstBits);
        z3 += int64_t(1) << (kConstBits - kPass1Bits - 1);
        idct12_1d(z3, dq(in, q, 32), dq(in, q, 16), dq(in, q, 48),
                  dq(in, q, 8), dq(in, q, 24), dq(in, q, 40), dq(in, q, 56),
                  [&](int r, int64_t v) {
                      ws[8 * r + c] =
                          static_cast<int>(v >> (kConstBits - kPass1Bits));
                  });
    }
    for (int r = 0; r < 12; ++r) {
        const int* w = ws + 8 * r;
        uint8_t* o = out + static_cast<size_t>(r) * stride;
        int64_t z3 = int64_t(w[0]) + (int64_t(1) << (kPass1Bits + 2));
        z3 = lshift(z3, kConstBits);
        idct12_1d(z3, w[4], w[2], w[6], w[1], w[3], w[5], w[7],
                  [&](int x, int64_t v) {
                      o[x] = limit_at(limit,
                                      v >> (kConstBits + kPass1Bits + 3));
                  });
    }
}

// the IDCT of an output size, null where the decoder has none (5, 7,
// 10, 14: the scales 5/8-7/8, which neither loader asks for)
Idct idct_of_size(int size) {
    switch (size) {
        case 1: return idct_1x1;
        case 2: return idct_2x2;
        case 3: return idct_3x3;
        case 4: return idct_4x4;
        case 6: return idct_6x6;
        case 8: return idct_8x8;
        case 12: return idct_12x12;
        default: return nullptr;
    }
}

// ------------------------------------------------------------ arithmetic
// jaricom.c jpeg_aritab, T.81 Table D.2: Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed probability
// 0.5 of the sign and refinement bits.
#define EPK_V(qe, lps, mps, sw) \
    ((int64_t(qe) << 16) | (int64_t(mps) << 8) | ((sw) << 7) | (lps))
constexpr int64_t kAritab[114] = {
    EPK_V(0x5a1d, 1, 1, 1),     EPK_V(0x2586, 14, 2, 0),
    EPK_V(0x1114, 16, 3, 0),    EPK_V(0x080b, 18, 4, 0),
    EPK_V(0x03d8, 20, 5, 0),    EPK_V(0x01da, 23, 6, 0),
    EPK_V(0x00e5, 25, 7, 0),    EPK_V(0x006f, 28, 8, 0),
    EPK_V(0x0036, 30, 9, 0),    EPK_V(0x001a, 33, 10, 0),
    EPK_V(0x000d, 35, 11, 0),   EPK_V(0x0006, 9, 12, 0),
    EPK_V(0x0003, 10, 13, 0),   EPK_V(0x0001, 12, 13, 0),
    EPK_V(0x5a7f, 15, 15, 1),   EPK_V(0x3f25, 36, 16, 0),
    EPK_V(0x2cf2, 38, 17, 0),   EPK_V(0x207c, 39, 18, 0),
    EPK_V(0x17b9, 40, 19, 0),   EPK_V(0x1182, 42, 20, 0),
    EPK_V(0x0cef, 43, 21, 0),   EPK_V(0x09a1, 45, 22, 0),
    EPK_V(0x072f, 46, 23, 0),   EPK_V(0x055c, 48, 24, 0),
    EPK_V(0x0406, 49, 25, 0),   EPK_V(0x0303, 51, 26, 0),
    EPK_V(0x0240, 52, 27, 0),   EPK_V(0x01b1, 54, 28, 0),
    EPK_V(0x0144, 56, 29, 0),   EPK_V(0x00f5, 57, 30, 0),
    EPK_V(0x00b7, 59, 31, 0),   EPK_V(0x008a, 60, 32, 0),
    EPK_V(0x0068, 62, 33, 0),   EPK_V(0x004e, 63, 34, 0),
    EPK_V(0x003b, 32, 35, 0),   EPK_V(0x002c, 33, 9, 0),
    EPK_V(0x5ae1, 37, 37, 1),   EPK_V(0x484c, 64, 38, 0),
    EPK_V(0x3a0d, 65, 39, 0),   EPK_V(0x2ef1, 67, 40, 0),
    EPK_V(0x261f, 68, 41, 0),   EPK_V(0x1f33, 69, 42, 0),
    EPK_V(0x19a8, 70, 43, 0),   EPK_V(0x1518, 72, 44, 0),
    EPK_V(0x1177, 73, 45, 0),   EPK_V(0x0e74, 74, 46, 0),
    EPK_V(0x0bfb, 75, 47, 0),   EPK_V(0x09f8, 77, 48, 0),
    EPK_V(0x0861, 78, 49, 0),   EPK_V(0x0706, 79, 50, 0),
    EPK_V(0x05cd, 48, 51, 0),   EPK_V(0x04de, 50, 52, 0),
    EPK_V(0x040f, 50, 53, 0),   EPK_V(0x0363, 51, 54, 0),
    EPK_V(0x02d4, 52, 55, 0),   EPK_V(0x025c, 53, 56, 0),
    EPK_V(0x01f8, 54, 57, 0),   EPK_V(0x01a4, 55, 58, 0),
    EPK_V(0x0160, 56, 59, 0),   EPK_V(0x0125, 57, 60, 0),
    EPK_V(0x00f6, 58, 61, 0),   EPK_V(0x00cb, 59, 62, 0),
    EPK_V(0x00ab, 61, 63, 0),   EPK_V(0x008f, 61, 32, 0),
    EPK_V(0x5b12, 65, 65, 1),   EPK_V(0x4d04, 80, 66, 0),
    EPK_V(0x412c, 81, 67, 0),   EPK_V(0x37d8, 82, 68, 0),
    EPK_V(0x2fe8, 83, 69, 0),   EPK_V(0x293c, 84, 70, 0),
    EPK_V(0x2379, 86, 71, 0),   EPK_V(0x1edf, 87, 72, 0),
    EPK_V(0x1aa9, 87, 73, 0),   EPK_V(0x174e, 72, 74, 0),
    EPK_V(0x1424, 72, 75, 0),   EPK_V(0x119c, 74, 76, 0),
    EPK_V(0x0f6b, 74, 77, 0),   EPK_V(0x0d51, 75, 78, 0),
    EPK_V(0x0bb6, 77, 79, 0),   EPK_V(0x0a40, 77, 48, 0),
    EPK_V(0x5832, 80, 81, 1),   EPK_V(0x4d1c, 88, 82, 0),
    EPK_V(0x438e, 89, 83, 0),   EPK_V(0x3bdd, 90, 84, 0),
    EPK_V(0x34ee, 91, 85, 0),   EPK_V(0x2eae, 92, 86, 0),
    EPK_V(0x299a, 93, 87, 0),   EPK_V(0x2516, 86, 71, 0),
    EPK_V(0x5570, 88, 89, 1),   EPK_V(0x4ca9, 95, 90, 0),
    EPK_V(0x44d9, 96, 91, 0),   EPK_V(0x3e22, 97, 92, 0),
    EPK_V(0x3824, 99, 93, 0),   EPK_V(0x32b4, 99, 94, 0),
    EPK_V(0x2e17, 93, 86, 0),   EPK_V(0x56a8, 95, 96, 1),
    EPK_V(0x4f46, 101, 97, 0),  EPK_V(0x47e5, 102, 98, 0),
    EPK_V(0x41cf, 103, 99, 0),  EPK_V(0x3c3d, 104, 100, 0),
    EPK_V(0x375e, 99, 93, 0),   EPK_V(0x5231, 105, 102, 0),
    EPK_V(0x4c0f, 106, 103, 0), EPK_V(0x4639, 107, 104, 0),
    EPK_V(0x415e, 103, 99, 0),  EPK_V(0x5627, 105, 106, 1),
    EPK_V(0x50e7, 108, 107, 0), EPK_V(0x4b85, 109, 103, 0),
    EPK_V(0x5597, 110, 109, 0), EPK_V(0x504f, 111, 107, 0),
    EPK_V(0x5a10, 110, 111, 1), EPK_V(0x5522, 112, 109, 0),
    EPK_V(0x59eb, 112, 111, 1), EPK_V(0x5a1d, 113, 113, 0)};
#undef EPK_V

// The QM decoder of jdarith.c (T.81 Annex D) over entropy-coded data:
// 0xFF00 stuffing removed; at a marker (or the end of the data) it feeds
// zero bytes, as libjpeg does, where hitting a marker is legal.
class ArithReader {
  public:
    ArithReader(const uint8_t* p, const uint8_t* end) : p_(p), end_(end) {}

    // the start of a scan or of a restart interval
    void reset() {
        c_ = 0;
        a_ = 0;
        ct_ = -16;            // read two bytes into C first
    }
    // jdarith.c's error state (a spectral or magnitude overflow): the
    // rest of the interval decodes nothing
    bool failed() const { return ct_ == -1; }
    void fail() { ct_ = -1; }

    int decode(uint8_t* st) {
        while (a_ < 0x8000) {
            if (--ct_ < 0) {
                c_ = (c_ << 8) | next_byte();
                if ((ct_ += 8) < 0 && ++ct_ == 0) a_ = 0x8000;
            }
            a_ <<= 1;
        }
        int sv = *st;
        int64_t qe = kAritab[sv & 0x7F];
        const int nl = static_cast<int>(qe & 0xFF);
        qe >>= 8;
        const int nm = static_cast<int>(qe & 0xFF);
        qe >>= 8;
        int64_t temp = a_ - qe;
        a_ = temp;
        temp = lshift(temp, ct_);
        if (c_ >= temp) {
            c_ -= temp;
            if (a_ < qe) {                  // conditional LPS exchange
                a_ = qe;
                *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
            } else {
                a_ = qe;
                *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
                sv ^= 0x80;
            }
        } else if (a_ < 0x8000) {           // conditional MPS exchange
            if (a_ < qe) {
                *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
                sv ^= 0x80;
            } else {
                *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
            }
        }
        return sv >> 7;
    }
    bool at_marker() const { return at_marker_; }
    // the next unread byte (a marker's first 0xFF when at_marker())
    const uint8_t* pos() const { return p_; }
    void restart_at(const uint8_t* q) {
        p_ = q;
        at_marker_ = false;
    }
    void stay_at_marker(const uint8_t* q) {
        p_ = q;
        at_marker_ = true;
    }

  private:
    int next_byte() {
        if (at_marker_) return 0;
        if (p_ >= end_) {
            at_marker_ = true;
            return 0;
        }
        if (*p_ != 0xFF) return *p_++;
        const uint8_t* q = p_ + 1;
        while (q < end_ && *q == 0xFF) ++q;
        if (q < end_ && *q == 0x00) {
            p_ = q + 1;
            return 0xFF;
        }
        at_marker_ = true;                  // p_ stays on the marker
        return 0;
    }

    const uint8_t* p_;
    const uint8_t* end_;
    int64_t c_ = 0, a_ = 0;
    int ct_ = -16;
    bool at_marker_ = false;
};

// ---------------------------------------------------------------- Huffman
struct Huffman {
    bool defined = false;
    int nsym = 0;
    int max_sym = 0;                // checked by the scans that use it
    uint8_t vals[256] = {};
    int32_t maxcode[18] = {};
    int32_t valoffset[18] = {};
    // codes of up to kLook bits decode from one table lookup
    static constexpr int kLook = 9;
    uint8_t look_len[1 << kLook] = {};
    uint8_t look_sym[1 << kLook] = {};

    // jdhuff.c jpeg_make_d_derived_tbl
    void build(const uint8_t counts[17], const uint8_t* symbols) {
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
        std::memset(vals, 0, sizeof(vals));
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
        max_sym = 0;
        for (int i = 0; i < nsym; ++i)
            max_sym = std::max<int>(max_sym, vals[i]);
        defined = true;
    }
};

// T.81 Annex K.3's tables, which jdhuff.c's std_huff_tables gives tables 0
// (luminance) and 1 (chrominance) of a file that defines none (Motion-JPEG
// frames): counts of the code lengths 1-16, then the symbols
constexpr uint8_t kStdDcBits[2][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
constexpr uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kStdAcBits[2][16] = {
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
constexpr uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
     0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
     0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
     0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
     0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
     0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
     0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

// Entropy-coded data: 0xFF00 stuffing removed, stopping at a marker or at
// the end of the buffer. Past either it feeds zero bits and counts them
// (jdhuff.c's fill of a segment that ends early); a decode that consumed
// one of those bits ran off its data.
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
    // jdhuff.c jpeg_huff_decode: a code longer than 16 bits takes 17
    // bits, decodes as symbol 0 and is counted (libjpeg warns)
    int decode(const Huffman& h) {
        const uint32_t look = peek(16) >> (16 - Huffman::kLook);
        int l = h.look_len[look];
        if (l) {
            skip(l);
            return h.look_sym[look];
        }
        l = Huffman::kLook + 1;
        const uint32_t top = peek(16);
        int32_t code = static_cast<int32_t>(top >> (16 - l));
        while (code > h.maxcode[l]) {
            if (++l > 16) {
                skip(16);
                bits(1);
                bad_codes_++;
                return 0;
            }
            code = static_cast<int32_t>(top >> (16 - l));
        }
        const int idx = code + h.valoffset[l];
        if (idx < 0 || idx > 255) {                 // a corrupt table
            skip(l);
            bad_codes_++;
            return 0;
        }
        skip(l);
        return h.vals[idx];
    }
    // zero bits consumed past the data?
    bool overrun() const { return nbits_ < fill_; }
    int bad_codes() const { return bad_codes_; }
    // whole bytes of data read into the buffer and not consumed
    int buffered_bytes() const { return std::max(0, nbits_ - fill_) / 8; }
    bool at_marker() const { return at_marker_; }
    // the next unread byte (a marker's first 0xFF when at_marker())
    const uint8_t* pos() const { return p_; }
    void restart_at(const uint8_t* q) { reset(q, false); }
    void stay_at_marker(const uint8_t* q) { reset(q, true); }

  private:
    void reset(const uint8_t* q, bool at_marker) {
        p_ = q;
        acc_ = 0;
        nbits_ = 0;
        fill_ = 0;
        at_marker_ = at_marker;
    }
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
    int bad_codes_ = 0;
    bool at_marker_ = false;
};

inline int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// jdhuff.c's bit reader as jdlhuff.c (lossless) uses it, read for read:
// a fill tops the buffer up to 57 bits, and only when a decode needs more
// bits than it holds (8 for a table lookup, the code's or the extra
// bits' length after that). The values equal BitReader's; what this one
// adds is ``hit_end``: whether a fill asked for a byte past ``real_end``,
// where OpenCV's memory source has none to give (libjpeg then suspends,
// and OpenCV's read of a zip member fails).
class LjBits {
  public:
    LjBits(const uint8_t* p, const uint8_t* end, const uint8_t* real_end)
        : p_(p), end_(end), real_end_(real_end) {}

    int decode(const Huffman& h) {
        if (bits_ < 8) fill(0);
        if (bits_ >= 8) {
            const uint32_t look = peek(8) << (Huffman::kLook - 8);
            // codes of up to 8 bits decode from the lookahead
            const int l = h.look_len[look];
            if (l && l <= 8) {
                bits_ -= l;
                return h.look_sym[look];
            }
        }
        // jpeg_huff_decode from the shortest possible code length up
        int l = bits_ < 8 ? 1 : 9;
        int32_t code = static_cast<int32_t>(get(l));
        while (code > h.maxcode[l]) {
            code = (code << 1) | static_cast<int32_t>(get(1));
            if (++l > 16) {
                bad_codes_++;
                return 0;
            }
        }
        const int idx = code + h.valoffset[l];
        if (idx < 0 || idx > 255) {
            bad_codes_++;
            return 0;
        }
        return h.vals[idx];
    }
    int bits(int n) { return static_cast<int>(get(n)); }
    // the data ran out (zero bits were stuffed) since the last restart
    bool insufficient() const { return insufficient_; }
    bool hit_end() const { return hit_end_; }
    bool at_marker() const { return marker_; }
    int bad_codes() const { return bad_codes_; }
    int buffered_bytes() const { return bits_ / 8; }
    const uint8_t* pos() const { return p_; }
    void restart_at(const uint8_t* q) { reset(q, false); }
    void stay_at_marker(const uint8_t* q) { reset(q, true); }

  private:
    void reset(const uint8_t* q, bool marker) {
        p_ = q;
        buf_ = 0;
        bits_ = 0;
        marker_ = marker;
        if (!marker) insufficient_ = false;
    }
    uint32_t peek(int n) const {
        return static_cast<uint32_t>((buf_ >> (bits_ - n)) & ((1u << n) - 1));
    }
    uint32_t get(int n) {
        if (bits_ < n) fill(n);
        const uint32_t v = peek(n);
        bits_ -= n;
        return v;
    }
    void fill(int nbits) {
        while (!marker_ && bits_ < 57) {
            if (p_ >= real_end_) hit_end_ = true;
            if (p_ >= end_) {
                marker_ = true;
                break;
            }
            int c = *p_;
            if (c == 0xFF) {
                const uint8_t* q = p_ + 1;
                while (q < end_ && *q == 0xFF) ++q;
                if (q >= real_end_) hit_end_ = true;
                if (q < end_ && *q == 0) {
                    p_ = q + 1;
                } else {
                    marker_ = true;         // p_ stays on the marker
                    break;
                }
            } else {
                ++p_;
            }
            buf_ = (buf_ << 8) | static_cast<uint64_t>(c);
            bits_ += 8;
        }
        if (marker_ && nbits > bits_) {
            insufficient_ = true;           // zeros from here on
            buf_ <<= 57 - bits_;
            bits_ = 57;
        }
    }

    const uint8_t* p_;
    const uint8_t* end_;
    const uint8_t* real_end_;
    uint64_t buf_ = 0;
    int bits_ = 0;
    int bad_codes_ = 0;
    bool marker_ = false, insufficient_ = false, hit_end_ = false;
};

// v << n on the two's-complement bits, kept to a coefficient's 16 bits
inline int16_t coef_shift(int v, int n) {
    return static_cast<int16_t>(static_cast<uint32_t>(v) << n);
}

// ------------------------------------------------------------------ frame
constexpr int kMaxComps = 4;
// whose decode: libjpeg-turbo 2.1 as the JAX package's native loader
// calls it, or OpenCV's reading through its bundled libjpeg-turbo 3.1 (the
// JAX package's imread). They differ in the block smoothing, and OpenCV
// keeps a one-scan image whose file goes wrong after that scan.
// The TIFF flavours decode as OpenCV's libjpeg-turbo does for libtiff's
// JPEG strips: YCbCr converted to RGB whatever the markers say (libtiff's
// JPEGCOLORMODE_RGB), or the samples as coded (JCS_UNKNOWN).
enum Flavour { kLibjpeg = 0, kOpenCV = 1, kTiffYcc = 2, kTiffRaw = 3 };
constexpr int kSavedCoefs = 10;     // jdcoefct.c: coef_bits[0..9] latched

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int td = 0, ta = 0;             // entropy tables of the current scan
    int bw = 0, bh = 0;             // blocks of a non-interleaved scan
    int gbw = 0, gbh = 0;           // blocks of the MCU-padded grid
    int ssize = 8;                  // IDCT output size (jdmaster.c)
    int sw = 0, sh = 0;             // downsampled size at that scale
    int stride = 0, rows = 0;       // plane size (MCU-padded)
    Idct idct = nullptr;
    bool quant_latched = false;
    int16_t quant[64] = {};         // natural order, as the IDCT's multiplier
    uint16_t quantval[64] = {};     // the table's own values (smoothing)
    std::vector<uint8_t> plane;
    std::vector<int16_t> coef;      // progressive: every block, natural order
    // progressive: Al of the last scan of each coefficient, -1 none, and
    // the values before the component's last scan (jdphuff.c, jdarith.c)
    int coef_bits[64], prev_coef_bits[64];
    int last_dc = 0, dc_context = 0;

    int16_t* block(int bx, int by) {
        return coef.data() +
               (static_cast<size_t>(by) * gbw + static_cast<size_t>(bx)) * 64;
    }
    // ``magnitude``: the sum of the block's |dequantized coefficients|
    // where the caller knows it (kIntIdctLimit)
    void idct_block(const int16_t* blk, int bx, int by,
                    int64_t magnitude = kIntIdctLimit + 1) {
        uint8_t* out = plane.data() +
                       static_cast<size_t>(by) * ssize * stride +
                       static_cast<size_t>(bx) * ssize;
        Idct f = idct;
        if (magnitude <= kIntIdctLimit)
            f = ssize == 8 ? idct_8x8_int
                : ssize == 4 ? idct_4x4_int
                : ssize == 2 ? idct_2x2_int : idct;
        f(blk, quant, out, stride);
    }
};

// where the entropy decoder resumes after a restart boundary
struct Resume {
    const uint8_t* at;
    bool at_marker;                 // an empty interval: it stays there
};

struct Decoder {
    const uint8_t* buf;
    const uint8_t* end;
    const uint8_t* real_end;        // past it, jpeg_mem_src's fake EOI
    const uint8_t* p;
    const int scale_num;            // output scale scale_num / 8
    const Flavour flavour;

    int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
    int out_w = 0, out_h = 0;       // output size at the scale
    bool have_frame = false, progressive = false, arithmetic = false;
    bool lossless = false;          // SOF3, OpenCV's flavours only
    int precision = 8;
    int scans = 0;                  // libjpeg's input_scan_number
    bool single_scan = false;       // a first scan of every component done
    Component comp[kMaxComps];
    uint16_t qt[4][64] = {};        // natural order
    bool qt_defined[4] = {};
    Huffman dc_tab[4], ac_tab[4];
    // arithmetic conditioning (DAC; T.81's defaults) and statistics bins
    uint8_t dc_L[16], dc_U[16], ac_K[16];
    uint8_t dc_stats[16][64], ac_stats[16][256];
    uint8_t fixed_bin[4] = {113, 0, 0, 0};
    int restart_interval = 0;
    bool saw_jfif = false, saw_adobe = false;
    int adobe_transform = 0;
    int mcux = 0, mcuy = 0;
    int eobrun = 0;                 // progressive Huffman AC scans
    int last_good_row = 0;          // jdmaster.c last_good_iMCU_row
    Status warned = kOk;            // kWarned or kEnded once libjpeg warns
    std::string warning;
    mutable std::vector<int> colsum;   // the h2v2 upsampler's row of sums
    // lossless: each component's rows of differences and of samples
    // (jddiffct.c diff_buf, undiff_buf), and whether its next row is the
    // first of a restart interval (jdlossls.c's first-row undifferencer)
    std::vector<int32_t> diff[kMaxComps], undiff[kMaxComps];
    bool first_row[kMaxComps] = {};
    bool scan_hit_end = false;      // a lossless scan read past the data

    Decoder(const uint8_t* b, size_t n, size_t real_n, int scale,
            Flavour fl = kLibjpeg)
        : buf(b), end(b + n), real_end(b + real_n), p(b), scale_num(scale),
          flavour(fl) {
        std::fill(dc_L, dc_L + 16, 0);
        std::fill(dc_U, dc_U + 16, 1);
        std::fill(ac_K, ac_K + 16, 5);
    }

    // a libjpeg warning: the first one's text is kept; running past the
    // data (kEnded) outranks the others
    void warn(Status s, const std::string& msg) {
        if (warned == kOk || (s == kEnded && warned != kEnded)) {
            warned = s;
            warning = msg;
        }
    }

    int u8() {
        if (p >= end) corrupt("truncated JPEG (inside a marker segment)");
        return *p++;
    }
    int u16() {
        const int hi = u8();
        return (hi << 8) | u8();
    }

    // jdmarker.c next_marker from ``q``: data bytes before the marker are
    // skipped, and counted into ``discarded``; ``at`` gets the marker's
    // first 0xFF, ``q`` the byte past its code
    int find_marker(const uint8_t*& q, const uint8_t*& at, int& discarded) {
        for (;;) {
            while (q < end && *q != 0xFF) {
                ++q;
                ++discarded;
            }
            at = q;
            while (q < end && *q == 0xFF) ++q;
            if (q >= end) corrupt("truncated JPEG (no EOI marker)");
            const int c = *q++;
            if (c != 0) return c;
            discarded += 2;
        }
    }

    void warn_discarded(int discarded, int marker) {
        if (discarded)
            warn(kWarned, "Corrupt JPEG data: " + std::to_string(discarded) +
                              " extraneous bytes before marker 0x" +
                              hex2(marker));
    }

    static std::string hex2(int v) {
        char s[4];
        std::snprintf(s, sizeof(s), "%02x", v & 0xFF);
        return s;
    }

    int next_marker() {
        int discarded = 0;
        const uint8_t* at;
        const int m = find_marker(p, at, discarded);
        warn_discarded(discarded, m);
        return m;
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

    // an APPn, COM or DNL segment, of which JFIF's APP0 and Adobe's APP14
    // set the colour-space guess
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
            (tc ? ac_tab : dc_tab)[th].build(counts, q);
            q += total;
        }
    }

    // a scan's Huffman table ``t`` of ``tabs``: K.3's for an undefined
    // table 0 or 1 of a sequential file, as libjpeg's jdhuff.c gives them
    // (its progressive decoder gives none), else it must be defined
    void standard_table(Huffman* tabs, int t, bool dc) const {
        if (tabs[t].defined) return;
        if (t > 1 || progressive)
            corrupt("scan uses an undefined Huffman table");
        uint8_t counts[17] = {};
        std::memcpy(counts + 1, dc ? kStdDcBits[t] : kStdAcBits[t], 16);
        tabs[t].build(counts, dc ? kStdDcVals : kStdAcVals[t]);
    }

    // jdmarker.c get_dac: conditioning of DC (L, U) and AC (Kx) tables
    void read_dac() {
        auto [s, e] = segment();
        if ((e - s) % 2) corrupt("bad DAC segment length");
        for (const uint8_t* q = s; q < e; q += 2) {
            const int index = q[0], val = q[1];
            if (index >= 32) corrupt("bad DAC table index");
            if (index >= 16) {
                ac_K[index - 16] = static_cast<uint8_t>(val);
            } else {
                dc_L[index] = static_cast<uint8_t>(val & 15);
                dc_U[index] = static_cast<uint8_t>(val >> 4);
                if (dc_L[index] > dc_U[index]) corrupt("bad DAC value");
            }
        }
    }

    void read_dri() {
        auto [s, e] = segment();
        if (e - s != 2) corrupt("bad DRI segment");
        restart_interval = (s[0] << 8) | s[1];
    }

    void read_sof(int marker) {
        // the modes that libjpeg-turbo 2.1 (8-bit) refuses too
        static const char* const kModes[16] = {
            nullptr, nullptr, nullptr, "lossless (SOF3)",
            nullptr, "hierarchical (SOF5)", "hierarchical progressive (SOF6)",
            "hierarchical lossless (SOF7)", nullptr, nullptr, nullptr,
            "lossless arithmetic coding (SOF11)", nullptr,
            "hierarchical arithmetic coding (SOF13)",
            "hierarchical progressive arithmetic coding (SOF14)",
            "hierarchical lossless arithmetic coding (SOF15)"};
        const int kind = marker - 0xC0;
        // libjpeg-turbo 3.1 (OpenCV's) decodes Huffman-coded lossless
        const bool is_lossless = kind == 3 && flavour != kLibjpeg;
        if (kModes[kind] && !is_lossless)
            fail(kUnsupported, std::string("unsupported JPEG mode: ") +
                                   kModes[kind]);
        if (have_frame) corrupt("more than one frame header");
        lossless = is_lossless;
        progressive = kind == 2 || kind == 10;
        arithmetic = kind >= 9;
        auto [s, e] = segment();
        if (e - s < 6) corrupt("truncated frame header");
        const int precision = s[0];
        height = (s[1] << 8) | s[2];
        width = (s[3] << 8) | s[4];
        ncomp = s[5];
        this->precision = precision;
        // OpenCV reads through libjpeg-turbo's 8-bit interface, which
        // refuses other precisions (lossless ones of 2-7 bits it takes)
        if (lossless && (precision < 2 || precision > 8))
            fail(kUnsupported, "unsupported JPEG mode: lossless, " +
                                   std::to_string(precision) +
                                   "-bit samples");
        if (!lossless && precision != 8)
            fail(kUnsupported, "unsupported JPEG mode: " +
                                   std::to_string(precision) +
                                   "-bit samples");
        if (lossless && scale_num != 8)
            fail(kBadArgs, "a lossless JPEG decodes at 8/8 only");
        if (height == 0 || width == 0 || ncomp == 0)
            corrupt("empty JPEG image (a zero dimension)");
        if (ncomp != 1 && ncomp != 3 && ncomp != 4)
            corrupt(std::to_string(ncomp) +
                    " components: libjpeg has no conversion of them to RGB");
        if (int64_t(width) * height > kMaxPixels)
            corrupt("image of " + std::to_string(width) + "x" +
                    std::to_string(height) +
                    " pixels exceeds the decoder's limit of 2^28");
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
            // (a lossless file latches no quantization table)
            if (k.tq > 3 && !lossless) corrupt("bad quantization table id");
            hmax = std::max(hmax, k.h);
            vmax = std::max(vmax, k.v);
        }
        mcux = (width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        // the padded sample planes (and a progressive file's coefficient
        // buffer, two bytes a sample) are bounded before any allocation
        if (lossless) {         // an MCU of h x v samples, not blocks
            mcux = (width + hmax - 1) / hmax;
            mcuy = (height + vmax - 1) / vmax;
        }
        int64_t padded = 0;
        for (int c = 0; c < ncomp; ++c)
            padded += int64_t(mcux) * comp[c].h * mcuy * comp[c].v *
                      (lossless ? 1 : 64);
        if (padded > 4 * kMaxPixels)
            corrupt("image of " + std::to_string(width) + "x" +
                    std::to_string(height) +
                    " pixels pads to over 4 * 2^28 samples");
        // jdmaster.c jpeg_calc_output_dimensions: the output size, then
        // each component's IDCT size, doubled while that keeps its
        // upsampling integral
        out_w = static_cast<int>((int64_t(width) * scale_num + 7) / 8);
        out_h = static_cast<int>((int64_t(height) * scale_num + 7) / 8);
        for (int c = 0; c < ncomp; ++c) {
            Component& k = comp[c];
            if (hmax % k.h || vmax % k.v)
                corrupt("fractional sampling factors (libjpeg has no "
                        "upsampler for them)");
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
            if (!k.idct)
                fail(kBadArgs, "scale " + std::to_string(scale_num) +
                                   "/8 needs a " + std::to_string(ss) + "x" +
                                   std::to_string(ss) +
                                   " IDCT, which the decoder lacks (it "
                                   "offers the scales 1-4 and 8 of 8)");
            k.sw = static_cast<int>((int64_t(width) * k.h * ss +
                                     int64_t(hmax) * 8 - 1) /
                                    (int64_t(hmax) * 8));
            k.sh = static_cast<int>((int64_t(height) * k.v * ss +
                                     int64_t(vmax) * 8 - 1) /
                                    (int64_t(vmax) * 8));
            k.stride = k.gbw * ss;
            k.rows = k.gbh * ss;
            if (lossless) {
                k.stride = k.gbw;
                k.rows = k.gbh;
            }
            std::fill(k.coef_bits, k.coef_bits + 64, -1);
            std::fill(k.prev_coef_bits, k.prev_coef_bits + 64, -1);
        }
        have_frame = true;
    }

    // ------------------------------------------ Huffman, sequential
    // one block into ``block``; returns the sum of its coefficients'
    // |value * quantizer| (a coefficient written twice counts twice) where
    // the component's IDCT has a C twin (8x8, 4x4, 2x2), else 0
    int64_t huff_block(BitReader& br, Component& k, int16_t* block) {
        return k.ssize == 8 || k.ssize == 4 || k.ssize == 2
                   ? huff_block_as<true>(br, k, block)
                   : huff_block_as<false>(br, k, block);
    }
    template <bool kMagnitude>
    int64_t huff_block_as(BitReader& br, Component& k, int16_t* block) {
        const Huffman& dc = dc_tab[k.td];
        const Huffman& ac = ac_tab[k.ta];
        int s = br.decode(dc);
        int diff = 0;
        if (s) diff = extend(br.bits(s), s);
        k.last_dc = static_cast<int>(static_cast<uint32_t>(k.last_dc) +
                                     static_cast<uint32_t>(diff));
        block[0] = static_cast<int16_t>(k.last_dc);
        int64_t magnitude = 0;
        if (kMagnitude) magnitude = std::abs(int64_t(block[0]) * k.quant[0]);
        for (int i = 1; i < 64; ++i) {
            const int rs = br.decode(ac);
            const int r = rs >> 4;
            s = rs & 15;
            if (s) {
                i += r;     // past 63: kNatural's extra entries, as libjpeg
                const int at = kNatural[i];
                block[at] = static_cast<int16_t>(extend(br.bits(s), s));
                if (kMagnitude)
                    magnitude += std::abs(int64_t(block[at]) * k.quant[at]);
            } else {
                if (r != 15) break;
                i += 15;
            }
        }
        return magnitude;
    }

    // ---------------------------------------- Huffman, progressive
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

    // --------------------------------------------------- arithmetic
    void arith_bad_code(ArithReader& ar) {
        warn(kWarned, "Corrupt JPEG data: bad arithmetic code");
        ar.fail();
    }

    // jdarith.c: a DC difference (F.19-F.24) added to the component's
    // prediction; false (and the reader failed) on a magnitude overflow
    bool arith_dc(ArithReader& ar, Component& k) {
        const int tbl = k.td;
        uint8_t* st = dc_stats[tbl] + k.dc_context;
        if (ar.decode(st) == 0) {
            k.dc_context = 0;
            return true;
        }
        const int sign = ar.decode(st + 1);
        st += 2 + sign;
        int m = ar.decode(st);
        if (m != 0) {
            st = dc_stats[tbl] + 20;                   // X1
            while (ar.decode(st)) {
                if ((m <<= 1) == 0x8000) {
                    arith_bad_code(ar);
                    return false;
                }
                st += 1;
            }
        }
        if (m < ((1 << dc_L[tbl]) >> 1))
            k.dc_context = 0;                          // zero diff
        else if (m > ((1 << dc_U[tbl]) >> 1))
            k.dc_context = 12 + sign * 4;              // large diff
        else
            k.dc_context = 4 + sign * 4;               // small diff
        int v = m;
        st += 14;
        while (m >>= 1)
            if (ar.decode(st)) v |= m;
        v += 1;
        if (sign) v = -v;
        k.last_dc = (k.last_dc + v) & 0xFFFF;
        return true;
    }

    // jdarith.c's AC coefficients ss..se (F.20); false on an overflow
    bool arith_ac(ArithReader& ar, Component& k, int16_t* blk, int ss,
                  int se, int al) {
        const int tbl = k.ta;
        for (int c = ss; c <= se; ++c) {
            uint8_t* st = ac_stats[tbl] + 3 * (c - 1);
            if (ar.decode(st)) break;                  // EOB
            while (ar.decode(st + 1) == 0) {
                st += 3;
                if (++c > se) {
                    arith_bad_code(ar);                // spectral overflow
                    return false;
                }
            }
            const int sign = ar.decode(fixed_bin);
            st += 2;
            int m = ar.decode(st);
            if (m != 0 && ar.decode(st)) {
                m <<= 1;
                st = ac_stats[tbl] + (c <= ac_K[tbl] ? 189 : 217);
                while (ar.decode(st)) {
                    if ((m <<= 1) == 0x8000) {
                        arith_bad_code(ar);            // magnitude overflow
                        return false;
                    }
                    st += 1;
                }
            }
            int v = m;
            st += 14;
            while (m >>= 1)
                if (ar.decode(st)) v |= m;
            v += 1;
            if (sign) v = -v;
            blk[kNatural[c]] = coef_shift(v, al);
        }
        return true;
    }

    // decode_mcu_AC_refine
    void arith_ac_refine(ArithReader& ar, Component& k, int16_t* blk,
                         int ss, int se, int al) {
        const int tbl = k.ta;
        const int p1 = 1 << al;
        const int m1 = static_cast<int>(static_cast<unsigned>(-1) << al);
        int kex = se;                  // the previous stage's end of block
        for (; kex > 0; --kex)
            if (blk[kNatural[kex]]) break;
        for (int c = ss; c <= se; ++c) {
            uint8_t* st = ac_stats[tbl] + 3 * (c - 1);
            if (c > kex && ar.decode(st)) break;       // EOB
            for (;;) {
                int16_t& coef = blk[kNatural[c]];
                if (coef) {                            // previously nonzero
                    if (ar.decode(st + 2))
                        coef = static_cast<int16_t>(coef + (coef < 0 ? m1 : p1));
                    break;
                }
                if (ar.decode(st + 1)) {               // newly nonzero
                    coef = static_cast<int16_t>(ar.decode(fixed_bin) ? m1 : p1);
                    break;
                }
                st += 3;
                if (++c > se) {
                    arith_bad_code(ar);                // spectral overflow
                    return;
                }
            }
        }
    }

    // ------------------------------------------------------- scans
    // jdmarker.c read_restart_marker and jpeg_resync_to_restart: the
    // marker at a restart boundary (already met by the entropy decoder,
    // else found from ``q``); the expected RSTn is consumed, another
    // marker makes libjpeg resynchronize (with a warning)
    Resume restart_marker(bool met, const uint8_t* q, int discarded,
                          int expected) {
        const uint8_t* at;
        int marker = find_marker(q, at, discarded);
        if (!met) warn_discarded(discarded, marker);
        if (marker == 0xD0 + expected) return {q, false};
        warn(kWarned, "Corrupt JPEG data: found marker 0x" + hex2(marker) +
                          " instead of RST" + std::to_string(expected));
        for (;;) {
            const auto rst = [&](int d) { return 0xD0 + ((expected + d) & 7); };
            int action = 1;
            if (marker < 0xC0)
                action = 2;                            // invalid marker
            else if (marker < 0xD0 || marker > 0xD7)
                action = 3;                            // not a restart
            else if (marker == rst(1) || marker == rst(2))
                action = 3;                            // one of the next two
            else if (marker == rst(-1) || marker == rst(-2))
                action = 2;                            // a prior restart
            if (action == 1) return {q, false};        // discard it, go on
            if (action == 3) return {at, true};        // leave it unread
            discarded = 0;
            marker = find_marker(q, at, discarded);
            warn_discarded(discarded, marker);
        }
    }

    // jdphuff.c / jdarith.c start_pass: the progression parameters and the
    // coefficients' status (coef_bits and the values before this scan)
    void progression(Component** in_scan, int ns, int ss, int se, int ah,
                     int al) {
        const bool dc_band = ss == 0;
        bool bad = dc_band ? se != 0 : (ss > se || se > 63 || ns != 1);
        if (ah != 0 && al != ah - 1) bad = true;
        if (al > 13) bad = true;
        if (bad)
            corrupt("bad progression parameters Ss=" + std::to_string(ss) +
                    " Se=" + std::to_string(se) + " Ah=" +
                    std::to_string(ah) + " Al=" + std::to_string(al));
        for (int i = 0; i < ns; ++i) {
            Component& k = *in_scan[i];
            const int index = static_cast<int>(&k - comp);
            if (!dc_band && k.coef_bits[0] < 0)
                warn(kWarned, bogus_progression(index, 0));
            for (int c = std::min(ss, 1); c <= std::max(se, 9); ++c)
                k.prev_coef_bits[c] = scans > 1 ? k.coef_bits[c] : 0;
            for (int c = ss; c <= se; ++c) {
                const int expected = k.coef_bits[c] < 0 ? 0 : k.coef_bits[c];
                if (ah != expected) warn(kWarned, bogus_progression(index, c));
                k.coef_bits[c] = al;
            }
        }
    }

    static std::string bogus_progression(int index, int c) {
        return "Inconsistent progression sequence for component " +
               std::to_string(index) + " coefficient " + std::to_string(c);
    }

    // -------------------------------------------------------- lossless
    // jdlossls.c: the predictors' state starts over (the next row of each
    // component is undifferenced as a first row)
    void reset_predictors() {
        std::fill(first_row, first_row + kMaxComps, true);
    }

    // jdlossls.c's undifferencers on one row of ``width`` samples:
    // ``d`` the differences, ``prev`` the row above (undifferenced),
    // ``out`` this row; sums modulo 2^16 as libjpeg-turbo keeps them
    static void undifference(int psv, bool first, int initial,
                             const int32_t* d, const int32_t* prev,
                             int32_t* out, int width) {
        if (first) {
            int ra = (d[0] + initial) & 0xFFFF;
            out[0] = ra;
            for (int x = 1; x < width; ++x) {
                ra = (d[x] + ra) & 0xFFFF;
                out[x] = ra;
            }
            return;
        }
        int rb = prev[0];
        int ra = (d[0] + rb) & 0xFFFF;
        out[0] = ra;
        for (int x = 1; x < width; ++x) {
            const int rc = rb;
            rb = prev[x];
            int pred;
            switch (psv) {
                case 1: pred = ra; break;
                case 2: pred = rb; break;
                case 3: pred = rc; break;
                case 4: pred = ra + rb - rc; break;
                case 5: pred = ra + ((rb - rc) >> 1); break;
                case 6: pred = rb + ((ra - rc) >> 1); break;
                default: pred = (ra + rb) >> 1; break;
            }
            ra = (d[x] + pred) & 0xFFFF;
            out[x] = ra;
        }
    }

    // one lossless scan (jddiffct.c decompress_data, jdlhuff.c
    // decode_mcus, jdlossls.c): each iMCU row's MCU rows are decoded into
    // differences, each restart interval (whole MCU rows) starting the
    // predictors over; an MCU row met after the data ran out gives zero
    // differences and starts the predictors over too (so it is grey);
    // then the iMCU row's rows are undifferenced and scaled (<< Al) into
    // 8-bit samples
    void lossless_scan(Component** in_scan, int ns, int psv, int se, int ah,
                       int al) {
        if (psv < 1 || psv > 7 || se != 0 || ah != 0 || al >= precision)
            corrupt("bad lossless parameters Ss=" + std::to_string(psv) +
                    " Se=" + std::to_string(se) + " Ah=" +
                    std::to_string(ah) + " Al=" + std::to_string(al));
        if (scans == 1) {
            // the colour conversions libjpeg-turbo does in lossless mode:
            // none but RGB and CMYK to OpenCV's BGR and CMYK
            if (ncomp == 1)
                fail(kUnsupported, "unsupported JPEG mode: lossless "
                                   "greyscale (no conversion to BGR)");
            if (ycc_guess(false))
                fail(kUnsupported, std::string("unsupported JPEG mode: "
                                               "lossless ") +
                                       (ncomp == 3 ? "YCbCr" : "YCCK") +
                                       " (no conversion to BGR)");
        }
        const bool inter = ns > 1;
        const int per_row = inter ? mcux : in_scan[0]->sw;
        if (restart_interval && restart_interval % per_row)
            corrupt("Invalid restart interval " +
                    std::to_string(restart_interval) +
                    "; must be an integer multiple of the number of MCUs "
                    "in an MCU row (" + std::to_string(per_row) + ")");
        for (int i = 0; i < ns; ++i) {
            Component& k = *in_scan[i];
            const int c = static_cast<int>(&k - comp);
            const size_t w = inter ? static_cast<size_t>(mcux) * k.h
                                   : static_cast<size_t>(k.sw);
            diff[c].assign(w * k.v, 0);
            undiff[c].assign(static_cast<size_t>(k.sw) * k.v, 0);
            if (k.plane.empty())
                k.plane.assign(static_cast<size_t>(k.stride) * k.rows, 0);
        }
        reset_predictors();
        const int initial = 1 << (precision - al - 1);
        LjBits br(p, end, real_end);
        bool insufficient = false;
        int rows_to_go = restart_interval / per_row, next_rst = 0;
        const auto row_stride = [&](const Component& k) {
            return inter ? static_cast<size_t>(mcux) * k.h
                         : static_cast<size_t>(k.sw);
        };
        for (int r = 0; r < mcuy; ++r) {
            const bool last = r == mcuy - 1;
            const auto height_of = [&](const Component& k) {
                const int rest = k.sh % k.v;
                return last && rest ? rest : k.v;
            };
            const int mcu_rows = inter ? 1 : height_of(*in_scan[0]);
            for (int yo = 0; yo < mcu_rows; ++yo) {
                if (restart_interval) {
                    if (rows_to_go == 0) {
                        const Resume res = restart_marker(
                            br.at_marker(), br.pos(), br.buffered_bytes(),
                            next_rst);
                        next_rst = (next_rst + 1) & 7;
                        // looking for it ran past the data
                        if (res.at >= real_end) scan_hit_end = true;
                        if (res.at_marker) {
                            br.stay_at_marker(res.at);
                        } else {
                            br.restart_at(res.at);
                            insufficient = false;
                        }
                        reset_predictors();
                        rows_to_go = restart_interval / per_row;
                    }
                }
                if (insufficient) {
                    for (int i = 0; i < ns; ++i) {
                        Component& k = *in_scan[i];
                        int32_t* d = diff[&k - comp].data();
                        const size_t n = row_stride(k);
                        if (inter)
                            std::fill(d, d + n * k.v, 0);
                        else
                            std::fill(d + yo * n, d + (yo + 1) * n, 0);
                    }
                    reset_predictors();
                } else {
                    for (int mx = 0; mx < per_row; ++mx) {
                        for (int i = 0; i < ns; ++i) {
                            Component& k = *in_scan[i];
                            const Huffman& tab = dc_tab[k.td];
                            int32_t* d = diff[&k - comp].data();
                            const size_t n = row_stride(k);
                            const int hh = inter ? k.h : 1;
                            const int vv = inter ? k.v : 1;
                            for (int y = 0; y < vv; ++y)
                                for (int x = 0; x < hh; ++x) {
                                    const int s = br.decode(tab);
                                    int v = 0;
                                    if (s == 16)
                                        v = 32768;
                                    else if (s)
                                        v = extend(br.bits(s), s);
                                    const size_t row = inter ? y : yo;
                                    d[row * n + static_cast<size_t>(mx) * hh +
                                      x] = v;
                                }
                        }
                    }
                    if (br.insufficient()) {
                        insufficient = true;
                        warn(kWarned, "Corrupt JPEG data: premature end of "
                                      "data segment");
                    }
                }
                if (restart_interval) --rows_to_go;
            }
            // undifference and scale the iMCU row
            for (int i = 0; i < ns; ++i) {
                Component& k = *in_scan[i];
                const int c = static_cast<int>(&k - comp);
                const size_t n = row_stride(k);
                const int rows = height_of(k);
                for (int row = 0; row < rows; ++row) {
                    const int prev = row ? row - 1 : k.v - 1;
                    int32_t* u = undiff[c].data();
                    undifference(psv, first_row[c], initial,
                                 diff[c].data() + row * n,
                                 u + static_cast<size_t>(prev) * k.sw,
                                 u + static_cast<size_t>(row) * k.sw, k.sw);
                    first_row[c] = false;
                    uint8_t* o = k.plane.data() +
                                 static_cast<size_t>(r * k.v + row) * k.stride;
                    const int32_t* ur = u + static_cast<size_t>(row) * k.sw;
                    for (int x = 0; x < k.sw; ++x)
                        o[x] = static_cast<uint8_t>(ur[x] << al);
                }
            }
        }
        if (br.bad_codes())
            warn(kWarned, "Corrupt JPEG data: bad Huffman code");
        scan_hit_end = scan_hit_end || br.hit_end();
        p = br.pos();
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
        // which tables the scan decodes with
        const bool need_dc = !progressive || (dc_band && ah == 0);
        const bool need_ac = !lossless && (!progressive || !dc_band);
        Component* in_scan[kMaxComps];
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
            if (!arithmetic) {
                if (k->td > 3 || (k->ta > 3 && !lossless))
                    corrupt("bad Huffman table id");
                if (need_dc) {
                    // jdlhuff.c installs no standard tables
                    if (lossless && !dc_tab[k->td].defined)
                        corrupt("scan uses an undefined Huffman table");
                    standard_table(dc_tab, k->td, true);
                    // jdhuff.c jpeg_make_d_derived_tbl
                    if (dc_tab[k->td].max_sym > (lossless ? 16 : 15))
                        corrupt("bad DC Huffman table");
                }
                if (need_ac) standard_table(ac_tab, k->ta, false);
            }
            if (!k->quant_latched && !lossless) {
                // libjpeg latches the table when the component's first
                // scan starts
                if (!qt_defined[k->tq])
                    corrupt("component uses an undefined quantization table");
                for (int j = 0; j < 64; ++j) {
                    k->quantval[j] = qt[k->tq][j];
                    k->quant[j] = static_cast<int16_t>(qt[k->tq][j]);
                }
                k->quant_latched = true;
            }
            if (progressive) {
                if (k->coef.empty())
                    k->coef.assign(static_cast<size_t>(k->gbw) * k->gbh * 64,
                                   0);
            } else if (k->plane.empty()) {
                // blocks no scan reaches are IDCTs of zeros: 128
                k->plane.assign(static_cast<size_t>(k->stride) * k->rows, 128);
            }
            in_scan[i] = k;
        }
        int blocks = 0;
        for (int i = 0; i < ns; ++i) blocks += in_scan[i]->h * in_scan[i]->v;
        if (ns > 1 && blocks > 10) corrupt("too many blocks in an MCU");
        ++scans;
        if (lossless) {
            lossless_scan(in_scan, ns, ss, se, ah, al);
            single_scan = scans == 1 && ns == ncomp;
            return;
        }
        if (progressive)
            progression(in_scan, ns, ss, se, ah, al);
        else if (ss != 0 || se != 63 || ah != 0 || al != 0)
            warn(kWarned, "Invalid SOS parameters for sequential JPEG");

        // the statistics the scan codes with start from zero
        const auto reset_stats = [&] {
            for (int i = 0; i < ns; ++i) {
                Component& k = *in_scan[i];
                if (!progressive || (dc_band && ah == 0)) {
                    std::memset(dc_stats[k.td], 0, sizeof(dc_stats[0]));
                    k.dc_context = 0;
                }
                if (!progressive || !dc_band)
                    std::memset(ac_stats[k.ta], 0, sizeof(ac_stats[0]));
            }
        };
        for (int i = 0; i < ns; ++i) in_scan[i]->last_dc = 0;
        if (arithmetic) reset_stats();

        BitReader br(p, end);
        ArithReader ar(p, end);
        ar.reset();
        bool insufficient = false;      // jdhuff.c: the data ran out
        eobrun = 0;

        // one block of the scan at (bx, by) of component k; false when the
        // arithmetic decoder failed inside it
        int16_t seq[64];
        const auto unit = [&](Component& k, int bx, int by) -> bool {
            if (!progressive) {
                std::memset(seq, 0, sizeof(seq));
                bool ok = true;
                if (arithmetic) {
                    ok = arith_dc(ar, k);
                    if (ok) {
                        seq[0] = static_cast<int16_t>(k.last_dc);
                        ok = arith_ac(ar, k, seq, 1, 63, 0);
                    }
                    k.idct_block(seq, bx, by);
                } else {
                    k.idct_block(seq, bx, by, huff_block(br, k, seq));
                }
                return ok;
            }
            int16_t* blk = k.block(bx, by);
            if (!arithmetic) {
                if (dc_band) {
                    if (ah == 0) dc_first(br, k, blk, al);
                    else dc_refine(br, blk, al);
                } else if (ah == 0) {
                    ac_first(br, ac_tab[k.ta], blk, ss, se, al);
                } else {
                    ac_refine(br, ac_tab[k.ta], blk, ss, se, al);
                }
                return true;
            }
            if (dc_band && ah == 0) {
                if (!arith_dc(ar, k)) return false;
                blk[0] = coef_shift(k.last_dc, al);
            } else if (dc_band) {
                if (ar.decode(fixed_bin))
                    blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
            } else if (ah == 0) {
                return arith_ac(ar, k, blk, ss, se, al);
            } else {
                arith_ac_refine(ar, k, blk, ss, se, al);
            }
            return !ar.failed();
        };

        const int64_t nx = ns == 1 ? in_scan[0]->bw : mcux;
        const int64_t ny = ns == 1 ? in_scan[0]->bh : mcuy;
        const int64_t total = nx * ny;
        int next_rst = 0;
        for (int64_t m = 0; m < total; ++m) {
            const int mx = static_cast<int>(m % nx), my = static_cast<int>(m / nx);
            // jdcoefct.c consume_data: the last iMCU row begun with data
            if (!insufficient) last_good_row = ns == 1 ? my / in_scan[0]->v : my;
            if (restart_interval && m && m % restart_interval == 0) {
                const bool met = arithmetic ? ar.at_marker() : br.at_marker();
                const Resume r = restart_marker(
                    met, arithmetic ? ar.pos() : br.pos(),
                    arithmetic ? 0 : br.buffered_bytes(), next_rst);
                next_rst = (next_rst + 1) & 7;
                if (r.at_marker) {
                    br.stay_at_marker(r.at);
                    ar.stay_at_marker(r.at);
                } else {
                    br.restart_at(r.at);
                    ar.restart_at(r.at);
                    insufficient = false;
                }
                for (int i = 0; i < ns; ++i) in_scan[i]->last_dc = 0;
                eobrun = 0;
                if (arithmetic) {
                    reset_stats();
                    ar.reset();
                }
            }
            if (arithmetic) {
                // a failed interval decodes nothing (a DC refinement scan
                // cannot fail)
                if (ar.failed()) continue;
            } else if (insufficient) {
                continue;               // the rest of the interval: zeros
            }
            if (ns == 1) {
                unit(*in_scan[0], mx, my);
            } else {
                bool ok = true;
                for (int i = 0; i < ns && ok; ++i) {
                    Component& k = *in_scan[i];
                    for (int y = 0; y < k.v && ok; ++y)
                        for (int x = 0; x < k.h && ok; ++x)
                            ok = unit(k, mx * k.h + x, my * k.v + y);
                }
            }
            if (!arithmetic && br.overrun()) {
                insufficient = true;
                warn(kWarned, "Corrupt JPEG data: premature end of data "
                              "segment");
            }
        }
        if (br.bad_codes())
            warn(kWarned, "Corrupt JPEG data: bad Huffman code");
        // the next marker: data bytes before it are skipped (with a
        // warning), as libjpeg's next_marker does
        p = arithmetic ? ar.pos() : br.pos();
        single_scan = scans == 1 && !progressive && ns == ncomp;
    }

    // ------------------------------------------------------ smoothing
    // jdcoefct.c smoothing_ok: a progressive file whose coefficients 1-9
    // are not all final is block-smoothed; ``latch`` and ``prev`` get
    // coef_bits[0..9] now and before each component's last scan
    bool smoothing_ok(int latch[][kSavedCoefs], int prev[][kSavedCoefs]) const {
        static const int kQ[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
        if (!progressive) return false;
        bool useful = false;
        for (int c = 0; c < ncomp; ++c) {
            const Component& k = comp[c];
            if (!k.quant_latched) return false;
            for (int i : kQ)
                if (k.quantval[i] == 0) return false;
            if (k.coef_bits[0] < 0) return false;
            latch[c][0] = k.coef_bits[0];
            for (int i = 1; i < kSavedCoefs; ++i) {
                prev[c][i] = scans > 1 ? k.prev_coef_bits[i] : -1;
                latch[c][i] = k.coef_bits[i];
                if (k.coef_bits[i] != 0) useful = true;
            }
        }
        return useful;
    }

    // one estimate of decompress_smooth_data: ``num`` over the quantizer
    // ``q`` of the coefficient, its magnitude limited by its Al
    static int16_t smooth_pred(int64_t num, int64_t q, int al) {
        int pred;
        if (num >= 0) {
            pred = static_cast<int>(((q << 7) + num) / (q << 8));
            if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        } else {
            pred = static_cast<int>(((q << 7) - num) / (q << 8));
            if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
            pred = -pred;
        }
        return static_cast<int16_t>(pred);
    }

    // jdcoefct.c decompress_smooth_data: each block's unknown
    // low-frequency coefficients estimated from the DC values of a 5 x 5
    // window of blocks, its DC too when no AC coefficient has arrived;
    // iMCU rows past the last one begun with data take the coefficient
    // status from before the last scan. libjpeg-turbo 2.1 and 3.1 differ
    // in the window's rows where a component has two block rows an iMCU
    // row, and in its columns where a component is two blocks wide.
    void smooth_component(Component& k, const int* cur_bits,
                          const int* prev_bits) {
        const int total = mcuy, last_row = mcuy - 1;
        const uint16_t* qv = k.quantval;
        const int64_t Q00 = qv[0], Q01 = qv[1], Q10 = qv[8], Q20 = qv[16],
                      Q11 = qv[9], Q02 = qv[2], Q03 = qv[3], Q12 = qv[10],
                      Q21 = qv[17], Q30 = qv[24];
        const int last_col = k.bw - 1;
        int16_t ws[64];
        for (int r = 0; r < total; ++r) {
            int block_rows = k.v;
            if (r == last_row) {
                block_rows = k.bh % k.v;
                if (block_rows == 0) block_rows = k.v;
            }
            const int* cb = r > last_good_row ? prev_bits : cur_bits;
            bool change_dc = true;
            for (int i = 1; i <= 9; ++i)
                if (cb[i] != -1) change_dc = false;
            const int image_rows = block_rows * total;
            for (int br = 0; br < block_rows; ++br) {
                const int image_row = r * block_rows + br;
                const int row = r * k.v + br;
                // the rows above and below: 3.1 counts block rows of the
                // image, 2.1 block rows of the iMCU row and iMCU rows
                bool up1 = image_row > 0, up2 = image_row > 1,
                     down1 = image_row < image_rows - 1,
                     down2 = image_row < image_rows - 2;
                if (flavour == kLibjpeg) {
                    up1 = br > 0 || r > 0;
                    up2 = br > 1 || r > 1;
                    down1 = br < block_rows - 1 || r < last_row;
                    down2 = br < block_rows - 2 || r + 1 < last_row;
                }
                const int16_t* cur = k.block(0, row);
                const int16_t* prv = up1 ? k.block(0, row - 1) : cur;
                const int16_t* pp = up2 ? k.block(0, row - 2) : prv;
                const int16_t* nxt = down1 ? k.block(0, row + 1) : cur;
                const int16_t* nn = down2 ? k.block(0, row + 2) : nxt;
                const auto dc = [](const int16_t* rowp, int col) {
                    return static_cast<int>(rowp[static_cast<size_t>(col) * 64]);
                };
                int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09,
                    DC10, DC11, DC12, DC13, DC14, DC15, DC16, DC17, DC18,
                    DC19, DC20, DC21, DC22, DC23, DC24, DC25;
                DC01 = DC02 = DC03 = DC04 = DC05 = dc(pp, 0);
                DC06 = DC07 = DC08 = DC09 = DC10 = dc(prv, 0);
                DC11 = DC12 = DC13 = DC14 = DC15 = dc(cur, 0);
                DC16 = DC17 = DC18 = DC19 = DC20 = dc(nxt, 0);
                DC21 = DC22 = DC23 = DC24 = DC25 = dc(nn, 0);
                for (int bx = 0; bx <= last_col; ++bx) {
                    std::memcpy(ws, cur + static_cast<size_t>(bx) * 64,
                                sizeof(ws));
                    if (bx == 0 && bx < last_col) {
                        DC04 = dc(pp, bx + 1);
                        DC09 = dc(prv, bx + 1);
                        DC14 = dc(cur, bx + 1);
                        DC19 = dc(nxt, bx + 1);
                        DC24 = dc(nn, bx + 1);
                        if (flavour != kLibjpeg) {
                            // 3.1 replicates column 1 where there is no 2
                            DC05 = DC04;
                            DC10 = DC09;
                            DC15 = DC14;
                            DC20 = DC19;
                            DC25 = DC24;
                        }
                    }
                    if (bx + 1 < last_col) {
                        DC05 = dc(pp, bx + 2);
                        DC10 = dc(prv, bx + 2);
                        DC15 = dc(cur, bx + 2);
                        DC20 = dc(nxt, bx + 2);
                        DC25 = dc(nn, bx + 2);
                    }
                    int al;
                    if ((al = cb[1]) != 0 && ws[1] == 0) {             // AC01
                        const int64_t num = Q00 * (change_dc ?
                            (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 +
                             13 * DC07 - 13 * DC09 + 3 * DC10 - 3 * DC11 +
                             38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 +
                             13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 -
                             DC22 + DC24 + DC25) :
                            (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
                        ws[1] = smooth_pred(num, Q01, al);
                    }
                    if ((al = cb[2]) != 0 && ws[8] == 0) {             // AC10
                        const int64_t num = Q00 * (change_dc ?
                            (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 -
                             DC06 + 13 * DC07 + 38 * DC08 + 13 * DC09 -
                             DC10 + DC16 - 13 * DC17 - 38 * DC18 -
                             13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 +
                             3 * DC24 + DC25) :
                            (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
                        ws[8] = smooth_pred(num, Q10, al);
                    }
                    if ((al = cb[3]) != 0 && ws[16] == 0) {            // AC20
                        const int64_t num = Q00 * (change_dc ?
                            (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 -
                             5 * DC12 - 14 * DC13 - 5 * DC14 + 2 * DC17 +
                             7 * DC18 + 2 * DC19 + DC23) :
                            (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 -
                             DC23));
                        ws[16] = smooth_pred(num, Q20, al);
                    }
                    if ((al = cb[4]) != 0 && ws[9] == 0) {             // AC11
                        const int64_t num = Q00 * (change_dc ?
                            (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                             9 * DC19 + DC21 - DC25) :
                            (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 -
                             DC20 + DC22 - DC24 + DC04 - DC06 + 10 * DC07 -
                             10 * DC09));
                        ws[9] = smooth_pred(num, Q11, al);
                    }
                    if ((al = cb[5]) != 0 && ws[2] == 0) {             // AC02
                        const int64_t num = Q00 * (change_dc ?
                            (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 +
                             7 * DC12 - 14 * DC13 + 7 * DC14 + DC15 +
                             2 * DC17 - 5 * DC18 + 2 * DC19) :
                            (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 -
                             DC15));
                        ws[2] = smooth_pred(num, Q02, al);
                    }
                    if (change_dc) {
                        if ((al = cb[6]) != 0 && ws[3] == 0)           // AC03
                            ws[3] = smooth_pred(
                                Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 +
                                       DC17 - DC19), Q03, al);
                        if ((al = cb[7]) != 0 && ws[10] == 0)          // AC12
                            ws[10] = smooth_pred(
                                Q00 * (DC07 - 3 * DC08 + DC09 - DC17 +
                                       3 * DC18 - DC19), Q12, al);
                        if ((al = cb[8]) != 0 && ws[17] == 0)          // AC21
                            ws[17] = smooth_pred(
                                Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 +
                                       DC17 - DC19), Q21, al);
                        if ((al = cb[9]) != 0 && ws[24] == 0)          // AC30
                            ws[24] = smooth_pred(
                                Q00 * (DC07 + 2 * DC08 + DC09 - DC17 -
                                       2 * DC18 - DC19), Q30, al);
                        // the DC itself (its status is known: >= 0)
                        ws[0] = smooth_pred(
                            Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 -
                                   6 * DC04 - 2 * DC05 - 6 * DC06 +
                                   6 * DC07 + 42 * DC08 + 6 * DC09 -
                                   6 * DC10 - 8 * DC11 + 42 * DC12 +
                                   152 * DC13 + 42 * DC14 - 8 * DC15 -
                                   6 * DC16 + 6 * DC17 + 42 * DC18 +
                                   6 * DC19 - 6 * DC20 - 2 * DC21 -
                                   6 * DC22 - 8 * DC23 - 6 * DC24 -
                                   2 * DC25), Q00, 0);
                    }
                    k.idct_block(ws, bx, row);
                    DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
                    DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
                    DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
                    DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
                    DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
                }
            }
        }
    }

    // jdmarker.c read_markers from where the last call stopped: up to the
    // frame header when ``headers_only``, else through EOI
    void markers(bool headers_only) {
        for (;;) {
            const int m = next_marker();
            if (m == 0xD9) return;                        // EOI
            if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC) {
                if (m == 0xC8) corrupt("unsupported marker type 0xc8 (JPG)");
                read_sof(m);
                if (headers_only) return;
            } else if (m == 0xC4) {
                read_dht();
            } else if (m == 0xCC) {
                read_dac();
            } else if (m == 0xDB) {
                read_dqt();
            } else if (m == 0xDD) {
                read_dri();
            } else if (m == 0xDA) {
                // jdinput.c: a sequential file whose first scan holds every
                // component has no second scan
                if (single_scan) corrupt("Didn't expect more than one scan");
                read_scan();
            } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
                read_app(m);                              // APPn, COM, DNL
            } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
                continue;                                 // RSTn, TEM: none
            } else if (m == 0xD8) {
                corrupt("second SOI marker");
            } else {
                corrupt("unsupported marker type 0x" + hex2(m));
            }
        }
    }

    // parse markers from where the last call stopped: up to the frame
    // header when ``headers_only``, else through EOI
    void run(bool headers_only) {
        if (p == buf) {
            if (real_end - p < 2 || p[0] != 0xFF || p[1] != 0xD8)
                corrupt("not a JPEG (no SOI marker)");
            p += 2;
        }
        try {
            markers(headers_only);
        } catch (const Failure& f) {
            // OpenCV has read a one-scan image's rows before libjpeg
            // meets what follows the scan, and keeps them
            if (!(flavour != kLibjpeg && single_scan && f.status != kBadArgs))
                throw;
            warn(kWarned, f.msg);
        }
        if (!have_frame) corrupt("no frame header");
        if (headers_only) return;
        if (lossless) {
            // jddiffct.c's buffered image (a scan a component) is not
            // zeroed: a component no scan reached cannot be read
            for (int c = 0; c < ncomp; ++c)
                if (comp[c].plane.empty())
                    corrupt("Bogus virtual array access");
        }
        // OpenCV has the rows of a one-scan lossless image once its scan
        // is decoded: only a scan that read past the data fails from
        // memory
        if (lossless && single_scan && !scan_hit_end) {
            if (p > real_end) warn(kWarned, "Premature end of JPEG file");
        } else if (p > real_end || scan_hit_end) {
            warn(kEnded, "Premature end of JPEG file");
        }
        if (!scans) corrupt("JPEG datastream contains no image");
        for (int c = 0; c < ncomp; ++c)
            if (comp[c].plane.empty() && !progressive)   // never scanned
                comp[c].plane.assign(
                    static_cast<size_t>(comp[c].stride) * comp[c].rows, 128);
        if (progressive) {
            // the coefficient buffer through the IDCTs, as jdcoefct.c's
            // decompress_data, or decompress_smooth_data when libjpeg
            // block-smooths
            int latch[kMaxComps][kSavedCoefs], prev[kMaxComps][kSavedCoefs];
            const bool smooth = smoothing_ok(latch, prev);
            for (int c = 0; c < ncomp; ++c) {
                Component& k = comp[c];
                k.plane.assign(static_cast<size_t>(k.stride) * k.rows, 128);
                if (k.coef.empty()) continue;              // never scanned
                if (smooth) {
                    smooth_component(k, latch[c], prev[c]);
                } else {
                    for (int by = 0; by < k.bh; ++by)
                        for (int bx = 0; bx < k.bw; ++bx)
                            k.idct_block(k.block(bx, by), bx, by);
                }
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
        const bool fancy = scale_num > 1 && !lossless;
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

    // jdapimin.c default_decompress_parms: the colour-space guess of a
    // three- or four-component image, YCbCr (or YCCK) or not; the TIFF
    // flavours say it themselves. ``warn_unknown``: warn of an unknown
    // Adobe transform, as libjpeg does.
    bool ycc_guess(bool warn_unknown) {
        if (flavour == kTiffYcc || flavour == kTiffRaw)
            return flavour == kTiffYcc && ncomp == 3;
        bool ycc = true;
        if (ncomp == 4) {
            ycc = saw_adobe && adobe_transform != 0;       // YCCK, else CMYK
            if (warn_unknown && saw_adobe && adobe_transform != 0 &&
                adobe_transform != 2)
                warn(kWarned, "Unknown Adobe color transform code " +
                                  std::to_string(adobe_transform));
        } else if (!saw_jfif) {
            if (saw_adobe) {
                ycc = adobe_transform != 0;
                if (warn_unknown && adobe_transform > 1)
                    warn(kWarned, "Unknown Adobe color transform code " +
                                      std::to_string(adobe_transform));
            } else if (comp[0].id == 82 && comp[1].id == 71 &&
                       comp[2].id == 66) {
                ycc = false;                               // 'R', 'G', 'B'
            } else {
                // libjpeg-turbo 3.1 takes a lossless file without markers
                // for RGB, whatever its component ids
                ycc = !lossless;
            }
        }
        return ycc;
    }

    void to_rgb(uint8_t* rgb) {
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
        const bool ycc = ycc_guess(true);
        // rows padded for the upsamplers, which may write 2 * dw samples
        const size_t pad = W + 16 * static_cast<size_t>(hmax);
        std::vector<uint8_t> rows(kMaxComps * pad);
        colsum.resize(pad);
        std::vector<uint8_t> rgbrow(3 * W);
        const uint8_t* r[kMaxComps];
        for (int y = 0; y < out_h; ++y) {
            for (int c = 0; c < ncomp; ++c)
                r[c] = upsample_row(comp[c], y, rows.data() + c * pad);
            uint8_t* o = rgb + y * W * 3;
            if (ncomp == 4) {
                cmyk_row(r, ycc, rgbrow.data(), o, W);
            } else if (ycc) {
                ycc_rgb_row(r[0], r[1], r[2], rgbrow.data(), o, W);
            } else {
                for (size_t x = 0; x < W; ++x) {
                    o[3 * x] = r[0][x];
                    o[3 * x + 1] = r[1][x];
                    o[3 * x + 2] = r[2][x];
                }
            }
        }
    }

    // A CMYK (or YCCK) row to RGB as OpenCV reads it: libjpeg's
    // jdcolor.c ycck_cmyk_convert (YCCK -> CMYK, the inverted YCbCr -> RGB
    // of jdcolor.c), then OpenCV's icvCvt_CMYK2BGR_8u_C4C3R, which takes
    // the samples as Adobe's inverted CMYK: each of R, G, B is
    // k - ((255 - s) * k >> 8) of its C, M, Y sample s.
    static void cmyk_row(const uint8_t* const* r, bool ycck, uint8_t* tmp,
                         uint8_t* out, size_t n) {
        const uint8_t* c = r[0];
        const uint8_t* m = r[1];
        const uint8_t* yy = r[2];
        if (ycck) {
            ycc_rgb_row(r[0], r[1], r[2], tmp, out, n);
            for (size_t x = 0; x < 3 * n; ++x)
                tmp[x] = static_cast<uint8_t>(255 - out[x]);
            // tmp is interleaved CMY now
            for (size_t x = 0; x < n; ++x) {
                const int k = r[3][x];
                for (int ch = 0; ch < 3; ++ch)
                    out[3 * x + ch] = static_cast<uint8_t>(
                        k - (((255 - tmp[3 * x + ch]) * k) >> 8));
            }
            return;
        }
        for (size_t x = 0; x < n; ++x) {
            const int k = r[3][x];
            out[3 * x] = static_cast<uint8_t>(k - (((255 - c[x]) * k) >> 8));
            out[3 * x + 1] = static_cast<uint8_t>(k - (((255 - m[x]) * k) >> 8));
            out[3 * x + 2] = static_cast<uint8_t>(k - (((255 - yy[x]) * k) >> 8));
        }
    }
};

int report(const Failure& f, char* err, int errlen) {
    if (err && errlen > 0) std::snprintf(err, errlen, "%s", f.msg.c_str());
    return f.status;
}

// ``body`` returns kOk or a warning status (its text in ``msg``)
template <typename Body>
int guarded(char* err, int errlen, Body&& body) {
    if (err && errlen > 0) err[0] = 0;
    try {
        std::string msg;
        const int status = body(msg);
        if (status && err && errlen > 0)
            std::snprintf(err, errlen, "%s", msg.c_str());
        return status;
    } catch (const Failure& f) {
        return report(f, err, errlen);
    } catch (const std::bad_alloc&) {
        return report({kCorrupt, "out of memory"}, err, errlen);
    }
}

void check_flavour(int flavour) {
    if (flavour < kLibjpeg || flavour > kTiffRaw)
        fail(kBadArgs, "flavour " + std::to_string(flavour) +
                           " is not 0 (libjpeg), 1 (OpenCV), 2 (TIFF YCbCr) "
                           "or 3 (TIFF as coded)");
}

void check_scale(int scale_num) {
    if (scale_num < 1 || scale_num > 8)
        fail(kBadArgs, "scale_num " + std::to_string(scale_num) +
                           " is not in 1..8");
}

// jpeg_mem_src's end of data: past the last byte libjpeg reads fake EOI
// markers (with a warning), in a marker segment cut short too. The
// decoder reads a copy followed by enough of them for any segment.
constexpr size_t kFakeEoi = 65540;

struct Input {
    std::vector<uint8_t> copy;
    const uint8_t* data;
    size_t n;
    Input(const uint8_t* buf, size_t size) {
        copy.reserve(size + kFakeEoi);
        copy.assign(buf, buf + size);
        copy.resize(size + kFakeEoi);
        for (size_t i = size; i < copy.size(); i += 2) {
            copy[i] = 0xFF;
            copy[i + 1] = 0xD9;
        }
        data = copy.data();
        n = copy.size();
    }
};

}  // namespace

namespace epk {

// Decode ``buf`` at scale_num/8 into ``out`` (resized to h * w * 3 RGB):
// a status as the C interface's; ``w``, ``h`` the output size and
// ``full_w``, ``full_h`` the image's. With ``cmyk`` false a four-component
// image fails as unsupported (libjpeg has no CMYK -> RGB, so the JAX
// package's loader fails on it).
inline int decode_rgb(const uint8_t* buf, size_t n, int scale_num,
                      std::vector<uint8_t>& out, int& w, int& h, int& full_w,
                      int& full_h, char* err = nullptr, int errlen = 0,
                      bool cmyk = true, int flavour = kLibjpeg) {
    return guarded(err, errlen, [&](std::string& msg) {
        check_scale(scale_num);
        if (!buf) fail(kBadArgs, "null argument");
        const Input in(buf, n);
        Decoder d(in.data, in.n, n, scale_num,
                  static_cast<Flavour>(flavour));
        d.run(true);
        if (d.ncomp == 4 && !cmyk)
            fail(kUnsupported, "unsupported JPEG mode: CMYK/YCCK (libjpeg "
                               "has no conversion of it to RGB)");
        full_w = d.width;
        full_h = d.height;
        w = d.out_w;
        h = d.out_h;
        d.run(false);
        out.resize(static_cast<size_t>(w) * h * 3);
        d.to_rgb(out.data());
        msg = d.warning;
        return static_cast<int>(d.warned);
    });
}

}  // namespace epk

extern "C" {

int epk_jpeg_info(const uint8_t* buf, size_t n, int scale_num, int* w,
                  int* h, int* comps, int flavour, char* err, int errlen) {
    return guarded(err, errlen, [&](std::string&) {
        if (!buf || !w || !h || !comps) fail(kBadArgs, "null argument");
        check_scale(scale_num);
        check_flavour(flavour);
        const Input in(buf, n);
        Decoder d(in.data, in.n, n, scale_num, static_cast<Flavour>(flavour));
        d.run(true);
        *w = d.out_w;
        *h = d.out_h;
        *comps = d.ncomp;
        return static_cast<int>(kOk);
    });
}

int epk_jpeg_decode_rgb(const uint8_t* buf, size_t n, int scale_num,
                        uint8_t* out, int w, int h, int flavour, char* err,
                        int errlen) {
    return guarded(err, errlen, [&](std::string& msg) {
        if (!buf || !out) fail(kBadArgs, "null argument");
        check_scale(scale_num);
        check_flavour(flavour);
        const Input in(buf, n);
        Decoder d(in.data, in.n, n, scale_num, static_cast<Flavour>(flavour));
        d.run(true);
        if (d.out_w != w || d.out_h != h)
            fail(kBadArgs, "output is " + std::to_string(w) + "x" +
                               std::to_string(h) + ", image is " +
                               std::to_string(d.out_w) + "x" +
                               std::to_string(d.out_h) + " at " +
                               std::to_string(scale_num) + "/8");
        d.run(false);
        d.to_rgb(out);
        msg = d.warning;
        return static_cast<int>(d.warned);
    });
}

}  // extern "C"
