// fastloader: the port's native batch loader, with no libjpeg.
//
// It computes what the JAX package's native loader computes, with the same
// C functions and crops: a whole batch of JPEG decode -> bilinear affine
// warp -> uint8 or float crops in one call, parallel over frames with
// OpenMP. Each frame is decoded by the port's own decoder (jpegdec.cpp,
// included below) as libjpeg-turbo 2.1 decodes it: at libjpeg's DCT scale
// scale_num/8 when the crop shrinks the frame 2x or more, the affine then
// remapped onto the scaled pixel grid. All matrices are the cv2-convention
// src->dst affines of geometry.affine; inversion happens here.
// Out-of-bounds samples read as 0 (BORDER_CONSTANT). A frame that fails to
// decode gives a zero crop and is counted in the call's result; so do the
// frames libjpeg refuses, CMYK and YCCK among them (the JAX package's
// loader asks libjpeg for RGB, which it has no conversion to). A
// truncated frame is decoded as libjpeg fills it, as that loader does.
//
// The crops' geometry and warp are float and double arithmetic, and the
// JAX package's loader is built with -march=native, which fuses
// multiply-adds wherever the host has FMA. Each frame's geometry and warp
// are therefore compiled twice, for FMA and without it, and the host's
// variant is picked when the library loads (GCC's target_clones): the
// same roundings as that build on any host, and no -march here.
//
// The library also counts its decodes by the scale that served them, its
// failures, and of these the modes libjpeg refuses too, and the decodes
// libjpeg warns about: epk_loader_counts / epk_loader_reset_counts.

#include "jpegdec.cpp"

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#define EPK_INLINE inline __attribute__((always_inline))
#define EPK_FMA_CLONES __attribute__((target_clones("fma", "default")))

namespace {

// [0] failed decodes, [s] decodes at scale s/8 (s in 1..8); of the
// failures, [9] those of a mode the JAX package's loader (libjpeg) refuses
// too: lossless, hierarchical, 12-bit, CMYK/YCCK; of the decodes, [10]
// those libjpeg warns about (a truncated file, a lost restart marker)
constexpr int kCountSlots = 11;
std::atomic<int64_t> g_counts[kCountSlots];

// Decode one JPEG buffer to RGB uint8 at scale_num/8, as libjpeg-turbo
// 2.1 decodes it (its block smoothing); 0 on success, a decode libjpeg
// warns about included. full_w/full_h report the unscaled size so the
// caller can fix up its affine. A frame the decoder cannot decode at that
// scale fails: it is never served at another.
int decode_one(const uint8_t* buf, size_t size, std::vector<uint8_t>& out,
               int& w, int& h, int scale_num, int& full_w, int& full_h) {
    const int status = epk::decode_rgb(buf, size, scale_num, out, w, h,
                                       full_w, full_h, nullptr, 0,
                                       /*cmyk=*/false, kLibjpeg);
    const bool ok = status == kOk || status == kWarned || status == kEnded;
    g_counts[ok ? scale_num : 0].fetch_add(1, std::memory_order_relaxed);
    if (status == kUnsupported)
        g_counts[9].fetch_add(1, std::memory_order_relaxed);
    if (status == kWarned || status == kEnded)
        g_counts[10].fetch_add(1, std::memory_order_relaxed);
    return ok ? 0 : 1;
}

// Output-type adapters: float crops get the caller's scale (e.g. 1/255);
// uint8 crops round-to-nearest (scale is ignored — values stay in 0..255,
// matching cv2.warpAffine's uint8 output up to its fixed-point rounding).
EPK_INLINE void store_px(float acc, float scale, float* o) {
    *o = acc * scale;
}
EPK_INLINE void store_px(float acc, float /*scale*/, uint8_t* o) {
    const float v = acc + 0.5f;
    *o = v <= 0.f ? 0 : (v >= 255.f ? 255 : static_cast<uint8_t>(v));
}

EPK_INLINE void invert_affine(const float* M, double* inv) {
    const double a = M[0], b = M[1], c = M[2];
    const double d = M[3], e = M[4], f = M[5];
    const double det = a * e - b * d;
    const double id = det != 0.0 ? 1.0 / det : 0.0;
    inv[0] = e * id;
    inv[1] = -b * id;
    inv[2] = (b * f - e * c) * id;
    inv[3] = -d * id;
    inv[4] = a * id;
    inv[5] = (d * c - a * f) * id;
}

// Border-handling bilinear sample (BORDER_CONSTANT = 0), scalar path.
template <typename OutT>
EPK_INLINE void sample_checked(const uint8_t* src, int sw, int sh, double sx,
                               double sy, float scale, OutT* o) {
    const int x0 = static_cast<int>(std::floor(sx));
    const int y0 = static_cast<int>(std::floor(sy));
    const float fx = static_cast<float>(sx - x0);
    const float fy = static_cast<float>(sy - y0);
    float acc[3] = {0.f, 0.f, 0.f};
    for (int dy2 = 0; dy2 <= 1; ++dy2) {
        const int yy = y0 + dy2;
        if (yy < 0 || yy >= sh) continue;
        const float wy = dy2 ? fy : 1.f - fy;
        for (int dx2 = 0; dx2 <= 1; ++dx2) {
            const int xx = x0 + dx2;
            if (xx < 0 || xx >= sw) continue;
            const float wxy = wy * (dx2 ? fx : 1.f - fx);
            const uint8_t* p = src + (static_cast<size_t>(yy) * sw + xx) * 3;
            acc[0] += wxy * p[0];
            acc[1] += wxy * p[1];
            acc[2] += wxy * p[2];
        }
    }
    store_px(acc[0], scale, o + 0);
    store_px(acc[1], scale, o + 1);
    store_px(acc[2], scale, o + 2);
}

// Bilinear warp from a pre-inverted (dst->src) affine. Per output row the
// source coords are linear in x, so the row is split into [border |
// interior | border]: the interior span (2x2 stencil fully inside) runs
// branch-free in float — the hot path for person crops, which are
// interior for all but a few edge rows.
template <typename OutT>
EPK_INLINE void warp_one_inv(const uint8_t* src, int sw, int sh,
                             const double* inv, OutT* dst, int dw, int dh,
                             float scale) {
    for (int y = 0; y < dh; ++y) {
        const double sx0 = inv[1] * y + inv[2];
        const double sy0 = inv[4] * y + inv[5];
        // x-interval where sx in [0, sw-2] AND sy in [0, sh-2]
        double xa = 0.0, xb = static_cast<double>(dw);
        auto clip = [&xa, &xb](double a, double b, double hi) {
            if (b > 1e-12) {
                xa = std::max(xa, (0.0 - a) / b);
                xb = std::min(xb, (hi - a) / b);
            } else if (b < -1e-12) {
                xa = std::max(xa, (hi - a) / b);
                xb = std::min(xb, (0.0 - a) / b);
            } else if (a < 0.0 || a > hi) {
                xa = 1.0; xb = 0.0;
            }
        };
        clip(sx0, inv[0], sw - 2.000001);
        clip(sy0, inv[3], sh - 2.000001);
        int xi0 = static_cast<int>(std::ceil(std::max(0.0, xa)));
        int xi1 = static_cast<int>(std::floor(std::min(
            static_cast<double>(dw), xb)));
        if (xi1 < xi0) { xi0 = 0; xi1 = 0; }

        OutT* orow = dst + static_cast<size_t>(y) * dw * 3;
        for (int x = 0; x < xi0; ++x)
            sample_checked(src, sw, sh, inv[0] * x + sx0, inv[3] * x + sy0,
                           scale, orow + x * 3);
        const size_t stride = static_cast<size_t>(sw) * 3;
        for (int x = xi0; x < xi1; ++x) {
            const float sx = static_cast<float>(inv[0] * x + sx0);
            const float sy = static_cast<float>(inv[3] * x + sy0);
            const int x0 = static_cast<int>(sx);
            const int y0 = static_cast<int>(sy);
            const float fx = sx - x0, fy = sy - y0;
            const float w00 = (1.f - fx) * (1.f - fy), w01 = fx * (1.f - fy);
            const float w10 = (1.f - fx) * fy, w11 = fx * fy;
            const uint8_t* p0 = src + (static_cast<size_t>(y0) * sw + x0) * 3;
            const uint8_t* p1 = p0 + stride;
            OutT* o = orow + x * 3;
            store_px(w00 * p0[0] + w01 * p0[3] + w10 * p1[0] + w11 * p1[3],
                     scale, o + 0);
            store_px(w00 * p0[1] + w01 * p0[4] + w10 * p1[1] + w11 * p1[4],
                     scale, o + 1);
            store_px(w00 * p0[2] + w01 * p0[5] + w10 * p1[2] + w11 * p1[5],
                     scale, o + 2);
        }
        for (int x = xi1; x < dw; ++x)
            sample_checked(src, sw, sh, inv[0] * x + sx0, inv[3] * x + sy0,
                           scale, orow + x * 3);
    }
}

// The scale_num (of 8) for a dst->src affine: with the crop shrinking by
// s source px per dst px, decoding at ceil(8/s)/8 keeps the effective
// shrink >= 1 while cutting IDCT work by ~s^2. Engaged only for s >= 2 so
// near-native crops keep bit-parity with full decodes.
EPK_INLINE int pick_scale_num(const double* inv) {
    const double rx = std::hypot(inv[0], inv[1]);
    const double ry = std::hypot(inv[3], inv[4]);
    const double shrink = std::min(rx, ry);
    if (shrink < 2.0) return 8;
    int num = static_cast<int>(std::ceil(8.0 / shrink));
    return num < 1 ? 1 : (num > 8 ? 8 : num);
}

// remap dst->src coords onto the DCT-scaled pixel grid:
// x_scaled = (x_full + 0.5) * (w/full_w) - 0.5
EPK_INLINE void remap_to_scaled(double* inv, int w, int h, int full_w,
                                int full_h) {
    if (w == full_w && h == full_h) return;
    const double rx = static_cast<double>(w) / full_w;
    const double ry = static_cast<double>(h) / full_h;
    inv[0] *= rx; inv[1] *= rx; inv[2] = inv[2] * rx + 0.5 * rx - 0.5;
    inv[3] *= ry; inv[4] *= ry; inv[5] = inv[5] * ry + 0.5 * ry - 0.5;
}

// One frame: decode (at the scale its affine allows), remap, warp into
// ``out``; 1 (and a zero crop) when the decode fails.
template <typename OutT>
EPK_INLINE int decode_warp_frame(const uint8_t* jpeg, size_t size,
                                 const float* M, int dw, int dh, OutT* out,
                                 float scale) {
    std::vector<uint8_t> img;
    int w = 0, h = 0, full_w = 0, full_h = 0;
    double inv[6];
    invert_affine(M, inv);
    if (decode_one(jpeg, size, img, w, h, pick_scale_num(inv), full_w,
                   full_h) != 0) {
        std::memset(out, 0, sizeof(OutT) * dh * dw * 3);
        return 1;
    }
    remap_to_scaled(inv, w, h, full_w, full_h);
    warp_one_inv(img.data(), w, h, inv, out, dw, dh, scale);
    return 0;
}

EPK_FMA_CLONES int frame_f32(const uint8_t* jpeg, size_t size,
                             const float* M, int dw, int dh, float* out,
                             float scale) {
    return decode_warp_frame(jpeg, size, M, dw, dh, out, scale);
}

EPK_FMA_CLONES int frame_u8(const uint8_t* jpeg, size_t size,
                            const float* M, int dw, int dh, uint8_t* out) {
    return decode_warp_frame(jpeg, size, M, dw, dh, out, 1.0f);
}

// Decode once at the LESS aggressive of the two affines' scales, warp
// twice.
EPK_FMA_CLONES int frame_dual(const uint8_t* jpeg, size_t size,
                              const float* M1, const float* M2, int dw1,
                              int dh1, int dw2, int dh2, uint8_t* o1,
                              uint8_t* o2) {
    std::vector<uint8_t> img;
    int w = 0, h = 0, full_w = 0, full_h = 0;
    double inv1[6], inv2[6];
    invert_affine(M1, inv1);
    invert_affine(M2, inv2);
    const int snum = std::max(pick_scale_num(inv1), pick_scale_num(inv2));
    if (decode_one(jpeg, size, img, w, h, snum, full_w, full_h) != 0) {
        std::memset(o1, 0, static_cast<size_t>(dh1) * dw1 * 3);
        std::memset(o2, 0, static_cast<size_t>(dh2) * dw2 * 3);
        return 1;
    }
    remap_to_scaled(inv1, w, h, full_w, full_h);
    remap_to_scaled(inv2, w, h, full_w, full_h);
    warp_one_inv(img.data(), w, h, inv1, o1, dw1, dh1, 1.0f);
    warp_one_inv(img.data(), w, h, inv2, o2, dw2, dh2, 1.0f);
    return 0;
}

EPK_FMA_CLONES void warp_image(const uint8_t* src, int sw, int sh,
                               const float* M, float* out, int dw, int dh,
                               float scale) {
    double inv[6];
    invert_affine(M, inv);
    warp_one_inv(src, sw, sh, inv, out, dw, dh, scale);
}

}  // namespace

extern "C" {

// Fused batch pipeline: jpeg bytes -> decode -> warp -> float32 crops
// scaled by ``scale``. jpegs: array of n pointers; sizes: n byte counts;
// Ms: n*6 src->dst affines; out: n*dh*dw*3 floats. Returns the number of
// failed decodes.
int decode_warp_batch(const uint8_t** jpegs, const size_t* sizes, int n,
                      const float* Ms, int dw, int dh, float* out,
                      float scale) {
    int failures = 0;
#pragma omp parallel for schedule(dynamic) reduction(+ : failures)
    for (int i = 0; i < n; ++i)
        failures += frame_f32(jpegs[i], sizes[i], Ms + size_t(i) * 6, dw, dh,
                              out + size_t(i) * dh * dw * 3, scale);
    return failures;
}

// Same pipeline, uint8 crops (round-to-nearest): 4x fewer bytes to copy on
// the host and to ship to the device.
int decode_warp_batch_u8(const uint8_t** jpegs, const size_t* sizes, int n,
                         const float* Ms, int dw, int dh, uint8_t* out) {
    int failures = 0;
#pragma omp parallel for schedule(dynamic) reduction(+ : failures)
    for (int i = 0; i < n; ++i)
        failures += frame_u8(jpegs[i], sizes[i], Ms + size_t(i) * 6, dw, dh,
                             out + size_t(i) * dh * dw * 3);
    return failures;
}

// Decode ONCE, warp TWICE (uint8 out): the self-supervised dual crop, a
// clean teacher crop (Ms1) and an augmented student crop (Ms2) of the
// same frame. DCT scaling uses the LESS aggressive of the two affines'
// shrink factors so both crops keep full-decode quality parity. The two
// crops may have different output sizes (a half-size teacher crop).
int decode_warp2_sized_batch_u8(const uint8_t** jpegs, const size_t* sizes,
                                int n, const float* Ms1, const float* Ms2,
                                int dw1, int dh1, int dw2, int dh2,
                                uint8_t* out1, uint8_t* out2) {
    int failures = 0;
#pragma omp parallel for schedule(dynamic) reduction(+ : failures)
    for (int i = 0; i < n; ++i)
        failures += frame_dual(jpegs[i], sizes[i], Ms1 + size_t(i) * 6,
                               Ms2 + size_t(i) * 6, dw1, dh1, dw2, dh2,
                               out1 + size_t(i) * dh1 * dw1 * 3,
                               out2 + size_t(i) * dh2 * dw2 * 3);
    return failures;
}

int decode_warp2_batch_u8(const uint8_t** jpegs, const size_t* sizes, int n,
                          const float* Ms1, const float* Ms2,
                          int dw, int dh, uint8_t* out1, uint8_t* out2) {
    return decode_warp2_sized_batch_u8(jpegs, sizes, n, Ms1, Ms2,
                                       dw, dh, dw, dh, out1, out2);
}

// Batch warp of pre-decoded uint8 RGB images (all same size).
void warp_batch_u8(const uint8_t* src, int n, int sw, int sh,
                   const float* Ms, int dw, int dh, float* out,
                   float scale) {
#pragma omp parallel for schedule(static)
    for (int i = 0; i < n; ++i)
        warp_image(src + size_t(i) * sh * sw * 3, sw, sh, Ms + size_t(i) * 6,
                   out + size_t(i) * dh * dw * 3, dw, dh, scale);
}

// out[0]: failed decodes; out[s]: decodes at scale s/8, s in 1..8; out[9]:
// failures of a mode libjpeg refuses too; out[10]: decodes with a libjpeg
// warning (since the last reset)
void epk_loader_counts(int64_t* out) {
    for (int s = 0; s < kCountSlots; ++s)
        out[s] = g_counts[s].load(std::memory_order_relaxed);
}

void epk_loader_reset_counts() {
    for (auto& c : g_counts) c.store(0, std::memory_order_relaxed);
}

}  // extern "C"
