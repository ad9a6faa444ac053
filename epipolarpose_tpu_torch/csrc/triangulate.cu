// Batched multi-view DLT triangulation with the closed-form adjugate solver.
//
// The port's kernel for epipolarpose_tpu/geometry/triangulation.py::
// triangulate(..., method="fast") (lines 125-160): an op XLA fuses into one
// program on the TPU, and not a pl.pallas_call. In eager PyTorch the same
// solve is dozens of small launches (two 4x4 adjugates, norms, argmax,
// where, products), so one kernel does it all, in registers.
//
// Per point, with V views (2..8, a template parameter so that every loop
// unrolls):
//   1. rows x*P[2] - P[0] (the V x rows) and y*P[2] - P[1] (the V y rows),
//      each scaled by w / (its norm + 1e-12), w the view's weight (1 if
//      none);
//   2. M = A^T A (symmetric: 10 entries);
//   3. v = the largest-norm column of adj(M) (the first of equal norms,
//      compared squared: the square root is monotonic), over (its norm +
//      1e-30);
//   4. one Rayleigh-shifted step: lam = v.M.v, w = adj(M - (lam - 1e-7) I) v,
//      kept as w / (|w| + 1e-30) only where |w| > 1e-12;
//   5. v times sign(v3) (v3 == 0 counts as +), X = v[:3] / v3 with |v3|
//      clamped to 1e-12; residual |A v|, taken as sqrt(v.M.v).
// These are the rules of the plain version (geometry/triangulation.py),
// step by step; the results differ from it by rounding only.
//
// Precision. The rows are f32, as in the plain version. In millimetres
// A^T A spans some eight decades (the homogeneous column against the rest),
// and an f32 M and an f32 adjugate of M - sI amplify rounding into
// millimetres of X where views disagree (the plain version: tens of mm
// from the same solver in f64 at 10^6 points). So M is summed in f64 (the
// products of f32 rows are exact there) and the Rayleigh step, which fixes
// the answer, runs in f64; the first adjugate only picks a start vector
// and runs in f32 on M rounded to f32. The kernel lands within about 1 mm
// of the f64 solver there.
//
// Bound: per point V*(2+1) input floats and 4 output floats (64 bytes at
// V = 4): about 21 us for 10^6 points at 3.35 TB/s. The kernel is bound by
// the instructions it issues and by latency, so it issues few: rsqrt for
// the row norms (the 1e-12 is below f32 rounding there; the exact form
// below 1e-4) and the unit vectors, one reciprocal for the
// dehomogenization, no IEEE division; each adjugate from twelve
// 2x2 determinants shared by its cofactors (Laplace expansion over rows
// 0-1 or 2-3), only its lower triangle, since M and M - sI are symmetric:
// 54 operations where 16 separate 3x3 minors take 224. It keeps no row
// after adding it to M (the residual comes from M), so a thread holds 53
// to 72 registers (62 at V = 4, one thread a point: 8 blocks an SM).
//
// Two layouts (the wrapper's route picks one from the number of points):
//   L = 1, one thread a point, for large batches: X is staged through
//     shared memory so that each warp writes its 32 points' X with one
//     16-byte store a lane;
//   L = 4, four lanes a point, for small batches, where the launch and one
//     thread's serial chain set the time: the lanes split the views (each
//     builds its rows and its part of M, summed over the four by shuffles:
//     every lane ends with the same bits of M) and then all four solve the
//     same 4x4 problem, so the per-view part of the chain is cut to one
//     view at V = 4.
// P is staged in shared memory when all frames share it; per-frame P (the
// SS step's case) is read through the cache by the points of a frame.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxViews = 8;
constexpr unsigned kFull = 0xffffffffu;

// 2x2 determinant of rows p, p + 1 and columns k, l of m.
template <typename R>
__device__ __forceinline__ R det2(const R m[4][4], int p, int k, int l) {
  return m[p][k] * m[p + 1][l] - m[p][l] * m[p + 1][k];
}

// Entry (i, c) of adj(m): (-1)^(i+c) times the minor without row c and
// column i, expanded along row c ^ 1 over the 2x2 determinants of the two
// rows left (rows 2, 3 for c < 2, rows 0, 1 otherwise). With compile-time
// i and c the compiler computes each of the 12 determinants once.
template <typename R>
__device__ __forceinline__ R adj_entry(const R m[4][4], int i, int c) {
  const int e = c ^ 1;
  const int p = c < 2 ? 2 : 0;
  const int k0 = i == 0 ? 1 : 0;
  const int k1 = i <= 1 ? 2 : 1;
  const int k2 = i <= 2 ? 3 : 2;
  const R minor = m[e][k0] * det2(m, p, k1, k2) -
                  m[e][k1] * det2(m, p, k0, k2) +
                  m[e][k2] * det2(m, p, k0, k1);
  return ((i + c) & 1) ? -minor : minor;
}

// adj(m) of a symmetric m: the lower triangle, mirrored.
template <typename R>
__device__ __forceinline__ void adjugate_sym(const R m[4][4], R b[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c <= i; ++c) {
      b[i][c] = adj_entry(m, i, c);
      b[c][i] = b[i][c];
    }
  }
}

template <typename R>
__device__ __forceinline__ R dot4(const R a[4], const R b[4]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3];
}

// Sum of x over the L lanes of a point: every lane gets the same bits
// (each step adds a pair in either order, and addition commutes).
template <int L, typename R>
__device__ __forceinline__ R lane_sum(R x) {
#pragma unroll
  for (int o = 1; o < L; o <<= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// 1 / (sqrt(ss) + 1e-12): rsqrt where the 1e-12 is below f32 rounding
// (sqrt(ss) > 1e-4), the exact form below.
__device__ __forceinline__ float inv_norm(float ss) {
  return ss > 1e-8f ? rsqrtf(ss) : 1.0f / (sqrtf(ss) + 1e-12f);
}

// kPerFrame: P is (N, V, 3, 4), else (V, 3, 4) for all frames (a template
// parameter, so that neither path issues the other's loads)
template <int V, int L, bool kPerFrame>
__global__ void __launch_bounds__(kThreads)
triangulate_kernel(const float* __restrict__ pts,   // (N, V, J, 2)
                   const float* __restrict__ P,
                   const float* __restrict__ wts,   // (N, V, J) or null
                   float* __restrict__ X,           // (N, J, 3)
                   float* __restrict__ res,         // (N, J)
                   unsigned points, int J) {
  static_assert(L == 1 || L == 4, "one or four lanes a point");
  constexpr int kOwn = (V + L - 1) / L;   // views a lane reads
  __shared__ __align__(16) float sP[kMaxViews * 12];
  if constexpr (!kPerFrame) {
    for (int i = threadIdx.x; i < V * 12; i += kThreads) sP[i] = P[i];
    __syncthreads();
  }
  // Every lane runs to the end (the shuffles name the whole warp); lanes
  // past the last point compute the last point again and store nothing.
  const unsigned q = threadIdx.x % L;
  const unsigned own = (blockIdx.x * kThreads + threadIdx.x) / L;
  const bool live = own < points;
  const unsigned t = live ? own : points - 1;
  const unsigned n = t / J;
  const unsigned j = t - n * J;

  // 1. this lane's rows (f32), normalized and weighted, summed into its
  // part of M (f64); the loads first
  float2 xy[kOwn];
  float wt[kOwn];
#pragma unroll
  for (int s = 0; s < kOwn; ++s) {
    const int v = static_cast<int>(q) + s * L;
    if (kOwn * L == V || v < V) {
      const size_t at = (static_cast<size_t>(n) * V + v) * J + j;
      xy[s] = __ldg(reinterpret_cast<const float2*>(pts) + at);
      wt[s] = wts ? __ldg(wts + at) : 1.0f;
    }
  }
  double m[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) m[a][b] = 0.0;
  }
#pragma unroll
  for (int s = 0; s < kOwn; ++s) {
    const int v = static_cast<int>(q) + s * L;
    if (kOwn * L != V && v >= V) continue;
    float p0[4], p1[4], p2[4];
    if constexpr (kPerFrame) {
      const float* pv = P + (static_cast<size_t>(n) * V + v) * 12;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p0[c] = __ldg(pv + c);
        p1[c] = __ldg(pv + 4 + c);
        p2[c] = __ldg(pv + 8 + c);
      }
    } else {
      const float4* pv = reinterpret_cast<const float4*>(sP + v * 12);
      const float4 a = pv[0], b = pv[1], d = pv[2];
      p0[0] = a.x; p0[1] = a.y; p0[2] = a.z; p0[3] = a.w;
      p1[0] = b.x; p1[1] = b.y; p1[2] = b.z; p1[3] = b.w;
      p2[0] = d.x; p2[1] = d.y; p2[2] = d.z; p2[3] = d.w;
    }
    float r0[4], r1[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      r0[c] = xy[s].x * p2[c] - p0[c];
      r1[c] = xy[s].y * p2[c] - p1[c];
    }
    const float f0 = wt[s] * inv_norm(dot4(r0, r0));
    const float f1 = wt[s] * inv_norm(dot4(r1, r1));
    double a0[4], a1[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      a0[c] = r0[c] * f0;
      a1[c] = r1[c] * f1;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b <= a; ++b) {
        m[a][b] += a0[a] * a0[b];
        m[a][b] += a1[a] * a1[b];
      }
    }
  }
  // 2. M, the same bits on every lane of the point; and M in f32
  float m32[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      m[a][b] = lane_sum<L>(m[a][b]);
      m[b][a] = m[a][b];
      m32[a][b] = m32[b][a] = static_cast<float>(m[a][b]);
    }
  }

  // 3. the largest-norm column of adj(M) (f32), the first of equal norms
  double vec[4];
  {
    float B[4][4];
    adjugate_sym(m32, B);
    int best = 0;
    float best_sq = -1.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float sq = B[0][c] * B[0][c] + B[1][c] * B[1][c] +
                       B[2][c] * B[2][c] + B[3][c] * B[3][c];
      if (sq > best_sq) {
        best_sq = sq;
        best = c;
      }
    }
    // 1 / (|column| + 1e-30): the 1e-30 is below f32 rounding for any
    // normal best_sq
    const float inv = best_sq > 1e-37f ? rsqrtf(best_sq)
                                       : 1.0f / (sqrtf(best_sq) + 1e-30f);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e = best == 0 ? B[r][0] : best == 1 ? B[r][1]
                    : best == 2 ? B[r][2] : B[r][3];
      vec[r] = e * inv;
    }
  }

  // 4. one Rayleigh-shifted adjugate step (f64); M becomes S = M - shift I
  double Mv[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) Mv[a] = dot4(m[a], vec);
  const double shift = dot4(vec, Mv) - 1e-7;
#pragma unroll
  for (int a = 0; a < 4; ++a) m[a][a] -= shift;
  float u[4];
  {
    double adj[4][4];
    adjugate_sym(m, adj);
    float w[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      u[a] = static_cast<float>(vec[a]);
      w[a] = static_cast<float>(dot4(adj[a], vec));
    }
    // |w| > 1e-12 as |w|^2 > 1e-24; there the 1e-30 is below f32 rounding
    const float w2 = dot4(w, w);
    if (w2 > 1e-24f) {
      const float inv = rsqrtf(w2);
#pragma unroll
      for (int a = 0; a < 4; ++a) u[a] = w[a] * inv;
    }
  }

  // 5. sign, dehomogenize (f32); residual |A u| = sqrt(u.S.u + shift u.u)
  const float sgn = u[3] < 0.0f ? -1.0f : 1.0f;
#pragma unroll
  for (int a = 0; a < 4; ++a) u[a] *= sgn;
  const float inv_den =
      __fdividef(1.0f, fabsf(u[3]) < 1e-12f ? 1e-12f : u[3]);
  const float x0 = u[0] * inv_den, x1 = u[1] * inv_den, x2 = u[2] * inv_den;
  double ud[4], Su[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) ud[a] = u[a];
#pragma unroll
  for (int a = 0; a < 4; ++a) Su[a] = dot4(m[a], ud);
  const double r2 = dot4(ud, Su) + shift * dot4(ud, ud);
  const float resid = sqrtf(static_cast<float>(r2 > 0.0 ? r2 : 0.0));

  if constexpr (L == 4) {
    // lanes 0-2 write X's components, lane 3 the residual: a warp's 8
    // points' X are 24 consecutive floats
    if (live) {
      if (q == 3) {
        res[t] = resid;
      } else {
        X[static_cast<size_t>(t) * 3 + q] = q == 0 ? x0 : q == 1 ? x1 : x2;
      }
    }
  } else {
    if (live) res[t] = resid;
    // the warp's 32 points' X through shared memory: 96 consecutive floats
    __shared__ __align__(16) float sX[kThreads * 3];
    const unsigned lane = threadIdx.x % 32;
    float* sx = sX + (threadIdx.x - lane) * 3;
    sx[lane * 3] = x0;
    sx[lane * 3 + 1] = x1;
    sx[lane * 3 + 2] = x2;
    __syncwarp();
    const unsigned first = own - lane;
    float* xw = X + static_cast<size_t>(first) * 3;
    if (first + 32 <= points) {
      if (lane < 24) {
        reinterpret_cast<float4*>(xw)[lane] =
            reinterpret_cast<const float4*>(sx)[lane];
      }
    } else {
      const unsigned count = first < points ? (points - first) * 3 : 0;
#pragma unroll
      for (unsigned k = lane; k < 96; k += 32) {
        if (k < count) xw[k] = sx[k];
      }
    }
  }
}

template <int L>
cudaError_t launch(const float* pts, const float* P, int p_per_frame,
                   const float* w, float* X, float* res, int N, int V, int J,
                   cudaStream_t s) {
  const long long points = static_cast<long long>(N) * J;
  // thread indices and point numbers are 32-bit
  if (points <= 0 || points * L > 0xffffffffll - kThreads)
    return cudaErrorInvalidValue;
  const unsigned blocks =
      static_cast<unsigned>((points * L + kThreads - 1) / kThreads);
  const unsigned p = static_cast<unsigned>(points);
  switch (V) {
#define EPK_CASE(v)                                                        \
  case v:                                                                  \
    if (p_per_frame) {                                                     \
      triangulate_kernel<v, L, true><<<blocks, kThreads, 0, s>>>(          \
          pts, P, w, X, res, p, J);                                        \
    } else {                                                               \
      triangulate_kernel<v, L, false><<<blocks, kThreads, 0, s>>>(         \
          pts, P, w, X, res, p, J);                                        \
    }                                                                      \
    break;
    EPK_CASE(2) EPK_CASE(3) EPK_CASE(4) EPK_CASE(5) EPK_CASE(6)
    EPK_CASE(7) EPK_CASE(8)
#undef EPK_CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int L>
int launch_on(const void* pts, const void* P, int p_per_frame,
              const void* weights, void* X, void* residual, int N, int V,
              int J, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return static_cast<int>(launch<L>(
      static_cast<const float*>(pts), static_cast<const float*>(P),
      p_per_frame, static_cast<const float*>(weights), static_cast<float*>(X),
      static_cast<float*>(residual), N, V, J,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

// X (N, J, 3) and residual (N, J), f32, from undistorted points (N, V, J, 2),
// projection matrices (V, 3, 4) shared by all frames (p_per_frame = 0) or
// (N, V, 3, 4) (p_per_frame = 1), and per-view weights (N, V, J) or a null
// pointer for none. All f32 and contiguous, X 16-byte aligned; 2 <= V <= 8;
// 1 <= N * J < 2^32 - 128. Launches on `stream` of `device`; returns
// cudaGetLastError(). One thread a point.
extern "C" int epk_triangulate(const void* pts, const void* P,
                               int p_per_frame, const void* weights, void* X,
                               void* residual, int N, int V, int J,
                               int device, void* stream) {
  return launch_on<1>(pts, P, p_per_frame, weights, X, residual, N, V, J,
                      device, stream);
}

// The same, four lanes a point (for small batches).
extern "C" int epk_triangulate_split(const void* pts, const void* P,
                                     int p_per_frame, const void* weights,
                                     void* X, void* residual, int N, int V,
                                     int J, int device, void* stream) {
  return launch_on<4>(pts, P, p_per_frame, weights, X, residual, N, V, J,
                      device, stream);
}
