// Batched multi-view DLT triangulation with the closed-form adjugate solver.
//
// The port's kernel for epipolarpose_tpu/geometry/triangulation.py::
// triangulate(..., method="fast") (lines 125-160): an op XLA fuses into one
// program on the TPU, and not a pl.pallas_call. In eager PyTorch the same
// solve is dozens of small launches (two 4x4 adjugates of 16 3x3
// determinants each, norms, argmax, where, products), so one kernel does it
// all: one thread per (frame, joint) point, everything in f32 registers.
//
// Per point, with V views (2..8, a template parameter so that every loop
// unrolls and the 2V x 4 system lives in registers):
//   1. rows x*P[2] - P[0] (the V x rows) and y*P[2] - P[1] (the V y rows),
//      each divided by (its norm + 1e-12), then times the view's weight;
//   2. M = A^T A;
//   3. v = the largest-norm column of adj(M) (the first of equal norms),
//      over (its norm + 1e-30);
//   4. one Rayleigh-shifted step: lam = v.M.v, w = adj(M - (lam - 1e-7) I) v,
//      kept as w / (|w| + 1e-30) only where |w| > 1e-12;
//   5. v times sign(v3) (v3 == 0 counts as +), X = v[:3] / v3 with |v3|
//      clamped to 1e-12; residual |A v|.
// These are the rules of the plain version (geometry/triangulation.py),
// step by step; results differ from it only by rounding (the compiler may
// fuse a multiply and an add into one FMA where torch rounds twice).
//
// Bound: per point V*(2+1) input floats, 4 output floats and about
// 106V + 600 f32 operations (the two adjugates dominate), so at V = 4 about
// 64 bytes against 1,000 operations: bytes and operations take about the
// same time on the card (67 TFLOP/s f32, 3.35 TB/s), some tens of
// microseconds for 10^6 points; at the SS step's 544 points the launch
// itself sets the time. The design reads each point's 2V coordinates and V
// weights once (neighbouring threads hold neighbouring joints, so a warp's
// loads of one view are contiguous), keeps P in shared memory when all
// frames share it (read through the cache when each frame has its own),
// and writes X and the residual once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxViews = 8;

// Determinant of the 3x3 minor of m without row r and column c, in the
// plain version's order: a0*(b1*d2 - b2*d1) - a1*(b0*d2 - b2*d0)
// + a2*(b0*d1 - b1*d0).
__device__ __forceinline__ float minor3(const float m[4][4], int r, int c) {
  int rows[3], cols[3];
  int nr = 0, nc = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i != r) rows[nr++] = i;
    if (i != c) cols[nc++] = i;
  }
  const float* a = m[rows[0]];
  const float* b = m[rows[1]];
  const float* d = m[rows[2]];
  const float a0 = a[cols[0]], a1 = a[cols[1]], a2 = a[cols[2]];
  const float b0 = b[cols[0]], b1 = b[cols[1]], b2 = b[cols[2]];
  const float d0 = d[cols[0]], d1 = d[cols[1]], d2 = d[cols[2]];
  return a0 * (b1 * d2 - b2 * d1) - a1 * (b0 * d2 - b2 * d0) +
         a2 * (b0 * d1 - b1 * d0);
}

// adj[i][k] = (-1)^(i+k) * minor(k, i): the transposed cofactor matrix.
__device__ __forceinline__ void adjugate4(const float m[4][4],
                                          float adj[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float cof = minor3(m, r, c);
      adj[c][r] = ((r + c) & 1) ? -cof : cof;
    }
  }
}

__device__ __forceinline__ float norm4(const float v[4]) {
  return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3]);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
triangulate_kernel(const float* __restrict__ pts,   // (N, V, J, 2)
                   const float* __restrict__ P,     // (V,3,4) or (N,V,3,4)
                   int p_per_frame,
                   const float* __restrict__ wts,   // (N, V, J) or null
                   float* __restrict__ X,           // (N, J, 3)
                   float* __restrict__ res,         // (N, J)
                   int N, int J) {
  __shared__ float sP[kMaxViews * 12];
  if (!p_per_frame) {
    for (int i = threadIdx.x; i < V * 12; i += blockDim.x) sP[i] = P[i];
    __syncthreads();
  }
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= static_cast<long long>(N) * J) return;
  const int n = static_cast<int>(t / J);
  const int j = static_cast<int>(t % J);
  const float* p = p_per_frame ? P + static_cast<long long>(n) * V * 12 : sP;

  // 1. the normalized, weighted rows: A[v] the x row, A[V + v] the y row
  float A[2 * V][4];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const long long at = (static_cast<long long>(n) * V + v) * J + j;
    const float2 xy = __ldg(reinterpret_cast<const float2*>(pts) + at);
    const float w = wts ? __ldg(wts + at) : 1.0f;
    const float* pv = p + v * 12;
    float r0[4], r1[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float p0 = pv[c], p1 = pv[4 + c], p2 = pv[8 + c];
      r0[c] = xy.x * p2 - p0;
      r1[c] = xy.y * p2 - p1;
    }
    const float n0 = norm4(r0) + 1e-12f;
    const float n1 = norm4(r1) + 1e-12f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      A[v][c] = wts ? (r0[c] / n0) * w : r0[c] / n0;
      A[V + v][c] = wts ? (r1[c] / n1) * w : r1[c] / n1;
    }
  }

  // 2. M = A^T A
  float M[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < 2 * V; ++r) s += A[r][a] * A[r][b];
      M[a][b] = s;
    }
  }

  // 3. the largest-norm column of adj(M), the first of equal norms
  float B[4][4];
  adjugate4(M, B);
  int best = 0;
  float best_norm = -1.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float cn = sqrtf(B[0][c] * B[0][c] + B[1][c] * B[1][c] +
                           B[2][c] * B[2][c] + B[3][c] * B[3][c]);
    if (cn > best_norm) {
      best_norm = cn;
      best = c;
    }
  }
  float vec[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) vec[r] = B[r][best];
  {
    const float nv = norm4(vec) + 1e-30f;
#pragma unroll
    for (int r = 0; r < 4; ++r) vec[r] /= nv;
  }

  // 4. one Rayleigh-shifted adjugate step
  float Mv[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    Mv[a] = M[a][0] * vec[0] + M[a][1] * vec[1] + M[a][2] * vec[2] +
            M[a][3] * vec[3];
  }
  const float lam = vec[0] * Mv[0] + vec[1] * Mv[1] + vec[2] * Mv[2] +
                    vec[3] * Mv[3];
  const float shift = lam - 1e-7f;
  float S[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) S[a][b] = M[a][b] - (a == b ? shift : 0.0f);
  }
  adjugate4(S, B);
  float wv[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    wv[a] = B[a][0] * vec[0] + B[a][1] * vec[1] + B[a][2] * vec[2] +
            B[a][3] * vec[3];
  }
  const float nw = norm4(wv);
  if (nw > 1e-12f) {
#pragma unroll
    for (int a = 0; a < 4; ++a) vec[a] = wv[a] / (nw + 1e-30f);
  }

  // 5. sign, dehomogenize, residual
  const float sgn = vec[3] < 0.0f ? -1.0f : 1.0f;
#pragma unroll
  for (int a = 0; a < 4; ++a) vec[a] *= sgn;
  const float den = fabsf(vec[3]) < 1e-12f ? 1e-12f : vec[3];
  float* x = X + t * 3;
  x[0] = vec[0] / den;
  x[1] = vec[1] / den;
  x[2] = vec[2] / den;
  float r2 = 0.0f;
#pragma unroll
  for (int r = 0; r < 2 * V; ++r) {
    const float e = A[r][0] * vec[0] + A[r][1] * vec[1] + A[r][2] * vec[2] +
                    A[r][3] * vec[3];
    r2 += e * e;
  }
  res[t] = sqrtf(r2);
}

template <int V>
cudaError_t launch(const float* pts, const float* P, int p_per_frame,
                   const float* w, float* X, float* res, int N, int J,
                   cudaStream_t s) {
  const long long points = static_cast<long long>(N) * J;
  const long long blocks = (points + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  triangulate_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      pts, P, p_per_frame, w, X, res, N, J);
  return cudaGetLastError();
}

}  // namespace

// X (N, J, 3) and residual (N, J), f32, from undistorted points (N, V, J, 2),
// projection matrices (V, 3, 4) shared by all frames (p_per_frame = 0) or
// (N, V, 3, 4) (p_per_frame = 1), and per-view weights (N, V, J) or a null
// pointer for none. All f32 and contiguous; 2 <= V <= 8. Launches on
// `stream` of `device`; returns cudaGetLastError().
extern "C" int epk_triangulate(const void* pts, const void* P,
                               int p_per_frame, const void* weights, void* X,
                               void* residual, int N, int V, int J,
                               int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float*>(pts);
  const auto* pm = static_cast<const float*>(P);
  const auto* w = static_cast<const float*>(weights);
  auto* x = static_cast<float*>(X);
  auto* r = static_cast<float*>(residual);
  cudaError_t e;
  switch (V) {
    case 2: e = launch<2>(p, pm, p_per_frame, w, x, r, N, J, s); break;
    case 3: e = launch<3>(p, pm, p_per_frame, w, x, r, N, J, s); break;
    case 4: e = launch<4>(p, pm, p_per_frame, w, x, r, N, J, s); break;
    case 5: e = launch<5>(p, pm, p_per_frame, w, x, r, N, J, s); break;
    case 6: e = launch<6>(p, pm, p_per_frame, w, x, r, N, J, s); break;
    case 7: e = launch<7>(p, pm, p_per_frame, w, x, r, N, J, s); break;
    case 8: e = launch<8>(p, pm, p_per_frame, w, x, r, N, J, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
