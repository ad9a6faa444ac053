// y = x @ w with per-column BatchNorm statistics in the epilogue.
//
// Replaces the TPU kernel tools/profile_step.py::fused_matmul_stats
// (pl.pallas_call). x (M, K) and w (K, N) are row-major bf16; y (M, N) is
// bf16, rounded from an f32 accumulator; stats (2, N) f32 holds, per column,
// sum(y) and sum(y*y) of the f32 ACCUMULATOR (as the Pallas kernel sums it,
// not the bf16-rounded y). The caller zeroes stats.
//
// Bound: the 15 ResNet-50 1x1-conv shapes need 2*M*K*N operations and
// (M*K + K*N + M*N)*2 bytes; most are bound by the bytes, the widest ones
// (K, N >= 1024) by the tensor cores. This first version is a simple tiled
// kernel: a 128x64 output tile per block of 4 warps, 32-deep bf16 tiles of
// x and w in shared memory, WMMA 16x16x16 bf16 fragments accumulating in
// f32 (mma.sync on Hopper). The epilogue stages the f32 tile in shared
// memory (aliasing the input tiles), writes y with 16-byte stores, and adds
// each column's partial sums to stats with two atomics per column and
// block. The TPU kernel carried its stats tile across an in-order M grid;
// blocks here run in no order, so atomics take that role. Ragged M, N and K
// are masked (zero-filled loads, skipped stores). wgmma and TMA are left for
// a later version.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 128, BN = 64, BK = 32;
constexpr int kThreads = 128;           // 4 warps, 32 rows of the tile each
constexpr int LDA = BK + 8;             // padded smem strides (elements)
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;
constexpr int kTileBytes = (BM * LDA + BK * LDB) * 2;
constexpr int kEpiBytes = BM * LDC * 4;
constexpr int kSmemBytes = kTileBytes > kEpiBytes ? kTileBytes : kEpiBytes;

// Copy 8 consecutive bf16 of a row-major (rows, cols) matrix into smem,
// zero-filling what lies outside it.
__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ g,
                                      int rows, int cols, int r, int c,
                                      bool vec_ok, __nv_bfloat16* s) {
  if (vec_ok && r < rows && c + 8 <= cols) {
    *reinterpret_cast<uint4*>(s) =
        __ldg(reinterpret_cast<const uint4*>(g + static_cast<long long>(r) * cols + c));
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    s[i] = (r < rows && c + i < cols)
               ? g[static_cast<long long>(r) * cols + c + i]
               : __float2bfloat16(0.f);
  }
}

__global__ void __launch_bounds__(kThreads)
matmul_stats_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ stats,
                    int M, int K, int N) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int t = threadIdx.x, warp = t >> 5;
  const bool x_vec = (K % 8 == 0) && ((reinterpret_cast<uintptr_t>(x) & 15) == 0);
  const bool w_vec = (N % 8 == 0) && ((reinterpret_cast<uintptr_t>(w) & 15) == 0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: 128 rows x 4 chunks of 8; w tile: 32 rows x 8 chunks of 8
#pragma unroll
    for (int i = 0; i < (BM * BK / 8) / kThreads; ++i) {
      const int ch = t + i * kThreads, r = ch >> 2, c = (ch & 3) * 8;
      load8(x, M, K, m0 + r, k0 + c, x_vec, As + r * LDA + c);
    }
#pragma unroll
    for (int i = 0; i < (BK * BN / 8) / kThreads; ++i) {
      const int ch = t + i * kThreads, r = ch >> 3, c = (ch & 7) * 8;
      load8(w, K, N, k0 + r, n0 + c, w_vec, Bs + r * LDB + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (warp * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * LDB + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: f32 tile to smem (aliases As/Bs, free after the last sync).
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (warp * 32 + i * 16) * LDC + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  // y: 128 rows x 8 chunks of 8 columns, 8 chunks per thread.
  const bool y_vec = (N % 8 == 0) && ((reinterpret_cast<uintptr_t>(y) & 15) == 0);
#pragma unroll
  for (int i = 0; i < (BM * BN / 8) / kThreads; ++i) {
    const int ch = t + i * kThreads, r = ch >> 3, c = (ch & 7) * 8;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M) continue;
    const float* src = Cs + r * LDC + c;
    __nv_bfloat16* dst = y + static_cast<long long>(gm) * N + gn;
    if (y_vec && gn + 8 <= N) {
      uint4 q;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        h[k] = __floats2bfloat162_rn(src[2 * k], src[2 * k + 1]);
      *reinterpret_cast<uint4*>(dst) = q;
    } else {
      for (int k = 0; k < 8 && gn + k < N; ++k) dst[k] = __float2bfloat16(src[k]);
    }
  }

  // stats: thread t sums column t % 64 over one half of the tile's rows.
  const int c = t & (BN - 1), half = t / BN;
  if (n0 + c < N) {
    const int r_end = min(BM / 2, M - m0 - half * (BM / 2));
    float s = 0.f, q = 0.f;
    for (int r = 0; r < r_end; ++r) {
      const float v = Cs[(half * (BM / 2) + r) * LDC + c];
      s += v;
      q = fmaf(v, v, q);
    }
    atomicAdd(stats + n0 + c, s);
    atomicAdd(stats + N + n0 + c, q);
  }
}

}  // namespace

// device: the CUDA device of the tensors and the stream (this library's
// runtime keeps its own current device, apart from PyTorch's).
extern "C" int epk_matmul_stats(const void* x, const void* w, void* y,
                                void* stats, int M, int K, int N, int device,
                                void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_stats_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(stats), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
