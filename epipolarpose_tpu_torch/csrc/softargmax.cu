// Soft-argmax over integral-regression volumes: forward and backward.
//
// Replaces the TPU kernel epipolarpose_tpu/ops/pallas/softargmax.py
// (fused_softmax_integral, removed in da6785a): the forward pass (its
// _run_fwd) and the backward pass (its _bwd / _bwd_kernel), for the live
// function epipolarpose_tpu/ops/integral.py::softmax_integral.
//
// Input: logits (N, J*D, H, W), contiguous, bf16 or f32. Channel j*D + d is
// depth bin d of joint j, so each joint's (D, H, W) volume is one contiguous
// row of L = D*H*W elements. Forward output: (N*J, 3) f32 normalized
// (x, y, z) in [-0.5, 0.5), z = 0 when D == 1; optionally (N*J, 4) f32
// statistics (lse = M + ln Z, Ex, Ey, Ez in index units) for the backward.
//
// Forward bound: reading the volume once (0.57 GB in bf16 for batch 64 of
// the 17x64x64x64 flagship head, ~0.17 ms at 3.35 TB/s); the exp and four
// accumulations per element are below the card's arithmetic rates. So the
// design reads each element once with 16-byte loads, several in flight per
// thread, and keeps nothing but five running values per thread:
// (m, Z, sum e*x, sum e*y, sum e*z) with an online max that rescales by
// exp(m_old - m_new). A 16-byte chunk lies inside one W-row (W is a multiple
// of the chunk length, checked by the wrapper), so x, y and z of a chunk
// come from one index split; x sums become w0*sum(e) + sum(e*i).
// One block per (n, j) row; the partials merge with warp shuffles, then
// across warps through shared memory.
//
// Backward: with p = exp(l - lse) and the incoming gradient g = (gx, gy, gz)
// of a row, dl[d,h,w] = p * (a*w + b*h + c*d + r), where a = gx/W, b = gy/H,
// c = gz/D (0 when D == 1) and r = -(a*Ex + b*Ey + c*Ez). It is elementwise
// with per-row coefficients, bound by reading the logits and writing dlogits
// once (0.57 GB in bf16 at batch 32 of the flagship head, ~0.17 ms). Each
// block streams a slice of one row with 16-byte loads and stores, four in
// flight per thread, so the grid fills the card whatever the row count.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr float kLog2e = 1.4426950408889634f;

struct Acc {
  float m, z, sx, sy, sz;
};

// Merge partial b into a (both relative to their own running max).
__device__ __forceinline__ void merge(Acc& a, const Acc& b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return;  // both empty
  const float sa = exp2f((a.m - m) * kLog2e);  // exp2(-inf) = 0
  const float sb = exp2f((b.m - m) * kLog2e);
  a.z = a.z * sa + b.z * sb;
  a.sx = a.sx * sa + b.sx * sb;
  a.sy = a.sy * sa + b.sy * sb;
  a.sz = a.sz * sa + b.sz * sb;
  a.m = m;
}

__device__ __forceinline__ Acc shfl_down(const Acc& a, int off) {
  Acc b;
  b.m = __shfl_down_sync(0xffffffffu, a.m, off);
  b.z = __shfl_down_sync(0xffffffffu, a.z, off);
  b.sx = __shfl_down_sync(0xffffffffu, a.sx, off);
  b.sy = __shfl_down_sync(0xffffffffu, a.sy, off);
  b.sz = __shfl_down_sync(0xffffffffu, a.sz, off);
  return b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
softargmax_fwd_kernel(const T* __restrict__ logits, float* __restrict__ out,
                      float* __restrict__ stats, int D, int H, int W) {
  constexpr int V = Vec16<T>::N;
  const int L = D * H * W;
  const int n_chunks = L / V;
  const int chunks_per_row = W / V;
  const T* row = logits + static_cast<long long>(blockIdx.x) * L;

  Acc acc = {-INFINITY, 0.f, 0.f, 0.f, 0.f};
  for (int base = threadIdx.x; base < n_chunks; base += kThreads * kUnroll) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = base + u * kThreads;
      if (c < n_chunks) load16(row + static_cast<long long>(c) * V, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = base + u * kThreads;
      if (c >= n_chunks) break;
      float cmax = v[u][0];
#pragma unroll
      for (int i = 1; i < V; ++i) cmax = fmaxf(cmax, v[u][i]);
      if (cmax > acc.m) {
        const float s = exp2f((acc.m - cmax) * kLog2e);
        acc.z *= s; acc.sx *= s; acc.sy *= s; acc.sz *= s;
        acc.m = cmax;
      }
      // subtract the max first: exact near it (Sterbenz), where
      // fmaf(v, log2e, -m*log2e) keeps the rounding of m*log2e, up to half
      // its spacing, as an exponent (exp2 of it overflows for |m| ~ 1e9)
      float se = 0.f, si = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float e = exp2f((v[u][i] - acc.m) * kLog2e);
        se += e;
        si = fmaf(e, static_cast<float>(i), si);
      }
      const int w0 = (c % chunks_per_row) * V;
      const int hd = c / chunks_per_row;  // d * H + h
      const int h = hd % H;
      const int d = hd / H;
      acc.z += se;
      acc.sx += fmaf(static_cast<float>(w0), se, si);
      acc.sy = fmaf(static_cast<float>(h), se, acc.sy);
      acc.sz = fmaf(static_cast<float>(d), se, acc.sz);
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) merge(acc, shfl_down(acc, off));

  __shared__ Acc warp_acc[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_acc[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_acc[lane]
                               : Acc{-INFINITY, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) merge(acc, shfl_down(acc, off));
    if (lane == 0) {
      const float ex = acc.sx / acc.z, ey = acc.sy / acc.z,
                  ez = acc.sz / acc.z;
      float* o = out + 3ll * blockIdx.x;
      o[0] = ex / W - 0.5f;
      o[1] = ey / H - 0.5f;
      o[2] = D > 1 ? ez / D - 0.5f : 0.f;
      if (stats != nullptr) {
        float* st = stats + 4ll * blockIdx.x;
        st[0] = acc.m + logf(acc.z);
        st[1] = ex;
        st[2] = ey;
        st[3] = ez;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
softargmax_bwd_kernel(const T* __restrict__ logits,
                      const float* __restrict__ stats,
                      const float* __restrict__ grad, T* __restrict__ dlogits,
                      int blocks_per_row, int D, int H, int W) {
  constexpr int V = Vec16<T>::N;
  const int L = D * H * W;
  const int n_chunks = L / V;
  const int chunks_per_row = W / V;
  const int row = blockIdx.x / blocks_per_row;
  const int first = (blockIdx.x % blocks_per_row) * (kThreads * kUnroll);
  const long long offset = static_cast<long long>(row) * L;

  const float* st = stats + 4ll * row;
  const float* g = grad + 3ll * row;
  const float a = g[0] / W, b = g[1] / H, c = D > 1 ? g[2] / D : 0.f;
  const float r = -(a * st[1] + b * st[2] + c * st[3]);
  const float lse = st[0];

  float v[kUnroll][V];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int ch = first + u * kThreads + threadIdx.x;
    if (ch < n_chunks) {
      load16(logits + offset + static_cast<long long>(ch) * V, v[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int ch = first + u * kThreads + threadIdx.x;
    if (ch >= n_chunks) break;
    const int w0 = (ch % chunks_per_row) * V;
    const int hd = ch / chunks_per_row;  // d * H + h
    const int h = hd % H;
    const int d = hd / H;
    const float base = fmaf(a, static_cast<float>(w0),
                            fmaf(b, static_cast<float>(h),
                                 fmaf(c, static_cast<float>(d), r)));
    float dl[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float p = exp2f((v[u][i] - lse) * kLog2e);  // as the forward
      dl[i] = p * fmaf(a, static_cast<float>(i), base);
    }
    store16(dlogits + offset + static_cast<long long>(ch) * V, dl);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. rows = N * J. stats: (rows, 4) f32 or
// null (the eval path skips the write). device: the CUDA device of the
// tensors and the stream (this library's runtime keeps its own current
// device, apart from PyTorch's).
extern "C" int epk_softargmax_fwd(const void* logits, void* out, void* stats,
                                  int dtype, int rows, int D, int H, int W,
                                  int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    softargmax_fwd_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), static_cast<float*>(out),
        static_cast<float*>(stats), D, H, W);
  } else if (dtype == 0) {
    softargmax_fwd_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(logits), static_cast<float*>(out),
        static_cast<float*>(stats), D, H, W);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward: dlogits (same shape and dtype as logits) from the logits, the
// forward's (rows, 4) statistics and the (rows, 3) f32 gradient of the
// normalized coordinates. Arguments as for epk_softargmax_fwd.
extern "C" int epk_softargmax_bwd(const void* logits, const void* stats,
                                  const void* grad, void* dlogits, int dtype,
                                  int rows, int D, int H, int W, int device,
                                  void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = dtype == 1 ? Vec16<__nv_bfloat16>::N : Vec16<float>::N;
  const long long n_chunks = static_cast<long long>(D) * H * W / vec;
  const long long per_block = kThreads * kUnroll;
  const long long blocks_per_row = (n_chunks + per_block - 1) / per_block;
  const long long blocks = blocks_per_row * rows;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const int bpr = static_cast<int>(blocks_per_row);
  const auto* st = static_cast<const float*>(stats);
  const auto* g = static_cast<const float*>(grad);
  if (dtype == 1) {
    softargmax_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), st, g,
        static_cast<__nv_bfloat16*>(dlogits), bpr, D, H, W);
  } else if (dtype == 0) {
    softargmax_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(logits), st, g,
        static_cast<float*>(dlogits), bpr, D, H, W);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
