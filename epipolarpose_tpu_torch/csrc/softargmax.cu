// Soft-argmax forward over integral-regression volumes, one pass.
//
// Replaces the TPU kernel epipolarpose_tpu/ops/pallas/softargmax.py
// (fused_softmax_integral, forward half; removed in da6785a) for the live
// function epipolarpose_tpu/ops/integral.py::softmax_integral.
//
// Input: logits (N, J*D, H, W), contiguous, bf16 or f32. Channel j*D + d is
// depth bin d of joint j, so each joint's (D, H, W) volume is one contiguous
// row of L = D*H*W elements. Output: (N*J, 3) f32 normalized (x, y, z) in
// [-0.5, 0.5), z = 0 when D == 1.
//
// Bound: reading the volume once (0.57 GB in bf16 for batch 64 of the
// 17x64x64x64 flagship head, ~0.17 ms at 3.35 TB/s); the exp and four
// accumulations per element are below the card's arithmetic rates. So the
// design reads each element once with 16-byte loads, several in flight per
// thread, and keeps nothing but five running values per thread:
// (m, Z, sum e*x, sum e*y, sum e*z) with an online max that rescales by
// exp(m_old - m_new). A 16-byte chunk lies inside one W-row (W is a multiple
// of the chunk length, checked by the wrapper), so x, y and z of a chunk
// come from one index split; x sums become w0*sum(e) + sum(e*i).
// One block per (n, j) row; the partials merge with warp shuffles, then
// across warps through shared memory.

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
                      int D, int H, int W) {
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
      const float ml = acc.m * kLog2e;
      float se = 0.f, si = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float e = exp2f(fmaf(v[u][i], kLog2e, -ml));
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
      float* o = out + 3ll * blockIdx.x;
      o[0] = acc.sx / acc.z / W - 0.5f;
      o[1] = acc.sy / acc.z / H - 0.5f;
      o[2] = D > 1 ? acc.sz / acc.z / D - 0.5f : 0.f;
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. rows = N * J. device: the CUDA device
// of the tensors and the stream (this library's runtime keeps its own
// current device, apart from PyTorch's).
extern "C" int epk_softargmax_fwd(const void* logits, void* out, int dtype,
                                  int rows, int D, int H, int W, int device,
                                  void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    softargmax_fwd_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), static_cast<float*>(out),
        D, H, W);
  } else if (dtype == 0) {
    softargmax_fwd_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(logits), static_cast<float*>(out), D, H,
        W);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
