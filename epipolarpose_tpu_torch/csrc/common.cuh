// Shared helpers of the kernel library: 16-byte vector loads and stores of
// bf16/f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Number of elements of T in one 16-byte load.
template <typename T> struct Vec16;
template <> struct Vec16<float> { static constexpr int N = 4; };
template <> struct Vec16<__nv_bfloat16> { static constexpr int N = 8; };

// Load Vec16<T>::N consecutive elements from a 16-byte aligned address and
// widen them to float.
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Narrow Vec16<T>::N floats to T and store them at a 16-byte aligned address.
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(p) = q;
}
