// y = x @ w with per-column BatchNorm statistics in the epilogue.
//
// Replaces the TPU kernel tools/profile_step.py::fused_matmul_stats (the
// pl.pallas_call at :152). x (M, K) and w (K, N) are row-major bf16; y
// (M, N) is bf16, rounded from an f32 accumulator; stats (2, N) f32 holds,
// per column, sum(y) and sum(y*y) of the f32 ACCUMULATOR (as the Pallas
// kernel sums it, not the bf16-rounded y).
//
// What bounds it: the 15 ResNet-50 1x1-conv shapes of the tool need
// 2*M*K*N operations and (M*K + K*N + M*N)*2 bytes. At 3.35 TB/s and 989
// bf16 TFLOP/s the 10 shapes with M >= 32768 (but 32768 x 512 x 1024) are
// bound by the bytes: x streams in, y streams out, and y's bytes equal or
// exceed x's on the 524288-row shapes. The 8192-row shapes and 32768 x
// 512 x 1024 are bound by the tensor cores.
//
// Two routes; the wrapper (kernels/matmul_stats.py::route) picks one by a
// fixed rule, never on a failure:
//
// epk_matmul_stats (the tool's shapes): a persistent, warp-specialised
// Hopper kernel.
// - Loads: one producer thread issues TMA copies (cp.async.bulk.tensor,
//   128-byte swizzle) of a 128 x 64 x tile and a 64 x BN w tile into a ring
//   of 6-8 shared-memory stages guarded by full/empty mbarriers, so loads
//   run ahead of the tensor cores and the epilogue. x is K-major for
//   wgmma's A; w (K, N) is MN-major for B and is read through the
//   descriptor's transpose bit, with no transposed copy.
// - Products: two consumer warpgroups, 64 rows each, run
//   wgmma.mma_async m64nBNk16 (bf16 in, f32 accumulate) straight from the
//   swizzled stages, with one commit group kept in flight.
// - Tiles: BN = 64 up to N = 128, else 128 (on the card, 256-wide tiles
//   were slower on 14 of the 15 shapes: fewer tiles to spread over the
//   SMs, 4 stages instead of 6). A block keeps one column tile and walks
//   M tiles (the TPU kernel's "M innermost" grid); the column tiles of one
//   M tile are neighbouring block indices, so they run together and share
//   x through L2. w stays in L2.
// - Stats: taken from the accumulator registers. Each thread adds its two
//   rows per column; per 64-column box, a three-step butterfly of
//   __shfl_xor over the lanes that share a column halves the values at
//   each step, and each thread keeps 2 column sums per box in registers
//   across all the block's M tiles. The block reduces its warps through
//   shared memory once and writes a (2, BN) partial to a scratch buffer;
//   matmul_stats_finish (a programmatic dependent launch) sums the
//   partials in a fixed order into stats. stats is written, not
//   accumulated: no zeroing launch, and two calls give equal bits.
// - Epilogue: the accumulator is rounded to bf16 into two swizzled
//   staging buffers taken in turn per 64-column box, each stored by TMA
//   (shared -> global) while the next box is written and the producer
//   already loads the next tile. Rows past M load as zeros (they add
//   nothing to the stats) and their stores are clipped by the tensor map.
// The tensor maps are encoded on the host (cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint, so nothing links libcuda) and passed as
// __grid_constant__ kernel parameters.
//
// epk_matmul_stats_simt: what TMA cannot describe (K or N not a multiple
// of 8, a base address not 16-byte aligned, K = 0). A tiled kernel: a
// 128x64 output tile per block of 4 warps, 32-deep bf16 tiles of x and w
// in shared memory, WMMA 16x16x16 fragments (mma.sync), masked ragged
// edges, and two atomics per column and block into stats, which the
// caller zeroes.

#include <cuda.h>
#include <mma.h>

#include "common.cuh"

namespace {

namespace simt {

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
matmul_stats_simt_kernel(const __nv_bfloat16* __restrict__ x,
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

}  // namespace simt

namespace hopper {

constexpr int BM = 128;                 // rows of a tile: two warpgroups of 64
constexpr int BK = 64;                  // k per stage: one 128-byte swizzle row
constexpr int kConsumers = 256;         // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
constexpr int kSmemLimit = 232448;      // dynamic shared memory of a block
constexpr int kAlign = 1024;            // a 128-byte swizzle atom: 8 rows
constexpr int kBarrierBytes = 256;
constexpr int kMaxDevices = 64;

constexpr int cmin(int a, int b) { return a < b ? a : b; }

constexpr int kYBufs = 2;               // y staging buffers, 128 x 64 each

// Shared-memory plan of a block with BN columns: a ring of stages (x tile,
// then BN / 64 boxes of 64 k x 64 n of w), then kYBufs y staging buffers
// of 128 rows x 64 columns that the 64-column boxes of y take in turn,
// then the mbarriers.
template <int BN> struct Tile {
  static constexpr int kX = BM * BK * 2;
  static constexpr int kWBox = BK * 64 * 2;
  static constexpr int kStage = kX + (BN / 64) * kWBox;
  static constexpr int kYBox = BM * 64 * 2;
  static constexpr int kY = kYBufs * kYBox;
  static constexpr int kStages =
      cmin(8, (kSmemLimit - kAlign - kBarrierBytes - kY) / kStage);
  static constexpr int kSmem = kAlign + kStages * kStage + kY + kBarrierBytes;
  static constexpr int kAcc = BN / 2;   // f32 accumulators of a thread
  static constexpr int kKept = BN / 32; // its column sums, 2 per 64 columns
  static_assert(kStages >= 6 && kSmem <= kSmemLimit, "shared memory plan");
  static_assert(2 * kStages * 8 <= kBarrierBytes, "mbarrier space");
  static_assert(8 * 2 * BN * 4 <= kY, "the stats reduction reuses y's tile");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// TMA: the box at (c0 innermost, c1) of `map` into shared memory at `dst`,
// completing `bytes` on the mbarrier `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0),
      "r"(c1) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of the committed stores have not yet read their
// shared memory.
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Barrier over `count` threads of the consumer warpgroups (id 0 is
// __syncthreads').
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
template <int R> __device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64 x N, f32 registers) (+)= A(64 x 16, K-major) B(16 x N, MN-major),
// bf16, from shared-memory descriptors. accumulate = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}


template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t a,
                                           uint64_t b, int accumulate) {
  if constexpr (BN == 64) wgmma_m64n64(d, a, b, accumulate);
  else wgmma_m64n128(d, a, b, accumulate);
}

// One butterfly step over the lanes `mask` apart, which hold the same
// columns: a lane keeps one half of its 2H values (the upper half where its
// `mask` bit is set), adds its partner's copy of that half, and hands over
// the other half. v[0, H) then holds the kept sums.
template <int H>
__device__ __forceinline__ void fold(float* v, int mask, bool upper) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float keep = upper ? v[i + H] : v[i];
    const float send = upper ? v[i] : v[i + H];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// Grid: blocks b = 0..gridDim.x-1, gridDim.x a multiple of n_tiles. Block
// b owns column tile b % n_tiles and M tiles b / n_tiles, + gridDim.x /
// n_tiles, ...; it writes its (2, BN) stats partial to part[b].
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
matmul_stats_wgmma(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap ty,
                   float* __restrict__ part, int M, int K, int n_tiles) {
  using T = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1);
  const uint32_t y_smem = base + T::kStages * T::kStage;
  const uint32_t full0 = y_smem + T::kY;           // full[s]: full0 + 8 s
  const uint32_t empty0 = full0 + 8 * T::kStages;  // empty[s]: empty0 + 8 s
  float* red = reinterpret_cast<float*>(smem_raw + (y_smem - raw));

  const int m_tiles = (M + BM - 1) / BM;
  const int k_blocks = (K + BK - 1) / BK;
  const int m_first = blockIdx.x / n_tiles;
  const int m_step = gridDim.x / n_tiles;
  const int n0 = (blockIdx.x % n_tiles) * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);                // the producer's arrival
      mbar_init(empty0 + 8 * s, kConsumers / 32); // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= kConsumers) {
    // Producer warpgroup: one thread keeps the ring full.
    if (threadIdx.x == kConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      for (int mt = m_first; mt < m_tiles; mt += m_step) {
        for (int kb = 0; kb < k_blocks; ++kb) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t xs = base + stage * T::kStage;
          mbar_expect_tx(full, T::kStage);
          tma_load(xs, &tx, full, kb * BK, mt * BM);
#pragma unroll
          for (int i = 0; i < BN / 64; ++i)
            tma_load(xs + T::kX + i * T::kWBox, &tw, full, n0 + 64 * i,
                     kb * BK);
          if (++stage == T::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumer warpgroups: rows 64 wg .. 64 wg + 63 of each tile.
    const int wg = threadIdx.x / 128;
    const int warp = threadIdx.x / 32;
    const int row = (warp % 4) * 16 + lane / 4;  // and row + 8, of the 64
    const bool leader = threadIdx.x % 128 == 0;
    float acc[T::kAcc];
    float sum[T::kKept], sq[T::kKept];
#pragma unroll
    for (int i = 0; i < T::kKept; ++i) sum[i] = sq[i] = 0.f;
    int stage = 0, y_box = 0;
    uint32_t phase = 0;
    for (int mt = m_first; mt < m_tiles; mt += m_step) {
      int prev = 0;
      for (int kb = 0; kb < k_blocks; ++kb) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t xs = base + stage * T::kStage + wg * (64 * BK * 2);
        const uint32_t ws = base + stage * T::kStage + T::kX;
        pin(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // A: +32 bytes per 16 k inside the swizzled 128-byte rows; 8-row
          // groups 1024 bytes apart. B: +16 rows of 128 bytes per 16 k;
          // 8-row groups 1024 bytes apart, 64-column boxes kWBox apart.
          wgmma_tile<BN>(acc, smem_desc(xs + kk * 32, 16, 1024),
                         smem_desc(ws + kk * 16 * 128, T::kWBox, 1024),
                         kb > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        pin(acc);
        if (kb > 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
        prev = stage;
        if (++stage == T::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      pin(acc);
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);

      // y, per 64-column box: bf16 into the next swizzled staging buffer
      // once the store that used it last has read it, then one TMA store
      // (a commit group of its own). A thread holds rows (row, row + 8)
      // and columns 8 j + 2 (lane % 4) + {0, 1}.
#pragma unroll
      for (int box = 0; box < BN / 64; ++box, ++y_box) {
        const uint32_t buf =
            y_smem + (y_box % kYBufs) * T::kYBox + wg * 64 * 128;
        if (leader) bulk_wait_read<kYBufs - 1>();
        named_sync(1 + wg, 128);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * box + jj;
          const uint32_t at =
              buf + row * 128 + ((jj ^ (row % 8)) * 16) + (lane % 4) * 4;
          st_shared(at, pack_bf16(acc[4 * j], acc[4 * j + 1]));
          st_shared(at + 8 * 128, pack_bf16(acc[4 * j + 2], acc[4 * j + 3]));
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_sync(1 + wg, 128);
        if (leader) {
          tma_store(&ty, buf, n0 + 64 * box, mt * BM + 64 * wg);
          bulk_commit();
        }
      }

      // stats of the f32 accumulator, per 64-column box: a thread's two
      // rows, then the lanes with the same lane % 4 (bits 4, 3, 2 of the
      // lane), which leaves 2 column sums of the box in each lane.
#pragma unroll
      for (int box = 0; box < BN / 64; ++box) {
        float s[16], q[16];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 8 * box + jj;
            const float a = acc[4 * j + e], b = acc[4 * j + 2 + e];
            s[2 * jj + e] = a + b;
            q[2 * jj + e] = fmaf(a, a, b * b);
          }
        }
        fold<8>(s, 16, lane & 16);
        fold<8>(q, 16, lane & 16);
        fold<4>(s, 8, lane & 8);
        fold<4>(q, 8, lane & 8);
        fold<2>(s, 4, lane & 4);
        fold<2>(q, 4, lane & 4);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          sum[2 * box + i] += s[i];
          sq[2 * box + i] += q[i];
        }
      }
    }

    // The finishing kernel may start its launch (it waits for this grid).
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    // The block's partial: the 8 consumer warps through shared memory (the
    // staging buffers, once the last store has read them), in a fixed order.
    if (leader) bulk_wait_all();
    named_sync(3, kConsumers);
    // sum[2 box + i] holds box-local value p = 8 b4 + 4 b3 + 2 b2 + i
    // (b: lane bits), column 64 box + 8 (p / 2) + 2 (lane % 4) + p % 2.
    const int hi = ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 +
                   ((lane >> 2) & 1) * 2;
#pragma unroll
    for (int i = 0; i < T::kKept; ++i) {
      const int p = hi + i % 2;
      const int col = 64 * (i / 2) + 8 * (p / 2) + 2 * (lane % 4) + p % 2;
      red[(warp * 2 + 0) * BN + col] = sum[i];
      red[(warp * 2 + 1) * BN + col] = sq[i];
    }
    named_sync(3, kConsumers);
    for (int c = threadIdx.x; c < 2 * BN; c += kConsumers) {
      const int st = c / BN, col = c % BN;
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kConsumers / 32; ++w) t += red[(w * 2 + st) * BN + col];
      part[static_cast<long long>(blockIdx.x) * 2 * BN + c] = t;
    }
  }
}

// stats[s, c] = sum over the blocks b of column tile c / bn, in order, of
// part[b, s, c % bn]. Launched as a programmatic dependent of the main
// kernel: it waits here until that grid has finished and its writes show.
__global__ void matmul_stats_finish(const float* __restrict__ part,
                                    float* __restrict__ stats, int N, int bn,
                                    int n_tiles, int blocks) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= 2 * N) return;
  const int st = c / N, col = c % N;
  float t = 0.f;
  for (int b = col / bn; b < blocks; b += n_tiles)
    t += part[(static_cast<long long>(b) * 2 + st) * bn + col % bn];
  stats[c] = t;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major bf16 (rows, cols) matrix in boxes of box_rows x box_cols,
// 128-byte swizzled; reads past its edges give zeros, stores are clipped.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rows,
            int cols, int box_rows, int box_cols) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& tw,
                   const CUtensorMap& ty, float* part, int M, int K,
                   int n_tiles, int grid, int device, cudaStream_t stream) {
  static bool opted_in[kMaxDevices] = {};  // the attribute, per device
  if (device >= kMaxDevices || !opted_in[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        matmul_stats_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile<BN>::kSmem);
    if (e != cudaSuccess) return e;
    if (device < kMaxDevices) opted_in[device] = true;
  }
  matmul_stats_wgmma<BN><<<grid, kThreads, Tile<BN>::kSmem, stream>>>(
      tx, tw, ty, part, M, K, n_tiles);
  return cudaGetLastError();
}

}  // namespace hopper

}  // namespace

// The Hopper route. part holds grid x 2 x bn floats; grid is a multiple of
// ceil(N / bn); bn is 64 or 128 (kernels/matmul_stats.py::wgmma_plan).
// K and N are multiples of 8 and x, w, y 16-byte aligned
// (kernels/matmul_stats.py::route). device: the CUDA device of the tensors
// and the stream (this library's runtime keeps its own current device,
// apart from PyTorch's).
extern "C" int epk_matmul_stats(const void* x, const void* w, void* y,
                                void* stats, void* part, int M, int K, int N,
                                int bn, int grid, int device, void* stream) {
  using namespace hopper;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (bn != 64 && bn != 128) return cudaErrorInvalidValue;
  const int n_tiles = (N + bn - 1) / bn;
  if (M <= 0 || K <= 0 || N <= 0 || grid <= 0 || grid % n_tiles != 0)
    return cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tx, tw, ty;
  if (!encode(fn, &tx, x, M, K, BM, BK) || !encode(fn, &tw, w, K, N, BK, 64) ||
      !encode(fn, &ty, y, M, N, 64, 64))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  cudaError_t e;
  if (bn == 64)
    e = launch<64>(tx, tw, ty, p, M, K, n_tiles, grid, device, s);
  else
    e = launch<128>(tx, tw, ty, p, M, K, n_tiles, grid, device, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((2 * N + 255) / 256);
  cfg.blockDim = dim3(256);
  cfg.stream = s;
  cudaLaunchAttribute early[1];
  early[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = early;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, matmul_stats_finish, static_cast<const float*>(p),
      static_cast<float*>(stats), N, bn, n_tiles, grid));
}

// The SIMT route; the caller zeroes stats.
extern "C" int epk_matmul_stats_simt(const void* x, const void* w, void* y,
                                     void* stats, int M, int K, int N,
                                     int device, void* stream) {
  using namespace simt;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_stats_simt_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(stats), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
