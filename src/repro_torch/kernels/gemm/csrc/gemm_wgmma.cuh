// The 16-bit routes of the hand-written GEMM on the tensor cores
// (bf16_wgmma and f16_wgmma): wgmma fed by TMA, shared by csrc/gemm.cu and
// the chain kernel through gemm_routes.cuh.  One tile loop for both element
// types: WgElem<T> below holds what they differ in (wgmma's operand type,
// TMA's data type); everything else, the tiles, the ring, the swizzle and
// the epilogue, is the same code, since both types are 2 bytes wide.
//
// What bounds it on an H100: the 16-bit tensor cores (989 TFLOP/s) are so
// fast that a 1024^3 product (2.1 GFLOP, 2.2 us at peak) is bounded in
// practice by how quickly tiles reach shared memory and by the latency of
// each K step, not by arithmetic.  So the design keeps the loads out of
// the threads' way: one thread issues TMA copies (cp.async.bulk.tensor)
// for a ring of four stages ahead, an mbarrier per stage says when a
// stage has landed, and the warpgroup spends its time in wgmma.
//
// wgmma_tile: one block is one warpgroup (128 threads) and owns a 64x128
// output tile (1024^2 gives 128 blocks).  A K step of 64 is one stage:
// a 64x64 panel of A (K-major, as it lies) and two 64x64 panels of B (B
// is K x N row-major, so N-major: wgmma's transposed-B form), each written
// by TMA in the 128-byte swizzle that wgmma reads.  Per stage the
// warpgroup issues 4 k16 steps of two m64n64k16 instructions (bf16 or f16
// operands from shared memory, fp32 accumulators in registers), waits for
// them, and the stage goes back to the loader.  The ragged edge is TMA's
// zero fill.  The epilogue adds C in fp32 and rounds once to the input
// type, or to the output type the GEMM's caller asked for (gemm_tile.cuh
// store_level).
//
// TMA needs a 16-byte-aligned base and row strides that are multiples of
// 16 bytes: gemm_routes.cuh sends other operands to the CUDA-core route.
// The tensor maps are 3-D (columns, rows, levels), so a chain's per-level
// operands are one map and the level is a coordinate.

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "gemm_tile.cuh"

namespace bind_gemm {

// What the two element types of the tile loop differ in.  F16: wgmma's
// operands are .f16 (else .bf16); TMA: the tensor maps' data type.
template <typename T> struct WgElem;
template <> struct WgElem<__nv_bfloat16> {
  static constexpr bool F16 = false;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <> struct WgElem<__half> {
  static constexpr bool F16 = true;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

constexpr int WG_BM = 64;
constexpr int WG_BN = 128;
constexpr int WG_BK = 64;
constexpr int WG_STAGES = 4;
constexpr int WG_THREADS = 128;
constexpr int WG_PANEL = 64 * 64 * 2;                 // bytes of one box
constexpr int WG_STAGE = 3 * WG_PANEL;                // A, B[:, :64], B[:, 64:]
constexpr size_t WG_SMEM =
    1024 + WG_STAGES * WG_STAGE + WG_STAGES * sizeof(uint64_t);

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// waits for the barrier's phase ``parity`` to complete; a copy that never
// lands (a bad tensor map) traps after about a second instead of hanging
// the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 28)) asm volatile("trap;\n");
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle: start, leading and
// stride byte offsets in 16-byte units
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator accesses across a fence
__device__ __forceinline__ void wg_pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define BIND_WG_D8(o)                                                     \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),          \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// d (64x64, fp32) += A (64x16, K-major) @ B (16x64, N-major), A and B of
// type T ("bf16" or "f16" in the instruction, the operand list the same)
template <typename T>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
#define BIND_WG_N64(ty)                                                   \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." ty "." ty " "         \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"                 \
      : BIND_WG_D8(0), BIND_WG_D8(8), BIND_WG_D8(16), BIND_WG_D8(24)      \
      : "l"(da), "l"(db), "r"(1))
  if constexpr (WgElem<T>::F16) BIND_WG_N64("f16"); else BIND_WG_N64("bf16");
#undef BIND_WG_N64
}

#undef BIND_WG_D8

// ---- the tile loop ------------------------------------------------------------

// All WG_THREADS threads call it, with WG_SMEM bytes of dynamic shared
// memory at ``smem``.  ta: A as (K, M, levels), tb: B as (N, K, levels);
// T is __nv_bfloat16 or __half.
template <typename T, typename O = T>
__device__ __forceinline__ void wgmma_tile(
    const CUtensorMap* ta, const CUtensorMap* tb, const Problem<T, O>& p,
    unsigned char* smem) {
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + WG_STAGES * WG_STAGE);
  const int tid = threadIdx.x;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * WG_BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * WG_BN;
  const int64_t nk = (p.K + WG_BK - 1) / WG_BK;
  const int64_t total = nk * p.L;

  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // panel t (level t / nk, K step t % nk) into stage s, by thread 0
  auto issue = [&](int64_t t, int s) {
    const int64_t l = t / nk;
    const int k0 = static_cast<int>((t - l * nk) * WG_BK);
    const int la = p.a_stride != 0 ? static_cast<int>(l) : 0;
    const int lb = p.b_stride != 0 ? static_cast<int>(l) : 0;
    unsigned char* st = ring + s * WG_STAGE;
    mbar_expect(&full[s], WG_STAGE);
    tma_load(st, ta, &full[s], k0, static_cast<int>(m0), la);
    tma_load(st + WG_PANEL, tb, &full[s], static_cast<int>(n0), k0, lb);
    tma_load(st + 2 * WG_PANEL, tb, &full[s], static_cast<int>(n0) + 64, k0,
             lb);
  };
  if (tid == 0)
    for (int s = 0; s < WG_STAGES && s < total; ++s) issue(s, s);

  float acc[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.0f;

  const int warp = tid / 32;
  const int lane = tid % 32;
  int64_t ck = 0, cl = 0;
  for (int64_t t = 0; t < total; ++t) {
    const int s = static_cast<int>(t % WG_STAGES);
    mbar_wait(&full[s], static_cast<uint32_t>((t / WG_STAGES) & 1));
    const uint32_t a_addr = smem_addr(ring + s * WG_STAGE);
    wg_pin(acc[0]);
    wg_pin(acc[1]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      // A: 8-row groups 1024 bytes apart, k16 = 32 bytes into the row;
      // B: 8-row (K) groups 1024 bytes apart, k16 = 16 rows = 2048 bytes
      const uint64_t da = wg_desc(a_addr + kk * 32, 16, 1024);
      const uint64_t db0 =
          wg_desc(a_addr + WG_PANEL + kk * 2048, WG_PANEL, 1024);
      const uint64_t db1 =
          wg_desc(a_addr + 2 * WG_PANEL + kk * 2048, WG_PANEL, 1024);
      wgmma_n64<T>(acc[0], da, db0);
      wgmma_n64<T>(acc[1], da, db1);
    }
    wg_commit();
    wg_wait_all();
    wg_pin(acc[0]);
    wg_pin(acc[1]);
    __syncthreads();   // the whole warpgroup is done reading stage s
    if (tid == 0 && t + WG_STAGES < total) issue(t + WG_STAGES, s);
    if (++ck == nk) {
      // d[4j + i]: row 16 warp + lane / 4 + 8 (i / 2), col 8j + 2 (lane % 4)
      // + i % 2, in each 64-column half h
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int j = r / 4;
          const int i = r % 4;
          const int64_t gm = m0 + warp * 16 + lane / 4 + 8 * (i / 2);
          const int64_t gn = n0 + h * 64 + 8 * j + 2 * (lane % 4) + i % 2;
          if (gm < p.M && gn < p.N) store_level(p, cl, gm, gn, acc[h][r]);
          acc[h][r] = 0.0f;
        }
      }
      ck = 0;
      ++cl;
    }
  }
}

// ---- host side: the tensor maps ---------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no
// -lcuda); NULL when the driver has none
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// a (levels, rows, cols) row-major array of 16-bit elements of TMA type
// `type` (WgElem<T>::TMA for the GEMM, bf16 or f16) read in boxes of 64
// columns by box_rows rows with the 128-byte swizzle; level_stride in
// elements (0: the levels lie back to back)
inline cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType type,
                            const void* base, int64_t rows, int64_t cols,
                            int64_t levels, int64_t level_stride,
                            int box_rows = 64) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(cols) * 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(levels)};
  const cuuint64_t strides[2] = {
      row_bytes, level_stride != 0
                     ? static_cast<cuuint64_t>(level_stride) * 2
                     : row_bytes * static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, type, 3, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace bind_gemm
