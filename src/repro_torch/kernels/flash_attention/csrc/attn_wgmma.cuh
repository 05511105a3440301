// The 16-bit routes of flash attention on the tensor cores, bfloat16
// (bf16_wgmma) and float16 (f16_wgmma): wgmma fed by TMA, in the shape of
// FlashAttention-3, built from the pieces of the GEMM's tensor-core route
// (gemm/csrc/gemm_wgmma.cuh: the mbarrier helpers, TMA tensor maps, wgmma
// descriptors, the transposed-B form).  One set of kernels serves both,
// the element type T a template parameter; Elem<T> (below) holds all that
// differs: wgmma's operand type (.bf16 / .f16), the packing of two fp32
// values into one register (P, dS, the outputs) and TMA's data type.  The
// layouts, swizzles, descriptors and fragments are those of any 16-bit
// type: both instantiations run the same instructions on their own
// operand type.
//
// What bounds it on an H100: operations.  Causal prefill at S = 8192 does
// 4 d Hq visible-pairs FLOP (687 GFLOP at Qwen3-14B width) against a few
// hundred MB of q, k, v and out, far above the ridge point of the bf16
// tensor cores (989 TFLOP/s).  Next to them, the softmax is the scarce
// part: one exp2 per score on the 16 MUFU lanes of an SM costs half as
// many cycles as the two products of that score on the tensor cores, and
// the threads that run it cannot issue wgmma meanwhile.  So the design
// keeps the tensor cores and the softmax out of each other's way:
//   * two warpgroups of 64 query rows each (BQ = 128) share K and V tiles
//     that TMA brings into a ring of STAGES stages, each with a "full"
//     mbarrier (the copy landed).  While one warpgroup runs its softmax,
//     the other's wgmma keeps the tensor cores busy.  There is no producer
//     warp: the block's Q tile and the first STAGES tiles are issued at the
//     start, and each later tile by the warpgroup that is second to be
//     done with the stage it goes to (a count per stage in shared memory,
//     odd for the second).  Registers decide this: an SM's 64K registers
//     are four banks of 16K, one per scheduler, and warps are dealt to
//     them in turn, so a block of 9 to 12 warps (a producer warp or
//     warpgroup beside the two) may give a thread at most 168 registers,
//     and ptxas holds every thread to that budget (it does not raise it
//     after setmaxnreg); the consumers then spilled at d = 128 and 256 and
//     their wgmma was serialised.  At 8 warps a thread may hold 255, and
//     the accumulators (S: BKV / 2, O: d / 2, P: BKV / 4 a thread) fit;
//   * S = Q K^T with wgmma m64n{BKV}k16, Q and K both K-major (rows of d
//     contiguous, as they lie) in the 128-byte swizzle TMA writes, fp32
//     accumulators in registers.  BKV = 128 keys at d <= 128, 64 above
//     (the O accumulator takes d / 2 registers a thread);
//   * the online softmax on the accumulator fragment: a row of a wgmma
//     accumulator lies in the 4 lanes of a quad, so a row's max is two
//     shfl_xor (1, 2); the sum l stays a per-thread partial sum, reduced
//     once at the end.  m, l and the correction are fp32; 2^x is one MUFU
//     ex2 (subnormals flushed) with scale * log2(e) folded into the scores,
//     and O is rescaled only when some row of the warp saw its max move
//     (corr == 1 is exact).  A masked key gets -inf, so exactly p = 0; m
//     starts at -1e30 (finite), so a row that has seen no key keeps corr =
//     1 and l = 0, and a row that sees none gives zeros;
//   * O += P V with P in registers: the S accumulator, paired into bf16x2
//     (f16x2), is the A-operand register layout of a k16 step (registers
//     8 kk .. 8 kk + 7 of S are step kk's four A registers), so P never
//     goes through shared memory.  V is keys x d, N-major: the transposed-B
//     form, one m64n64k16 per 64-column panel of d (the last at N = d % 64
//     where d is no multiple of 64, below).  At the end O / l is rounded
//     once to bf16 (f16) and stored from registers;
//   * masks from the kernel's own tiles: the block loads only the key tiles
//     the mask leaves for its 128 rows (the causal t1 and windowed t0 of
//     flash_attention.cu); a consumer masks per element only a tile that
//     holds a diagonal, a window edge or the ragged end, and skips a tile
//     none of its 64 rows sees (it still waits for the tile and releases
//     it).  Keys past Skv and rows past Sq are TMA's zero fill, masked by
//     position (keys) or never stored (rows);
//   * scheduling: the grid is (batch x q heads, query tiles) with the query
//     tile counted from the last, so under causal masking the longest tiles
//     go first and the short ones fill the tail; the q heads of one kv head
//     run side by side, and L2 serves their shared K and V.
//
// Tolerance: P is rounded to bf16 before P V, where the reference keeps p
// in fp32.  Each p is in [0, 1] and moves by at most 2^-9 relative, so an
// output element moves by at most 2^-9 max|v| (relative to the row's
// weights, which sum to one); l is summed from the unrounded p.  That is
// about 2e-3 for unit-variance v, well inside the reference's bf16
// tolerance of 3e-2, which also covers rounding the output to bf16.  In
// float16 each p moves by at most 2^-11 relative (f16's unit roundoff)
// where it is normal (2^-14 and up), and by at most 2^-25 absolute below
// (f16's subnormals), so an output element by at most (2^-11 + Skv 2^-25)
// max|v|: 1.5 x 2^-11 max|v| at Skv 8192; l and O are fp32 as in bf16,
// and the output is rounded once to f16.  chip_smoke.py holds each type
// to limits derived from its unit roundoff.
//
// The log-sum-exp, on request: given a (B, Hq, Sq) float32 buffer, the
// block also stores each row's log-sum-exp of its scaled, masked scores in
// natural-log units, (m + log2 l) ln 2, once l is reduced (+inf for a row
// that sees no key, so that the backward's p is exactly 0 there).  Only a
// store is added: out is computed as without it.  The backward
// (attn_bwd_wgmma.cuh) reads it instead of sweeping the keys for it.
//
// Head dims that are no multiple of 64 (h2o-danube's 80, Phi-3-vision's
// 96): a row of d is ceil(d / 64) panels of 64 columns, and the last one
// holds d % 64 real columns.  The tensor maps give TMA the real row width
// d, so its 64-column box past d writes zeros into shared memory and reads
// no byte more (the full box still counts towards the mbarrier's bytes).
// Q K^T steps its k16 slices over the d real columns only (5 / 6 at d 80 /
// 96).  P V issues the last panel at N = d % 64 (m64n16k16 / m64n32k16):
// through the N-major descriptor of the full panel it reads the first
// 16 / 32 columns of each 128-byte swizzled row, which the swizzle keeps
// where TMA put them (the addresses are swizzled, not the panel); each
// output column is its own sum, so the real ones are those the panel at
// N = 64 over the zeros would give.  The accumulator keeps d 128's 64
// registers a thread, of which the last panel's unused ones hold nothing
// and are dropped by the compiler: with CUDA 12.8's ptxas the kernel takes
// 196 / 204 registers at d 80 / 96 (221 at d 128), for a quarter / a
// third less P V work than at N = 64.  No store writes a column past d.
//
// TMA needs 16-byte-aligned bases and rows of whole 16-byte units (d 80 /
// 96: 160 / 192 bytes): the routes (flash_attention.cu) take bf16 or f16
// with d one of wgmma_head_dim's (64, 80, 96, 128, 192, 256) and q, k, v,
// out 16-byte aligned, and send any other bf16 or f16 call to the
// CUDA-core loop (attn_tile.cuh).

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "../../gemm/csrc/gemm_wgmma.cuh"
#include "attn_tile.cuh"

namespace bind_attn_wg {

using bind_attn::Mask;
using bind_gemm::mbar_expect;
using bind_gemm::mbar_init;
using bind_gemm::mbar_wait;
using bind_gemm::smem_addr;
using bind_gemm::tma_load;
using bind_gemm::wg_commit;
using bind_gemm::wg_desc;
using bind_gemm::wg_fence;
using bind_gemm::wg_wait_all;

constexpr int BQ = 128;                 // query rows per block
constexpr int CONSUMERS = 2;            // warpgroups of 64 rows each
constexpr int THREADS = 128 * CONSUMERS;
constexpr int STAGES = 2;               // K and V tiles in flight

// the head dims the tensor-core routes of the forward and the backward
// take (route_of in flash_attention.cu and flash_attention_bwd.cu; ops.py
// WGMMA_HEAD_DIMS is the same set)
__host__ __device__ constexpr bool wgmma_head_dim(int64_t d) {
  return d == 64 || d == 80 || d == 96 || d == 128 || d == 192 || d == 256;
}

// 64-column panels of a row of d: the last one of d 80 / 96 holds 16 / 32
// real columns and TMA's zero fill past them
__host__ __device__ constexpr int panels(int d) { return (d + 63) / 64; }

// whether columns 64 p + 8 j .. + 7 of a panel's accumulator fragment are
// real (d is a multiple of 16, so the 8 columns are all real or all pad)
__host__ __device__ constexpr bool real_cols(int d, int p, int j) {
  return 64 * p + 8 * j < d;
}

template <int D> struct Cfg {
  static_assert(wgmma_head_dim(D), "d: 64, 80, 96, 128, 192, 256");
  static constexpr int BKV = D <= 128 ? 128 : 64;   // keys per tile
  static constexpr int PANELS = panels(D);          // 64-column panels
  static constexpr int Q_PANEL = BQ * 128;          // bytes of a Q panel
  static constexpr int KV_PANEL = BKV * 128;        // bytes of a K/V panel
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;
  static constexpr int BARRIERS = 1 + 2 * STAGES;   // q, k and v "full"
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES +
                                 BARRIERS * sizeof(uint64_t) +
                                 2 * STAGES * sizeof(unsigned int);
};

// What the two element types differ in.  F16: wgmma's operands are .f16
// (else .bf16); pack: two fp32 values rounded to a register of two
// elements, the A operand of a k16 step (P, dS); pair: the same for two
// neighbouring elements of an output; TMA: the tensor maps' data type.
template <typename T> struct Elem;

template <> struct Elem<__nv_bfloat16> {
  using Pair = __nv_bfloat162;
  static constexpr bool F16 = false;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ Pair pair(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
  static __device__ __forceinline__ float2 unpair(Pair v) {
    return __bfloat1622float2(v);
  }
};

template <> struct Elem<__half> {
  using Pair = __half2;
  static constexpr bool F16 = true;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ Pair pair(float lo, float hi) {
    return __floats2half2_rn(lo, hi);
  }
  static __device__ __forceinline__ float2 unpair(Pair v) {
    return __half22float2(v);
  }
};

// two neighbouring output elements at dst, each rounded once
template <typename T>
__device__ __forceinline__ void store2(T* dst, float lo, float hi) {
  *reinterpret_cast<typename Elem<T>::Pair*>(dst) = Elem<T>::pair(lo, hi);
}

// the problem of one launch; q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D)
struct Shape {
  int64_t hq, hkv, sq, skv;
  float scale_log2;      // scale * log2(e)
  Mask mask;
};

// ---- PTX wrappers -----------------------------------------------------------

// the 128 threads of warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// keeps the compiler from moving register accesses across a wgmma fence,
// commit or wait
template <int N> __device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N> __device__ __forceinline__ void pin(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define BIND_AW_D8(o)                                                     \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),          \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
// the instruction of shape `shape` on operands of type `ty` ("bf16" or
// "f16", each A and B element), fp32 accumulators
#define BIND_AW_OP(shape, ty)                                             \
  "wgmma.mma_async.sync.aligned." shape ".f32." ty "." ty " "

// d (64 x 64, fp32) = [d +] A (64 x 16, K-major, shared) B (16 x 64,
// K-major, shared), A and B of type T; accumulate: 0 overwrites d
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
#define BIND_AW_SS64(ty)                                                   \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                          \
      BIND_AW_OP("m64n64k16", ty)                                          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"                  \
      : BIND_AW_D8(0), BIND_AW_D8(8), BIND_AW_D8(16), BIND_AW_D8(24)       \
      : "l"(da), "l"(db), "r"(accumulate))
  if constexpr (Elem<T>::F16) BIND_AW_SS64("f16"); else BIND_AW_SS64("bf16");
#undef BIND_AW_SS64
}

// the same with 128 columns of B
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
#define BIND_AW_SS128(ty)                                                  \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                          \
      BIND_AW_OP("m64n128k16", ty)                                         \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "  \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "  \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, " \
      "1, 0, 0;\n}\n"                                                       \
      : BIND_AW_D8(0), BIND_AW_D8(8), BIND_AW_D8(16), BIND_AW_D8(24),      \
        BIND_AW_D8(32), BIND_AW_D8(40), BIND_AW_D8(48), BIND_AW_D8(56)     \
      : "l"(da), "l"(db), "r"(accumulate))
  if constexpr (Elem<T>::F16) BIND_AW_SS128("f16"); else BIND_AW_SS128("bf16");
#undef BIND_AW_SS128
}

// d (64 x 64, fp32) += A (64 x 16, pairs of T in registers) B (16 x 64,
// N-major, shared: the transposed-B form)
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
#define BIND_AW_RS64(ty)                                                   \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
      BIND_AW_OP("m64n64k16", ty)                                          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"    \
      : BIND_AW_D8(0), BIND_AW_D8(8), BIND_AW_D8(16), BIND_AW_D8(24)       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  if constexpr (Elem<T>::F16) BIND_AW_RS64("f16"); else BIND_AW_RS64("bf16");
#undef BIND_AW_RS64
}

// the same with 32 columns of B (the first half of a 64-column panel)
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t* a,
                                         uint64_t db) {
#define BIND_AW_RS32(ty)                                                   \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                          \
      BIND_AW_OP("m64n32k16", ty)                                          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                   \
      : BIND_AW_D8(0), BIND_AW_D8(8)                                       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  if constexpr (Elem<T>::F16) BIND_AW_RS32("f16"); else BIND_AW_RS32("bf16");
#undef BIND_AW_RS32
}

// the same with 16 columns of B (the first quarter of a panel)
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t* a,
                                         uint64_t db) {
#define BIND_AW_RS16(ty)                                                   \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                          \
      BIND_AW_OP("m64n16k16", ty)                                          \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "   \
      "1, 1;\n}\n"                                                          \
      : BIND_AW_D8(0)                                                      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  if constexpr (Elem<T>::F16) BIND_AW_RS16("f16"); else BIND_AW_RS16("bf16");
#undef BIND_AW_RS16
}

#undef BIND_AW_OP
#undef BIND_AW_D8

// the first N / 2 registers of a panel's accumulator fragment: its first N
// columns
template <int N>
__device__ __forceinline__ float (&first(float (&acc)[32]))[N / 2] {
  return *reinterpret_cast<float (*)[N / 2]>(&acc[0]);
}

// keeps the compiler from moving the accumulator registers of a row of d
// across a wgmma fence, commit or wait: every panel's, and of the last
// panel of d 80 / 96 only the ones its product writes (the rest hold
// nothing and are left for the compiler to drop)
template <int D>
__device__ __forceinline__ void pin_acc(float (&acc)[panels(D)][32]) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p) pin(acc[p]);
  if constexpr (D % 64 != 0) pin(first<D % 64>(acc[D / 64]));
}

// 2^x on the MUFU unit, subnormals flushed to zero (a weight below 2^-126
// of the row's largest is 0 either way in bf16 or f16 P)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- the three steps of a key tile, for one warpgroup ---------------------

// S (64 x BKV, fp32) = Q (the warpgroup's 64 rows at q_addr) K^T (the tile
// at k_addr), both of type T; Q and K are K-major in 64-column panels,
// 8-row groups 1024 bytes apart, a k16 step 32 bytes along the swizzled row
template <typename T, int D, int BKV>
__device__ __forceinline__ void issue_qk(float (&sc)[BKV / 2],
                                         uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da =
        wg_desc(q_addr + (kk / 4) * (BQ * 128) + (kk % 4) * 32, 16, 1024);
    const uint64_t db =
        wg_desc(k_addr + (kk / 4) * (BKV * 128) + (kk % 4) * 32, 16, 1024);
    wgmma_ss<T>(sc, da, db, kk > 0);
  }
}

// O (64 x D) += P (registers) V (the tile at v_addr: keys x D, N-major in
// 64-column panels, 8-key groups 1024 bytes apart, a k16 step 2048 bytes);
// the last panel of d 80 / 96 at N = 16 / 32, its real columns only; P
// and V of type T
template <typename T, int D, int BKV>
__device__ __forceinline__ void issue_pv(float (&o)[panels(D)][32],
                                         const uint32_t (&pa)[BKV / 4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
    for (int p = 0; p < D / 64; ++p)
      wgmma_rs<T>(o[p], &pa[4 * kk],
               wg_desc(v_addr + p * (BKV * 128) + kk * 2048, BKV * 128,
                       1024));
    if constexpr (D % 64 != 0)
      wgmma_rs<T>(first<D % 64>(o[D / 64]), &pa[4 * kk],
               wg_desc(v_addr + (D / 64) * (BKV * 128) + kk * 2048,
                       BKV * 128, 1024));
  }
}

// The online softmax of a tile's scores sc: sc[4 j + e] is row row_a + 8
// (e / 2), key k0 + 8 j + col_l + e % 2.  Updates m and the partial sums
// l, rescales O by the correction, and leaves P in pa as pairs of T.
template <typename T, int BKV, int PANELS>
__device__ __forceinline__ void softmax(float (&sc)[BKV / 2],
                                        uint32_t (&pa)[BKV / 4],
                                        float (&o)[PANELS][32], float (&m)[2],
                                        float (&l)[2], const Shape& sh,
                                        const Mask& mask, int64_t k0,
                                        int64_t row_a, int col_l,
                                        bool masked) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = sc[4 * j + e] * sh.scale_log2;
      if (masked) {
        const int64_t key = k0 + 8 * j + col_l + (e % 2);
        const int64_t row = row_a + 8 * (e / 2);
        bool vis = key < sh.skv;
        if (mask.causal) vis = vis && key <= row;
        if (mask.windowed) vis = vis && row - key < mask.window;
        v = vis ? v : -INFINITY;
      }
      sc[4 * j + e] = v;
      mx[e / 2] = fmaxf(mx[e / 2], v);
    }
  }
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    corr[h] = exp2_fast(m[h] - mx[h]);
    m[h] = mx[h];
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < BKV / 4; ++i) {
    const int h = i % 2;
    const float p0 = exp2_fast(sc[2 * i] - m[h]);
    const float p1 = exp2_fast(sc[2 * i + 1] - m[h]);
    sum[h] += p0 + p1;
    pa[i] = Elem<T>::pack(p0, p1);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = corr[h] * l[h] + sum[h];
  // O *= corr, unless no row of the warp saw its max move (corr == 1)
  if (!__all_sync(0xffffffffu, corr[0] == 1.0f && corr[1] == 1.0f)) {
#pragma unroll
    for (int p = 0; p < PANELS; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] *= corr[(i / 2) % 2];
  }
}

// ---- the block -----------------------------------------------------------

// The sweep of one block over key tiles [t0, t1): all THREADS threads of
// a block call it, with Cfg<D>::SMEM bytes of dynamic shared memory at
// smem.  tq, tk, tv: q, k, v as (D, S, planes) tensor maps read in boxes
// of 64 columns by BQ (q) or BKV (k, v) rows; the block's BQ query rows
// start at row q0 of q's plane qz, its keys and values lie in plane kz of
// k and vz of v.  Each row is masked by its position (sh.mask, the keys
// past sh.skv).  At the end each thread calls epilogue(o, m, l, row_a,
// col_l, lane) with its rows' unnormalised O, their max m (in the scaled
// log2 units of the sweep) and its partial sums l (not yet summed over the
// quad): flash attention stores O / l, chain_attn (kernels/chain) the
// partials of a chunk of keys.
template <typename T, int D, typename Epilogue>
__device__ __forceinline__ void sweep_block(const CUtensorMap* tq,
                                            const CUtensorMap* tk,
                                            const CUtensorMap* tv,
                                            const Shape& sh, int64_t q0,
                                            int qz, int kz, int vz,
                                            int64_t t0, int64_t t1,
                                            unsigned char* smem,
                                            Epilogue&& epilogue) {
  using C = Cfg<D>;
  constexpr int BKV = C::BKV;
  constexpr int PANELS = C::PANELS;
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
  unsigned char* ks = qs + C::Q_BYTES;
  unsigned char* vs = ks + STAGES * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * C::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  // how many warpgroups were done with each K / V stage, all told
  unsigned int* k_done = reinterpret_cast<unsigned int*>(v_full + STAGES);
  unsigned int* v_done = k_done + STAGES;
  const Mask mask = sh.mask;
  const int n = t1 > t0 ? static_cast<int>(t1 - t0) : 0;

  // tile it of the sweep into its stage, K or V; by one thread
  auto issue = [&](int it, bool values) {
    const int s = it % STAGES;
    const int row = static_cast<int>((t0 + it) * BKV);
    unsigned char* dst = (values ? vs : ks) + s * C::KV_BYTES;
    uint64_t* bar = values ? &v_full[s] : &k_full[s];
    mbar_expect(bar, C::KV_BYTES);
#pragma unroll
    for (int p = 0; p < PANELS; ++p)
      tma_load(dst + p * C::KV_PANEL, values ? tv : tk, bar, p * 64, row,
               values ? vz : kz);
  };
  // a warpgroup is done with stage it % STAGES of K or V; the second of
  // the two refills it with tile it + STAGES
  auto release = [&](int wg, int tid, int it, bool values) {
    warpgroup_sync(wg);       // every warp of it has finished reading
    if (tid == 0) {
      unsigned int* done = (values ? v_done : k_done) + it % STAGES;
      if ((atomicAdd(done, 1u) & 1u) != 0 && it + STAGES < n)
        issue(it + STAGES, values);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      k_done[s] = 0;
      v_done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(q_full, C::Q_BYTES);
#pragma unroll
    for (int p = 0; p < PANELS; ++p)
      tma_load(qs + p * C::Q_PANEL, tq, q_full, p * 64, static_cast<int>(q0),
               qz);
    for (int it = 0; it < STAGES && it < n; ++it) {
      issue(it, false);
      issue(it, true);
    }
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int64_t r0 = q0 + wg * 64;                     // first row
  const int64_t row_a = r0 + warp * 16 + lane / 4;     // and row_a + 8
  const int col_l = 2 * (lane % 4);                    // + 8 j, + 0 / 1

  float o[PANELS][32];
#pragma unroll
  for (int p = 0; p < PANELS; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.0f;
  float m[2] = {-1e30f, -1e30f};
  float l[2] = {0.0f, 0.0f};

  const uint32_t q_addr = smem_addr(qs) + wg * 64 * 128;
  mbar_wait(q_full, 0);

  // what the mask does to tile it: none of the warpgroup's rows sees a
  // key of it (skip) / some keys are hidden from some rows (masked)
  auto skips = [&](int64_t k0) {
    return (mask.causal && k0 > r0 + 63) ||
           (mask.windowed && r0 - (k0 + BKV - 1) >= mask.window);
  };
  auto masks = [&](int64_t k0) {
    return k0 + BKV > sh.skv || (mask.causal && k0 + BKV - 1 > r0) ||
           (mask.windowed && r0 + 63 - k0 >= mask.window);
  };
  uint32_t pa[BKV / 4];       // P as pairs of T: step kk is pa[4 kk ..]

  for (int it = 0; it < n; ++it) {
    const int s = it % STAGES;
    const uint32_t ph = (it / STAGES) & 1;
    const int64_t k0 = (t0 + it) * BKV;
    const bool skip = skips(k0);
    float sc[BKV / 2];
    mbar_wait(&k_full[s], ph);
    if (!skip) {
      wg_fence();
      issue_qk<T, D, BKV>(sc, q_addr, smem_addr(ks + s * C::KV_BYTES));
      wg_commit();
      wg_wait_all();
      pin(sc);
    }
    release(wg, tid, it, false);
    if (!skip) {
      softmax<T, BKV, PANELS>(sc, pa, o, m, l, sh, mask, k0, row_a, col_l,
                              masks(k0));
      mbar_wait(&v_full[s], ph);
      pin_acc<D>(o);
      pin(pa);
      wg_fence();
      issue_pv<T, D, BKV>(o, pa, smem_addr(vs + s * C::KV_BYTES));
      wg_commit();
      wg_wait_all();
      pin_acc<D>(o);
    } else {
      mbar_wait(&v_full[s], ph);
    }
    release(wg, tid, it, true);
  }

  epilogue(o, m, l, row_a, col_l, lane);
}

// Flash attention's block: all THREADS threads of a block call it, with
// Cfg<D>::SMEM bytes of dynamic shared memory at smem.  tq, tk, tv: q, k,
// v as (D, S, heads) tensor maps.  Block (x, y) computes q head x % Hq of
// batch x / Hq for query tile gridDim.y - 1 - y.  LSE: null, or the (B,
// Hq, Sq) log-sum-exp buffer.
template <typename T, int D>
__device__ __forceinline__ void attention_block(const CUtensorMap* tq,
                                                const CUtensorMap* tk,
                                                const CUtensorMap* tv,
                                                T* __restrict__ O,
                                                float* __restrict__ LSE,
                                                const Shape& sh,
                                                unsigned char* smem) {
  using C = Cfg<D>;
  constexpr int BKV = C::BKV;
  constexpr int PANELS = C::PANELS;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / sh.hq;
  const int64_t kvh = b * sh.hkv + (bh % sh.hq) / (sh.hq / sh.hkv);
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * BQ;
  const Mask mask = sh.mask;

  // the key tiles the mask leaves for rows [q0, q0 + BQ)
  int64_t t0 = 0;
  int64_t t1 = (sh.skv + BKV - 1) / BKV;
  if (mask.causal) {
    const int64_t last = (q0 + BQ - 1) / BKV + 1;
    t1 = last < t1 ? last : t1;
  }
  if (mask.windowed) {
    const int64_t oldest = q0 - mask.window + 1;
    if (oldest > 0) t0 = oldest / BKV;
  }

  const int kz = static_cast<int>(kvh);
  sweep_block<T, D>(
      tq, tk, tv, sh, q0, static_cast<int>(bh), kz, kz, t0, t1, smem,
      [&](float (&o)[PANELS][32], float (&m)[2], float (&l)[2],
          int64_t row_a, int col_l, int lane) {
      // out = O / l, rounded once; a row that saw no key has l = 0, O = 0
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        const int64_t row = row_a + 8 * h;
        if (row >= sh.sq) continue;
        if (LSE != nullptr && (lane & 3) == 0)
          LSE[bh * sh.sq + row] =
              l[h] == 0.0f ? INFINITY
                           : (m[h] + log2f(l[h])) * 0.6931471805599453f;
        const float inv = 1.0f / (l[h] == 0.0f ? 1.0f : l[h]);
        T* dst = O + (bh * sh.sq + row) * D + col_l;
#pragma unroll
        for (int p = 0; p < PANELS; ++p)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (real_cols(D, p, j))
              store2(dst + p * 64 + 8 * j, o[p][4 * j + 2 * h] * inv,
                     o[p][4 * j + 2 * h + 1] * inv);
      }
      });
}

// the tensor maps of one launch, of element type T: q as (D, Sq, B Hq) in
// boxes of BQ rows, k and v as (D, Skv, B Hkv) in boxes of Cfg<D>::BKV rows
template <typename T, int D>
inline cudaError_t make_maps(CUtensorMap* tq, CUtensorMap* tk,
                             CUtensorMap* tv, const void* q, const void* k,
                             const void* v, int64_t batch, int64_t hq,
                             int64_t hkv, int64_t sq, int64_t skv) {
  constexpr CUtensorMapDataType type = Elem<T>::TMA;
  cudaError_t err =
      bind_gemm::make_map(tq, type, q, sq, D, batch * hq, 0, BQ);
  if (err != cudaSuccess) return err;
  if (skv == 0) {             // no key tile is ever loaded
    *tk = *tq;
    *tv = *tq;
    return cudaSuccess;
  }
  err = bind_gemm::make_map(tk, type, k, skv, D, batch * hkv, 0,
                            Cfg<D>::BKV);
  if (err != cudaSuccess) return err;
  return bind_gemm::make_map(tv, type, v, skv, D, batch * hkv, 0,
                             Cfg<D>::BKV);
}

}  // namespace bind_attn_wg
