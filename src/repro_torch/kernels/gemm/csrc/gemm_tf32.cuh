// The float32 route of the hand-written GEMM on the tensor cores
// (f32_3xtf32): wgmma in TF32, each product split three ways so that the
// result keeps the float32 contract.  Shared by csrc/gemm.cu and the chain
// kernel through gemm_routes.cuh.
//
// What bounds it on an H100: operations.  A 1024^3 product is 2.1 GFLOP;
// on the CUDA cores (67 TFLOP/s, the f32_simt route) no loop beats
// 0.032 ms.  The TF32 tensor cores run 495 TFLOP/s, but one TF32 product
// keeps about three decimal digits.  3xTF32 keeps float32's accuracy: every
// operand x is split into hi = tf32(x), rounded to nearest with ties away
// from zero (tf32_rna of tf32.cuh, the attention routes' rounding too),
// and lo = x - hi, exact in float32, which the tensor cores read as TF32
// by dropping its last 13 bits (no rounding pass: on an H100 that ran
// 1024^3 faster and no less accurately than lo rounded to nearest).  So
// x = hi + lo to 2^-21 relative, and a product is hi.hi + hi.lo + lo.hi
// (lo.lo is below 2^-22 of it), each a TF32 wgmma accumulated in fp32.
// Three products at 495 TFLOP/s bound the 1024^3 leaf at 0.0130 ms.
//
// Layout.  TF32 wgmma reads its shared operands K-major and has no
// transposed form (the bf16 route reads B N-major through wgmma's
// transposed-B form, which TF32 lacks).  So:
//   * A (M x K, row-major: K-major as it lies) never goes through shared
//     memory: each thread loads its own fragment rows straight into
//     registers and splits them there, and the wgmma take A from registers;
//   * B (K x N, row-major: N-major) is transposed on its way into shared
//     memory: global -> registers -> split into hi and lo -> B^T (N rows of
//     a 32-wide K panel, 128 bytes each) in the 128-byte swizzle wgmma
//     reads, then fence.proxy.async so the tensor cores see the threads'
//     stores.  The 32 lanes of a warp take the 32 K rows of one 4-column
//     chunk, so the transposing stores fall on 32 banks; the transpose
//     costs nothing beyond the split.
// Inside a 32-wide K panel the K index is permuted: an A fragment (m64k8)
// gives a thread the K slots t and t + 4 (t = lane % 4) of each k8 step, and
// slot t of step j holds K = 8 t + 2 j, slot t + 4 holds 8 t + 2 j + 1.  A
// thread's A then is the 8 contiguous floats 8 t .. 8 t + 7 of each of its
// two rows (two 16-byte loads a row), and the staging pass writes B^T's
// columns in the same order.  The terms of a sum over K are the same in
// any order, so the permutation changes nothing else.
//
// Accumulation.  The tensor cores add into their fp32 accumulator with
// truncation, not IEEE rounding: one accumulator over all of K (128 k8
// steps at 1024, three products each) drifts, as the attention route found
// (attn_tf32.cuh).  So each 32-wide K panel is summed from zero: hi.hi in
// one accumulator, the two lo products in another (hi.hi's large terms
// would truncate their small ones), and the panel's sum, hi.hi + lo, is
// added into the level's sum in registers with __fadd_rn.  Non-finite
// operands: a NaN's hi is a NaN (tf32_rna; but for a signalling NaN of a
// small payload, which reads as +-inf), so hi.hi is NaN wherever the
// product is; an infinite x has hi = x and lo = inf - inf = NaN, so hi.hi
// is +-inf (NaN where the IEEE product is: inf x 0, inf - inf) and the lo
// products are NaN, never an inf of the lo's own sign.  The panel adds
// fmaxf(lo, -FLT_MAX), which is lo but for that NaN, so every output is
// NaN, +inf or -inf where the IEEE product is.  The adds are intrinsics
// so that the GEMM's and the chain kernel's separately compiled kernels
// cannot round differently through contraction.  No split K and no
// atomics: two calls give the same bits, and a chain gives per-level
// replay's bits.
//
// tf32_tile: one block of two warpgroups (256 threads) owns a 128 x 64
// output tile, each warpgroup 64 rows of it (1024^2 gives 128 blocks, one
// on each of 128 of the 132 SMs).  The two share the panel's B^T, which
// all 256 threads stage, and each loads its own rows of A.  Per panel a
// warpgroup issues 4 k8 steps of three m64n64k8 wgmma (A from registers,
// B^T from shared memory); while they run its threads split and store the
// next panel's B^T into the other of two stages, then wait, add the panel
// into the sum, split the next panel's A (loaded a panel ahead) and load
// the panel after it.  One block barrier a panel.  Registers: the three
// accumulator sets (96 a thread), A's hi and lo (32), the next panel in
// flight (24).  What holds it back is the staging (loads, splits,
// transposing stores), which overlaps the products only in part: with the
// staging taken out the products alone run near half the bound's rate.
// A 64 x 64 tile of one warpgroup (two blocks an SM) staged a third more
// for the same products and was slower.
//
// Edges: rows past M and columns past N are zero-filled by the staging
// threads (predicated loads, no branch), as is K past the end (a last panel
// of fewer than 32, and a last k8 step of 4: K % 8 == 4).  The epilogue is
// store_level (gemm_tile.cuh): C added in fp32, then one rounding to the
// output type.  The L levels of a chain stream through the stages as one
// run of panels, the level's sum written (rounded to the carry's type)
// after its last panel, the carry read back from out by the thread that
// wrote it.
//
// The route (gemm_routes.cuh) takes float32 whose A and B start 16-byte
// aligned with K and N multiples of 4 (rows of whole 16-byte chunks), K >
// 0 and level strides of whole chunks: the 16-byte loads.

#pragma once

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "gemm_tile.cuh"
#include "gemm_wgmma.cuh"
#include "tf32.cuh"

namespace bind_gemm {

using bind_tf32::fence_async_shared;
using bind_tf32::pin;
using bind_tf32::tf32_rna;

constexpr int TF_BM = 128;                     // output tile rows
constexpr int TF_BN = 64;                      // output tile columns
constexpr int TF_BK = 32;                      // K panel: 128 bytes of B^T
constexpr int TF_THREADS = 256;                // two warpgroups
constexpr int TF_HALF = TF_BN * TF_BK * 4;     // B^T hi (or lo) of a panel
constexpr int TF_STAGE = 2 * TF_HALF;          // hi, then lo
constexpr size_t TF_SMEM = 1024 + 2 * TF_STAGE;

#define BIND_TF32_D8(o)                                                   \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),          \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// d (64 x 64, fp32) [+]= A (64 x 8, TF32 in registers a[0..3]) B (8 x 64,
// K-major, shared); accumulate 0 overwrites d
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                               const float* a, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : BIND_TF32_D8(0), BIND_TF32_D8(8), BIND_TF32_D8(16), BIND_TF32_D8(24)
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])), "l"(db),
        "r"(accumulate));
}

#undef BIND_TF32_D8

// 16 bytes at p into v when ``in``, zeros otherwise (no branch)
__device__ __forceinline__ float4 tf_ld4(const float* p, bool in) {
  float4 v;
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %5, 0;\n"
      "mov.b32 %0, 0;\nmov.b32 %1, 0;\nmov.b32 %2, 0;\nmov.b32 %3, 0;\n"
      "@q ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n}\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "r"(static_cast<int>(in)));
  return v;
}

__device__ __forceinline__ void tf_st(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// The tensor-core route for float32.  All TF_THREADS threads of the block
// call it, with TF_SMEM bytes of dynamic shared memory at ``smem``.
template <typename O = float>
__device__ __forceinline__ void tf32_tile(const Problem<float, O>& p,
                                          unsigned char* smem) {
  const uint32_t ring =
      (smem_addr(smem) + 1023) & ~uint32_t(1023);   // 1024-byte aligned
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;   // in the warpgroup
  const int w8 = tid / 32;             // in the block
  const int lane = tid % 32;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * TF_BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * TF_BN;
  const int64_t nk = (p.K + TF_BK - 1) / TF_BK;     // K > 0 on this route
  const int64_t total = nk * p.L;

  // A: this thread's fragment rows ra and ra + 8, and its 8 columns 8 t ..
  // 8 t + 7 of a panel (t = lane % 4)
  const int64_t ra = m0 + 64 * wg + warp * 16 + lane / 4;
  const int ka = 8 * (lane % 4);
  const bool a_in0 = ra < p.M, a_in1 = ra + 8 < p.M;
  // B: K row ``lane`` of a panel, 4-column chunks w8 + 8 j (j < 2); in
  // B^T that row is column ``kcol``, the slot the permutation gives it
  const int kcol = 8 * ((lane & 7) >> 1) + (lane >> 3) + 4 * (lane & 1);
  bool b_in[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) b_in[j] = n0 + 4 * (w8 + 8 * j) < p.N;
  // element e of chunk w8 + 8 j lands at B^T row 4 w8 + 32 j + e: at
  // b_e[e] + 4096 j of a stage's hi (lo: + TF_HALF)
  uint32_t b_e[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = 4 * (w8 & 1) + e;
    b_e[e] = (w8 >> 1) * 1024 + r * 128 + (((kcol >> 2) ^ r) << 4) +
             (kcol & 3) * 4;
  }

  // the loader: the next panel's level and K offset, and where its rows
  // start (A's row ra at column lk + ka, B's row lk + lane at column n0 +
  // 4 w8)
  int64_t ll = 0, lk = 0;
  const float* pa = p.A + (a_in0 ? ra : 0) * p.K + ka;
  const float* pb = p.B + static_cast<int64_t>(lane) * p.N + n0 + 4 * w8;
  const int64_t a8 = 8 * p.K;      // row ra + 8, from row ra
  float4 ar[4], br[2];
  auto load = [&]() {
    const bool c0 = lk + ka < p.K, c1 = lk + ka + 4 < p.K;
    ar[0] = tf_ld4(pa, a_in0 && c0);
    ar[1] = tf_ld4(pa + 4, a_in0 && c1);
    ar[2] = tf_ld4(pa + a8, a_in1 && c0);
    ar[3] = tf_ld4(pa + a8 + 4, a_in1 && c1);
    const bool k_in = lk + lane < p.K;
#pragma unroll
    for (int j = 0; j < 2; ++j) br[j] = tf_ld4(pb + 32 * j, k_in && b_in[j]);
    lk += TF_BK;
    pa += TF_BK;
    pb += TF_BK * p.N;
    if (lk >= nk * TF_BK) {       // the next level
      lk = 0;
      ++ll;
      pa += p.a_stride - nk * TF_BK;
      pb += p.b_stride - nk * TF_BK * p.N;
    }
  };
  // A's fragments of the 4 k8 steps, hi and lo: step j is a0..a3 = (row
  // ra, slot t), (ra + 8, t), (ra, t + 4), (ra + 8, t + 4), K = 8 t + 2 j
  // and 8 t + 2 j + 1
  float ah[16], al[16];
  auto split_a = [&]() {
    const float r0[8] = {ar[0].x, ar[0].y, ar[0].z, ar[0].w,
                         ar[1].x, ar[1].y, ar[1].z, ar[1].w};
    const float r1[8] = {ar[2].x, ar[2].y, ar[2].z, ar[2].w,
                         ar[3].x, ar[3].y, ar[3].z, ar[3].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x[4] = {r0[2 * j], r1[2 * j], r0[2 * j + 1],
                          r1[2 * j + 1]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float hi = tf32_rna(x[i]);
        ah[4 * j + i] = hi;
        al[4 * j + i] = __fsub_rn(x[i], hi);
      }
    }
  };
  auto store_b = [&](int s) {
    const uint32_t hi = ring + s * TF_STAGE;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float x[4] = {br[j].x, br[j].y, br[j].z, br[j].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float h = tf32_rna(x[e]);
        tf_st(hi + b_e[e] + 4096 * j, h);
        tf_st(hi + TF_HALF + b_e[e] + 4096 * j, __fsub_rn(x[e], h));
      }
    }
  };

  load();
  split_a();
  store_b(0);
  fence_async_shared();
  if (total > 1) load();
  __syncthreads();

  // acc: the level's sum; hh, lo: the panel's hi.hi and lo products
  float acc[32], hh[32], lo[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

  int64_t ck = 0, cl = 0;    // the panel's index within its level; level
  for (int64_t t = 0; t < total; ++t) {
    const int s = static_cast<int>(t & 1);
    const uint32_t b_hi = ring + s * TF_STAGE;
    const uint32_t b_lo = b_hi + TF_HALF;
    wg_fence();
#pragma unroll
    for (int j = 0; j < TF_BK / 8; ++j) {
      const uint64_t dh = wg_desc(b_hi + 32 * j, 16, 1024);
      const uint64_t dl = wg_desc(b_lo + 32 * j, 16, 1024);
      wgmma_tf32_n64(lo, &al[4 * j], dh, j > 0);
      wgmma_tf32_n64(lo, &ah[4 * j], dl, 1);
      wgmma_tf32_n64(hh, &ah[4 * j], dh, j > 0);
    }
    wg_commit();
    if (t + 1 < total) {       // the next panel's B^T, into the other stage
      store_b(s ^ 1);
      fence_async_shared();
    }
    wg_wait_all();
    pin(hh);
    pin(lo);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float sum = __fadd_rn(hh[i], fmaxf(lo[i], -FLT_MAX));
      acc[i] = __fadd_rn(acc[i], sum);
    }
    if (t + 1 < total) {
      split_a();
      if (t + 2 < total) load();
    }
    if (++ck == nk) {   // the level's sum is complete
      // acc[4 j + i]: row ra + 8 (i / 2), column 8 j + 2 (lane % 4) + i % 2
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int j = r / 4;
        const int i = r % 4;
        const int64_t gm = ra + 8 * (i / 2);
        const int64_t gn = n0 + 8 * j + 2 * (lane % 4) + i % 2;
        if (gm < p.M && gn < p.N) store_level(p, cl, gm, gn, acc[r]);
        acc[r] = 0.0f;
      }
      ck = 0;
      ++cl;
    }
    __syncthreads();   // B^T of panel t + 1 staged; stage s free
  }
}

}  // namespace bind_gemm
