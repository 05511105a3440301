// The float32 route of flash attention on the tensor cores (f32_3xtf32):
// wgmma in TF32, each product split three ways so the result keeps the
// float32 contract.
//
// What bounds it on an H100: operations.  Causal prefill at S = 8192 does
// 4 d Hq visible-pairs FLOP (687 GFLOP at Qwen3-14B width).  On the CUDA
// cores (67 TFLOP/s, the f32_simt route) no loop can beat 10.3 ms there.
// The TF32 tensor cores run 495 TFLOP/s, but one TF32 product keeps about
// three decimal digits, two orders of magnitude outside the reference's
// float32 tolerance (2e-5).  3xTF32 keeps float32's accuracy: every operand
// x is split into hi = tf32(x) and lo = tf32(x - hi) (tf32_rna of
// ../../gemm/csrc/tf32.cuh, cvt.rna, which the GEMM shares), so
// x = hi + lo to 2^-22 relative, and a product is hi.hi + hi.lo + lo.hi
// (the lo.lo term is below 2^-22 of it), each a TF32 wgmma accumulated in
// fp32.  Three products at 495 TFLOP/s bound the Qwen3-14B call at
// 4.17 ms.
//
// Layout.  TF32 wgmma reads both operands K-major from shared memory (no
// transposed form, unlike bf16), or A from registers:
//   * S = Q K^T: A = Q (rows x d) and B = K (keys x d) are K-major as they
//     lie;
//   * O += P V: A = P from registers, B must be V^T (d x keys, keys
//     contiguous), so V is transposed on its way into shared memory.
// Nothing is loaded by TMA: every tile goes global -> registers -> split
// into hi and lo -> shared memory, in the 128-byte swizzle wgmma reads
// (rows of 32 floats, 16-byte chunk c of row r at c ^ (r % 8), 8-row groups
// 1024 bytes apart), then fence.proxy.async so the tensor cores see the
// threads' stores.  The split pass is where V is transposed, so the
// transpose costs nothing beyond it; stores are conflict-free (V: the 32
// lanes of a warp take 32 keys of one column, Q and K: 16-byte stores, 8
// rows apart per 128 bytes).
//
// Accumulation.  The tensor cores add into their fp32 accumulator with
// truncation, not IEEE rounding, so an accumulator that takes every key
// tile's P V (several thousand wgmma at S = 8192) drifts: the first design
// did, and its error against float64 was 7x the CUDA-core route's at
// S = 8192 (tools/attn_faults.py plants it).  So each key tile's P V is
// summed from zero in its own accumulator (12 wgmma) and added into O with
// one IEEE add, as the CUDA-core loop adds each key's p v.  S starts from
// zero every tile, but its 3 d / 8 products in one accumulator still gave
// up to 4.6x (also planted there): the two lo products go to an
// accumulator of their own, added to hi.hi's once they are done (at most
// 2.2x on the small cases, 1.7x at Qwen3-14B width: chip_smoke.py).  Each product is one wgmma m64n{BKV}k8 (S) or
// m64n{D}k8 (O) a k8 step: the widest instruction the tile allows (four
// n32 instructions in place of one n128 were slower).
//
// P as A in registers.  A TF32 A fragment (m64k8) gives a thread rows r and
// r + 8 at keys t and t + 4 (t = lane % 4); the S accumulator gives it keys
// 2t and 2t + 1.  So the keys are permuted inside every group of 8 in the
// staging pass: logical position t holds key 2t, position t + 4 key 2t + 1
// (V^T's columns), and the accumulator registers {s0, s2, s1, s3} of a
// group are the A registers as they lie; no shuffle.  hi and lo of P are
// split in registers; the row sum l is taken from the unsplit p.
//
// Shared memory.  Q hi and lo for BQ = 128 rows stay for the whole sweep:
// 2 x 128 x d x 4 bytes, 128 KB at d = 128.  What is left holds one key
// tile, hi and lo of K and of V^T: 4 x BKV x d x 4 bytes, so BKV = 32 keys
// at d >= 80 (64 KB at 128; 197,632 bytes with the alignment pad, of
// 232,448; 144,384 at d = 80) and 64 at d <= 64 (128 KB at d = 64 with
// Q's 64).  At d = 80 a key tile of 64 would hold the next tile's 40
// registers beside O, P V's and S's: 255 and a spill.  At d = 192 or 256 Q alone (192 / 256 KB) leaves no
// room for a key tile at 128 rows: d 256 runs the block of
// attn_tf32_wide.cuh (64 rows, two warpgroups each owning half of O's
// columns, S split over d between them, 16-key tiles), d 192 stays on
// f32_simt.
//
// Head dims (tf32_head_dim, which the C route_of of the forward and of the
// backward both call): 32, 64, 80, 96, 128 here, 256 in
// attn_tf32_wide.cuh (and attn_bwd_tf32_wide.cuh).  A row is ceil(d / 32)
// panels; at d = 80 the last one holds 16 real columns and 16 the split
// pass fills with zeros once a block (nothing is loaded by TMA here, so
// the threads write them; no product reads them).  Q K^T steps its k8
// slices over the real columns only (10 at d = 80), P V is issued at N =
// d (m64n80k8), and no store writes past column d.
//
// Log-sum-exp.  The training forward (attention_block<D, true>) also
// stores each row's log-sum-exp, (m + log2 l) ln 2 with m in the scaled
// log2 units of the sweep, +inf for a row that sees no key, as the bf16
// route does; the backward's f32_3xtf32 route (attn_bwd_tf32.cuh) reads
// it.  The output's arithmetic is the same source either way.
//
// Pipeline (two warpgroups of 64 query rows, 256 threads, one block an SM,
// 255 registers a thread: no producer warp, as in attn_wgmma.cuh).  The
// next key tile is loaded into registers while the tensor cores run, and
// each half of the split pass hides behind the other half's products:
//   barrier; issue S = Q K^T (async); split V(t) into V^T; load K, V(t+1)
//   into registers; wait; softmax; barrier; issue O_t = P V (async); split
//   K(t+1); wait; O += O_t.
// Two block barriers a tile, each after a fence.proxy.async.
//
// The online softmax is the reference's, in fp32 on the accumulator:
// scores scaled by scale * log2(e) and exponentiated with the accurate
// exp2f; m starts at -1e30 and a masked key gets -inf, so p = 0 exactly and
// a row that sees no key gives zeros; O is rescaled only when some row of
// the warp saw its max move (corr == 1 is exact); out = O / l, one IEEE
// division.  Masks come from the kernel's own tiles: 128-row query tiles
// and BKV-key tiles, as in the other routes, the longest query tiles
// launched first.
//
// Registers a thread at d = 128: O 64, the tile's P V 64, S (P hi) 16, P
// lo 16, the next tile 32, softmax state and addresses (ptxas: about 250,
// no spill).  The route (flash_attention.cu) takes
// float32 with d one of tf32_head_dim's and q, k, v, out 16-byte aligned
// (the 16-byte loads and the 128-byte panels).

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "../../gemm/csrc/gemm_wgmma.cuh"
#include "../../gemm/csrc/tf32.cuh"
#include "attn_tile.cuh"

namespace bind_attn_tf {

using bind_attn::Mask;
using bind_gemm::smem_addr;
using bind_gemm::wg_commit;
using bind_gemm::wg_desc;
using bind_gemm::wg_fence;
using bind_gemm::wg_wait_all;
using bind_tf32::fence_async_shared;
using bind_tf32::pin;
using bind_tf32::tf32_rna;

constexpr int BQ = 128;                 // query rows per block
constexpr int THREADS = 256;            // two warpgroups of 64 rows

// the head dims of the f32_3xtf32 routes, forward and backward (ops.py
// TF32_HEAD_DIMS); 256 runs the blocks of attn_tf32_wide.cuh and
// attn_bwd_tf32_wide.cuh
__host__ __device__ constexpr bool tf32_head_dim(int64_t d) {
  return d == 32 || d == 64 || d == 80 || d == 96 || d == 128 || d == 256;
}

// 32-column panels of a row of d: the last one of d 80 holds 16 real
// columns and the split pass's zeros past them
__host__ __device__ constexpr int tf32_panels(int d) { return (d + 31) / 32; }

template <int D> struct Cfg {
  static_assert(tf32_head_dim(D) && D <= 128, "d: 32, 64, 80, 96, 128");
  static constexpr int PANELS = tf32_panels(D);
  static constexpr int BKV = D <= 64 ? 64 : 32;        // keys per tile
  static constexpr int Q_PANEL = BQ * 128;             // 32 columns of Q
  static constexpr int K_PANEL = BKV * 128;            // 32 columns of K
  static constexpr int V_PANEL = D * 128;              // 32 keys of V^T
  static constexpr int Q_BYTES = PANELS * Q_PANEL;     // hi or lo
  static constexpr int K_BYTES = PANELS * K_PANEL;
  static constexpr int V_BYTES = (BKV / 32) * V_PANEL;
  static constexpr size_t SMEM =
      1024 + 2 * size_t(Q_BYTES) + 2 * size_t(K_BYTES) + 2 * size_t(V_BYTES);
  static constexpr int SR = BKV / 2;                   // S registers a thread
  static constexpr int OR = D / 2;                     // O registers a thread
  // float4 a thread: at d = 80 the last of 3 on half of the threads
  static constexpr int CHUNKS = BKV * D / 4;
  static constexpr int LOADS = (CHUNKS + THREADS - 1) / THREADS;
  static constexpr bool EXACT = LOADS * THREADS == CHUNKS;
  static_assert(CHUNKS * 4 == BKV * D && (EXACT || D % 32 != 0),
                "tile / threads");
  static_assert(SMEM <= 232448, "shared memory");
};

// the problem of one launch; q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D)
struct Shape {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  int64_t hq, hkv, sq, skv;
  float scale_log2;      // scale * log2(e)
  Mask mask;
};

// ---- PTX wrappers -----------------------------------------------------------

#define BIND_TF_D8(o)                                                     \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),          \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define BIND_TF_A(i) "r"(__float_as_uint(a##i))

// d (64 x N, fp32) [+]= A (64 x 8, K-major, shared) B (8 x N, K-major,
// shared), TF32 operands, N = 16, 32 or 64; accumulate 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
        : BIND_TF_D8(0)
        : "l"(da), "l"(db), "r"(accumulate));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, %16, %17, p, 1, 1;\n}\n"
        : BIND_TF_D8(0), BIND_TF_D8(8)
        : "l"(da), "l"(db), "r"(accumulate));
  } else {
    static_assert(N == 64, "S is 64 x 16, 64 x 32 or 64 x 64");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
        : BIND_TF_D8(0), BIND_TF_D8(8), BIND_TF_D8(16), BIND_TF_D8(24)
        : "l"(da), "l"(db), "r"(accumulate));
  }
}

// d (64 x N, fp32) [+]= A (64 x 8, TF32 in registers a0..a3) B (8 x N,
// K-major, shared), N = 16, 32, 64, 80, 96 or 128; accumulate 0 overwrites
// d
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], float a0,
                                         float a1, float a2, float a3,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "
        "1;\n}\n"
        : BIND_TF_D8(0)
        : BIND_TF_A(0), BIND_TF_A(1), BIND_TF_A(2), BIND_TF_A(3), "l"(db),
          "r"(accumulate));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : BIND_TF_D8(0), BIND_TF_D8(8)
        : BIND_TF_A(0), BIND_TF_A(1), BIND_TF_A(2), BIND_TF_A(3), "l"(db),
          "r"(accumulate));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : BIND_TF_D8(0), BIND_TF_D8(8), BIND_TF_D8(16), BIND_TF_D8(24)
        : BIND_TF_A(0), BIND_TF_A(1), BIND_TF_A(2), BIND_TF_A(3), "l"(db),
          "r"(accumulate));
  } else if constexpr (N == 80) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, "
        "%41, %42, %43}, %44, p, 1, 1;\n}\n"
        : BIND_TF_D8(0), BIND_TF_D8(8), BIND_TF_D8(16), BIND_TF_D8(24),
          BIND_TF_D8(32)
        : BIND_TF_A(0), BIND_TF_A(1), BIND_TF_A(2), BIND_TF_A(3), "l"(db),
          "r"(accumulate));
  } else if constexpr (N == 96) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, "
        "1, 1;\n}\n"
        : BIND_TF_D8(0), BIND_TF_D8(8), BIND_TF_D8(16), BIND_TF_D8(24),
          BIND_TF_D8(32), BIND_TF_D8(40)
        : BIND_TF_A(0), BIND_TF_A(1), BIND_TF_A(2), BIND_TF_A(3), "l"(db),
          "r"(accumulate));
  } else {
    static_assert(N == 128, "O is 64 x 32, 64, 80, 96 or 128");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, "
        "%67}, %68, p, 1, 1;\n}\n"
        : BIND_TF_D8(0), BIND_TF_D8(8), BIND_TF_D8(16), BIND_TF_D8(24),
          BIND_TF_D8(32), BIND_TF_D8(40), BIND_TF_D8(48), BIND_TF_D8(56)
        : BIND_TF_A(0), BIND_TF_A(1), BIND_TF_A(2), BIND_TF_A(3), "l"(db),
          "r"(accumulate));
  }
}

#undef BIND_TF_A
#undef BIND_TF_D8

// ---- staging: global -> registers -> hi / lo in shared memory --------------

// byte offset of element (r, c) of a K-major operand in 128-byte panels of
// 32 floats, panel_bytes apart
__device__ __forceinline__ uint32_t swz(int r, int c, int panel_bytes) {
  return static_cast<uint32_t>((c >> 5) * panel_bytes + (r >> 3) * 1024 +
                               (r & 7) * 128 +
                               ((((c & 31) >> 2) ^ (r & 7)) << 4) +
                               ((c & 3) << 2));
}

// where key j of a tile goes along V^T's rows: inside each group of 8, key
// 2t at t and key 2t + 1 at t + 4 (the A fragment's order, see the note)
__device__ __forceinline__ int key_slot(int j) {
  const int p = j & 7;
  return (j & ~7) + ((p & 1) ? 4 + (p >> 1) : (p >> 1));
}

__device__ __forceinline__ float4 ld4(const float* p, bool in) {
  return in ? __ldg(reinterpret_cast<const float4*>(p))
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ void st_split4(unsigned char* hi,
                                          unsigned char* lo, uint32_t off,
                                          float4 x) {
  const float4 h = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z),
                               tf32_rna(x.w));
  const float4 l = make_float4(tf32_rna(x.x - h.x), tf32_rna(x.y - h.y),
                               tf32_rna(x.z - h.z), tf32_rna(x.w - h.w));
  *reinterpret_cast<float4*>(hi + off) = h;
  *reinterpret_cast<float4*>(lo + off) = l;
}

__device__ __forceinline__ void st_split(unsigned char* hi, unsigned char* lo,
                                         uint32_t off, float x) {
  const float h = tf32_rna(x);
  *reinterpret_cast<float*>(hi + off) = h;
  *reinterpret_cast<float*>(lo + off) = tf32_rna(x - h);
}

// the block's 128 query rows (zeros past Sq), split, by all threads;
// thread i takes 16-byte chunk i % (D / 4) of row i / (D / 4), + THREADS
template <int D>
__device__ __forceinline__ void stage_q(const float* q, int64_t rows,
                                        unsigned char* hi,
                                        unsigned char* lo) {
  constexpr int CH = D / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    st_split4(hi, lo, swz(r, c, Cfg<D>::Q_PANEL), ld4(q + r * D + c, r < rows));
  }
}

// The columns past d of the last panel of rows [0, rows) of a K-major
// buffer (panels panel_bytes apart), zeros in hi and lo; nothing at d % 32
// == 0.  Once a block: the split pass never writes them.
template <int D>
__device__ __forceinline__ void zero_pad(unsigned char* hi,
                                         unsigned char* lo, int rows,
                                         int panel_bytes) {
  constexpr int CH = D / 4, PAD = tf32_panels(D) * 8 - CH;
  if constexpr (PAD > 0) {
    for (int i = threadIdx.x; i < rows * PAD; i += blockDim.x) {
      const int r = i / PAD, c = (CH + i % PAD) * 4;
      st_split4(hi, lo, swz(r, c, panel_bytes),
                make_float4(0.0f, 0.0f, 0.0f, 0.0f));
    }
  }
}

// The next key tile in registers: K as stage_q takes Q, V with the 32 lanes
// of a warp on 32 keys of one 4-column chunk (V^T's stores then fall on 32
// banks).  Keys at or past ``keys`` read as zeros.
template <int D> struct TileRegs {
  float4 k[Cfg<D>::LOADS];
  float4 v[Cfg<D>::LOADS];

  __device__ __forceinline__ void load(const float* kb, const float* vb,
                                       int64_t keys) {
    constexpr int BKV = Cfg<D>::BKV, CH = D / 4;
#pragma unroll
    for (int j = 0; j < Cfg<D>::LOADS; ++j) {
      const int i = threadIdx.x + THREADS * j;
      if constexpr (!Cfg<D>::EXACT) {
        if (i >= Cfg<D>::CHUNKS) break;
      }
      const int kr = i / CH, kc = (i % CH) * 4;
      k[j] = ld4(kb + kr * D + kc, kr < keys);
      const int vr = i % BKV, vc = (i / BKV) * 4;
      v[j] = ld4(vb + vr * D + vc, vr < keys);
    }
  }

  __device__ __forceinline__ void store_k(unsigned char* hi,
                                          unsigned char* lo) const {
    constexpr int CH = D / 4;
#pragma unroll
    for (int j = 0; j < Cfg<D>::LOADS; ++j) {
      const int i = threadIdx.x + THREADS * j;
      if constexpr (!Cfg<D>::EXACT) {
        if (i >= Cfg<D>::CHUNKS) break;
      }
      st_split4(hi, lo, swz(i / CH, (i % CH) * 4, Cfg<D>::K_PANEL), k[j]);
    }
  }

  __device__ __forceinline__ void store_v(unsigned char* hi,
                                          unsigned char* lo) const {
    constexpr int BKV = Cfg<D>::BKV;
#pragma unroll
    for (int j = 0; j < Cfg<D>::LOADS; ++j) {
      const int i = threadIdx.x + THREADS * j;
      if constexpr (!Cfg<D>::EXACT) {
        if (i >= Cfg<D>::CHUNKS) break;
      }
      const int slot = key_slot(i % BKV), c = (i / BKV) * 4;
      st_split(hi, lo, swz(c + 0, slot, Cfg<D>::V_PANEL), v[j].x);
      st_split(hi, lo, swz(c + 1, slot, Cfg<D>::V_PANEL), v[j].y);
      st_split(hi, lo, swz(c + 2, slot, Cfg<D>::V_PANEL), v[j].z);
      st_split(hi, lo, swz(c + 3, slot, Cfg<D>::V_PANEL), v[j].w);
    }
  }
};

// ---- the two products of a key tile, for one warpgroup -----------------------

// S (64 x BKV) = Q K^T in 3xTF32, one wgmma m64n{BKV}k8 a k8 step and
// product: hi.hi into s, the two lo products into s_lo, added once the
// products are done (two accumulators, so the tensor cores have two
// chains of products in flight).  q_hi / q_lo: the warpgroup's 64 rows; a
// k8 step is 32 bytes along a panel's rows, 4 steps a panel
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[Cfg<D>::SR],
                                         float (&s_lo)[Cfg<D>::SR],
                                         uint32_t q_hi, uint32_t q_lo,
                                         uint32_t k_hi, uint32_t k_lo) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint32_t qa = (kk / 4) * C::Q_PANEL + (kk % 4) * 32;
    const uint32_t ka = (kk / 4) * C::K_PANEL + (kk % 4) * 32;
    wgmma_ss<C::BKV>(s_lo, wg_desc(q_lo + qa, 16, 1024),
                     wg_desc(k_hi + ka, 16, 1024), kk > 0);
    wgmma_ss<C::BKV>(s_lo, wg_desc(q_hi + qa, 16, 1024),
                     wg_desc(k_lo + ka, 16, 1024), 1);
    wgmma_ss<C::BKV>(s, wg_desc(q_hi + qa, 16, 1024),
                     wg_desc(k_hi + ka, 16, 1024), kk > 0);
  }
}

// O_t (64 x D) = P V in 3xTF32, P hi / lo in registers, one wgmma
// m64n{D}k8 a k8 step and product: step kk is keys 8 kk .. 8 kk + 7,
// accumulator registers 4 kk .. 4 kk + 3 of S, whose order {0, 2, 1, 3} is
// the A fragment's (keys permuted in V^T)
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[Cfg<D>::OR],
                                         const float (&ph)[Cfg<D>::SR],
                                         const float (&pl)[Cfg<D>::SR],
                                         uint32_t v_hi, uint32_t v_lo) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < C::BKV / 8; ++kk) {
    const int g = 4 * kk;
    const uint32_t va = (kk / 4) * C::V_PANEL + (kk % 4) * 32;
    wgmma_rs<D>(o, pl[g], pl[g + 2], pl[g + 1], pl[g + 3],
                wg_desc(v_hi + va, 16, 1024), kk > 0);
    wgmma_rs<D>(o, ph[g], ph[g + 2], ph[g + 1], ph[g + 3],
                wg_desc(v_lo + va, 16, 1024), 1);
  }
#pragma unroll
  for (int kk = 0; kk < C::BKV / 8; ++kk) {
    const int g = 4 * kk;
    const uint32_t va = (kk / 4) * C::V_PANEL + (kk % 4) * 32;
    wgmma_rs<D>(o, ph[g], ph[g + 2], ph[g + 1], ph[g + 3],
                wg_desc(v_hi + va, 16, 1024), 1);
  }
}

// The online softmax of a tile's scores s: s[4 j + e] is row row_a + 8
// (e / 2), key k0 + 8 j + col_l + e % 2.  Updates m and the partial sums
// l, rescales O by the correction, leaves P's hi in s and lo in pl.
template <int D>
__device__ __forceinline__ void softmax(float (&s)[Cfg<D>::SR],
                                        float (&pl)[Cfg<D>::SR],
                                        float (&o)[Cfg<D>::OR],
                                        float (&m)[2], float (&l)[2],
                                        const Shape& sh, int64_t k0,
                                        int64_t row_a, int col_l,
                                        bool masked) {
  using C = Cfg<D>;
  const Mask& mask = sh.mask;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < C::SR; ++i) {
    float v = s[i] * sh.scale_log2;
    if (masked) {
      const int64_t key = k0 + 8 * (i / 4) + col_l + (i % 2);
      const int64_t row = row_a + 8 * ((i / 2) % 2);
      bool vis = key < sh.skv;
      if (mask.causal) vis = vis && key <= row;
      if (mask.windowed) vis = vis && row - key < mask.window;
      v = vis ? v : -INFINITY;
    }
    s[i] = v;
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], v);
  }
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    corr[h] = exp2f(m[h] - mx[h]);
    m[h] = mx[h];
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < C::SR; ++i) {
    const int h = (i / 2) % 2;
    const float p = exp2f(s[i] - m[h]);
    sum[h] += p;
    const float hi = tf32_rna(p);
    s[i] = hi;
    pl[i] = tf32_rna(p - hi);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = corr[h] * l[h] + sum[h];
  if (!__all_sync(0xffffffffu, corr[0] == 1.0f && corr[1] == 1.0f)) {
#pragma unroll
    for (int i = 0; i < C::OR; ++i) o[i] *= corr[(i / 2) % 2];
  }
}

// ---- the block -----------------------------------------------------------

// The sweep of one block over key tiles [t0, t1): all THREADS threads of
// a block call it, with Cfg<D>::SMEM bytes of dynamic shared memory at
// smem.  qb: the block's BQ query rows (q_rows of them real, zeros past
// them), row q0 of their sequence; kb, vb: the sequence's keys and values
// (sh.skv of each).  Each row is masked by its position (sh.mask, the keys
// past sh.skv).  At the end each thread calls epilogue(o, m, l, row_a,
// col_l, lane) with its rows' unnormalised O, their max m (in the scaled
// log2 units of the sweep) and its partial sums l (not yet summed over the
// quad): flash attention stores O / l, chain_attn (kernels/chain) the
// partials of a chunk of keys.
template <int D, typename Epilogue>
__device__ __forceinline__ void sweep_block(const Shape& sh,
                                            const float* qb, int64_t q_rows,
                                            const float* kb, const float* vb,
                                            int64_t q0, int64_t t0,
                                            int64_t t1, unsigned char* smem,
                                            Epilogue&& epilogue) {
  using C = Cfg<D>;
  constexpr int BKV = C::BKV;
  unsigned char* q_hi = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
  unsigned char* q_lo = q_hi + C::Q_BYTES;
  unsigned char* k_hi = q_lo + C::Q_BYTES;
  unsigned char* k_lo = k_hi + C::K_BYTES;
  unsigned char* v_hi = k_lo + C::K_BYTES;
  unsigned char* v_lo = v_hi + C::V_BYTES;
  const Mask mask = sh.mask;
  const int n = t1 > t0 ? static_cast<int>(t1 - t0) : 0;

  TileRegs<D> next;
  if (n > 0) next.load(kb + t0 * BKV * D, vb + t0 * BKV * D, sh.skv - t0 * BKV);
  zero_pad<D>(q_hi, q_lo, BQ, C::Q_PANEL);
  zero_pad<D>(k_hi, k_lo, BKV, C::K_PANEL);
  stage_q<D>(qb, q_rows, q_hi, q_lo);
  if (n > 0) next.store_k(k_hi, k_lo);
  fence_async_shared();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int64_t r0 = q0 + wg * 64;                     // first row
  const int64_t row_a = r0 + warp * 16 + lane / 4;     // and row_a + 8
  const int col_l = 2 * (lane % 4);

  float o[C::OR];
#pragma unroll
  for (int i = 0; i < C::OR; ++i) o[i] = 0.0f;
  float m[2] = {-1e30f, -1e30f};
  float l[2] = {0.0f, 0.0f};

  const uint32_t qh = smem_addr(q_hi) + wg * 64 * 128;
  const uint32_t ql = smem_addr(q_lo) + wg * 64 * 128;
  const uint32_t kh = smem_addr(k_hi), kl = smem_addr(k_lo);
  const uint32_t vh = smem_addr(v_hi), vl = smem_addr(v_lo);

  // none of the warpgroup's rows sees a key of the tile (skip) / some keys
  // are hidden from some rows (masked)
  auto skips = [&](int64_t k0) {
    return (mask.causal && k0 > r0 + 63) ||
           (mask.windowed && r0 - (k0 + BKV - 1) >= mask.window);
  };
  auto masks = [&](int64_t k0) {
    return k0 + BKV > sh.skv || (mask.causal && k0 + BKV - 1 > r0) ||
           (mask.windowed && r0 + 63 - k0 >= mask.window);
  };

  for (int it = 0; it < n; ++it) {
    const int64_t k0 = (t0 + it) * BKV;
    const bool skip = skips(k0);
    float s[C::SR];
    float pl[C::SR];
    float ot[C::OR];
    __syncthreads();     // K(it) staged; every warpgroup done with V(it - 1)
    if (!skip) {
      wg_fence();
      issue_qk<D>(s, pl, qh, ql, kh, kl);
      wg_commit();
    }
    next.store_v(v_hi, v_lo);
    fence_async_shared();
    if (it + 1 < n) {
      const int64_t k1 = k0 + BKV;
      next.load(kb + k1 * D, vb + k1 * D, sh.skv - k1);
    }
    if (!skip) {
      wg_wait_all();
      pin(s);
      pin(pl);
#pragma unroll
      for (int i = 0; i < C::SR; ++i) s[i] = __fadd_rn(s[i], pl[i]);
      softmax<D>(s, pl, o, m, l, sh, k0, row_a, col_l, masks(k0));
    }
    __syncthreads();     // V(it) staged; every warpgroup done with K(it)
    if (!skip) {
      pin(s);
      pin(pl);
      wg_fence();
      issue_pv<D>(ot, s, pl, vh, vl);
      wg_commit();
    }
    if (it + 1 < n) {
      next.store_k(k_hi, k_lo);
      fence_async_shared();
    }
    if (!skip) {
      wg_wait_all();
      pin(ot);
#pragma unroll
      for (int i = 0; i < C::OR; ++i) o[i] = __fadd_rn(o[i], ot[i]);
    }
  }

  epilogue(o, m, l, row_a, col_l, lane);
}

// Flash attention's block: all THREADS threads of a block call it, with
// Cfg<D>::SMEM bytes of dynamic shared memory at smem.  Block (x, y)
// computes q head x % Hq of batch x / Hq for query tile gridDim.y - 1 - y;
// with LSE, also each of its rows' log-sum-exp into the (B, Hq, Sq) buffer
// lse.
template <int D, bool LSE>
__device__ __forceinline__ void attention_block(const Shape& sh,
                                                unsigned char* smem,
                                                float* __restrict__ lse) {
  using C = Cfg<D>;
  constexpr int BKV = C::BKV;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / sh.hq;
  const int64_t kvh = b * sh.hkv + (bh % sh.hq) / (sh.hq / sh.hkv);
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * BQ;
  const Mask mask = sh.mask;
  const float* kb = sh.k + kvh * sh.skv * D;
  const float* vb = sh.v + kvh * sh.skv * D;

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

  sweep_block<D>(
      sh, sh.q + (bh * sh.sq + q0) * D, sh.sq - q0, kb, vb, q0, t0, t1, smem,
      [&](float (&o)[C::OR], float (&m)[2], float (&l)[2], int64_t row_a,
          int col_l, int lane) {
      // out = O / l; a row that saw no key has l = 0, O = 0
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        const int64_t row = row_a + 8 * h;
        if (row >= sh.sq) continue;
        if constexpr (LSE) {
          if ((lane & 3) == 0)
            lse[bh * sh.sq + row] =
                l[h] == 0.0f ? INFINITY
                             : (m[h] + log2f(l[h])) * 0.6931471805599453f;
        }
        const float safe = l[h] == 0.0f ? 1.0f : l[h];
        float* dst = sh.out + (bh * sh.sq + row) * D + col_l;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(dst + 8 * j) =
              make_float2(__fdiv_rn(o[4 * j + 2 * h], safe),
                          __fdiv_rn(o[4 * j + 2 * h + 1], safe));
      }
      });
}

}  // namespace bind_attn_tf
