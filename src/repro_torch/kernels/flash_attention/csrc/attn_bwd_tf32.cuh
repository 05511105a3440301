// The float32 route of the attention backward on the tensor cores
// (f32_3xtf32): dq, dk, dv of out = softmax(q k^T * scale + mask) v from q,
// k, v, out, dout and the forward's per-row log-sum-exp, each product three
// TF32 wgmma (hi.hi + hi.lo + lo.hi, the operands split as attn_tf32.cuh
// splits them) accumulated in fp32, built from the pieces of the forward's
// 3xTF32 loop (attn_tf32.cuh: the wgmma forms, the split pass, the 128-byte
// swizzle, the key permutation that makes an accumulator an A operand).
//
// What bounds it on an H100: operations.  Per head and visible (row, key)
// pair the gradient needs five products of 2 d FLOP (s, dp, dq, dk, dv);
// this route forms s three times and dp twice (below), 16 d a pair, each
// as three TF32 products: 48 d TF32 FLOP a pair at 495 TFLOP/s, 1.04 ms at
// h2o-danube-1.8b's training shape (q (8, 32, 1024, 80), causal).  The
// CUDA-core route (flash_attention_bwd.cu) does the same 16 d a pair in
// f32 at 7-9 TFLOP/s of the card's 67.
//
// Layouts.  TF32 wgmma reads both shared-memory operands K-major only
// (attn_tf32.cuh), and A may come from registers.  Of the five products,
// S = Q K^T and dP = dO V^T contract over d: Q, K, dO and V are K-major as
// they lie.  dQ = dS K contracts over keys, dV = P^T dO and dK = dS^T Q over
// query rows: their B operands must be K^T, dO^T and Q^T (d rows, the keys
// or query rows contiguous), and their A operands (dS, P^T, dS^T) come from
// the registers of the product before, the keys (query rows) permuted
// inside each group of 8 as the forward permutes V^T's keys.  So the split
// pass stages transposed copies, hi and lo of each: K^T in the dq kernel,
// Q^T and dO^T in the dk/dv kernel.  A tile loaded with the 32 lanes of a
// warp on 32 rows of one 4-column chunk gives both layouts conflict-free
// stores (attn_tf32.cuh's V^T).
//
// Four launches:
//   (i)   attention_bwd_delta_f32_kernel: delta = sum_c dout_c out_c per
//         row into a (B, Hq, Sq) float32 scratch, one warp a row;
//   (ii)  attention_bwd_dq_tf32_kernel, one block (one warpgroup, 128
//         threads) per (64 query rows, q head, batch).  Q and dO, hi and
//         lo, stay in shared memory; it sweeps the key tiles the mask
//         leaves: S = Q K^T and dP = dO V^T, p = 2^(s scale log2 e - lse
//         log2 e), ds = p (dp - delta) on the accumulator fragment, then
//         dQ_t = dS K (dS hi / lo from registers, K^T from the split pass);
//   (iii) attention_bwd_dkv_tf32_kernel<D, false>, dV: one block (one
//         warpgroup) per (64 keys, kv head, batch), K hi and lo in shared
//         memory; it sweeps the group's query heads and, for each, the
//         query tiles that see its keys, in a fixed order: S^T = K Q^T,
//         P^T, dV_t = P^T dO;
//   (iv)  attention_bwd_dkv_tf32_kernel<D, true>, dK: the same blocks with
//         K and V: S^T and dP^T = V dO^T, dS^T, dK_t = dS^T Q.
// Each dk/dv tile's lse and delta go through shared memory (its columns are
// query rows).  dV and dK are two kernels: one kernel holding both passes
// had ptxas serialise every one of its wgmma (C7514), and apart the dV
// kernel's 95 KB at d = 80 let two of its blocks share an SM.  The group's
// query heads are summed inside a block, in order: there are no atomics
// and no head-group partials, so two calls give the same bits.  With
// 64-key blocks the grids fill the card at the shapes the route serves
// (h2o-danube: 8 x 8 x 16 = 1024 dk/dv blocks; Qwen3-14B at S 4096: 512).
//
// Accumulation.  The tensor cores truncate as they add into an fp32
// accumulator (attn_tf32.cuh: one accumulator over every key tile of the
// forward drifted to 7x the CUDA-core route's float64 error at S 8192).
// So every product over a streamed tile starts from zero in an accumulator
// of its own and is added into the running sum with one IEEE add: dQ over
// key tiles, dK and dV over query tiles and heads (tools/attn_faults.py
// plants the single-accumulator drift in each).  S, dP, S^T and dP^T keep
// their two lo products in an accumulator apart from hi.hi's, added once
// they are done, as the forward's S does.
//
// Registers (one warpgroup, 255 a thread, no spill allowed: chip_smoke.py
// reads -Xptxas -v): the running sum (d / 2), the tile's product (d / 2),
// the two score accumulators with their lo halves (2 BS, BS rows a
// streamed tile) and the next tile's operands in flight (BS d / 128
// each).  The operand the softmax terms do not need (V in dq, dO in
// dk/dv) is loaded only after them, so at most one of the two is live
// beside the scores.  One kernel holding dK, dV and both tile products
// would be 2 d of accumulators alone (256 at d = 128): dV and dK are
// separate sweeps, forming S^T twice, 16 d FLOP a pair against the 10 d
// the gradient needs.  At d <= 80 a streamed tile is 32 rows, at d 96 and
// 128 16 rows.  The wgmma descriptors are formed in the loop from an
// opaque base word (opaque, desc): hoisted out of it, the 80 of the dq
// kernel's scores at d 80 held registers of their own, and it spilled.
// With CUDA 12.8's ptxas: 166-255 registers a thread over the 15 kernels,
// none spilling.
//
// Shared memory (bytes, hi and lo of everything, 32-column panels, the
// last one of d 80 zero-filled past d once a block; no product reads past
// column d):
//   d     BS   dq: Q, dO + K, V + K^T       dV: K + Q + dO^T    dK: K, V + Q, dO + Q^T
//   32    32   32768 + 16384 + 8192         16384 + 8192 + 8192    32768 + 16384 + 8192
//   64    32   65536 + 32768 + 16384        32768 + 16384 + 16384  65536 + 32768 + 16384
//   80    32   98304 + 49152 + 20480        49152 + 24576 + 20480  98304 + 49152 + 20480
//   96    16   98304 + 24576 + 24576        49152 + 12288 + 24576  98304 + 24576 + 24576
//   128   16   131072 + 32768 + 32768       65536 + 16384 + 32768  131072 + 32768 + 32768
// plus 1024 of alignment and the dk/dv tile's lse and delta: at most
// 197,760 bytes (dK at d 128) of the 232,448 a block may have.
//
// Pipeline (one warpgroup; the split pass of one tile hides behind the
// products of the other half): barrier; issue the scores (async); store the
// transposed operand of tile t; load the next tile's first operand; wait;
// softmax terms; load its second operand; barrier; issue the tile's dQ /
// dV / dK product; store the next tile's K-major operands; wait; add.
// Each barrier after a fence.proxy.async.
//
// Masks: tile pairs no (row, key) of which is visible are skipped, as in
// the other routes; a tile that holds a diagonal, a window edge or the
// ragged end of the keys tests each element (32-bit positions relative to
// the tile).  Rows and keys past Sq / Skv are zeros from the split pass; a
// row past Sq gets lse = +inf and delta = 0 (p = 0, ds = 0), a key past
// Skv is masked, and neither is stored.  A row that sees no key has lse =
// +inf from the forward, so p = 0: its dq is 0 and it adds nothing to dk or
// dv.  p uses the accurate exp2f of the forward.
//
// The route (flash_attention_bwd.cu route_of) takes float32 with d one of
// tf32_head_dim's (32, 64, 80, 96, 128 here; 256 on the blocks of
// attn_bwd_tf32_wide.cuh, included below), q, k, v, out, dout and the
// log-sum-exp 16-byte aligned, and a log-sum-exp the forward saved; any
// other float32 call takes f32_simt.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "attn_mask.cuh"
#include "attn_tf32.cuh"

namespace bind_attn_bwd_tf {

using bind_attn::capped;
using bind_attn::Mask;
using bind_attn::visible;
using bind_attn::window32;
using bind_attn_tf::fence_async_shared;
using bind_attn_tf::key_slot;
using bind_attn_tf::ld4;
using bind_attn_tf::pin;
using bind_attn_tf::st_split;
using bind_attn_tf::st_split4;
using bind_attn_tf::swz;
using bind_attn_tf::tf32_rna;
using bind_attn_tf::wgmma_rs;
using bind_attn_tf::wgmma_ss;
using bind_attn_tf::zero_pad;
using bind_gemm::smem_addr;
using bind_gemm::wg_commit;
using bind_gemm::wg_fence;
using bind_gemm::wg_wait_all;

constexpr int THREADS = 128;   // one warpgroup
constexpr int OWN = 64;        // a block's query rows (dq) or keys (dk/dv)
constexpr float LOG2E = 1.4426950408889634f;

template <int D> struct Cfg {
  static_assert(bind_attn_tf::tf32_head_dim(D) && D <= 128,
                "d: 32, 64, 80, 96, 128");
  static constexpr int PANELS = bind_attn_tf::tf32_panels(D);
  // rows of a streamed tile: keys (dq), query rows (dk/dv)
  static constexpr int BS = D <= 80 ? 32 : 16;
  static constexpr int OWN_PANEL = OWN * 128;         // 32 columns, 64 rows
  static constexpr int OWN_BYTES = PANELS * OWN_PANEL;     // hi or lo
  static constexpr int S_PANEL = BS * 128;            // 32 columns, BS rows
  static constexpr int S_BYTES = PANELS * S_PANEL;
  static constexpr int T_BYTES = D * 128;   // a transposed tile: D rows
  static constexpr size_t DQ_SMEM = 1024 + 4 * size_t(OWN_BYTES) +
                                    4 * size_t(S_BYTES) + 2 * size_t(T_BYTES);
  static constexpr int LOADS = BS * D / 4 / THREADS;  // float4 an operand
  static constexpr int AR = BS / 2;                   // S registers a thread
  static constexpr int OR = D / 2;                    // dQ / dK / dV ones
  static_assert(LOADS * 4 * THREADS == BS * D, "tile / threads");
  static_assert(DQ_SMEM <= 232448, "shared memory");
};

// the problem of one launch; q, out, dout, dq (B, Hq, Sq, D), k, v, dk, dv
// (B, Hkv, Skv, D), lse and delta (B, Hq, Sq)
struct Shape {
  const float* q;
  const float* k;
  const float* v;
  const float* out;
  const float* dout;
  const float* lse;
  float* delta;
  float* dq;
  float* dk;
  float* dv;
  int64_t hq, hkv, sq, skv;
  float scale;           // softmax scale
  float scale_log2;      // scale * log2(e)
  Mask mask;
  // d 256 (attn_bwd_tf32_wide.cuh): the head groups a kv head's query
  // heads are split into across dk / dv blocks, and with more than one
  // their float32 partials, a (2, B, groups, Hkv, Skv, D) scratch (0: dV,
  // 1: dK); 1 and null below d 256
  float* part;
  int64_t groups;
};

// x, opaque to the compiler: what a loop derives from it (descriptors,
// shared-memory offsets) is formed where it is used, each iteration, and
// not hoisted out of the loop into registers of its own (the dq kernel
// held 80 descriptors so at d 80, and spilled)
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// The low word of a K-major operand's wgmma descriptor (128-byte swizzle,
// 16-byte leading and 1024-byte stride offsets; bind_gemm::wg_desc) at
// shared address addr.  Its high word is the same for every operand.
constexpr uint32_t DESC_HI = (1024 >> 4) | (1u << 30);
__device__ __forceinline__ uint32_t desc_lo(uint32_t addr) {
  return ((addr & 0x3FFFF) >> 4) | ((16 >> 4) << 16);
}

// the descriptor of the operand `bytes` (a multiple of 16) past the one
// whose low word is lo: the 14-bit address field cannot carry past shared
// memory's 227 KB
__device__ __forceinline__ uint64_t desc(uint32_t lo, uint32_t bytes) {
  uint64_t d;
  asm("mov.b64 %0, {%1, %2};\n"
      : "=l"(d)
      : "r"(lo + (bytes >> 4)), "r"(DESC_HI));
  return d;
}

// ---- staging ------------------------------------------------------------------

// a block's own 64 rows (zeros past `rows`), K-major, split, by all threads
template <int D>
__device__ __forceinline__ void stage_own(const float* src, int64_t rows,
                                          unsigned char* hi,
                                          unsigned char* lo) {
  constexpr int CH = D / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < OWN * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    st_split4(hi, lo, swz(r, c, Cfg<D>::OWN_PANEL),
              ld4(src + r * D + c, r < rows));
  }
}

// Two operands of a streamed tile of BS rows in registers, the 32 lanes of
// a warp (16 at BS 16) on rows of one 4-column chunk; rows at or past
// `rows` read as zeros.  Each operand is loaded on its own (load<W>), and
// goes to shared memory K-major (store<W>) or transposed with its rows
// permuted (store_t<W>).
template <int D> struct Tile {
  float4 x[2][Cfg<D>::LOADS];

  template <int W>
  __device__ __forceinline__ void load(const float* a, int64_t rows) {
    constexpr int BS = Cfg<D>::BS;
#pragma unroll
    for (int j = 0; j < Cfg<D>::LOADS; ++j) {
      const int i = threadIdx.x + THREADS * j;
      const int r = i % BS, c = (i / BS) * 4;
      x[W][j] = ld4(a + r * D + c, r < rows);
    }
  }

  template <int W>
  __device__ __forceinline__ void store(unsigned char* hi,
                                        unsigned char* lo) const {
    constexpr int BS = Cfg<D>::BS;
    const int tid = static_cast<int>(opaque(threadIdx.x));
#pragma unroll
    for (int j = 0; j < Cfg<D>::LOADS; ++j) {
      const int i = tid + THREADS * j;
      st_split4(hi, lo, swz(i % BS, (i / BS) * 4, Cfg<D>::S_PANEL),
                x[W][j]);
    }
  }

  template <int W>
  __device__ __forceinline__ void store_t(unsigned char* hi,
                                          unsigned char* lo) const {
    constexpr int BS = Cfg<D>::BS;
    const int tid = static_cast<int>(opaque(threadIdx.x));
#pragma unroll
    for (int j = 0; j < Cfg<D>::LOADS; ++j) {
      const int i = tid + THREADS * j;
      const int slot = key_slot(i % BS), c = (i / BS) * 4;
      const float4 t = x[W][j];
      st_split(hi, lo, swz(c + 0, slot, Cfg<D>::T_BYTES), t.x);
      st_split(hi, lo, swz(c + 1, slot, Cfg<D>::T_BYTES), t.y);
      st_split(hi, lo, swz(c + 2, slot, Cfg<D>::T_BYTES), t.z);
      st_split(hi, lo, swz(c + 3, slot, Cfg<D>::T_BYTES), t.w);
    }
  }
};

// ---- the products ---------------------------------------------------------------

// acc (64 x BS) = A B^T over d in 3xTF32: A the block's own 64 rows, B a
// streamed tile's BS rows, both K-major (a_hi ... b_lo: their descriptors'
// low words); hi.hi into acc, the two lo products into acc_lo (the
// forward's issue_qk)
template <int D>
__device__ __forceinline__ void issue_scores(float (&acc)[Cfg<D>::AR],
                                             float (&acc_lo)[Cfg<D>::AR],
                                             uint32_t a_hi, uint32_t a_lo,
                                             uint32_t b_hi, uint32_t b_lo) {
  using C = Cfg<D>;
  a_hi = opaque(a_hi);
  a_lo = opaque(a_lo);
  b_hi = opaque(b_hi);
  b_lo = opaque(b_lo);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint32_t aa = (kk / 4) * C::OWN_PANEL + (kk % 4) * 32;
    const uint32_t ba = (kk / 4) * C::S_PANEL + (kk % 4) * 32;
    wgmma_ss<C::BS>(acc_lo, desc(a_lo, aa), desc(b_hi, ba), kk > 0);
    wgmma_ss<C::BS>(acc_lo, desc(a_hi, aa), desc(b_lo, ba), 1);
    wgmma_ss<C::BS>(acc, desc(a_hi, aa), desc(b_hi, ba), kk > 0);
  }
}

// acc (64 x D) = A B from zero in 3xTF32: A (64 x BS) hi / lo in registers
// as a 64 x BS accumulator lies, B (BS x D) a transposed tile (D rows of
// BS permuted columns; t_hi / t_lo its descriptors' low words); lo
// products first (the forward's issue_pv)
template <int D>
__device__ __forceinline__ void issue_grad(float (&acc)[Cfg<D>::OR],
                                           const float (&ah)[Cfg<D>::AR],
                                           const float (&al)[Cfg<D>::AR],
                                           uint32_t t_hi, uint32_t t_lo) {
  using C = Cfg<D>;
  t_hi = opaque(t_hi);
  t_lo = opaque(t_lo);
#pragma unroll
  for (int kk = 0; kk < C::BS / 8; ++kk) {
    const int g = 4 * kk;
    wgmma_rs<D>(acc, al[g], al[g + 2], al[g + 1], al[g + 3],
                desc(t_hi, kk * 32), kk > 0);
    wgmma_rs<D>(acc, ah[g], ah[g + 2], ah[g + 1], ah[g + 3],
                desc(t_lo, kk * 32), 1);
  }
#pragma unroll
  for (int kk = 0; kk < C::BS / 8; ++kk) {
    const int g = 4 * kk;
    wgmma_rs<D>(acc, ah[g], ah[g + 2], ah[g + 1], ah[g + 3],
                desc(t_hi, kk * 32), 1);
  }
}

// x = tf32(x) + its lo half, the hi half left in x and the lo in lo
__device__ __forceinline__ void split(float& x, float& lo) {
  const float hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
  x = hi;
}

// acc (64 x D, the fragment: row r0 + warp 16 + lane / 4 + 8 (e / 2),
// column 8 j + 2 (lane % 4) + e % 2 at acc[4 j + e]) times mul to dst,
// rows at or past `rows` not stored
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[Cfg<D>::OR],
                                           float mul, float* dst,
                                           int64_t r0, int64_t rows) {
  const int tid = threadIdx.x;
  const int64_t row_a = r0 + (tid / 32) * 16 + (tid % 32) / 4;
  const int col_l = 2 * (tid % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t row = row_a + 8 * h;
    if (row >= rows) continue;
    float* p = dst + row * D + col_l;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(p + 8 * j) =
          make_float2(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
  }
}

// ---- (i) delta ------------------------------------------------------------------

// DELTA[r] = sum_c dO[r, c] O[r, c] in f32 for r < rows, one warp a row
__global__ void __launch_bounds__(256)
attention_bwd_delta_f32_kernel(const float* __restrict__ O,
                               const float* __restrict__ dO,
                               float* __restrict__ DELTA, int64_t rows,
                               int d) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float s = 0.0f;
  for (int c = lane; c < d; c += 32)
    s = fmaf(O[row * d + c], dO[row * d + c], s);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) DELTA[row] = s;
}

// ---- (ii) dq --------------------------------------------------------------------

// All THREADS threads of a block call it, with Cfg<D>::DQ_SMEM bytes of
// dynamic shared memory.  Block (x, y) computes dq of q head x % Hq of
// batch x / Hq for query rows [64 t, 64 t + 64), t = gridDim.y - 1 - y.
template <int D>
__device__ __forceinline__ void dq_block(const Shape& sh,
                                         unsigned char* smem) {
  using C = Cfg<D>;
  constexpr int BS = C::BS;
  unsigned char* q_hi = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
  unsigned char* q_lo = q_hi + C::OWN_BYTES;
  unsigned char* do_hi = q_lo + C::OWN_BYTES;
  unsigned char* do_lo = do_hi + C::OWN_BYTES;
  unsigned char* k_hi = do_lo + C::OWN_BYTES;
  unsigned char* k_lo = k_hi + C::S_BYTES;
  unsigned char* v_hi = k_lo + C::S_BYTES;
  unsigned char* v_lo = v_hi + C::S_BYTES;
  unsigned char* kt_hi = v_lo + C::S_BYTES;
  unsigned char* kt_lo = kt_hi + C::T_BYTES;

  const int64_t bh = blockIdx.x;
  const int64_t b = bh / sh.hq;
  const int64_t kvh = b * sh.hkv + (bh % sh.hq) / (sh.hq / sh.hkv);
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * OWN;
  const Mask mask = sh.mask;
  const float* kb = sh.k + kvh * sh.skv * D;
  const float* vb = sh.v + kvh * sh.skv * D;

  // the key tiles the mask leaves for rows [q0, q0 + 64)
  int64_t t0 = 0;
  int64_t t1 = (sh.skv + BS - 1) / BS;
  if (mask.causal) {
    const int64_t last = (q0 + OWN - 1) / BS + 1;
    t1 = last < t1 ? last : t1;
  }
  if (mask.windowed) {
    const int64_t oldest = q0 - mask.window + 1;
    if (oldest > 0) t0 = oldest / BS;
  }
  const int n = t1 > t0 ? static_cast<int>(t1 - t0) : 0;

  Tile<D> next;
  if (n > 0) {
    next.template load<0>(kb + t0 * BS * D, sh.skv - t0 * BS);
    next.template load<1>(vb + t0 * BS * D, sh.skv - t0 * BS);
  }
  zero_pad<D>(q_hi, q_lo, OWN, C::OWN_PANEL);
  zero_pad<D>(do_hi, do_lo, OWN, C::OWN_PANEL);
  zero_pad<D>(k_hi, k_lo, BS, C::S_PANEL);
  zero_pad<D>(v_hi, v_lo, BS, C::S_PANEL);
  stage_own<D>(sh.q + (bh * sh.sq + q0) * D, sh.sq - q0, q_hi, q_lo);
  stage_own<D>(sh.dout + (bh * sh.sq + q0) * D, sh.sq - q0, do_hi, do_lo);
  if (n > 0) {
    next.template store<0>(k_hi, k_lo);
    next.template store<1>(v_hi, v_lo);
  }
  fence_async_shared();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row_a = q0 + warp * 16 + lane / 4;     // and row_a + 8
  const int col_l = 2 * (lane % 4);
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t row = row_a + 8 * h;
    const bool in = row < sh.sq;
    lse2[h] = in ? sh.lse[bh * sh.sq + row] * LOG2E : INFINITY;
    dlt[h] = in ? sh.delta[bh * sh.sq + row] : 0.0f;
  }
  float dq[C::OR];
#pragma unroll
  for (int i = 0; i < C::OR; ++i) dq[i] = 0.0f;

  const uint32_t qh = desc_lo(smem_addr(q_hi)), ql = desc_lo(smem_addr(q_lo));
  const uint32_t doh = desc_lo(smem_addr(do_hi));
  const uint32_t dol = desc_lo(smem_addr(do_lo));
  const uint32_t kh = desc_lo(smem_addr(k_hi)), kl = desc_lo(smem_addr(k_lo));
  const uint32_t vh = desc_lo(smem_addr(v_hi)), vl = desc_lo(smem_addr(v_lo));
  const uint32_t kth = desc_lo(smem_addr(kt_hi));
  const uint32_t ktl = desc_lo(smem_addr(kt_lo));
  const int win = window32(mask);

  // The tile range is exact for a block of one warpgroup, so no tile is
  // skipped; the branches on skip stay because without them ptxas
  // serialised the loop's wgmma for registers (C7511) and spilled at d 80.
  for (int it = 0; it < n; ++it) {
    const int64_t k0 = (t0 + it) * BS;
    // none of the rows sees a key of the tile (skip) / some keys are
    // hidden from some rows (masked)
    const bool skip = (mask.causal && k0 > q0 + OWN - 1) ||
                      (mask.windowed && q0 - (k0 + BS - 1) >= mask.window);
    const bool masked = k0 + BS > sh.skv ||
                        (mask.causal && k0 + BS - 1 > q0) ||
                        (mask.windowed && q0 + OWN - 1 - k0 >= mask.window);
    float s[C::AR], sl[C::AR], dp[C::AR], dpl[C::AR];
    __syncthreads();     // K(it), V(it) staged; every warp done with K^T
    if (!skip) {
      wg_fence();
      issue_scores<D>(s, sl, qh, ql, kh, kl);
      issue_scores<D>(dp, dpl, doh, dol, vh, vl);
      wg_commit();
    }
    next.template store_t<0>(kt_hi, kt_lo);
    fence_async_shared();
    const int64_t k1 = k0 + BS;
    if (it + 1 < n) next.template load<0>(kb + k1 * D, sh.skv - k1);
    if (!skip) {
      wg_wait_all();
      pin(s);
      pin(sl);
      pin(dp);
      pin(dpl);
      // s[4 j + e]: row row_a + 8 (e / 2), key k0 + 8 j + col_l + e % 2
      const int rel = static_cast<int>(row_a - k0) - col_l;
      const int left = capped(sh.skv - k0, BS) - col_l;
#pragma unroll
      for (int i = 0; i < C::AR; ++i) {
        const int h = (i / 2) % 2;
        const int at = 8 * (i / 4) + (i % 2);          // the key's offset
        float p = exp2f(__fadd_rn(s[i], sl[i]) * sh.scale_log2 - lse2[h]);
        if (masked && !visible(mask, rel + 8 * h - at, left - at, win))
          p = 0.0f;
        s[i] = p * (__fadd_rn(dp[i], dpl[i]) - dlt[h]);
        split(s[i], sl[i]);
      }
    }
    // V(it + 1) only now: its registers are not live beside the scores'
    if (it + 1 < n) next.template load<1>(vb + k1 * D, sh.skv - k1);
    __syncthreads();     // K^T(it) staged; every warp done with K, V(it)
    float dqt[C::OR];
    if (!skip) {
      pin(s);
      pin(sl);
      wg_fence();
      issue_grad<D>(dqt, s, sl, kth, ktl);
      wg_commit();
    }
    if (it + 1 < n) {
      next.template store<0>(k_hi, k_lo);
      next.template store<1>(v_hi, v_lo);
      fence_async_shared();
    }
    if (!skip) {
      wg_wait_all();
      pin(dqt);
#pragma unroll
      for (int i = 0; i < C::OR; ++i) dq[i] = __fadd_rn(dq[i], dqt[i]);
    }
  }
  store_rows<D>(dq, sh.scale, sh.dq + bh * sh.sq * D, q0, sh.sq);
}

// ---- (iii) dk and dv ---------------------------------------------------------------

// The dk/dv blocks' shared memory: the block's own K (and, for dK, V), hi
// and lo; the streamed tile's K-major Q (and, for dK, dO); its transposed
// dO^T (dV) or Q^T (dK); its rows' lse and delta
template <int D, bool DK> struct DkvSmem {
  using C = Cfg<D>;
  static constexpr int OWNS = DK ? 2 : 1;
  static constexpr size_t BYTES =
      1024 + 2 * OWNS * size_t(C::OWN_BYTES) + 2 * OWNS * size_t(C::S_BYTES) +
      2 * size_t(C::T_BYTES) + 2 * C::BS * sizeof(float);
  static_assert(BYTES <= 232448, "shared memory");
};

// All THREADS threads of a block call it, with DkvSmem<D, DK>::BYTES of
// dynamic shared memory.  Block (x, y) computes dV (DK false) or dK of
// keys [64 y, 64 y + 64) of kv head x % Hkv of batch x / Hkv over all of
// the head's query heads, in order, and each of their query tiles that
// sees the keys.
template <int D, bool DK>
__device__ __forceinline__ void dkv_block(const Shape& sh,
                                          unsigned char* smem) {
  using C = Cfg<D>;
  using M = DkvSmem<D, DK>;
  constexpr int BS = C::BS;
  unsigned char* k_hi = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
  unsigned char* k_lo = k_hi + C::OWN_BYTES;
  unsigned char* v_hi = k_lo + C::OWN_BYTES;           // dK only
  unsigned char* v_lo = v_hi + C::OWN_BYTES;
  unsigned char* q_hi = k_hi + 2 * M::OWNS * C::OWN_BYTES;
  unsigned char* q_lo = q_hi + C::S_BYTES;
  unsigned char* do_hi = q_lo + C::S_BYTES;            // dK only
  unsigned char* do_lo = do_hi + C::S_BYTES;
  unsigned char* t_hi = q_hi + 2 * M::OWNS * C::S_BYTES;
  unsigned char* t_lo = t_hi + C::T_BYTES;
  float* lse_s = reinterpret_cast<float*>(t_lo + C::T_BYTES);
  float* dl_s = lse_s + BS;

  const int64_t hk = blockIdx.x % sh.hkv;
  const int64_t b = blockIdx.x / sh.hkv;
  const int64_t kb0 = static_cast<int64_t>(blockIdx.y) * OWN;
  const Mask mask = sh.mask;
  // the query tiles some row of which sees a key of [kb0, kb0 + 64)
  const int64_t qt0 = mask.causal ? kb0 / BS : 0;
  int64_t qt1 = (sh.sq + BS - 1) / BS;
  if (mask.windowed) {
    const int64_t last = kb0 + OWN - 1 + mask.window - 1;
    const int64_t end = last < 0 ? 0 : last / BS + 1;
    qt1 = end < qt1 ? end : qt1;
  }
  const int nqt = qt1 > qt0 ? static_cast<int>(qt1 - qt0) : 0;
  const int64_t group = sh.hq / sh.hkv;
  const int total = static_cast<int>(group) * nqt;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int64_t key_a = kb0 + warp * 16 + lane / 4;    // and key_a + 8
  const int col_l = 2 * (lane % 4);
  const int win = window32(mask);
  // how far the thread's first key lies short of Skv (> 0: it exists)
  const int left = capped(sh.skv > key_a ? sh.skv - key_a : 0, 16);

  auto head_of = [&](int it) { return group * hk + it / nqt; };
  auto row_of = [&](int it) { return (qt0 + it % nqt) * BS; };
  auto tile_ptr = [&](const float* base, int it) {
    return base + ((b * sh.hq + head_of(it)) * sh.sq + row_of(it)) * D;
  };
  // tile it's lse (log2 units) and delta into shared memory
  auto stage_rows = [&](int it) {
    if (tid < BS) {
      const int64_t row = row_of(it) + tid;
      const int64_t at = (b * sh.hq + head_of(it)) * sh.sq + row;
      const bool in = row < sh.sq;
      lse_s[tid] = in ? sh.lse[at] * LOG2E : INFINITY;
      dl_s[tid] = in ? sh.delta[at] : 0.0f;
    }
  };

  const int64_t koff = ((b * sh.hkv + hk) * sh.skv + kb0) * D;
  zero_pad<D>(k_hi, k_lo, OWN, C::OWN_PANEL);
  zero_pad<D>(q_hi, q_lo, BS, C::S_PANEL);
  stage_own<D>(sh.k + koff, sh.skv - kb0, k_hi, k_lo);
  if constexpr (DK) {
    zero_pad<D>(v_hi, v_lo, OWN, C::OWN_PANEL);
    zero_pad<D>(do_hi, do_lo, BS, C::S_PANEL);
    stage_own<D>(sh.v + koff, sh.skv - kb0, v_hi, v_lo);
  }

  const uint32_t kh = desc_lo(smem_addr(k_hi)), kl = desc_lo(smem_addr(k_lo));
  const uint32_t vh = desc_lo(smem_addr(v_hi)), vl = desc_lo(smem_addr(v_lo));
  const uint32_t qh = desc_lo(smem_addr(q_hi)), ql = desc_lo(smem_addr(q_lo));
  const uint32_t doh = desc_lo(smem_addr(do_hi));
  const uint32_t dol = desc_lo(smem_addr(do_lo));
  const uint32_t th = desc_lo(smem_addr(t_hi)), tl = desc_lo(smem_addr(t_lo));

  float acc[C::OR];
#pragma unroll
  for (int i = 0; i < C::OR; ++i) acc[i] = 0.0f;

  // Q (operand 0) is stored K-major (and, for dK, transposed), dO
  // (operand 1) transposed (dV) or K-major (dK)
  Tile<D> next;
  if (total > 0) {
    next.template load<0>(tile_ptr(sh.q, 0), sh.sq - row_of(0));
    next.template load<1>(tile_ptr(sh.dout, 0), sh.sq - row_of(0));
    next.template store<0>(q_hi, q_lo);
    if constexpr (DK) next.template store<1>(do_hi, do_lo);
    stage_rows(0);
  }
  fence_async_shared();

  for (int it = 0; it < total; ++it) {
    const int64_t q0 = row_of(it);
    // none of the tile's rows sees a key of the block's (never, the range
    // being exact: see dq_block) / some do not
    const bool skip = (mask.causal && q0 + BS - 1 < kb0) ||
                      (mask.windowed && q0 - (kb0 + OWN - 1) >= mask.window);
    const bool masked =
        kb0 + OWN > sh.skv || (mask.causal && kb0 + OWN - 1 > q0) ||
        (mask.windowed && q0 + BS - 1 - kb0 >= mask.window);
    float st[C::AR], stl[C::AR], dpt[C::AR], dptl[C::AR];
    __syncthreads();     // tile it staged; every warp done with the last
    if (!skip) {
      wg_fence();
      issue_scores<D>(st, stl, kh, kl, qh, ql);
      if constexpr (DK) issue_scores<D>(dpt, dptl, vh, vl, doh, dol);
      wg_commit();
    }
    next.template store_t<DK ? 0 : 1>(t_hi, t_lo);
    fence_async_shared();
    if (it + 1 < total)
      next.template load<0>(tile_ptr(sh.q, it + 1), sh.sq - row_of(it + 1));
    if (!skip) {
      wg_wait_all();
      pin(st);
      pin(stl);
      if constexpr (DK) {
        pin(dpt);
        pin(dptl);
      }
      // st[4 j + e]: key key_a + 8 (e / 2), row q0 + 8 j + col_l + e % 2
      const int rel = static_cast<int>(q0 - key_a) + col_l;
#pragma unroll
      for (int i = 0; i < C::AR; ++i) {
        const int c = 8 * (i / 4) + col_l + (i % 2);   // the row's offset
        const int e8 = 8 * ((i / 2) % 2);              // the key's
        float p = exp2f(__fadd_rn(st[i], stl[i]) * sh.scale_log2 - lse_s[c]);
        if (masked &&
            !visible(mask, rel + 8 * (i / 4) + (i % 2) - e8, left - e8, win))
          p = 0.0f;
        if constexpr (DK) p = p * (__fadd_rn(dpt[i], dptl[i]) - dl_s[c]);
        st[i] = p;
        split(st[i], stl[i]);
      }
    }
    // dO(it + 1) only now: its registers are not live beside the scores'
    if (it + 1 < total)
      next.template load<1>(tile_ptr(sh.dout, it + 1),
                            sh.sq - row_of(it + 1));
    __syncthreads();     // the transposed tile staged; every warp done with
                         // the K-major one, lse and delta
    float at[C::OR];
    if (!skip) {
      pin(st);
      pin(stl);
      wg_fence();
      issue_grad<D>(at, st, stl, th, tl);
      wg_commit();
    }
    if (it + 1 < total) {
      next.template store<0>(q_hi, q_lo);
      if constexpr (DK) next.template store<1>(do_hi, do_lo);
      stage_rows(it + 1);
      fence_async_shared();
    }
    if (!skip) {
      wg_wait_all();
      pin(at);
#pragma unroll
      for (int i = 0; i < C::OR; ++i) acc[i] = __fadd_rn(acc[i], at[i]);
    }
  }
  float* dst = (DK ? sh.dk : sh.dv) + (b * sh.hkv + hk) * sh.skv * D;
  store_rows<D>(acc, DK ? sh.scale : 1.0f, dst, kb0, sh.skv);
}

}  // namespace bind_attn_bwd_tf

// the blocks of d 256 (bind_attn_bwd_tfw), built from the helpers above
#include "attn_bwd_tf32_wide.cuh"

namespace bind_attn_bwd_tf {

// ---- kernels and the launcher -----------------------------------------------------

// a block's threads and dynamic shared memory at head dim D: one
// warpgroup up to d 128, two at d 256 (attn_bwd_tf32_wide.cuh)
template <int D, bool WIDE = (D > 128)> struct Blocks {
  static constexpr int THREADS = bind_attn_bwd_tf::THREADS;
  static constexpr size_t DQ = Cfg<D>::DQ_SMEM;
  static constexpr size_t DV = DkvSmem<D, false>::BYTES;
  static constexpr size_t DK = DkvSmem<D, true>::BYTES;
};
template <int D> struct Blocks<D, true> {
  using W = bind_attn_bwd_tfw::Cfg<D>;
  static constexpr int THREADS = bind_attn_bwd_tfw::THREADS;
  static constexpr size_t DQ = W::DQ_SMEM;
  static constexpr size_t DV = W::DV_SMEM;
  static constexpr size_t DK = W::DK_SMEM;
};

template <int D>
__global__ void __launch_bounds__(Blocks<D>::THREADS, 1)
attention_bwd_dq_tf32_kernel(const Shape sh) {
  extern __shared__ __align__(1024) unsigned char bwd_tf_smem[];
  if constexpr (D > 128)
    bind_attn_bwd_tfw::dq_block<D>(sh, bwd_tf_smem);
  else
    dq_block<D>(sh, bwd_tf_smem);
}

// DK false: dV; true: dK (two kernels: one holding both passes had ptxas
// serialise every wgmma of it, C7514)
template <int D, bool DK>
__global__ void __launch_bounds__(Blocks<D>::THREADS, 1)
attention_bwd_dkv_tf32_kernel(const Shape sh) {
  extern __shared__ __align__(1024) unsigned char bwd_tf_smem[];
  if constexpr (D <= 128)
    dkv_block<D, DK>(sh, bwd_tf_smem);
  else if constexpr (DK)
    bind_attn_bwd_tfw::dk_block<D>(sh, bwd_tf_smem);
  else
    bind_attn_bwd_tfw::dv_block<D>(sh, bwd_tf_smem);
}

// Enqueues (i)-(iv); sh.delta is a (B, Hq, Sq) float32 scratch.
template <int D>
cudaError_t launch_d(const Shape& sh, int64_t batch, cudaStream_t stream) {
  using C = Blocks<D>;
  const int64_t q_tiles = (sh.sq + OWN - 1) / OWN;
  const int64_t k_blocks = (sh.skv + OWN - 1) / OWN;
  if (q_tiles > 65535 || k_blocks > 65535 || batch * sh.hq > 0x7fffffff ||
      batch * sh.hkv * sh.groups > 0x7fffffff || sh.sq > 0x7fffffff ||
      sh.skv > 0x7fffffff || sh.groups < 1 ||
      (sh.hq / sh.hkv) % sh.groups != 0 ||
      (sh.groups > 1 && (D <= 128 || sh.part == nullptr)))
    return cudaErrorInvalidValue;
  auto kdq = attention_bwd_dq_tf32_kernel<D>;
  auto kdv = attention_bwd_dkv_tf32_kernel<D, false>;
  auto kdk = attention_bwd_dkv_tf32_kernel<D, true>;
  constexpr size_t DV_SMEM = C::DV;
  constexpr size_t DK_SMEM = C::DK;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kdq,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(C::DQ))) !=
          cudaSuccess ||
      (err = cudaFuncSetAttribute(kdv,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(DV_SMEM))) !=
          cudaSuccess ||
      (err = cudaFuncSetAttribute(kdk,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(DK_SMEM))) != cudaSuccess)
    return err;
  const int64_t rows = batch * sh.hq * sh.sq;
  attention_bwd_delta_f32_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256,
                                   0, stream>>>(sh.out, sh.dout, sh.delta,
                                                rows, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kdq<<<dim3(static_cast<unsigned>(batch * sh.hq),
             static_cast<unsigned>(q_tiles)),
        C::THREADS, C::DQ, stream>>>(sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 kv_grid(static_cast<unsigned>(batch * sh.hkv * sh.groups),
                     static_cast<unsigned>(k_blocks));
  kdv<<<kv_grid, C::THREADS, DV_SMEM, stream>>>(sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kdk<<<kv_grid, C::THREADS, DK_SMEM, stream>>>(sh);
  if constexpr (D > 128) {
    // the head groups' partials, summed in order
    if (sh.groups > 1) {
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      const int64_t per = sh.hkv * sh.skv * D;
      const int64_t quads = batch * per / 4;
      bind_attn_bwd_tfw::attention_bwd_dkv_sum_f32_kernel<<<
          dim3(static_cast<unsigned>(quads < 2048 * 256
                                         ? (quads + 255) / 256
                                         : 2048),
               2),
          256, 0, stream>>>(sh.part, sh.dv, sh.dk, batch, sh.groups, per);
    }
  }
  return cudaGetLastError();
}

inline cudaError_t launch(const Shape& sh, int64_t batch, int64_t d,
                          cudaStream_t stream) {
  switch (d) {
    case 32: return launch_d<32>(sh, batch, stream);
    case 64: return launch_d<64>(sh, batch, stream);
    case 80: return launch_d<80>(sh, batch, stream);
    case 96: return launch_d<96>(sh, batch, stream);
    case 128: return launch_d<128>(sh, batch, stream);
    case 256: return launch_d<256>(sh, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bind_attn_bwd_tf
