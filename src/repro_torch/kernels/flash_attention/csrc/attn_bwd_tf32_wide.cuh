// The float32 route of the attention backward on the tensor cores
// (f32_3xtf32) at head dim 256 (RecurrentGemma-9B, Gemma-7B): dq, dk, dv
// from q, k, v, out, dout and the forward's log-sum-exp, every product
// three TF32 wgmma (hi.hi + hi.lo + lo.hi) as in attn_bwd_tf32.cuh, whose
// delta pass, masks and accumulation rules it keeps: every product over a
// streamed tile summed from zero and added into the running sum with one
// IEEE add, the scores' two lo products in an accumulator apart from
// hi.hi's, no atomics, a block's query heads summed in a fixed order, and
// where a kv head's query heads are split into head groups across blocks
// (too few blocks to fill the card otherwise: RG-9B's one kv head), their
// float32 partials summed in order by attention_bwd_dkv_sum_f32_kernel
// (two calls give the same bits).  attn_bwd_tf32.cuh includes it after its
// helpers; its kernels launch these blocks at d 256.
//
// What bounds it on an H100: operations, 10 d Hq visible-pairs FLOP (five
// products), three TF32 products of each at 495 TFLOP/s (RecurrentGemma-9B
// at its training shape, S 4096, window 2048: 1.562 ms).  These blocks form
// S three times and dP twice, 16 d a pair, as attn_bwd_tf32.cuh's do.
//
// What d 256 changes.  attn_bwd_tf32.cuh's blocks are one warpgroup that
// keeps its two own operands (dq: Q and dO; dK: K and V) in shared memory,
// hi and lo: 64 x 256 x 4 x 4 = 256 KB, more than a block may have
// (232,448), and a running sum and a tile's product of 64 x 256 floats, 256
// registers a thread.  So every block here is two warpgroups (256 threads)
// and each owns half of the output's columns (64 + 64 registers), and the
// tiles streamed past the own rows are 16 rows: K-major in 128-byte panels,
// transposed (d rows of 16) in the 64-byte swizzle of attn_tf32_wide.cuh.
//
//   dq (dq_block) and dK (dk_block): the own operands stay raw, 64 KB each,
//     in the order of a TF32 A fragment (float4 [k8 slice][warp][lane]: a
//     thread's four values of a slice in one 16-byte load), and the score
//     products take A from registers, split into hi and lo as they are
//     issued, four k8 slices (32 registers) at a time, two such chunks in
//     flight.  The two score products are split between the warpgroups:
//     warpgroup 0 forms S (Q K^T, or S^T = K Q^T) and p, warpgroup 1 forms
//     dP (dO V^T, or dP^T = V dO^T) and dP - delta, each over all of d,
//     and each hands its 64 x 16 result to the other through the shared
//     memory of the operand it has just read (its streamed K or V, Q or
//     dO, dead until the next tile); both form dS = p (dP - delta) from
//     the two values read back, the same product in both, and its hi / lo,
//     then their half of dQ_t = dS K (dK_t = dS^T Q) from the transposed
//     tile.  Shared memory: raw 2 x 65,536, the two K-major tiles 4 x
//     16,384, the transposed one 2 x 16,384, 1,024 of alignment (and dK's
//     tile rows' lse and delta, 128): 230,400 (230,528) of 232,448.  Three
//     barriers a tile: the third lets both read the exchange before the
//     next tile overwrites it.
//   dV (dv_block): one score product, so the block is attn_tf32_wide.cuh's
//     forward with K in Q's place: K hi and lo stay in shared memory (128
//     KB), S^T = K Q^T is split over d (each warpgroup its 128 columns, the
//     two partials summed through shared memory in warpgroup 0's order),
//     p^T from the streamed rows' lse (double-buffered: p is formed after
//     the second barrier), and dV_t's half = P^T dO from dO^T.  205,952
//     bytes; two barriers a tile.
//
// Registers a thread: the running sum 64, the tile's product 64, the scores
// and their lo 16, the next tile in flight 32 (dV: one operand at a time,
// 16), and (dq, dK) the A fragments of two chunks, 64, while the scores are
// issued.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "attn_mask.cuh"
#include "attn_tf32_wide.cuh"

namespace bind_attn_bwd_tfw {

using bind_attn::capped;
using bind_attn::Mask;
using bind_attn::visible;
using bind_attn::window32;
using bind_attn_bwd_tf::desc;
using bind_attn_bwd_tf::desc_lo;
using bind_attn_bwd_tf::LOG2E;
using bind_attn_bwd_tf::opaque;
using bind_attn_bwd_tf::Shape;
using bind_attn_bwd_tf::split;
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
using bind_attn_tfw::desc64;
using bind_attn_tfw::swz64;
using bind_gemm::smem_addr;
using bind_gemm::wg_commit;
using bind_gemm::wg_fence;
using bind_gemm::wg_wait_all;

constexpr int THREADS = 256;   // two warpgroups
constexpr int OWN = 64;        // a block's query rows (dq) or keys (dk, dv)
constexpr int BS = 16;         // rows of a streamed tile

template <int D> struct Cfg {
  static_assert(D == 256, "d: 256");
  static constexpr int HALF = D / 2;                   // output columns a WG
  static constexpr int PANELS = D / 32;
  static constexpr int OWN_PANEL = OWN * 128;          // 32 columns, 64 rows
  static constexpr int OWN_BYTES = PANELS * OWN_PANEL; // hi or lo (dV's K)
  static constexpr int RAW_BYTES = OWN * D * 4;        // a raw own operand
  static constexpr int S_PANEL = BS * 128;             // 32 columns, 16 rows
  static constexpr int S_BYTES = PANELS * S_PANEL;     // hi or lo
  static constexpr int T_BYTES = D * 64;               // d rows of 16
  static constexpr int X_BYTES = 2 * OWN * BS * 4;     // dV's partial S^T
  static constexpr int LOADS = BS * D / 4 / THREADS;   // float4 an operand
  static constexpr int AR = BS / 2;                    // score registers
  static constexpr int OR = HALF / 2;                  // output registers
  static constexpr size_t DQ_SMEM = 1024 + 2 * size_t(RAW_BYTES) +
                                    4 * size_t(S_BYTES) + 2 * size_t(T_BYTES);
  static constexpr size_t DK_SMEM = DQ_SMEM + 2 * BS * sizeof(float);
  static constexpr size_t DV_SMEM =
      1024 + 2 * size_t(OWN_BYTES) + 2 * size_t(S_BYTES) +
      2 * size_t(T_BYTES) + X_BYTES + 2 * BS * sizeof(float);
  static_assert(LOADS * 4 * THREADS == BS * D, "tile / threads");
  static_assert(DK_SMEM <= 232448 && DV_SMEM <= 232448, "shared memory");
};

template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned char* aligned1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ---- staging ------------------------------------------------------------------

// A block's own 64 rows of d (zeros past `rows`), raw, in the order of a
// TF32 A fragment: float4 (slice kk, warp w, lane l) holds rows r = 16 w +
// l / 4 and r + 8 at columns c = 8 kk + l % 4 and c + 4, as (r, c), (r + 8,
// c), (r, c + 4), (r + 8, c + 4) (attn_tf32.cuh's a0 .. a3)
template <int D>
__device__ __forceinline__ void stage_raw(const float* src, int64_t rows,
                                          float* dst) {
  constexpr int CH = D / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < OWN * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    const float4 x = ld4(src + r * D + c, r < rows);
    float* p = dst + ((c / 8 * 4 + r / 16) * 32 + (r % 8) * 4) * 4 +
               (r % 16) / 8 + 2 * ((c / 4) % 2);
    p[0] = x.x;
    p[4] = x.y;
    p[8] = x.z;
    p[12] = x.w;
  }
}

// Two operands of a streamed tile of 16 rows in registers, 16 lanes on the
// rows of one 4-column chunk; rows at or past `rows` read as zeros.  Each
// goes to shared memory K-major (store<W>) or transposed, its rows
// permuted as keys are (store_t<W>).
template <int D> struct Tile {
  float4 x[2][Cfg<D>::LOADS];

  template <int W>
  __device__ __forceinline__ void load(const float* a, int64_t rows) {
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
    const int tid = static_cast<int>(opaque(threadIdx.x));
#pragma unroll
    for (int j = 0; j < Cfg<D>::LOADS; ++j) {
      const int i = tid + THREADS * j;
      st_split4(hi, lo, swz(i % BS, (i / BS) * 4, Cfg<D>::S_PANEL), x[W][j]);
    }
  }

  template <int W>
  __device__ __forceinline__ void store_t(unsigned char* hi,
                                          unsigned char* lo) const {
    const int tid = static_cast<int>(opaque(threadIdx.x));
#pragma unroll
    for (int j = 0; j < Cfg<D>::LOADS; ++j) {
      const int i = tid + THREADS * j;
      const int slot = key_slot(i % BS), c = (i / BS) * 4;
      const float4 t = x[W][j];
      st_split(hi, lo, swz64(c + 0, slot), t.x);
      st_split(hi, lo, swz64(c + 1, slot), t.y);
      st_split(hi, lo, swz64(c + 2, slot), t.z);
      st_split(hi, lo, swz64(c + 3, slot), t.w);
    }
  }
};

// ---- the products ---------------------------------------------------------------

// acc (64 x 16) = X B^T over all of d in 3xTF32: X the block's own rows in
// fragment order (xf), B a streamed tile's 16 rows, K-major (b_hi, b_lo:
// its descriptors' low words); hi.hi into acc, the lo products into acc_lo.
// A is split from X in chunks of four k8 slices, two chunks in flight.
// Returns with the last two chunks in flight: wg_wait_all() before acc is
// read.
template <int D>
__device__ __forceinline__ void issue_rs_scores(float (&acc)[Cfg<D>::AR],
                                                float (&acc_lo)[Cfg<D>::AR],
                                                const float4* xf,
                                                uint32_t b_hi,
                                                uint32_t b_lo) {
  using C = Cfg<D>;
  constexpr int CK = 4, CHUNKS = D / 8 / CK;
  const int frag = (threadIdx.x % 128) / 32 * 32 + threadIdx.x % 32;
  b_hi = opaque(b_hi);
  b_lo = opaque(b_lo);
  float ah[2][CK][4], al[2][CK][4];
#pragma unroll
  for (int ch = 0; ch < CHUNKS; ++ch) {
    const int buf = ch % 2;
    if (ch >= 2) wg_wait<1>();        // chunk ch - 2 done with buf
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      const float4 x = xf[(ch * CK + j) * 128 + frag];
      const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ah[buf][j][e] = tf32_rna(v[e]);
        al[buf][j][e] = tf32_rna(v[e] - ah[buf][j][e]);
      }
    }
    wg_fence();
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      const int kk = ch * CK + j;
      const uint32_t off = (kk / 4) * C::S_PANEL + (kk % 4) * 32;
      const float(&h)[4] = ah[buf][j];
      const float(&l)[4] = al[buf][j];
      wgmma_rs<BS>(acc_lo, l[0], l[1], l[2], l[3], desc(b_hi, off), kk > 0);
      wgmma_rs<BS>(acc_lo, h[0], h[1], h[2], h[3], desc(b_lo, off), 1);
      wgmma_rs<BS>(acc, h[0], h[1], h[2], h[3], desc(b_hi, off), kk > 0);
    }
    wg_commit();
  }
}

// acc (64 x 16) = A B^T over this warpgroup's 128 columns of d in 3xTF32,
// both from shared memory, K-major: A the own rows' hi / lo (64-row panels),
// B a streamed tile's (16-row panels); hi.hi into acc, the lo products into
// acc_lo (attn_tf32_wide.cuh's issue_qk)
template <int D>
__device__ __forceinline__ void issue_ss_scores(float (&acc)[Cfg<D>::AR],
                                                float (&acc_lo)[Cfg<D>::AR],
                                                uint32_t a_hi, uint32_t a_lo,
                                                uint32_t b_hi, uint32_t b_lo,
                                                int wg) {
  using C = Cfg<D>;
  a_hi = opaque(a_hi);
  a_lo = opaque(a_lo);
  b_hi = opaque(b_hi);
  b_lo = opaque(b_lo);
  const uint32_t p0 = wg * (C::HALF / 32);
#pragma unroll
  for (int kk = 0; kk < C::HALF / 8; ++kk) {
    const uint32_t panel = p0 + kk / 4;
    const uint32_t aa = panel * C::OWN_PANEL + (kk % 4) * 32;
    const uint32_t ba = panel * C::S_PANEL + (kk % 4) * 32;
    wgmma_ss<BS>(acc_lo, desc(a_lo, aa), desc(b_hi, ba), kk > 0);
    wgmma_ss<BS>(acc_lo, desc(a_hi, aa), desc(b_lo, ba), 1);
    wgmma_ss<BS>(acc, desc(a_hi, aa), desc(b_hi, ba), kk > 0);
  }
}

// acc (64 x 128) = A B from zero in 3xTF32: A (64 x 16) hi / lo in
// registers as a score accumulator lies, B this warpgroup's 128 rows of a
// transposed tile (t_hi, t_lo: their shared addresses); lo products first
template <int D>
__device__ __forceinline__ void issue_grad(float (&acc)[Cfg<D>::OR],
                                           const float (&ah)[Cfg<D>::AR],
                                           const float (&al)[Cfg<D>::AR],
                                           uint32_t t_hi, uint32_t t_lo) {
  t_hi = opaque(t_hi);
  t_lo = opaque(t_lo);
#pragma unroll
  for (int kk = 0; kk < BS / 8; ++kk) {
    const int g = 4 * kk;
    wgmma_rs<Cfg<D>::HALF>(acc, al[g], al[g + 2], al[g + 1], al[g + 3],
                           desc64(t_hi + kk * 32), kk > 0);
    wgmma_rs<Cfg<D>::HALF>(acc, ah[g], ah[g + 2], ah[g + 1], ah[g + 3],
                           desc64(t_lo + kk * 32), 1);
  }
#pragma unroll
  for (int kk = 0; kk < BS / 8; ++kk) {
    const int g = 4 * kk;
    wgmma_rs<Cfg<D>::HALF>(acc, ah[g], ah[g + 2], ah[g + 1], ah[g + 3],
                           desc64(t_hi + kk * 32), 1);
  }
}

// acc (the 64 x 128 fragment of this warpgroup's columns: row r0 + warp 16
// + lane / 4 + 8 (e / 2), column 128 wg + 8 j + 2 (lane % 4) + e % 2 at
// acc[4 j + e]) times mul to dst, rows at or past `rows` not stored
template <int D>
__device__ __forceinline__ void store_half(const float (&acc)[Cfg<D>::OR],
                                           float mul, float* dst, int64_t r0,
                                           int64_t rows) {
  const int tid = threadIdx.x % 128;
  const int wg = threadIdx.x / 128;
  const int64_t row_a = r0 + (tid / 32) * 16 + (tid % 32) / 4;
  const int col_l = wg * Cfg<D>::HALF + 2 * (tid % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t row = row_a + 8 * h;
    if (row >= rows) continue;
    float* p = dst + row * D + col_l;
#pragma unroll
    for (int j = 0; j < Cfg<D>::HALF / 8; ++j)
      *reinterpret_cast<float2*>(p + 8 * j) =
          make_float2(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
  }
}

// each thread's 8 score values into slot `part` (0: p, 1: dP - delta) of
// an exchange of 2 x 2 x 128 float4, and dS = p (dP - delta) from both
// slots, read back in the same order by both warpgroups
__device__ __forceinline__ void put8(float4* x, int tid, const float (&v)[8]) {
  x[tid] = make_float4(v[0], v[1], v[2], v[3]);
  x[128 + tid] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void ds8(const float4* p, const float4* dpd,
                                    int tid, float (&ds)[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 a = p[128 * h + tid], b = dpd[128 * h + tid];
    ds[4 * h + 0] = a.x * b.x;
    ds[4 * h + 1] = a.y * b.y;
    ds[4 * h + 2] = a.z * b.z;
    ds[4 * h + 3] = a.w * b.w;
  }
}

// ---- dq -------------------------------------------------------------------------

// All THREADS threads of a block call it, with Cfg<D>::DQ_SMEM bytes of
// dynamic shared memory.  Block (x, y) computes dq of q head x % Hq of
// batch x / Hq for query rows [64 t, 64 t + 64), t = gridDim.y - 1 - y.
template <int D>
__device__ __forceinline__ void dq_block(const Shape& sh,
                                         unsigned char* smem) {
  using C = Cfg<D>;
  unsigned char* base = aligned1024(smem);
  float* q_raw = reinterpret_cast<float*>(base);
  float* do_raw = reinterpret_cast<float*>(base + C::RAW_BYTES);
  unsigned char* k_hi = base + 2 * C::RAW_BYTES;
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

  // the key tiles the mask leaves for rows [q0, q0 + 64): each holds a key
  // some row sees
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
  stage_raw<D>(sh.q + (bh * sh.sq + q0) * D, sh.sq - q0, q_raw);
  stage_raw<D>(sh.dout + (bh * sh.sq + q0) * D, sh.sq - q0, do_raw);
  if (n > 0) {
    next.template store<0>(k_hi, k_lo);
    next.template store<1>(v_hi, v_lo);
  }
  fence_async_shared();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
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

  // warpgroup 0: S = Q K^T and p; warpgroup 1: dP = dO V^T and dP - delta;
  // each hands its values over in the K-major tile it read
  const float4* own = reinterpret_cast<const float4*>(wg == 0 ? q_raw
                                                              : do_raw);
  const uint32_t bh_w = desc_lo(smem_addr(wg == 0 ? k_hi : v_hi));
  const uint32_t bl_w = desc_lo(smem_addr(wg == 0 ? k_lo : v_lo));
  float4* x_p = reinterpret_cast<float4*>(k_hi);
  float4* x_dpd = reinterpret_cast<float4*>(v_hi);
  const uint32_t kth = smem_addr(kt_hi) + wg * (C::HALF / 8) * 512;
  const uint32_t ktl = smem_addr(kt_lo) + wg * (C::HALF / 8) * 512;
  const int win = window32(mask);

  for (int it = 0; it < n; ++it) {
    const int64_t k0 = (t0 + it) * BS;
    // some keys of the tile are hidden from some rows
    const bool masked = k0 + BS > sh.skv ||
                        (mask.causal && k0 + BS - 1 > q0) ||
                        (mask.windowed && q0 + OWN - 1 - k0 >= mask.window);
    float s[C::AR], sl[C::AR];
    __syncthreads();     // K(it), V(it) staged; everyone done with K^T and
                         // the exchange of it - 1
    issue_rs_scores<D>(s, sl, own, bh_w, bl_w);
    next.template store_t<0>(kt_hi, kt_lo);
    fence_async_shared();
    const int64_t k1 = k0 + BS;
    if (it + 1 < n) {
      next.template load<0>(kb + k1 * D, sh.skv - k1);
      next.template load<1>(vb + k1 * D, sh.skv - k1);
    }
    wg_wait_all();
    pin(s);
    pin(sl);
    // s[4 j + e]: row row_a + 8 (e / 2), key k0 + 8 j + col_l + e % 2
    const int rel = static_cast<int>(row_a - k0) - col_l;
    const int left = capped(sh.skv - k0, BS) - col_l;
#pragma unroll
    for (int i = 0; i < C::AR; ++i) {
      const int h = (i / 2) % 2;
      const int at = 8 * (i / 4) + (i % 2);            // the key's offset
      const float x = __fadd_rn(s[i], sl[i]);
      if (wg == 0) {
        float p = exp2f(x * sh.scale_log2 - lse2[h]);
        if (masked && !visible(mask, rel + 8 * h - at, left - at, win))
          p = 0.0f;
        s[i] = p;
      } else {
        s[i] = x - dlt[h];
      }
    }
    put8(wg == 0 ? x_p : x_dpd, tid, s);
    __syncthreads();     // K^T(it) staged, the exchange written; everyone
                         // done with K(it), V(it)
    ds8(x_p, x_dpd, tid, s);
#pragma unroll
    for (int i = 0; i < C::AR; ++i) split(s[i], sl[i]);
    float dqt[C::OR];
    pin(s);
    pin(sl);
    wg_fence();
    issue_grad<D>(dqt, s, sl, kth, ktl);
    wg_commit();
    __syncthreads();     // everyone has read the exchange
    if (it + 1 < n) {
      next.template store<0>(k_hi, k_lo);
      next.template store<1>(v_hi, v_lo);
      fence_async_shared();
    }
    wg_wait_all();
    pin(dqt);
#pragma unroll
    for (int i = 0; i < C::OR; ++i) dq[i] = __fadd_rn(dq[i], dqt[i]);
  }
  store_half<D>(dq, sh.scale, sh.dq + bh * sh.sq * D, q0, sh.sq);
}

// ---- dK, dV, and their head groups' sum -----------------------------------------

// A dk / dv block's batch, kv head and query heads (blockIdx.x = (b Hkv +
// hk) G + g for head group g of G = sh.groups; the kv head's Hq / Hkv query
// heads split into G runs), and where its rows of the result go: with G =
// 1 the output (which 0: dv, 1: dk), else the group's float32 partial in
// sh.part, a (2, B, G, Hkv, Skv, D) scratch that
// attention_bwd_dkv_sum_f32_kernel adds up
struct KvBlock {
  int64_t b, hk, head0, heads;
  float* dst;
};
template <int D>
__device__ __forceinline__ KvBlock kv_block(const Shape& sh, int which) {
  const int64_t g = blockIdx.x % sh.groups;
  const int64_t bh = blockIdx.x / sh.groups;
  const int64_t hk = bh % sh.hkv, b = bh / sh.hkv;
  const int64_t heads = sh.hq / sh.hkv / sh.groups;
  float* dst;
  if (sh.groups == 1) {
    dst = (which ? sh.dk : sh.dv) + (b * sh.hkv + hk) * sh.skv * D;
  } else {
    const int64_t batch = gridDim.x / (sh.hkv * sh.groups);
    dst = sh.part +
          (((which * batch + b) * sh.groups + g) * sh.hkv + hk) * sh.skv * D;
  }
  return {b, hk, hk * (sh.hq / sh.hkv) + g * heads, heads, dst};
}

// dv, dk = the sum over g of PART[which, b, g] in order g = 0, 1, ... (dK's
// partials carry its scale); per = Hkv Skv D elements of a (b, g) slice;
// blockIdx.y: 0 dv, 1 dk
__global__ void __launch_bounds__(256)
attention_bwd_dkv_sum_f32_kernel(const float* __restrict__ PART,
                                 float* __restrict__ DV,
                                 float* __restrict__ DK, int64_t batch,
                                 int64_t groups, int64_t per) {
  const int which = blockIdx.y;
  const float* part = PART + which * batch * groups * per;
  float* dst = which == 0 ? DV : DK;
  const int64_t quads = batch * per / 4;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < quads; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t b = 4 * i / per;
    const float* src = part + b * groups * per + (4 * i - b * per);
    float4 acc = *reinterpret_cast<const float4*>(src);
    for (int64_t g = 1; g < groups; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(src + g * per);
      acc.x = __fadd_rn(acc.x, x.x);
      acc.y = __fadd_rn(acc.y, x.y);
      acc.z = __fadd_rn(acc.z, x.z);
      acc.w = __fadd_rn(acc.w, x.w);
    }
    *reinterpret_cast<float4*>(dst + 4 * i) = acc;
  }
}

// the query tiles (16 rows) some row of which sees a key of [kb0, kb0 +
// 64): [qt0, qt0 + count)
struct QueryTiles {
  int64_t qt0;
  int count;
};
__device__ __forceinline__ QueryTiles query_tiles(const Shape& sh,
                                                  int64_t kb0) {
  const Mask& mask = sh.mask;
  const int64_t qt0 = mask.causal ? kb0 / BS : 0;
  int64_t qt1 = (sh.sq + BS - 1) / BS;
  if (mask.windowed) {
    const int64_t last = kb0 + OWN - 1 + mask.window - 1;
    const int64_t end = last < 0 ? 0 : last / BS + 1;
    qt1 = end < qt1 ? end : qt1;
  }
  return {qt0, qt1 > qt0 ? static_cast<int>(qt1 - qt0) : 0};
}

// All THREADS threads of a block call it, with Cfg<D>::DK_SMEM bytes of
// dynamic shared memory.  Block (x, y) computes dK of keys [64 y, 64 y +
// 64) of the kv head and batch kv_block gives it over its query heads, in
// order, and each of their query tiles that sees the keys.
template <int D>
__device__ __forceinline__ void dk_block(const Shape& sh,
                                         unsigned char* smem) {
  using C = Cfg<D>;
  unsigned char* base = aligned1024(smem);
  float* k_raw = reinterpret_cast<float*>(base);
  float* v_raw = reinterpret_cast<float*>(base + C::RAW_BYTES);
  unsigned char* q_hi = base + 2 * C::RAW_BYTES;
  unsigned char* q_lo = q_hi + C::S_BYTES;
  unsigned char* do_hi = q_lo + C::S_BYTES;
  unsigned char* do_lo = do_hi + C::S_BYTES;
  unsigned char* qt_hi = do_lo + C::S_BYTES;
  unsigned char* qt_lo = qt_hi + C::T_BYTES;
  float* lse_s = reinterpret_cast<float*>(qt_lo + C::T_BYTES);
  float* dl_s = lse_s + BS;

  const KvBlock blk = kv_block<D>(sh, 1);
  const int64_t b = blk.b;
  const int64_t kb0 = static_cast<int64_t>(blockIdx.y) * OWN;
  const Mask mask = sh.mask;
  const QueryTiles tiles = query_tiles(sh, kb0);
  const int nqt = tiles.count;
  const int total = static_cast<int>(blk.heads) * nqt;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int64_t key_a = kb0 + warp * 16 + lane / 4;    // and key_a + 8
  const int col_l = 2 * (lane % 4);
  const int win = window32(mask);
  // how far the thread's first key lies short of Skv (> 0: it exists)
  const int left = capped(sh.skv > key_a ? sh.skv - key_a : 0, 16);

  auto head_of = [&](int it) { return blk.head0 + it / nqt; };
  auto row_of = [&](int it) { return (tiles.qt0 + it % nqt) * BS; };
  auto tile_ptr = [&](const float* p, int it) {
    return p + ((b * sh.hq + head_of(it)) * sh.sq + row_of(it)) * D;
  };
  // tile it's lse (log2 units) and delta into shared memory
  auto stage_rows = [&](int it) {
    if (threadIdx.x < BS) {
      const int64_t row = row_of(it) + threadIdx.x;
      const int64_t at = (b * sh.hq + head_of(it)) * sh.sq + row;
      const bool in = row < sh.sq;
      lse_s[threadIdx.x] = in ? sh.lse[at] * LOG2E : INFINITY;
      dl_s[threadIdx.x] = in ? sh.delta[at] : 0.0f;
    }
  };

  const int64_t koff = ((b * sh.hkv + blk.hk) * sh.skv + kb0) * D;
  stage_raw<D>(sh.k + koff, sh.skv - kb0, k_raw);
  stage_raw<D>(sh.v + koff, sh.skv - kb0, v_raw);

  float acc[C::OR];
#pragma unroll
  for (int i = 0; i < C::OR; ++i) acc[i] = 0.0f;

  // warpgroup 0: S^T = K Q^T and p^T; warpgroup 1: dP^T = V dO^T and dP^T
  // - delta; each hands its values over in the K-major tile it read
  const float4* own = reinterpret_cast<const float4*>(wg == 0 ? k_raw
                                                              : v_raw);
  const uint32_t bh_w = desc_lo(smem_addr(wg == 0 ? q_hi : do_hi));
  const uint32_t bl_w = desc_lo(smem_addr(wg == 0 ? q_lo : do_lo));
  float4* x_p = reinterpret_cast<float4*>(q_hi);
  float4* x_dpd = reinterpret_cast<float4*>(do_hi);
  const uint32_t qth = smem_addr(qt_hi) + wg * (C::HALF / 8) * 512;
  const uint32_t qtl = smem_addr(qt_lo) + wg * (C::HALF / 8) * 512;

  Tile<D> next;
  if (total > 0) {
    next.template load<0>(tile_ptr(sh.q, 0), sh.sq - row_of(0));
    next.template load<1>(tile_ptr(sh.dout, 0), sh.sq - row_of(0));
    next.template store<0>(q_hi, q_lo);
    next.template store<1>(do_hi, do_lo);
    stage_rows(0);
  }
  fence_async_shared();

  for (int it = 0; it < total; ++it) {
    const int64_t q0 = row_of(it);
    // some rows of the tile do not see some of the block's keys
    const bool masked =
        kb0 + OWN > sh.skv || (mask.causal && kb0 + OWN - 1 > q0) ||
        (mask.windowed && q0 + BS - 1 - kb0 >= mask.window);
    float st[C::AR], stl[C::AR];
    __syncthreads();     // tile it staged; everyone done with Q^T and the
                         // exchange of it - 1
    issue_rs_scores<D>(st, stl, own, bh_w, bl_w);
    next.template store_t<0>(qt_hi, qt_lo);
    fence_async_shared();
    if (it + 1 < total) {
      next.template load<0>(tile_ptr(sh.q, it + 1), sh.sq - row_of(it + 1));
      next.template load<1>(tile_ptr(sh.dout, it + 1),
                            sh.sq - row_of(it + 1));
    }
    wg_wait_all();
    pin(st);
    pin(stl);
    // st[4 j + e]: key key_a + 8 (e / 2), row q0 + 8 j + col_l + e % 2
    const int rel = static_cast<int>(q0 - key_a) + col_l;
#pragma unroll
    for (int i = 0; i < C::AR; ++i) {
      const int c = 8 * (i / 4) + col_l + (i % 2);     // the row's offset
      const int e8 = 8 * ((i / 2) % 2);                // the key's
      const float x = __fadd_rn(st[i], stl[i]);
      if (wg == 0) {
        float p = exp2f(x * sh.scale_log2 - lse_s[c]);
        if (masked &&
            !visible(mask, rel + 8 * (i / 4) + (i % 2) - e8, left - e8, win))
          p = 0.0f;
        st[i] = p;
      } else {
        st[i] = x - dl_s[c];
      }
    }
    put8(wg == 0 ? x_p : x_dpd, tid, st);
    __syncthreads();     // Q^T(it) staged, the exchange written; everyone
                         // done with Q(it), dO(it), lse and delta
    ds8(x_p, x_dpd, tid, st);
#pragma unroll
    for (int i = 0; i < C::AR; ++i) split(st[i], stl[i]);
    float dkt[C::OR];
    pin(st);
    pin(stl);
    wg_fence();
    issue_grad<D>(dkt, st, stl, qth, qtl);
    wg_commit();
    __syncthreads();     // everyone has read the exchange
    if (it + 1 < total) {
      next.template store<0>(q_hi, q_lo);
      next.template store<1>(do_hi, do_lo);
      stage_rows(it + 1);
      fence_async_shared();
    }
    wg_wait_all();
    pin(dkt);
#pragma unroll
    for (int i = 0; i < C::OR; ++i) acc[i] = __fadd_rn(acc[i], dkt[i]);
  }
  store_half<D>(acc, sh.scale, blk.dst, kb0, sh.skv);
}

// ---- dV -------------------------------------------------------------------------

// All THREADS threads of a block call it, with Cfg<D>::DV_SMEM bytes of
// dynamic shared memory.  Block (x, y) computes dV of keys [64 y, 64 y +
// 64) of the kv head and batch kv_block gives it, as dk_block sweeps.
template <int D>
__device__ __forceinline__ void dv_block(const Shape& sh,
                                         unsigned char* smem) {
  using C = Cfg<D>;
  unsigned char* k_hi = aligned1024(smem);
  unsigned char* k_lo = k_hi + C::OWN_BYTES;
  unsigned char* q_hi = k_lo + C::OWN_BYTES;
  unsigned char* q_lo = q_hi + C::S_BYTES;
  unsigned char* dt_hi = q_lo + C::S_BYTES;
  unsigned char* dt_lo = dt_hi + C::T_BYTES;
  float4* xch = reinterpret_cast<float4*>(dt_lo + C::T_BYTES);
  float* lse_s = reinterpret_cast<float*>(dt_lo + C::T_BYTES + C::X_BYTES);

  const KvBlock blk = kv_block<D>(sh, 0);
  const int64_t b = blk.b;
  const int64_t kb0 = static_cast<int64_t>(blockIdx.y) * OWN;
  const Mask mask = sh.mask;
  const QueryTiles tiles = query_tiles(sh, kb0);
  const int nqt = tiles.count;
  const int total = static_cast<int>(blk.heads) * nqt;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int64_t key_a = kb0 + warp * 16 + lane / 4;    // and key_a + 8
  const int col_l = 2 * (lane % 4);
  const int win = window32(mask);
  const int left = capped(sh.skv > key_a ? sh.skv - key_a : 0, 16);

  auto head_of = [&](int it) { return blk.head0 + it / nqt; };
  auto row_of = [&](int it) { return (tiles.qt0 + it % nqt) * BS; };
  auto tile_ptr = [&](const float* p, int it) {
    return p + ((b * sh.hq + head_of(it)) * sh.sq + row_of(it)) * D;
  };
  // tile it's lse (log2 units) into buffer it % 2: p^T is formed after the
  // second barrier, while the next tile's rows are staged
  auto stage_rows = [&](int it) {
    if (threadIdx.x < BS) {
      const int64_t row = row_of(it) + threadIdx.x;
      const int64_t at = (b * sh.hq + head_of(it)) * sh.sq + row;
      lse_s[(it % 2) * BS + threadIdx.x] =
          row < sh.sq ? sh.lse[at] * LOG2E : INFINITY;
    }
  };

  {
    constexpr int CH = D / 4;
    const float* src = sh.k + ((b * sh.hkv + blk.hk) * sh.skv + kb0) * D;
    const int64_t rows = sh.skv - kb0;
#pragma unroll 4
    for (int i = threadIdx.x; i < OWN * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 4;
      st_split4(k_hi, k_lo, swz(r, c, C::OWN_PANEL),
                ld4(src + r * D + c, r < rows));
    }
  }

  float acc[C::OR];
#pragma unroll
  for (int i = 0; i < C::OR; ++i) acc[i] = 0.0f;

  const uint32_t kh = desc_lo(smem_addr(k_hi)), kl = desc_lo(smem_addr(k_lo));
  const uint32_t qh = desc_lo(smem_addr(q_hi)), ql = desc_lo(smem_addr(q_lo));
  const uint32_t dth = smem_addr(dt_hi) + wg * (C::HALF / 8) * 512;
  const uint32_t dtl = smem_addr(dt_lo) + wg * (C::HALF / 8) * 512;

  // Q (operand 0) K-major, dO (operand 1) transposed
  Tile<D> next;
  if (total > 0) {
    next.template load<0>(tile_ptr(sh.q, 0), sh.sq - row_of(0));
    next.template load<1>(tile_ptr(sh.dout, 0), sh.sq - row_of(0));
    next.template store<0>(q_hi, q_lo);
    stage_rows(0);
  }
  fence_async_shared();

  for (int it = 0; it < total; ++it) {
    const int64_t q0 = row_of(it);
    const bool masked =
        kb0 + OWN > sh.skv || (mask.causal && kb0 + OWN - 1 > q0) ||
        (mask.windowed && q0 + BS - 1 - kb0 >= mask.window);
    float st[C::AR], stl[C::AR];
    __syncthreads();     // Q(it) staged; everyone done with dO^T and the
                         // partials of it - 1
    wg_fence();
    issue_ss_scores<D>(st, stl, kh, kl, qh, ql, wg);
    wg_commit();
    next.template store_t<1>(dt_hi, dt_lo);
    fence_async_shared();
    if (it + 1 < total)
      next.template load<0>(tile_ptr(sh.q, it + 1), sh.sq - row_of(it + 1));
    wg_wait_all();
    pin(st);
    pin(stl);
#pragma unroll
    for (int i = 0; i < C::AR; ++i) st[i] = __fadd_rn(st[i], stl[i]);
    put8(xch + 256 * wg, tid, st);
    __syncthreads();     // dO^T(it) staged, both partials written; everyone
                         // done with Q(it)
    {
      const float* ls = lse_s + (it % 2) * BS;
      const int rel = static_cast<int>(q0 - key_a) + col_l;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 a = xch[128 * h + tid], c = xch[256 + 128 * h + tid];
        const float v[4] = {__fadd_rn(a.x, c.x), __fadd_rn(a.y, c.y),
                            __fadd_rn(a.z, c.z), __fadd_rn(a.w, c.w)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * h + e;
          const int r = 8 * (i / 4) + col_l + (i % 2);   // the row's offset
          const int e8 = 8 * ((i / 2) % 2);              // the key's
          float p = exp2f(v[e] * sh.scale_log2 - ls[r]);
          if (masked &&
              !visible(mask, rel + 8 * (i / 4) + (i % 2) - e8, left - e8, win))
            p = 0.0f;
          st[i] = p;
          split(st[i], stl[i]);
        }
      }
    }
    float dvt[C::OR];
    pin(st);
    pin(stl);
    wg_fence();
    issue_grad<D>(dvt, st, stl, dth, dtl);
    wg_commit();
    if (it + 1 < total) {
      next.template store<0>(q_hi, q_lo);
      stage_rows(it + 1);
      fence_async_shared();
      // dO(it + 1) only now: its registers are not live beside dV's tile
      // product (with both in flight ptxas serialised the wgmma, C7511)
      next.template load<1>(tile_ptr(sh.dout, it + 1),
                            sh.sq - row_of(it + 1));
    }
    wg_wait_all();
    pin(dvt);
#pragma unroll
    for (int i = 0; i < C::OR; ++i) acc[i] = __fadd_rn(acc[i], dvt[i]);
  }
  store_half<D>(acc, 1.0f, blk.dst, kb0, sh.skv);
}

}  // namespace bind_attn_bwd_tfw
