// The float32 route of flash attention on the tensor cores (f32_3xtf32) at
// head dim 256 (RecurrentGemma-9B, Gemma-7B): the products of
// attn_tf32.cuh (three TF32 wgmma a product, hi.hi + hi.lo + lo.hi, the
// operands split on their way into shared memory), with a block laid out
// for a row four times as wide as d 64's.
//
// What bounds it on an H100: operations, 4 d Hq visible-pairs FLOP, three
// TF32 products of each at 495 TFLOP/s (RecurrentGemma-9B at S 8192: 1.458
// ms).  What held d 256 on the CUDA-core loop (f32_simt):
//   * shared memory: Q's hi and lo at attn_tf32.cuh's 128 rows are 256 KB,
//     more than a block may have (232,448 bytes);
//   * registers: one warpgroup's running O over 64 rows and the tile's own
//     P V accumulator (the drift repair: each key tile's P V summed from
//     zero and added into O with one IEEE add) are d floats a thread, 256.
//
// The design:
//   * one block of two warpgroups (256 threads) per 64 query rows; Q's hi
//     and lo stay in shared memory for the sweep (128 KB);
//   * warpgroup w owns O's columns [128 w, 128 w + 128): its running O and
//     its tile's P V are 64 + 64 registers a thread;
//   * both warpgroups need all of P, so S = Q K^T is split over d:
//     warpgroup w forms the 64 x 16 partial of its 128 columns (its own
//     halves of Q and K; 16 k8 steps, three wgmma m64n16k8 each, the two lo
//     products in an accumulator of their own), adds the lo accumulator to
//     hi.hi's, and hands the partial to the other through shared memory;
//     each sums the two in the same order (warpgroup 0's first: one IEEE
//     add), so both hold the same S bit for bit and run the same online
//     softmax, and their m, l and P agree;
//   * key tiles of 16 (attn_tf32.cuh's 32 would not fit beside Q): K hi
//     and lo K-major in 128-byte panels, V^T hi and lo as 256 rows of 16
//     keys in the 64-byte swizzle (rows of 16 floats, 16-byte chunk c of
//     row r at c ^ ((r / 2) % 4), 8-row groups 512 bytes apart), the keys
//     permuted inside each group of 8 so that S's accumulator registers are
//     P V's A operand as they lie (attn_tf32.cuh's key_slot);
//   * P V: warpgroup w's 64 x 128 = P (64 x 16, hi / lo from registers)
//     times its 128 rows of V^T, two k8 steps of three wgmma m64n128k8,
//     summed from zero and added into O with one IEEE add.
//
// Shared memory (bytes): Q hi + lo 131,072; K hi + lo 32,768; V^T hi + lo
// 32,768; the two partial S 8,192; 1,024 of alignment: 205,824 of 232,448.
// Registers a thread: O 64, the tile's P V 64, S and its lo 16, the next
// tile's K or V in flight 16 (four float4), softmax state, addresses: 254,
// no spill.  In this order ptxas keeps every wgmma of both instantiations
// (with and without the log-sum-exp) in flight; with K and V of the next
// tile both held across P V (32, as attn_tf32.cuh holds them), or with no
// tile held in registers, it serialised those of one of the two for
// registers (C7511).
//
// Pipeline (the next tile's loads and split pass behind the products):
//   barrier; issue S_w (async); split V(t) into V^T; load K(t + 1) into
//   registers; wait; partial S_w to shared memory; barrier; S = S_0 + S_1;
//   softmax; issue O_t = P V (async); split K(t + 1); load V(t + 1);
//   wait; O += O_t.
// Two block barriers a tile, each after a fence.proxy.async.
//
// The online softmax, the masks (from the kernel's own 64-row and 16-key
// tiles), the log-sum-exp of the training forward and the output's one
// IEEE division are attn_tf32.cuh's.  Head dims: 256 (tf32_head_dim); the
// route takes q, k, v, out 16-byte aligned.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "attn_tf32.cuh"

namespace bind_attn_tfw {

using bind_attn::Mask;
using bind_attn_tf::fence_async_shared;
using bind_attn_tf::key_slot;
using bind_attn_tf::ld4;
using bind_attn_tf::pin;
using bind_attn_tf::Shape;
using bind_attn_tf::st_split;
using bind_attn_tf::st_split4;
using bind_attn_tf::swz;
using bind_attn_tf::tf32_rna;
using bind_attn_tf::wgmma_rs;
using bind_attn_tf::wgmma_ss;
using bind_gemm::smem_addr;
using bind_gemm::wg_commit;
using bind_gemm::wg_desc;
using bind_gemm::wg_fence;
using bind_gemm::wg_wait_all;

constexpr int BQ = 64;          // query rows per block
constexpr int THREADS = 256;    // two warpgroups, each owning half of O
constexpr int BKV = 16;         // keys per tile

// byte offset of element (r, j) of a transposed 16-column tile: rows of 64
// bytes in the 64-byte swizzle, 8-row groups 512 bytes apart
__device__ __forceinline__ uint32_t swz64(int r, int j) {
  return static_cast<uint32_t>((r >> 3) * 512 + (r & 7) * 64 +
                               ((((j >> 2) ^ ((r >> 1) & 3))) << 4) +
                               ((j & 3) << 2));
}

// the wgmma descriptor of such a tile at shared address addr (64-byte
// swizzle, 16-byte leading and 512-byte stride offsets)
__device__ __forceinline__ uint64_t desc64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(16 >> 4) << 16 |
         static_cast<uint64_t>(512 >> 4) << 32 | static_cast<uint64_t>(2)
                                                     << 62;
}

// x, opaque to the compiler: the wgmma descriptors derived from it are
// formed where they are used, each key tile, not hoisted out of the sweep
// into registers of their own (attn_bwd_tf32.cuh's opaque)
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

template <int D> struct Cfg {
  static_assert(D == 256, "d: 256");
  static constexpr int HALF = D / 2;                   // O's columns a WG
  static constexpr int PANELS = D / 32;
  static constexpr int Q_PANEL = BQ * 128;             // 32 columns of Q
  static constexpr int K_PANEL = BKV * 128;            // 32 columns of K
  static constexpr int Q_BYTES = PANELS * Q_PANEL;     // hi or lo
  static constexpr int K_BYTES = PANELS * K_PANEL;
  static constexpr int VT_BYTES = D * 64;              // D rows of 16 keys
  static constexpr int X_BYTES = 2 * BQ * BKV * 4;     // the partial S
  static constexpr size_t SMEM = 1024 + 2 * size_t(Q_BYTES) +
                                 2 * size_t(K_BYTES) + 2 * size_t(VT_BYTES) +
                                 X_BYTES;
  static constexpr int SR = BKV / 2;                   // S registers
  static constexpr int OR = HALF / 2;                  // O registers
  static constexpr int LOADS = BKV * D / 4 / THREADS;  // float4 an operand
  static_assert(LOADS * 4 * THREADS == BKV * D, "tile / threads");
  static_assert(SMEM <= 232448, "shared memory");
};

// The next key tile in registers: K with 64 threads on a row (16-byte
// chunks), V with 16 threads on the 16 keys of one 4-column chunk (V^T's
// stores), each loaded on its own (load_k, load_v) so that at most one of
// them is live beside P V's operands.  Keys at or past ``keys`` read as
// zeros.
template <int D> struct TileRegs {
  float4 k[Cfg<D>::LOADS];
  float4 v[Cfg<D>::LOADS];

  __device__ __forceinline__ void load_k(const float* kb, int64_t keys) {
    constexpr int CH = D / 4;
#pragma unroll
    for (int j = 0; j < Cfg<D>::LOADS; ++j) {
      const int i = threadIdx.x + THREADS * j;
      k[j] = ld4(kb + (i / CH) * D + (i % CH) * 4, i / CH < keys);
    }
  }

  __device__ __forceinline__ void load_v(const float* vb, int64_t keys) {
#pragma unroll
    for (int j = 0; j < Cfg<D>::LOADS; ++j) {
      const int i = threadIdx.x + THREADS * j;
      v[j] = ld4(vb + (i % BKV) * D + (i / BKV) * 4, i % BKV < keys);
    }
  }

  __device__ __forceinline__ void store_k(unsigned char* hi,
                                          unsigned char* lo) const {
    constexpr int CH = D / 4;
#pragma unroll
    for (int j = 0; j < Cfg<D>::LOADS; ++j) {
      const int i = threadIdx.x + THREADS * j;
      st_split4(hi, lo, swz(i / CH, (i % CH) * 4, Cfg<D>::K_PANEL), k[j]);
    }
  }

  __device__ __forceinline__ void store_v(unsigned char* hi,
                                          unsigned char* lo) const {
#pragma unroll
    for (int j = 0; j < Cfg<D>::LOADS; ++j) {
      const int i = threadIdx.x + THREADS * j;
      const int slot = key_slot(i % BKV), c = (i / BKV) * 4;
      st_split(hi, lo, swz64(c + 0, slot), v[j].x);
      st_split(hi, lo, swz64(c + 1, slot), v[j].y);
      st_split(hi, lo, swz64(c + 2, slot), v[j].z);
      st_split(hi, lo, swz64(c + 3, slot), v[j].w);
    }
  }
};

// warpgroup w's partial S (64 x 16) over d columns [128 w, 128 w + 128):
// hi.hi into s, the two lo products into s_lo
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[Cfg<D>::SR],
                                         float (&s_lo)[Cfg<D>::SR],
                                         uint32_t q_hi, uint32_t q_lo,
                                         uint32_t k_hi, uint32_t k_lo,
                                         int wg) {
  using C = Cfg<D>;
  q_hi = opaque(q_hi);
  q_lo = opaque(q_lo);
  k_hi = opaque(k_hi);
  k_lo = opaque(k_lo);
  const uint32_t p0 = wg * (C::HALF / 32);
#pragma unroll
  for (int kk = 0; kk < C::HALF / 8; ++kk) {
    const uint32_t panel = p0 + kk / 4;
    const uint32_t qa = panel * C::Q_PANEL + (kk % 4) * 32;
    const uint32_t ka = panel * C::K_PANEL + (kk % 4) * 32;
    wgmma_ss<BKV>(s_lo, wg_desc(q_lo + qa, 16, 1024),
                  wg_desc(k_hi + ka, 16, 1024), kk > 0);
    wgmma_ss<BKV>(s_lo, wg_desc(q_hi + qa, 16, 1024),
                  wg_desc(k_lo + ka, 16, 1024), 1);
    wgmma_ss<BKV>(s, wg_desc(q_hi + qa, 16, 1024),
                  wg_desc(k_hi + ka, 16, 1024), kk > 0);
  }
}

// O_t (64 x 128) = P V^T's rows [128 w, 128 w + 128) in 3xTF32, P hi / lo
// in registers, lo products first (attn_tf32.cuh's issue_pv)
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[Cfg<D>::OR],
                                         const float (&ph)[Cfg<D>::SR],
                                         const float (&pl)[Cfg<D>::SR],
                                         uint32_t v_hi, uint32_t v_lo) {
  v_hi = opaque(v_hi);
  v_lo = opaque(v_lo);
#pragma unroll
  for (int kk = 0; kk < BKV / 8; ++kk) {
    const int g = 4 * kk;
    wgmma_rs<Cfg<D>::HALF>(o, pl[g], pl[g + 2], pl[g + 1], pl[g + 3],
                           desc64(v_hi + kk * 32), kk > 0);
    wgmma_rs<Cfg<D>::HALF>(o, ph[g], ph[g + 2], ph[g + 1], ph[g + 3],
                           desc64(v_lo + kk * 32), 1);
  }
#pragma unroll
  for (int kk = 0; kk < BKV / 8; ++kk) {
    const int g = 4 * kk;
    wgmma_rs<Cfg<D>::HALF>(o, ph[g], ph[g + 2], ph[g + 1], ph[g + 3],
                           desc64(v_hi + kk * 32), 1);
  }
}

// attn_tf32.cuh's online softmax on a 64 x 16 tile: s[4 j + e] is row
// row_a + 8 (e / 2), key k0 + 8 j + col_l + e % 2.  Updates m and the
// partial sums l, rescales O by the correction, leaves P's hi in s and lo
// in pl.
template <int D>
__device__ __forceinline__ void wide_softmax(float (&s)[Cfg<D>::SR],
                                        float (&pl)[Cfg<D>::SR],
                                        float (&o)[Cfg<D>::OR],
                                        float (&m)[2], float (&l)[2],
                                        const Shape& sh, int64_t k0,
                                        int64_t row_a, int col_l,
                                        bool masked) {
  using C = Cfg<D>;
  const Mask& mask = sh.mask;
  // 32-bit positions relative to the tile: row - key of the thread's
  // first element, and how far its key lies short of Skv (> 0: it exists)
  const int rel = static_cast<int>(row_a - k0) - col_l;
  const int64_t ahead = sh.skv - k0;
  const int left = static_cast<int>(ahead < BKV ? ahead : BKV) - col_l;
  const int win = static_cast<int>(
      mask.window < (1 << 30) ? mask.window : (1 << 30));
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < C::SR; ++i) {
    float v = s[i] * sh.scale_log2;
    if (masked) {
      const int at = 8 * (i / 4) + (i % 2);      // the key's offset
      const int diff = rel + 8 * ((i / 2) % 2) - at;
      bool vis = left - at > 0;
      if (mask.causal) vis = vis && diff >= 0;
      if (mask.windowed) vis = vis && diff < win;
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

// All THREADS threads of a block call it, with Cfg<D>::SMEM bytes of
// dynamic shared memory at smem.  Block (x, y) computes q head x % Hq of
// batch x / Hq for query tile gridDim.y - 1 - y; with LSE, also each of
// its rows' log-sum-exp into the (B, Hq, Sq) buffer lse.
template <int D, bool LSE>
__device__ __forceinline__ void attention_block(const Shape& sh,
                                                unsigned char* smem,
                                                float* __restrict__ lse) {
  using C = Cfg<D>;
  unsigned char* q_hi = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
  unsigned char* q_lo = q_hi + C::Q_BYTES;
  unsigned char* k_hi = q_lo + C::Q_BYTES;
  unsigned char* k_lo = k_hi + C::K_BYTES;
  unsigned char* v_hi = k_lo + C::K_BYTES;
  unsigned char* v_lo = v_hi + C::VT_BYTES;
  float4* xch = reinterpret_cast<float4*>(v_lo + C::VT_BYTES);

  const int64_t bh = blockIdx.x;
  const int64_t b = bh / sh.hq;
  const int64_t kvh = b * sh.hkv + (bh % sh.hq) / (sh.hq / sh.hkv);
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * BQ;
  const Mask mask = sh.mask;
  const float* kb = sh.k + kvh * sh.skv * D;
  const float* vb = sh.v + kvh * sh.skv * D;

  // the key tiles the mask leaves for rows [q0, q0 + BQ): each holds a key
  // some row sees, so none is skipped
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
  const int n = t1 > t0 ? static_cast<int>(t1 - t0) : 0;

  {
    constexpr int CH = D / 4;
    const float* q = sh.q + (bh * sh.sq + q0) * D;
    const int64_t rows = sh.sq - q0;
#pragma unroll 4
    for (int i = threadIdx.x; i < BQ * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 4;
      st_split4(q_hi, q_lo, swz(r, c, C::Q_PANEL),
                ld4(q + r * D + c, r < rows));
    }
  }
  TileRegs<D> next;
  if (n > 0) {
    next.load_k(kb + t0 * BKV * D, sh.skv - t0 * BKV);
    next.load_v(vb + t0 * BKV * D, sh.skv - t0 * BKV);
    next.store_k(k_hi, k_lo);
  }
  fence_async_shared();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int64_t row_a = q0 + warp * 16 + lane / 4;     // and row_a + 8
  const int col_l = 2 * (lane % 4);

  float o[C::OR];
#pragma unroll
  for (int i = 0; i < C::OR; ++i) o[i] = 0.0f;
  float m[2] = {-1e30f, -1e30f};
  float l[2] = {0.0f, 0.0f};

  const uint32_t qh = smem_addr(q_hi), ql = smem_addr(q_lo);
  const uint32_t kh = smem_addr(k_hi), kl = smem_addr(k_lo);
  // warpgroup w's 128 rows of V^T: 16 groups of 8 rows
  const uint32_t vh = smem_addr(v_hi) + wg * (C::HALF / 8) * 512;
  const uint32_t vl = smem_addr(v_lo) + wg * (C::HALF / 8) * 512;

  for (int it = 0; it < n; ++it) {
    const int64_t k0 = (t0 + it) * BKV;
    // some keys of the tile are hidden from some rows
    const bool masked = k0 + BKV > sh.skv ||
                        (mask.causal && k0 + BKV - 1 > q0) ||
                        (mask.windowed && q0 + BQ - 1 - k0 >= mask.window);
    float s[C::SR];
    float pl[C::SR];
    float ot[C::OR];
    __syncthreads();     // K(it) staged; everyone done with V^T and the
                         // partial S of it - 1
    wg_fence();
    issue_qk<D>(s, pl, qh, ql, kh, kl, wg);
    wg_commit();
    next.store_v(v_hi, v_lo);
    // K(t + 1) now, V(t + 1) once K(t + 1) is split (see the note on
    // registers)
    if (it + 1 < n) next.load_k(kb + (k0 + BKV) * D, sh.skv - k0 - BKV);
    fence_async_shared();
    wg_wait_all();
    pin(s);
    pin(pl);
#pragma unroll
    for (int i = 0; i < C::SR; i += 4)
      xch[(wg * 2 + i / 4) * 128 + tid] =
          make_float4(__fadd_rn(s[i], pl[i]), __fadd_rn(s[i + 1], pl[i + 1]),
                      __fadd_rn(s[i + 2], pl[i + 2]),
                      __fadd_rn(s[i + 3], pl[i + 3]));
    __syncthreads();     // V^T(it) staged, both partials written; everyone
                         // done with K(it)
#pragma unroll
    for (int i = 0; i < C::SR; i += 4) {
      const float4 a = xch[(i / 4) * 128 + tid];         // warpgroup 0's
      const float4 c = xch[(2 + i / 4) * 128 + tid];     // warpgroup 1's
      s[i] = __fadd_rn(a.x, c.x);
      s[i + 1] = __fadd_rn(a.y, c.y);
      s[i + 2] = __fadd_rn(a.z, c.z);
      s[i + 3] = __fadd_rn(a.w, c.w);
    }
    wide_softmax<D>(s, pl, o, m, l, sh, k0, row_a, col_l, masked);
    pin(s);
    pin(pl);
    wg_fence();
    issue_pv<D>(ot, s, pl, vh, vl);
    wg_commit();
    if (it + 1 < n) {
      const int64_t k1 = k0 + BKV;
      next.store_k(k_hi, k_lo);
      next.load_v(vb + k1 * D, sh.skv - k1);
      fence_async_shared();
    }
    wg_wait_all();
    pin(ot);
#pragma unroll
    for (int i = 0; i < C::OR; ++i) o[i] = __fadd_rn(o[i], ot[i]);
  }

  // out = O / l; a row that saw no key has l = 0, O = 0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int64_t row = row_a + 8 * h;
    if (row >= sh.sq) continue;
    if constexpr (LSE) {
      if (wg == 0 && (lane & 3) == 0)
        lse[bh * sh.sq + row] =
            l[h] == 0.0f ? INFINITY
                         : (m[h] + log2f(l[h])) * 0.6931471805599453f;
    }
    const float safe = l[h] == 0.0f ? 1.0f : l[h];
    float* dst = sh.out + (bh * sh.sq + row) * D + wg * C::HALF + col_l;
#pragma unroll
    for (int j = 0; j < C::HALF / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(__fdiv_rn(o[4 * j + 2 * h], safe),
                      __fdiv_rn(o[4 * j + 2 * h + 1], safe));
  }
}

}  // namespace bind_attn_tfw
