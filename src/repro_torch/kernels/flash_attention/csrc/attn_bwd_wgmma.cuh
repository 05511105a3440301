// The 16-bit routes of the attention backward on the tensor cores,
// bfloat16 (bf16_wgmma) and float16 (f16_wgmma): dq, dk, dv of out =
// softmax(q k^T * scale + mask) v from q, k, v, out, dout and the forward's
// per-row log-sum-exp, built from the pieces of the forward's tensor-core
// loop (attn_wgmma.cuh: the wgmma forms, the exp2, the packing of an
// accumulator into A registers of the element type) and of the GEMM's
// (gemm/csrc/gemm_wgmma.cuh: mbarriers, TMA tensor maps, wgmma descriptors,
// the transposed-B form).  The element type T is a template parameter of
// every kernel here; attn_wgmma.cuh's Elem<T> holds what differs between
// bf16 and f16 (wgmma's operand type, the packing of P and dS, the stores,
// TMA's data type); the rest is one code for both.
//
// What bounds it on an H100: operations.  Per head and visible (row, key)
// pair the gradient needs five products of 2 d FLOP (s, dp, dq, dk, dv):
// 10 d FLOP, 258 GFLOP at RecurrentGemma-9B's training shape, against a
// few tens of MB of operands, far above the ridge point of the bf16 tensor
// cores (989 TFLOP/s).  The CUDA-core route (flash_attention_bwd.cu) did
// 16 d FLOP a pair in f32 at 7-9 TFLOP/s; this one does 14 d FLOP a pair at
// d <= 128 and 16 d above (s and dp are formed in both kernels, and s a
// third time at d > 128, below), all of it on wgmma.
//
// Three launches (four with head groups):
//   (i)   attention_bwd_delta_kernel: delta = sum_c dout_c out_c per row
//         into a (B, Hq, Sq) float32 scratch, one warp a row, lanes over
//         pairs of elements and a fixed shuffle tree.  Bound by bytes (it reads
//         out and dout once), so it is a plain CUDA kernel in this
//         library: it builds with the kernels it feeds, and the path
//         imports no Triton;
//   (ii)  attention_bwd_dq_wgmma_kernel, one block per (128 query rows, q
//         head, batch), two warpgroups of 64 rows sharing K and V tiles of
//         64 keys that TMA brings into a ring (the forward's scheme: no
//         producer warp, the second warpgroup done with a stage refills
//         it).  Q and dO stay in shared memory.  One sweep over the key
//         tiles the mask leaves: S = Q K^T and dP = dO V^T (K-major x
//         K-major, the forward's Q K^T form, one commit), then p =
//         2^(s scale log2 e - lse log2 e) and ds = p (dp - delta) on the
//         accumulator fragment, lse and delta read once a row, and dQ +=
//         dS K with dS from registers (the S accumulator paired into
//         bf16x2 or f16x2 is the A operand of a k16 step, the forward's
//         P V form) and K N-major (the transposed-B form);
//   (iii) attention_bwd_dkv_wgmma_kernel, one block per (128 keys, kv head,
//         head group, batch), two warpgroups of 64 keys sharing Q and dO
//         tiles of 64 query rows in a ring; K and V stay in shared memory.
//         It loops over the group's query heads and the query tiles that
//         see its keys: S^T = K Q^T and dP^T = V dO^T (the Q K^T form), p^T
//         and ds^T on the fragment (each warpgroup stages the tile's lse
//         and delta in shared memory: its columns are query rows), dV +=
//         P^T dO and dK += dS^T Q (the P V form), P^T and dS^T from
//         registers.  P, P^T, dS and dS^T never go through shared memory;
//   (iv)  with G > 1 head groups (below), attention_bwd_dkv_sum_kernel sums
//         the groups' float32 partials in fixed order and rounds once.
// There are no atomics on any result, so two calls give the same bits.
//
// Registers: a warpgroup's accumulators are 64 rows by d, d / 2 registers a
// thread.  At d <= 128 the dk/dv kernel holds dK and dV (d) beside S^T and
// dP^T (64): 192 of accumulators.  At d = 192 and 256, dK and dV together
// would be 192 / 256, above the 255 cap with anything beside them, so the
// kernel makes two passes over its query tiles: dV (d / 2 + S^T) and then
// dK (d / 2 + S^T + dP^T), forming S^T twice.  (At d = 128 one pass fits,
// and a trial of two was slower at Qwen3-14B's width.)  The dq
// kernel holds dQ, S and dP: 192 at d = 256.  Both run 256 threads a
// block, which a thread may give 255 registers (attn_wgmma.cuh says why
// 9-12 warps may not).  With CUDA 12.8's ptxas (-Xptxas -v) the dq kernel
// takes 151 / 160 / 168 / 188 / 215 / 244 registers at d = 64 / 80 / 96 /
// 128 / 192 / 256 and the dk/dv kernel 198 / 216 / 233 / 254 / 244 / 255,
// none spilling (chip_smoke.py fails on a spill); the masks work in 32-bit
// positions relative to the tile, which keeps dk/dv at d = 128 from
// spilling, as it did with 64-bit ones.
//
// Shared memory: two 128-row tiles of the block (Q and dO, or K and V) and
// a ring of 64-row tile pairs: 128 KB + STAGES x 64 KB at d = 256, so one
// stage there (192 KB of the 227 KB), two below.
//
// Too few blocks: with Hkv = B = 1 (RecurrentGemma-9B) the dk/dv grid is
// Skv / 128 = 32 blocks for 132 SMs.  So the group's query heads are split
// into G head groups across blocks (the launcher's caller picks G from the
// card's SM count), each writing float32 partials of dK and dV to a (2, B,
// G, Hkv, Skv, D) scratch that (iv) sums.  With G = 1 the kernel rounds
// and stores dK and dV itself (Qwen3-14B: Hkv = 8 gives 256 blocks).
//
// Masks: tile pairs no (row, key) of which is visible are skipped, as the
// CUDA-core route skips them (causal: keys past a query tile's last row;
// window: keys older than its first row's window; the mirror bounds for a
// key tile), so causal attention with a window is a band; a warpgroup
// masks per element only a tile that holds a diagonal, a window edge or the
// ragged end of the keys.  Rows and keys past Sq / Skv are TMA's zero fill;
// a row past Sq gets lse = +inf and delta = 0 (p = 0, ds = 0), a key past
// Skv is masked, and neither is stored.  A row that sees no key has lse =
// +inf from the forward, so p = 0 exactly: its dq is 0 and it adds nothing
// to dk or dv.
//
// p is formed as the forward forms it: one MUFU ex2 (subnormals flushed)
// of the score times scale log2 e, less the log-sum-exp times log2 e, so
// the backward's p is the forward's normalised weight.
//
// Tolerance: P and dS are rounded to bf16 before their products, where the
// CUDA-core route and the plain version keep them in f32.  Each moves by at
// most 2^-9 relative, so an element of dV moves by at most 2^-9 sum_i p_i
// |dout_i| <= 2^-9 max|dout| (the weights of a row sum to one), and one of
// dQ (dK) by at most 2^-9 scale sum |ds| |k| (|q|): random in sign, the rms
// error of a head slice is about 2^-9 / sqrt(3) of its rms, 1e-3, inside
// chip_smoke.py's 2^-7 rms per head slice.  delta comes from the stored
// bf16 output, as on the CUDA-core route.  The sums are f32, each gradient
// rounded once to bf16.  In float16 P and dS move by at most 2^-11
// relative (f16's unit roundoff; 2^-25 absolute below 2^-14, its
// subnormals), eight times less: chip_smoke.py holds f16_wgmma to 2^-10
// rms per head slice.  Unlike the CUDA-core route, which keeps dS in fp32,
// this route rounds dS = p (dp - delta) to f16 before dQ += dS K and dK +=
// dS^T Q: where |dS| passes 65504 (|dout| |v| of order 1e7 or more) it is
// inf, and so are the gradients it feeds (ROADMAP Queue 3).
//
// Head dims that are no multiple of 64 (80, 96) take the forward's scheme
// (attn_wgmma.cuh): ceil(d / 64) panels, the last one's columns past d
// TMA's zeros; the products that sum over d (S, dP, S^T, dP^T) step over
// the real columns only, those whose N is d (dQ, dV, dK) issue the last
// panel at N = d % 64, and no store writes a column past d (nor do the
// head groups' partials).  They keep d 128's shared memory and its one
// pass, with fewer registers: dq 160 / 168 and dk/dv 216 / 233 at d 80 /
// 96.
//
// TMA needs 16-byte-aligned bases, and the tiles are 64 columns wide: the
// routes (flash_attention_bwd.cu route_of) take bf16 or f16 with d one of
// wgmma_head_dim's (64, 80, 96, 128, 192, 256), q, k, v, out, dout and the
// log-sum-exp 16-byte aligned, and a log-sum-exp saved by the forward; any
// other call takes the CUDA cores.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "attn_mask.cuh"
#include "attn_wgmma.cuh"

namespace bind_attn_bwd {

using bind_attn::capped;
using bind_attn::Mask;
using bind_attn::visible;
using bind_attn::window32;
using bind_attn_wg::Elem;
using bind_attn_wg::exp2_fast;
using bind_attn_wg::issue_pv;
using bind_attn_wg::issue_qk;
using bind_attn_wg::panels;
using bind_attn_wg::pin;
using bind_attn_wg::pin_acc;
using bind_attn_wg::real_cols;
using bind_attn_wg::store2;
using bind_attn_wg::warpgroup_sync;
using bind_gemm::mbar_expect;
using bind_gemm::mbar_init;
using bind_gemm::mbar_wait;
using bind_gemm::smem_addr;
using bind_gemm::tma_load;
using bind_gemm::wg_commit;
using bind_gemm::wg_fence;
using bind_gemm::wg_wait_all;

constexpr int THREADS = 256;   // two warpgroups, no producer warp
// rows of a block's own tiles (dq: query rows; dk/dv: keys), and of a
// streamed tile (dq: keys; dk/dv: query rows): the forward's BQ and its
// BKV at d > 128, the A and B tiles of its issue_qk / issue_pv
constexpr int BIG = bind_attn_wg::BQ;
constexpr int SMALL = 64;
constexpr float LOG2E = 1.4426950408889634f;

template <int D> struct Cfg {
  static_assert(bind_attn_wg::wgmma_head_dim(D),
                "d: 64, 80, 96, 128, 192, 256");
  static constexpr int PANELS = panels(D);          // 64-column panels
  static constexpr int BIG_PANEL = BIG * 128;       // bytes of a panel
  static constexpr int SMALL_PANEL = SMALL * 128;
  static constexpr int BIG_BYTES = PANELS * BIG_PANEL;
  static constexpr int SMALL_BYTES = PANELS * SMALL_PANEL;
  static constexpr int STAGES = D <= 192 ? 2 : 1;   // streamed tile pairs
  static constexpr int BARRIERS = 1 + 2 * STAGES;
  static constexpr size_t SMEM =
      1024 + 2 * BIG_BYTES + 2 * STAGES * SMALL_BYTES +
      BARRIERS * sizeof(uint64_t) + 2 * STAGES * sizeof(unsigned int) +
      2 * 2 * SMALL * sizeof(float);
};

// the problem of one launch; q, out, dout (B, Hq, Sq, D), k, v (B, Hkv,
// Skv, D); dk/dv blocks split a kv head's query heads into `groups`
struct Shape {
  int64_t hq, hkv, sq, skv;
  float scale;           // softmax scale
  float scale_log2;      // scale * log2(e)
  Mask mask;
  int64_t groups;
};

// a block's shared memory: two 128-row tiles (big0, big1), two rings of
// STAGES 64-row tiles (ring0, ring1), a "full" barrier for the big tiles
// and one per ring stage, a release count per ring stage, and each
// warpgroup's lse and delta of a streamed tile (dk/dv)
template <int D> struct Smem {
  using C = Cfg<D>;
  unsigned char* big0;
  unsigned char* big1;
  unsigned char* ring0;
  unsigned char* ring1;
  uint64_t* big_full;
  uint64_t* full0;
  uint64_t* full1;
  unsigned int* done0;
  unsigned int* done1;
  float* lse;
  float* delta;

  __device__ __forceinline__ explicit Smem(unsigned char* smem) {
    big0 = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
    big1 = big0 + C::BIG_BYTES;
    ring0 = big1 + C::BIG_BYTES;
    ring1 = ring0 + C::STAGES * C::SMALL_BYTES;
    big_full = reinterpret_cast<uint64_t*>(ring1 + C::STAGES * C::SMALL_BYTES);
    full0 = big_full + 1;
    full1 = full0 + C::STAGES;
    done0 = reinterpret_cast<unsigned int*>(full1 + C::STAGES);
    done1 = done0 + C::STAGES;
    lse = reinterpret_cast<float*>(done1 + C::STAGES);
    delta = lse + 2 * SMALL;
  }

  // by one thread, before the block's first barrier
  __device__ __forceinline__ void init() const {
    mbar_init(big_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full0[s], 1);
      mbar_init(&full1[s], 1);
      done0[s] = 0;
      done1[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// the PANELS 64-column boxes of rows [row, row + R) of level z of a map into
// dst, completing on bar (which the caller has told the bytes to expect)
template <int D, int R>
__device__ __forceinline__ void load_rows(unsigned char* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int64_t row,
                                          int64_t z) {
#pragma unroll
  for (int p = 0; p < panels(D); ++p)
    tma_load(dst + p * R * 128, map, bar, p * 64, static_cast<int>(row),
             static_cast<int>(z));
}

// a warpgroup is done with stage it % STAGES of a ring: a count per stage,
// odd for the second of the two warpgroups, which calls refill(it +
// STAGES) when that tile exists
template <int STAGES, typename Refill>
__device__ __forceinline__ void release(unsigned int* done, int wg, int tid,
                                        int it, int n, Refill refill) {
  warpgroup_sync(wg);       // every warp of it has finished reading
  if (tid == 0 && (atomicAdd(&done[it % STAGES], 1u) & 1u) != 0 &&
      it + STAGES < n)
    refill(it + STAGES);
}

// ---- (i) delta ---------------------------------------------------------------

// DELTA[r] = sum_c dO[r, c] O[r, c] in f32 for r < rows, one warp a row
template <typename T>
__global__ void __launch_bounds__(256)
attention_bwd_delta_kernel(const T* __restrict__ O, const T* __restrict__ dO,
                           float* __restrict__ DELTA, int64_t rows, int d) {
  using Pair = typename Elem<T>::Pair;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const Pair* o = reinterpret_cast<const Pair*>(O + row * d);
  const Pair* g = reinterpret_cast<const Pair*>(dO + row * d);
  float s = 0.0f;
  for (int c = lane; c < d / 2; c += 32) {
    const float2 a = Elem<T>::unpair(o[c]);
    const float2 b = Elem<T>::unpair(g[c]);
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) DELTA[row] = s;
}

// ---- (ii) dq --------------------------------------------------------------------

// p and ds of a tile of the dq kernel's fragment: s[4 j + e] and dp[4 j +
// e] are row row_a + 8 (e / 2), key k0 + 8 j + col_l + e % 2; ds leaves as
// pairs of T, the A registers of dQ += dS K.  Where masked: rel = row_a -
// k0 - col_l, left = min(Skv - k0, SMALL) - col_l.
template <typename T>
__device__ __forceinline__ void dq_scores(float (&s)[32], float (&dp)[32],
                                          uint32_t (&da)[16],
                                          const float (&lse2)[2],
                                          const float (&dlt)[2],
                                          const Shape& sh, const Mask& mask,
                                          int rel, int left, int win,
                                          bool masked) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int h = i % 2;
    float ds[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float p = exp2_fast(s[2 * i + e] * sh.scale_log2 - lse2[h]);
      const int at = 8 * (i / 2) + e;          // the key's offset
      if (masked && !visible(mask, rel + 8 * h - at, left - at, win))
        p = 0.0f;
      ds[e] = p * (dp[2 * i + e] - dlt[h]);
    }
    da[i] = Elem<T>::pack(ds[0], ds[1]);
  }
}

// All THREADS threads of a block call it, with Cfg<D>::SMEM bytes of
// dynamic shared memory.  tq, tdo: q, dout as (D, Sq, B Hq) maps in boxes
// of BIG rows; tk, tv: k, v as (D, Skv, B Hkv) in boxes of SMALL rows.
// Block (x, y) computes dq of q head x % Hq of batch x / Hq for query tile
// gridDim.y - 1 - y.
template <typename T, int D>
__device__ __forceinline__ void dq_block(const CUtensorMap* tq,
                                         const CUtensorMap* tdo,
                                         const CUtensorMap* tk,
                                         const CUtensorMap* tv,
                                         const float* __restrict__ LSE,
                                         const float* __restrict__ DELTA,
                                         T* __restrict__ DQ,
                                         const Shape& sh,
                                         unsigned char* smem) {
  using C = Cfg<D>;
  constexpr int PANELS = C::PANELS;
  constexpr int STAGES = C::STAGES;
  const Smem<D> sm(smem);
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / sh.hq;
  const int64_t kvh = b * sh.hkv + (bh % sh.hq) / (sh.hq / sh.hkv);
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * BIG;
  const Mask mask = sh.mask;

  // the key tiles the mask leaves for rows [q0, q0 + BIG)
  int64_t t0 = 0;
  int64_t t1 = (sh.skv + SMALL - 1) / SMALL;
  if (mask.causal) {
    const int64_t last = (q0 + BIG - 1) / SMALL + 1;
    t1 = last < t1 ? last : t1;
  }
  if (mask.windowed) {
    const int64_t oldest = q0 - mask.window + 1;
    if (oldest > 0) t0 = oldest / SMALL;
  }
  const int n = t1 > t0 ? static_cast<int>(t1 - t0) : 0;

  // key tile it into its stage of ring0 (K) or ring1 (V); by one thread
  auto issue = [&](int it, bool values) {
    const int s = it % STAGES;
    uint64_t* bar = values ? &sm.full1[s] : &sm.full0[s];
    mbar_expect(bar, C::SMALL_BYTES);
    load_rows<D, SMALL>((values ? sm.ring1 : sm.ring0) + s * C::SMALL_BYTES,
                        values ? tv : tk, bar, (t0 + it) * SMALL, kvh);
  };

  if (threadIdx.x == 0) {
    sm.init();
    mbar_expect(sm.big_full, 2 * C::BIG_BYTES);
    load_rows<D, BIG>(sm.big0, tq, sm.big_full, q0, bh);
    load_rows<D, BIG>(sm.big1, tdo, sm.big_full, q0, bh);
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

  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t row = row_a + 8 * h;
    const bool in = row < sh.sq;
    lse2[h] = in ? LSE[bh * sh.sq + row] * LOG2E : INFINITY;
    dlt[h] = in ? DELTA[bh * sh.sq + row] : 0.0f;
  }
  float dq[PANELS][32];
#pragma unroll
  for (int p = 0; p < PANELS; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[p][i] = 0.0f;

  const uint32_t q_addr = smem_addr(sm.big0) + wg * 64 * 128;
  const uint32_t do_addr = smem_addr(sm.big1) + wg * 64 * 128;
  const int win = window32(mask);
  mbar_wait(sm.big_full, 0);

  // none of the warpgroup's rows sees a key of the tile (skip) / some keys
  // are hidden from some rows (masked)
  auto skips = [&](int64_t k0) {
    return (mask.causal && k0 > r0 + 63) ||
           (mask.windowed && r0 - (k0 + SMALL - 1) >= mask.window);
  };
  auto masks = [&](int64_t k0) {
    return k0 + SMALL > sh.skv || (mask.causal && k0 + SMALL - 1 > r0) ||
           (mask.windowed && r0 + 63 - k0 >= mask.window);
  };

  for (int it = 0; it < n; ++it) {
    const int s = it % STAGES;
    const uint32_t ph = (it / STAGES) & 1;
    const int64_t k0 = (t0 + it) * SMALL;
    const bool skip = skips(k0);
    const uint32_t k_addr = smem_addr(sm.ring0 + s * C::SMALL_BYTES);
    const uint32_t v_addr = smem_addr(sm.ring1 + s * C::SMALL_BYTES);
    float sc[32], dp[32];
    mbar_wait(&sm.full0[s], ph);
    mbar_wait(&sm.full1[s], ph);
    if (!skip) {
      wg_fence();
      issue_qk<T, D, SMALL>(sc, q_addr, k_addr);
      issue_qk<T, D, SMALL>(dp, do_addr, v_addr);
      wg_commit();
      wg_wait_all();
      pin(sc);
      pin(dp);
    }
    release<STAGES>(sm.done1, wg, tid, it, n,
                    [&](int next) { issue(next, true); });
    if (!skip) {
      uint32_t da[16];
      dq_scores<T>(sc, dp, da, lse2, dlt, sh, mask,
                static_cast<int>(row_a - k0) - col_l,
                   capped(sh.skv - k0, SMALL) - col_l, win, masks(k0));
      pin_acc<D>(dq);
      pin(da);
      wg_fence();
      issue_pv<T, D, SMALL>(dq, da, k_addr);
      wg_commit();
      wg_wait_all();
      pin_acc<D>(dq);
    }
    release<STAGES>(sm.done0, wg, tid, it, n,
                    [&](int next) { issue(next, false); });
  }

  // dq = scale dQ, rounded once
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t row = row_a + 8 * h;
    if (row >= sh.sq) continue;
    T* dst = DQ + (bh * sh.sq + row) * D + col_l;
#pragma unroll
    for (int p = 0; p < PANELS; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (real_cols(D, p, j))
          store2(dst + p * 64 + 8 * j, dq[p][4 * j + 2 * h] * sh.scale,
                 dq[p][4 * j + 2 * h + 1] * sh.scale);
  }
}

// ---- (iii) dk and dv ---------------------------------------------------------------

// what a pass of the dk/dv kernel accumulates
enum Pass : int { PASS_DV = 1, PASS_DK = 2, PASS_DKV = 3 };

// All THREADS threads of a block call run(), with Cfg<D>::SMEM bytes of
// dynamic shared memory.  tk, tv: k, v as (D, Skv, B Hkv) maps in boxes of
// BIG rows; tq, tdo: q, dout as (D, Sq, B Hq) in boxes of SMALL rows.  Block
// (x, y) computes keys [BIG y, BIG y + BIG) of kv head (x / G) % Hkv of
// batch x / (G Hkv), over head group x % G of its query heads.
template <typename T, int D> struct DkvBlock {
  using C = Cfg<D>;
  static constexpr int PANELS = C::PANELS;
  static constexpr int STAGES = C::STAGES;

  const CUtensorMap* tq;
  const CUtensorMap* tdo;
  const float* __restrict__ LSE;
  const float* __restrict__ DELTA;
  T* __restrict__ DK;
  T* __restrict__ DV;
  float* __restrict__ PART;    // null (G = 1), or the (2, B, G, Hkv, Skv, D)
  Shape sh;
  Smem<D> sm;
  int64_t b, hk, g, kb0, h0, qt0;
  int nqt, per_pass, total;

  __device__ __forceinline__ DkvBlock(const CUtensorMap* tq_,
                                      const CUtensorMap* tdo_,
                                      const float* lse, const float* delta,
                                      T* dk, T* dv,
                                      float* part, const Shape& shape,
                                      unsigned char* smem)
      : tq(tq_), tdo(tdo_), LSE(lse), DELTA(delta), DK(dk), DV(dv),
        PART(part), sh(shape), sm(smem) {
    const int64_t x = blockIdx.x;
    g = x % sh.groups;
    hk = (x / sh.groups) % sh.hkv;
    b = x / (sh.groups * sh.hkv);
    kb0 = static_cast<int64_t>(blockIdx.y) * BIG;
    const int64_t group = sh.hq / sh.hkv;
    const int64_t heads = group / sh.groups;
    h0 = hk * group + g * heads;
    // the query tiles some row of which sees a key of [kb0, kb0 + BIG)
    qt0 = sh.mask.causal ? kb0 / SMALL : 0;
    int64_t qt1 = (sh.sq + SMALL - 1) / SMALL;
    if (sh.mask.windowed) {
      // the last row that sees the block's last key: row - key < window
      const int64_t last = kb0 + BIG - 1 + sh.mask.window - 1;
      const int64_t end = last < 0 ? 0 : last / SMALL + 1;
      qt1 = end < qt1 ? end : qt1;
    }
    nqt = qt1 > qt0 ? static_cast<int>(qt1 - qt0) : 0;
    per_pass = static_cast<int>(heads) * nqt;
    total = (D <= 128 ? 1 : 2) * per_pass;
  }

  // the head and first row of tile it (of any pass)
  __device__ __forceinline__ int64_t head_of(int it) const {
    return h0 + (it % per_pass) / nqt;
  }
  __device__ __forceinline__ int64_t row_of(int it) const {
    return (qt0 + (it % per_pass) % nqt) * SMALL;
  }

  // Q and dO of tile it into stage it % STAGES; by one thread
  __device__ __forceinline__ void issue(int it) const {
    const int s = it % STAGES;
    const int64_t z = b * sh.hq + head_of(it);
    mbar_expect(&sm.full0[s], 2 * C::SMALL_BYTES);
    load_rows<D, SMALL>(sm.ring0 + s * C::SMALL_BYTES, tq, &sm.full0[s],
                        row_of(it), z);
    load_rows<D, SMALL>(sm.ring1 + s * C::SMALL_BYTES, tdo, &sm.full0[s],
                        row_of(it), z);
  }

  // acc (64 keys x D of the fragment: key key_a + 8 (e / 2), column 64 p +
  // 8 j + col_l + e % 2) times mul, to the gradient `which` (0 dk, 1 dv)
  __device__ __forceinline__ void store(const float (&acc)[PANELS][32],
                                        float mul, int which, int64_t key_a,
                                        int col_l) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t key = key_a + 8 * h;
      if (key >= sh.skv) continue;
      const int64_t at = ((b * sh.hkv + hk) * sh.skv + key) * D + col_l;
      if (PART == nullptr) {
        T* dst = (which == 0 ? DK : DV) + at;
#pragma unroll
        for (int p = 0; p < PANELS; ++p)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (real_cols(D, p, j))
              store2(dst + p * 64 + 8 * j, acc[p][4 * j + 2 * h] * mul,
                     acc[p][4 * j + 2 * h + 1] * mul);
      } else {
        const int64_t per = sh.hkv * sh.skv * D;    // a (b, g) slice
        const int64_t batch = gridDim.x / (sh.groups * sh.hkv);
        float* dst = PART + ((which * batch + b) * sh.groups + g) * per +
                     (at - b * per);
#pragma unroll
        for (int p = 0; p < PANELS; ++p)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (real_cols(D, p, j))
              *reinterpret_cast<float2*>(dst + p * 64 + 8 * j) =
                  make_float2(acc[p][4 * j + 2 * h] * mul,
                              acc[p][4 * j + 2 * h + 1] * mul);
      }
    }
  }

  // one sweep over tiles [it0, it0 + per_pass), accumulating what PASS
  // names, then storing it
  template <int PASS>
  __device__ __forceinline__ void pass(int it0) const {
    constexpr bool WANT_DV = (PASS & PASS_DV) != 0;
    constexpr bool WANT_DK = (PASS & PASS_DK) != 0;
    const int wg = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int64_t kw = kb0 + wg * 64;                   // the warpgroup's keys
    const int64_t key_a = kw + warp * 16 + lane / 4;    // and key_a + 8
    const int col_l = 2 * (lane % 4);
    const uint32_t k_addr = smem_addr(sm.big0) + wg * 64 * 128;
    const uint32_t v_addr = smem_addr(sm.big1) + wg * 64 * 128;
    float* lse_s = sm.lse + wg * SMALL;
    float* dl_s = sm.delta + wg * SMALL;
    const Mask mask = sh.mask;
    const int win = window32(mask);
    // how far the thread's first key lies short of Skv (> 0: it exists)
    const int left = capped(sh.skv > key_a ? sh.skv - key_a : 0, 16);

    float dv[PANELS][32], dk[PANELS][32];
#pragma unroll
    for (int p = 0; p < PANELS; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if constexpr (WANT_DV) dv[p][i] = 0.0f;
        if constexpr (WANT_DK) dk[p][i] = 0.0f;
      }

    for (int it = it0; it < it0 + per_pass; ++it) {
      const int s = it % STAGES;
      const uint32_t ph = (it / STAGES) & 1;
      const int64_t q0 = row_of(it);
      const int64_t bh = b * sh.hq + head_of(it);
      // none of the tile's rows sees a key of the warpgroup's
      const bool skip =
          kw >= sh.skv || (mask.causal && q0 + SMALL - 1 < kw) ||
          (mask.windowed && q0 - (kw + 63) >= mask.window);
      mbar_wait(&sm.full0[s], ph);
      if (!skip) {
        if (tid < SMALL) {
          const int64_t row = q0 + tid;
          const bool in = row < sh.sq;
          lse_s[tid] = in ? LSE[bh * sh.sq + row] * LOG2E : INFINITY;
          dl_s[tid] = in ? DELTA[bh * sh.sq + row] : 0.0f;
        }
        warpgroup_sync(wg);
        const uint32_t q_addr = smem_addr(sm.ring0 + s * C::SMALL_BYTES);
        const uint32_t do_addr = smem_addr(sm.ring1 + s * C::SMALL_BYTES);
        float st[32], dpt[32];
        wg_fence();
        issue_qk<T, D, SMALL>(st, k_addr, q_addr);
        if constexpr (WANT_DK) issue_qk<T, D, SMALL>(dpt, v_addr, do_addr);
        wg_commit();
        wg_wait_all();
        pin(st);
        if constexpr (WANT_DK) pin(dpt);
        // st[4 j + e]: key key_a + 8 (e / 2), row q0 + 8 j + col_l + e % 2
        const bool masked =
            kw + 64 > sh.skv || (mask.causal && kw + 63 > q0) ||
            (mask.windowed && q0 + SMALL - 1 - kw >= mask.window);
        const int rel = static_cast<int>(q0 - key_a);
        uint32_t pa[16], da[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * (i / 2) + col_l + e;
            p[e] = exp2_fast(st[2 * i + e] * sh.scale_log2 - lse_s[c]);
            if (masked && !visible(mask, rel + c - 8 * (i % 2),
                                   left - 8 * (i % 2), win))
              p[e] = 0.0f;
            if constexpr (WANT_DK) ds[e] = p[e] * (dpt[2 * i + e] - dl_s[c]);
          }
          if constexpr (WANT_DV) pa[i] = Elem<T>::pack(p[0], p[1]);
          if constexpr (WANT_DK) da[i] = Elem<T>::pack(ds[0], ds[1]);
        }
        if constexpr (WANT_DV) pin_acc<D>(dv);
        if constexpr (WANT_DK) pin_acc<D>(dk);
        if constexpr (WANT_DV) pin(pa);
        if constexpr (WANT_DK) pin(da);
        wg_fence();
        if constexpr (WANT_DV) issue_pv<T, D, SMALL>(dv, pa, do_addr);
        if constexpr (WANT_DK) issue_pv<T, D, SMALL>(dk, da, q_addr);
        wg_commit();
        wg_wait_all();
        if constexpr (WANT_DV) pin_acc<D>(dv);
        if constexpr (WANT_DK) pin_acc<D>(dk);
      }
      release<STAGES>(sm.done0, wg, tid, it, total,
                      [&](int next) { issue(next); });
    }
    if constexpr (WANT_DV) store(dv, 1.0f, 1, key_a, col_l);
    if constexpr (WANT_DK) store(dk, sh.scale, 0, key_a, col_l);
  }

  __device__ __forceinline__ void run(const CUtensorMap* tk,
                                      const CUtensorMap* tv) const {
    if (threadIdx.x == 0) {
      sm.init();
      mbar_expect(sm.big_full, 2 * C::BIG_BYTES);
      load_rows<D, BIG>(sm.big0, tk, sm.big_full, kb0, b * sh.hkv + hk);
      load_rows<D, BIG>(sm.big1, tv, sm.big_full, kb0, b * sh.hkv + hk);
      for (int it = 0; it < STAGES && it < total; ++it) issue(it);
    }
    __syncthreads();
    mbar_wait(sm.big_full, 0);
    if constexpr (D <= 128) {
      pass<PASS_DKV>(0);
    } else {
      pass<PASS_DV>(0);
      pass<PASS_DK>(per_pass);
    }
  }
};

// ---- (iv) the head groups' sum ------------------------------------------------

// dk, dv = T(sum over g of PART[which, b, g]) in order g = 0, 1, ...;
// per = Hkv Skv D elements of a (b, g) slice; blockIdx.y: 0 dk, 1 dv
template <typename T>
__global__ void __launch_bounds__(256)
attention_bwd_dkv_sum_kernel(const float* __restrict__ PART,
                             T* __restrict__ DK, T* __restrict__ DV,
                             int64_t batch, int64_t groups, int64_t per) {
  const int which = blockIdx.y;
  const float* part = PART + which * batch * groups * per;
  T* dst = which == 0 ? DK : DV;
  const int64_t pairs = batch * per / 2;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < pairs; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t b = 2 * i / per;
    const int64_t r = 2 * i - b * per;
    const float* src = part + b * groups * per + r;
    float2 acc = *reinterpret_cast<const float2*>(src);
    for (int64_t g = 1; g < groups; ++g) {
      const float2 x = *reinterpret_cast<const float2*>(src + g * per);
      acc.x += x.x;
      acc.y += x.y;
    }
    store2(dst + 2 * i, acc.x, acc.y);
  }
}

// ---- kernels and the launcher ---------------------------------------------------

// T: __nv_bfloat16 (bf16_wgmma) or __half (f16_wgmma)
template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1)
attention_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const float* __restrict__ LSE,
                              const float* __restrict__ DELTA,
                              T* __restrict__ DQ, const Shape sh) {
  extern __shared__ __align__(1024) unsigned char bwd_wg_smem[];
  dq_block<T, D>(&tq, &tdo, &tk, &tv, LSE, DELTA, DQ, sh, bwd_wg_smem);
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1)
attention_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ LSE,
                               const float* __restrict__ DELTA,
                               T* __restrict__ DK, T* __restrict__ DV,
                               float* __restrict__ PART, const Shape sh) {
  extern __shared__ __align__(1024) unsigned char bwd_wg_smem[];
  const DkvBlock<T, D> block(&tq, &tdo, LSE, DELTA, DK, DV, PART, sh,
                             bwd_wg_smem);
  block.run(&tk, &tv);
}

// Enqueues (i)-(iv) for elements of type T.  delta: a (B, Hq, Sq) float32
// scratch; part: null when sh.groups == 1, else the (2, B, G, Hkv, Skv, D)
// float32 scratch.
template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, void* dq, void* dk,
                     void* dv, const float* lse, float* delta, float* part,
                     int64_t batch, const Shape& sh, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr CUtensorMapDataType type = Elem<T>::TMA;
  const auto make_map = [](CUtensorMap* map, const void* base, int64_t rows,
                           int64_t levels, int box_rows) {
    return bind_gemm::make_map(map, type, base, rows, D, levels, 0,
                               box_rows);
  };
  const int64_t q_tiles = (sh.sq + BIG - 1) / BIG;
  const int64_t k_blocks = (sh.skv + BIG - 1) / BIG;
  // TMA coordinates are 32-bit; tiles and key blocks are the grids' y
  if (q_tiles > 65535 || k_blocks > 65535 || sh.sq > 0x7fffffff ||
      sh.skv > 0x7fffffff || batch * sh.hq > 0x7fffffff ||
      batch * sh.hkv * sh.groups > 0x7fffffff)
    return cudaErrorInvalidValue;
  CUtensorMap tq_big, tdo_big, tk_small, tv_small;
  CUtensorMap tk_big, tv_big, tq_small, tdo_small;
  const int64_t zq = batch * sh.hq, zk = batch * sh.hkv;
  cudaError_t err;
  if ((err = make_map(&tq_big, q, sh.sq, zq, BIG)) != cudaSuccess ||
      (err = make_map(&tdo_big, dout, sh.sq, zq, BIG)) != cudaSuccess ||
      (err = make_map(&tq_small, q, sh.sq, zq, SMALL)) != cudaSuccess ||
      (err = make_map(&tdo_small, dout, sh.sq, zq, SMALL)) != cudaSuccess ||
      (err = make_map(&tk_big, k, sh.skv, zk, BIG)) != cudaSuccess ||
      (err = make_map(&tv_big, v, sh.skv, zk, BIG)) != cudaSuccess ||
      (err = make_map(&tk_small, k, sh.skv, zk, SMALL)) != cudaSuccess ||
      (err = make_map(&tv_small, v, sh.skv, zk, SMALL)) != cudaSuccess)
    return err;
  auto kdq = attention_bwd_dq_wgmma_kernel<D, T>;
  auto kdkv = attention_bwd_dkv_wgmma_kernel<D, T>;
  if ((err = cudaFuncSetAttribute(kdq,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(C::SMEM))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(kdkv,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(C::SMEM))) != cudaSuccess)
    return err;
  const auto* O = static_cast<const T*>(o);
  const auto* dO = static_cast<const T*>(dout);
  const int64_t rows = zq * sh.sq;
  attention_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8),
                                  256, 0, stream>>>(O, dO, delta, rows, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kdq<<<dim3(static_cast<unsigned>(zq), static_cast<unsigned>(q_tiles)),
        THREADS, C::SMEM, stream>>>(tq_big, tdo_big, tk_small, tv_small, lse,
                                    delta, static_cast<T*>(dq), sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kdkv<<<dim3(static_cast<unsigned>(zk * sh.groups),
              static_cast<unsigned>(k_blocks)),
         THREADS, C::SMEM, stream>>>(
      tk_big, tv_big, tq_small, tdo_small, lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), sh.groups > 1 ? part : nullptr, sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (sh.groups > 1) {
    const int64_t per = sh.hkv * sh.skv * D;
    const int64_t blocks = (batch * per / 2 + 255) / 256;
    attention_bwd_dkv_sum_kernel<T><<<
        dim3(static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 2), 256, 0,
        stream>>>(part, static_cast<T*>(dk), static_cast<T*>(dv), batch,
                  sh.groups, per);
  }
  return cudaGetLastError();
}

template <typename T>
inline cudaError_t launch(const void* q, const void* k, const void* v,
                          const void* o, const void* dout, void* dq, void* dk,
                          void* dv, const float* lse, float* delta,
                          float* part, int64_t batch, const Shape& sh,
                          int64_t d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch_d<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                 part, batch, sh, stream);
    case 80: return launch_d<T, 80>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                 part, batch, sh, stream);
    case 96: return launch_d<T, 96>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                 part, batch, sh, stream);
    case 128: return launch_d<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                   part, batch, sh, stream);
    case 192: return launch_d<T, 192>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                   part, batch, sh, stream);
    case 256: return launch_d<T, 256>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                   part, batch, sh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bind_attn_bwd
