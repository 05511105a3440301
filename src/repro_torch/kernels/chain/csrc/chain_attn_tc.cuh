// chain_attn on the tensor cores: the routes BF16_WGMMA and F16_WGMMA
// (wgmma fed by TMA) and F32_3XTF32 (wgmma in TF32, each product split
// three ways).  A level's softmax(q k^T / sqrt(d)) v is flash attention's
// sweep, the very block flash_attention.cu runs (sweep_block of
// ../../flash_attention/csrc/attn_wgmma.cuh and attn_tf32.cuh: 128 query
// rows, two warpgroups of 64, the online softmax on the accumulator
// fragments); only what is around it is the chain's.
//
// Levels and chunks in parallel.  The contract of chain_attn (chain.cu)
// stands: a level's result is computed apart from the carry, and the
// carry is carry <- round_T(carry + level) in level order, rounded to T
// after every level.  One level of the served shape (512 query rows, 512
// keys, d 128) is only 4 row tiles, 4 blocks on 132 SMs.  So each level's
// keys are also split into S chunks of whole key tiles, and the grid is
// (row tile, level x chunk), one block each:
//   * a block sweeps its chunk's key tiles (a key range, as the causal t1
//     and windowed t0 of flash attention give one, with no mask but the
//     ragged end), stages its rows' O, m (the max, in the sweep's scaled
//     log2 units) and l in shared memory and writes them to the
//     workspace in float (emit): O unnormalised and (m, l) for a chunk of
//     several, O (1 / l) for a level of one chunk;
//   * the last of a (row tile, level)'s S blocks to finish (a
//     __threadfence and an atomic counter, set back to 0 by that block,
//     so no launch clears them) merges the chunks in fixed chunk order,
//     the flash-decoding combine: m* = max_c m_c, w_c = 2^(m_c - m*), the
//     level's value (sum_c w_c O_c) (1 / sum_c w_c l_c), each operation
//     rounded to float in that order, into chunk 0's slot (merge_chunks);
//   * a launch of several levels then runs chain_attn_fold_kernel on the
//     same stream: each thread adds four elements' levels into the carry
//     in level order, rounding to T after each, and writes out.  The fold
//     is the carry's ordered sum, element by element; by the last block
//     of a row tile, as the CUDA-core loop folds, it read every level's
//     values from one SM (1 MB at the 16-level Qwen3-14B tile, 24 of a
//     bf16 chain's 38 us on an H100).  A launch of one level, every served
//     attn_step, is one kernel: the merge (or, for one chunk, emit) adds
//     the value into the carry itself, with the fold's operations, so its
//     bits are a chain's.
// Only those last steps read the carry (the CUDA-core routes load it in
// every block, to keep their register pressure and bits, chain.cu).
//
// S (the wrapper's, kernels/chain/kernel.py attn_chunks) depends only on
// the level's shape and route: M, N, d and the route's key tile.  Never
// on the chain's length or on which run of levels a launch holds: a
// level's bits are then the same in a chain of any length as in per-level
// replay (attn_step: this kernel with one level), which chip_smoke.py
// checks bit for bit.  The rule: as many chunks as make the row tiles
// times S at least 16 blocks, no more than the level's key tiles (a
// chunk is at least one tile); the served shape runs as 16 blocks (4 row
// tiles x 4 chunks of one 128-key tile on wgmma, of four 32-key tiles in
// 3xTF32).  More chunks would fill more of the card for one level but
// restage the block's Q (64 KB of f32) for fewer keys and make the merge
// read more partials, which a chain of many levels pays for every level.
//
// Accuracy.  f32_3xtf32: the products as flash attention's 3xTF32 route
// (attn_tf32.cuh; within float32's tolerance, float64 error at most 4x the
// CUDA-core loop's, TF32_VS_SIMT).  bf16_wgmma / f16_wgmma: P is rounded
// to T before P V (the CUDA-core loop keeps it in float): each p moves by
// at most u relative (u = 2^-9 in bf16, 2^-11 in f16, plus 2^-25 absolute
// below f16's normal range), so a level's value moves by at most u
// sum_k p_k |v_k| <= u max|v|, beside the carry's own rounding to T
// (u |carry| each level, on either route).  Against float64 the CUDA-core
// route's error is that rounding alone.  Both are rounding errors of about
// the same size, independent of each other (the one of P in the sum over
// keys, the other of the output), so the tensor-core route's rms error is
// about sqrt(2) times the CUDA-core route's where the carry starts at 0
// and its largest about (1 + ~0.5) times it; with a carry of unit size the
// carry's rounding dominates both and the ratio is near 1.  chip_smoke.py
// holds the largest error to at most 2x the *_simt route's on the same
// values (CHAIN_HALF_VS_SIMT), which P rounded through bf16 on f16
// (4u) does not meet.  The merge adds a few float roundings of values of
// the level's size (2^-24 relative), far below either.
//
// Shapes: d == dv, one of the blocks' head dims (wgmma_head_dim: 64, 80,
// 96, 128, 192, 256; chain_tf32_head_dim: 32, 64, 80, 96, 128), N >= 1,
// and every level's q, k and v 16-byte aligned (TMA, and the 16-byte
// loads of the 3xTF32 staging).  d 256 in float32 stays on f32_simt: its
// 3xTF32 block is attn_tf32_wide.cuh's 64-row one, not swept here.
// Anything else takes the CUDA-core loop (chain.cu), unchanged.

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "../../flash_attention/csrc/attn_tf32.cuh"
#include "../../flash_attention/csrc/attn_wgmma.cuh"
#include "../../gemm/csrc/gemm_tile.cuh"

namespace bind_chain_tc {

using bind_gemm::from_acc;
using bind_gemm::to_acc;

constexpr int ROWS = 128;            // query rows of a block (either route)
constexpr int THREADS = 256;         // two warpgroups
constexpr int MAX_CHUNKS = 16;       // the merge's weights in shared memory
constexpr int IP = 4;                // float4 of the row tile a thread a pass
                                     // (emit; merge_chunks: 4 or 8)
static_assert(bind_attn_wg::BQ == ROWS && bind_attn_tf::BQ == ROWS, "rows");
static_assert(bind_attn_wg::THREADS == THREADS &&
                  bind_attn_tf::THREADS == THREADS,
              "threads");

// the head dims of chain_attn's f32_3xtf32 route (kernel.py
// TF32_HEAD_DIMS): attn_tf32.cuh's block
__host__ __device__ constexpr bool chain_tf32_head_dim(int64_t d) {
  return d == 32 || d == 64 || d == 80 || d == 96 || d == 128;
}

// one launch: o0 the carry in, out the carry out (M x d each), q (M x d),
// k and v (N x d) at level l start l * *_stride elements on (0: shared by
// every level); work holds n_levels x chunks x M x d floats of O, then
// n_levels x chunks x M pairs (m, l); done holds gridDim.x x n_levels
// chunk counters, all 0
template <typename T> struct Problem {
  const T* o0;
  T* out;
  const T* q;
  int64_t q_stride;
  const T* k;
  int64_t k_stride;
  const T* v;
  int64_t v_stride;
  float* work;
  unsigned int* done;
  int64_t m, n, n_levels;
  int chunks;
  int64_t per;                       // key tiles a chunk (the last: fewer)
  float scale_log2;                  // scale * log2(e)
  // none: the host's, and data to the 3xTF32 block, not a constant.
  // Folded to a constant, its tile loop lost flash attention's branches
  // and ptxas serialised its wgmma for registers (C7511); the wgmma block
  // takes a constant one
  bind_attn::Mask mask;
};

// the key tiles [t0, t1) of chunk c of a level of `tiles`, p.per a chunk
template <typename T>
__device__ __forceinline__ void chunk_tiles(const Problem<T>& p,
                                            int64_t tiles, int64_t c,
                                            int64_t& t0, int64_t& t1) {
  t0 = c * p.per;
  t1 = t0 + p.per < tiles ? t0 + p.per : tiles;
}

// The carry's one operation, for every place that adds a level into it
// (add_carry below, for emit and merge_chunks, and chain_attn_fold_kernel):
// the carry c plus the level's value v, rounded to T
template <typename T>
__device__ __forceinline__ T carry_plus(float c, float v) {
  return from_acc<T>(__fadd_rn(c, v));
}

// The block's rows as the sweep leaves them, in shared memory: O (ROWS x
// d floats, rows RS(d) apart: 4 floats of padding make a quad's eight
// rows fall on distinct banks, two ways at most) and each row's m, l and
// 1 / l.  The sweep's epilogue only stages (stage2, stage_row): anything more
// there (the global stores of three cases) made ptxas serialise the 3xTF32
// block's wgmma for registers (C7511); emit() below writes them, float4
// by float4 along the rows.
__host__ __device__ constexpr int RS(int d) { return d + 4; }
template <int D> __host__ __device__ constexpr int staged_bytes() {
  return (ROWS * RS(D) + 3 * ROWS) * 4;
}

// the local row (of ROWS) of the thread's row_a, as the sweep lays out a
// block's rows: warpgroup, warp, lane / 4
__device__ __forceinline__ int local_row(int lane) {
  return (threadIdx.x / 128) * 64 + ((threadIdx.x % 128) / 32) * 16 +
         lane / 4;
}
__device__ __forceinline__ void stage2(float* os, int d, int r, int col,
                                       float a, float b) {
  *reinterpret_cast<float2*>(os + r * RS(d) + col) = make_float2(a, b);
}
// row r's l summed over its quad; m, l and 1 / l (__frcp_rn) stored once
__device__ __forceinline__ void stage_row(float* os, int d, int r,
                                          float m, float& l, int lane) {
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if ((lane & 3) == 0) {
    float* rows = os + ROWS * RS(d);
    rows[r] = m;
    rows[ROWS + r] = l;
    rows[2 * ROWS + r] = __frcp_rn(l);
  }
}

// The carry at N float4 items of the row tile (item b: elements e0 + 4
// i[b] .. + 3), 0 where not live[b], for add_carry.  Every o0 load is
// issued before any store to out, which may alias o0 as far as the
// compiler knows (so a load after a store would wait for it: one memory
// round trip an item).
template <typename T, int N>
__device__ __forceinline__ void load_carry(const Problem<T>& p, int64_t e0,
                                           const int (&i)[N],
                                           const bool (&live)[N],
                                           float (&c)[N][4]) {
#pragma unroll
  for (int b = 0; b < N; ++b)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[b][j] = live[b] ? to_acc(p.o0[e0 + 4 * static_cast<int64_t>(i[b]) +
                                      j])
                        : 0.0f;
}
// out = round_T(c + v[b]) at the live items (carry_plus)
template <typename T, int N>
__device__ __forceinline__ void add_carry(const Problem<T>& p, int64_t e0,
                                          const int (&i)[N],
                                          const bool (&live)[N],
                                          const float (&c)[N][4],
                                          const float4 (&v)[N]) {
#pragma unroll
  for (int b = 0; b < N; ++b) {
    if (!live[b]) continue;
    T* out = p.out + e0 + 4 * static_cast<int64_t>(i[b]);
    out[0] = carry_plus<T>(c[b][0], v[b].x);
    out[1] = carry_plus<T>(c[b][1], v[b].y);
    out[2] = carry_plus<T>(c[b][2], v[b].z);
    out[3] = carry_plus<T>(c[b][3], v[b].w);
  }
}

// The staged rows to where they go (after a barrier): a launch of one level
// in one chunk, whose block is its row tile's only one, adds O / l into
// the carry at once, out = round_T(o0 + O (1 / l)) (add_carry, as the
// merge does; chain_attn_fold_kernel takes the same carry_plus); a level
// of one chunk stores O (1 / l) in its workspace slot; a chunk of several
// stores O and its rows' (m, l).
template <typename T>
__device__ __forceinline__ void emit(const Problem<T>& p, int d,
                                     int64_t level, int64_t chunk,
                                     int64_t q0, const float* os) {
  const int rows = static_cast<int>(p.m - q0 < ROWS ? p.m - q0 : ROWS);
  const int q4 = d / 4;
  const float* mrow = os + ROWS * RS(d);
  const float* lrow = mrow + ROWS;
  const float* inv = lrow + ROWS;
  float* slot = p.work + ((level * p.chunks + chunk) * p.m + q0) * d;
  const bool direct = p.chunks == 1 && p.n_levels == 1;
  for (int i0 = threadIdx.x; i0 < rows * q4; i0 += THREADS * IP) {
    int at[IP];
    bool live[IP];
    float4 x[IP];
#pragma unroll
    for (int b = 0; b < IP; ++b) {
      at[b] = i0 + b * THREADS;
      live[b] = at[b] < rows * q4;
      const int r = at[b] / q4, c = (at[b] % q4) * 4;
      x[b] = live[b] ? *reinterpret_cast<const float4*>(os + r * RS(d) + c)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      if (p.chunks == 1) {
        const float s = live[b] ? inv[r] : 0.0f;
        x[b] = make_float4(__fmul_rn(x[b].x, s), __fmul_rn(x[b].y, s),
                           __fmul_rn(x[b].z, s), __fmul_rn(x[b].w, s));
      }
    }
    if (direct) {
      float c[IP][4];
      load_carry(p, q0 * d, at, live, c);
      add_carry(p, q0 * d, at, live, c, x);
    } else {
#pragma unroll
      for (int b = 0; b < IP; ++b)
        if (live[b]) reinterpret_cast<float4*>(slot)[at[b]] = x[b];
    }
  }
  if (p.chunks > 1) {
    float* ml = p.work + p.n_levels * p.chunks * p.m * d +
                ((level * p.chunks + chunk) * p.m + q0) * 2;
    for (int r = threadIdx.x; r < rows; r += THREADS)
      reinterpret_cast<float2*>(ml)[r] =
          make_float2(mrow[r], lrow[r]);
  }
}

// Whether this block is the last of `total` to arrive at counter c (after
// every thread's stores); the last sets it back to 0.
__device__ __forceinline__ bool arrive(unsigned int* c, unsigned int total) {
  __shared__ unsigned int ticket;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    ticket = atomicAdd(c, 1u) + 1;
    if (ticket == total) *c = 0;
  }
  __syncthreads();
  const bool last = ticket == total;
  if (last) __threadfence();
  return last;
}

// 16 bytes from global memory at src into shared memory at dst, through L2
// (cg: never a line of this SM's L1, which other blocks' stores do not
// update); the copies of one thread complete in the groups it commits
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// until at most N of the thread's groups are still in flight
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A pass of the merge or the fold over one thread's IP float4 of the row
// tile (items i0, i0 + THREADS, ...; item b at base[b] and base[b] + k
// stride at step k, for the K steps of a level's chunks or of the chain's
// levels): the steps are copied into shared memory G - 1 ahead (cp.async,
// a ring of G slots a thread, each thread copying and reading only its
// own), and each handed to use(k, b, x) in step order.  So a pass keeps G
// - 1 steps of loads in flight without holding them in registers (loading
// into registers kept one step in flight, ~25 GB/s a block).
template <int G, int N, typename Use>
__device__ __forceinline__ void stream_steps(float4* ring,
                                             const float4* (&base)[N],
                                             const bool (&live)[N],
                                             int64_t stride, int64_t K,
                                             Use&& use) {
  float4* mine = ring + threadIdx.x;
  auto issue = [&](int64_t k) {
    if (k < K) {
      float4* slot = mine + (k % G) * N * THREADS;
#pragma unroll
      for (int b = 0; b < N; ++b)
        if (live[b]) cp_async16(slot + b * THREADS, base[b] + k * stride);
    }
    cp_commit();              // every step a group, empty past K
  };
#pragma unroll
  for (int g = 0; g < G - 1; ++g) issue(g);
  for (int64_t k = 0; k < K; ++k) {
    issue(k + G - 1);
    cp_wait<G - 1>();         // step k's group has landed
    const float4* slot = mine + (k % G) * N * THREADS;
#pragma unroll
    for (int b = 0; b < N; ++b)
      if (live[b]) use(k, b, slot[b * THREADS]);
  }
}

// ring slots of G steps of N float4 for THREADS threads, in bytes
template <int G, int N> __host__ __device__ constexpr int ring_bytes() {
  return G * N * THREADS * 16;
}
// the most steps of N float4 a thread in flight that fit `bytes` of shared
// memory (at most 8)
template <int N> __host__ __device__ constexpr int ring_steps(int bytes) {
  return bytes / ring_bytes<1, N>() < 8 ? bytes / ring_bytes<1, N>() : 8;
}

// After the block emitted its chunk's partials, for a level of several
// chunks: the last of its (row tile, level)'s blocks merges them (the
// comment at the top) into chunk 0's slot, or, for a launch of one level,
// straight into the carry (add_carry: out = round_T(o0 + value), the
// fold's carry_plus); chain_attn_fold_kernel adds a launch's levels into the
// carry after it.  Each pass streams the chunks through shared memory
// (stream_steps).  smem: the sweep's SMEM bytes, free once it is done but
// for the last ones (the wgmma block's mbarriers); the weights take (2
// MAX_CHUNKS + 1) x ROWS floats of it.
template <int SMEM, typename T>
__device__ __forceinline__ void merge_chunks(const Problem<T>& p, int d,
                                             int64_t level, int64_t q0,
                                             unsigned char* smem) {
  constexpr int WEIGHTS = (2 * MAX_CHUNKS + 1) * ROWS * 4;
  // below the sweep's mbarriers (the last bytes of its shared memory) and
  // its 1024-byte alignment pad
  constexpr int FREE = SMEM - 2048 - WEIGHTS;
  // 8 float4 a thread a pass where 4 steps of them fit (the served level's
  // 4 chunks in flight at once), else 4
  constexpr int N = ring_steps<8>(FREE) >= 4 ? 8 : IP;
  constexpr int G = ring_steps<N>(FREE);
  static_assert(G >= 2, "shared memory");
  if (p.chunks == 1 ||
      !arrive(&p.done[blockIdx.x * p.n_levels + level], p.chunks))
    return;
  const int rows = static_cast<int>(p.m - q0 < ROWS ? p.m - q0 : ROWS);
  const int64_t plane = p.m * d;              // floats of a (level, chunk)
  const int q4 = d / 4;                       // float4 of a row
  const int items = rows * q4;
  // each chunk's (m, l) of each row into shared memory, all loads at once;
  // then a row's weights w_c = 2^(m_c - max_c m_c) (over m) and the
  // reciprocal of its sum_c w_c l_c, each in chunk order
  float* w = reinterpret_cast<float*>(smem);   // [MAX_CHUNKS][ROWS]
  float* ls = w + MAX_CHUNKS * ROWS;           // [MAX_CHUNKS][ROWS]
  float* inv = ls + MAX_CHUNKS * ROWS;         // [ROWS]
  float4* ring = reinterpret_cast<float4*>(smem + WEIGHTS);
  const float* ml = p.work + p.n_levels * p.chunks * plane +
                    (level * p.chunks * p.m + q0) * 2;
  for (int i = threadIdx.x; i < rows * p.chunks; i += THREADS) {
    const int c = i / rows, r = i % rows;
    const float2 x =
        __ldcg(reinterpret_cast<const float2*>(ml + (c * p.m + r) * 2));
    w[c * ROWS + r] = x.x;
    ls[c * ROWS + r] = x.y;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    float mx = -INFINITY;
    for (int c = 0; c < p.chunks; ++c) mx = fmaxf(mx, w[c * ROWS + r]);
    float sum = 0.0f;
    for (int c = 0; c < p.chunks; ++c) {
      const float wc = exp2f(__fsub_rn(w[c * ROWS + r], mx));
      w[c * ROWS + r] = wc;
      sum = __fadd_rn(sum, __fmul_rn(wc, ls[c * ROWS + r]));
    }
    inv[r] = __frcp_rn(sum);
  }
  __syncthreads();
  // the level's value (sum_c w_c O_c) (1 / sum_c w_c l_c)
  float* lv = p.work + level * p.chunks * plane + q0 * d;
  for (int i0 = threadIdx.x; i0 < items; i0 += THREADS * N) {
    const float4* base[N];
    bool live[N];
    int at[N];
    float4 acc[N];
    float c0[N][4];
#pragma unroll
    for (int b = 0; b < N; ++b) {
      at[b] = i0 + b * THREADS;
      live[b] = at[b] < items;
      base[b] = reinterpret_cast<const float4*>(lv) + at[b];
      acc[b] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // the carry, loaded while the chunks stream in
    if (p.n_levels == 1) load_carry(p, q0 * d, at, live, c0);
    stream_steps<G>(
        ring, base, live, plane / 4, p.chunks,
        [&](int64_t c, int b, const float4& x) {
          const float wc = w[c * ROWS + at[b] / q4];
          acc[b].x = __fadd_rn(acc[b].x, __fmul_rn(wc, x.x));
          acc[b].y = __fadd_rn(acc[b].y, __fmul_rn(wc, x.y));
          acc[b].z = __fadd_rn(acc[b].z, __fmul_rn(wc, x.z));
          acc[b].w = __fadd_rn(acc[b].w, __fmul_rn(wc, x.w));
        });
    float4 v[N];
#pragma unroll
    for (int b = 0; b < N; ++b) {
      const float s = live[b] ? inv[at[b] / q4] : 0.0f;
      v[b] = make_float4(__fmul_rn(acc[b].x, s), __fmul_rn(acc[b].y, s),
                         __fmul_rn(acc[b].z, s), __fmul_rn(acc[b].w, s));
    }
    if (p.n_levels == 1) {
      add_carry(p, q0 * d, at, live, c0, v);
    } else {
#pragma unroll
      for (int b = 0; b < N; ++b)
        if (live[b]) reinterpret_cast<float4*>(lv)[at[b]] = v[b];
    }
  }
}

// The carry of a launch of several levels: out = o0 with each level's value
// (its chunk-0 slot) added in level order, rounded to T after every level,
// four neighbouring elements a thread.  It runs after the chain kernel on
// the same stream, over the whole card: the fold is an ordered sum per
// element, independent across elements, and one block a row tile reading
// every level's values (1 MB at the 16-level Qwen3-14B tile) could not
// keep enough bytes in flight (~40-85 GB/s a block on an H100: 24 of a
// bf16 chain's 38 us).
constexpr int FOLD_THREADS = 256;
template <typename T>
__global__ void __launch_bounds__(FOLD_THREADS)
chain_attn_fold_kernel(const Problem<T> p, int d) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * FOLD_THREADS + threadIdx.x;
  if (i >= p.m * d / 4) return;
  const int64_t step = p.chunks * p.m * d / 4;   // float4 between levels
  const float4* x = reinterpret_cast<const float4*>(p.work) + i;
  const int64_t e = 4 * i;
  float4 c = make_float4(to_acc(p.o0[e]), to_acc(p.o0[e + 1]),
                         to_acc(p.o0[e + 2]), to_acc(p.o0[e + 3]));
#pragma unroll 8
  for (int64_t l = 0; l < p.n_levels; ++l) {
    const float4 v = __ldcg(x + l * step);
    c.x = to_acc(carry_plus<T>(c.x, v.x));
    c.y = to_acc(carry_plus<T>(c.y, v.y));
    c.z = to_acc(carry_plus<T>(c.z, v.z));
    c.w = to_acc(carry_plus<T>(c.w, v.w));
  }
  p.out[e] = from_acc<T>(c.x);
  p.out[e + 1] = from_acc<T>(c.y);
  p.out[e + 2] = from_acc<T>(c.z);
  p.out[e + 3] = from_acc<T>(c.w);
}

// blockIdx.x / .y read by an asm statement the compiler may not merge with
// an earlier read: the chain's indices are computed again after the sweep
// rather than held in registers across it (held, they made ptxas serialise
// the 3xTF32 block's wgmma, C7511)
__device__ __forceinline__ unsigned ctaid_x() {
  unsigned r;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned ctaid_y() {
  unsigned r;
  asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(r));
  return r;
}

// ---- bf16_wgmma / f16_wgmma ------------------------------------------------

// block (r, y): row tile r, level y / chunks, chunk y % chunks; tq, tk, tv
// map q, k, v as (D, rows, planes), a plane per level (one for an operand
// every level shares)
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
chain_attn_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const Problem<T> p) {
  using C = bind_attn_wg::Cfg<D>;
  constexpr int PANELS = C::PANELS;
  static_assert(staged_bytes<D>() + 2048 <= C::SMEM, "staged rows");
  extern __shared__ __align__(1024) unsigned char cw_smem[];
  // the level, chunk and row tile are taken again after the sweep
  // (ctaid_x / ctaid_y)
  int64_t t0, t1;
  chunk_tiles(p, (p.n + C::BKV - 1) / C::BKV, blockIdx.y % p.chunks, t0,
              t1);
  // no mask but the ragged end, a constant here (p.mask is for the 3xTF32
  // block: with a data mask this sweep ran ~1.8x slower on an H100)
  const bind_attn_wg::Shape sh{1, 1, p.m, p.n, p.scale_log2,
                               bind_attn::Mask{false, false, 0}};
  const int z = static_cast<int>(blockIdx.y / p.chunks);
  bind_attn_wg::sweep_block<T, D>(
      &tq, &tk, &tv, sh, static_cast<int64_t>(blockIdx.x) * ROWS,
      p.q_stride ? z : 0, p.k_stride ? z : 0, p.v_stride ? z : 0, t0, t1,
      cw_smem,
      [&](float (&o)[PANELS][32], float (&m)[2], float (&l)[2],
          int64_t, int col_l, int lane) {
        __syncthreads();      // every warpgroup is done with the tiles
        float* os = reinterpret_cast<float*>(cw_smem);
        const int r0 = local_row(lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          stage_row(os, D, r0 + 8 * h, m[h], l[h], lane);
#pragma unroll
          for (int pn = 0; pn < PANELS; ++pn)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (bind_attn_wg::real_cols(D, pn, j))
                stage2(os, D, r0 + 8 * h, pn * 64 + 8 * j + col_l,
                       o[pn][4 * j + 2 * h], o[pn][4 * j + 2 * h + 1]);
        }
      });
  __syncthreads();
  const unsigned y = ctaid_y();
  const int64_t q0 = static_cast<int64_t>(ctaid_x()) * ROWS;
  emit(p, D, y / p.chunks, y % p.chunks, q0,
       reinterpret_cast<const float*>(cw_smem));
  merge_chunks<static_cast<int>(C::SMEM)>(p, D, y / p.chunks, q0,
                                          cw_smem);
}

// ---- f32_3xtf32 -------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
chain_attn_tf32_kernel(const Problem<float> p) {
  using C = bind_attn_tf::Cfg<D>;
  static_assert(staged_bytes<D>() + 2048 <= C::SMEM, "staged rows");
  extern __shared__ __align__(1024) unsigned char ct_smem[];
  // as chain_attn_wgmma_kernel: the chain's indices again after the sweep
  int64_t t0, t1;
  chunk_tiles(p, (p.n + C::BKV - 1) / C::BKV, blockIdx.y % p.chunks, t0,
              t1);
  const bind_attn_tf::Shape sh{nullptr, nullptr, nullptr, nullptr, 1, 1,
                               p.m,     p.n,     p.scale_log2, p.mask};
  const int64_t level = blockIdx.y / p.chunks;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * ROWS;
  bind_attn_tf::sweep_block<D>(
      sh, p.q + level * p.q_stride + q0 * D, p.m - q0,
      p.k + level * p.k_stride, p.v + level * p.v_stride, q0, t0, t1,
      ct_smem,
      [&](float (&o)[C::OR], float (&m)[2], float (&l)[2], int64_t,
          int col_l, int lane) {
        __syncthreads();      // every warpgroup is done with the tiles
        float* os = reinterpret_cast<float*>(ct_smem);
        const int r0 = local_row(lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          stage_row(os, D, r0 + 8 * h, m[h], l[h], lane);
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            stage2(os, D, r0 + 8 * h, 8 * j + col_l, o[4 * j + 2 * h],
                   o[4 * j + 2 * h + 1]);
        }
      });
  __syncthreads();
  const unsigned y = ctaid_y();
  const int64_t q0b = static_cast<int64_t>(ctaid_x()) * ROWS;
  emit(p, D, y / p.chunks, y % p.chunks, q0b,
       reinterpret_cast<const float*>(ct_smem));
  merge_chunks<static_cast<int>(C::SMEM)>(p, D, y / p.chunks, q0b,
                                          ct_smem);
}

// ---- launch -----------------------------------------------------------------

// the key tile of each route's block at head dim d (kernel.py KEY_TILES)
template <typename T> inline int key_tile(int d) {
  if constexpr (std::is_same_v<T, float>)
    return d <= 64 ? 64 : 32;                    // attn_tf32.cuh Cfg::BKV
  else
    return d <= 128 ? 128 : 64;                  // attn_wgmma.cuh Cfg::BKV
}

// whether chunks splits the level's key tiles into that many non-empty
// chunks (the wrapper's attn_chunks gives no other count)
inline bool chunks_fit(int64_t tiles, int chunks) {
  if (chunks < 1 || chunks > MAX_CHUNKS || chunks > tiles) return false;
  const int64_t per = (tiles + chunks - 1) / chunks;
  return (tiles + per - 1) / per == chunks;
}

inline dim3 grid_of(int64_t m, int64_t n_levels, int chunks) {
  return dim3(static_cast<unsigned>((m + ROWS - 1) / ROWS),
              static_cast<unsigned>(n_levels * chunks));
}

// chain_attn_fold_kernel after a launch of several levels (one level's
// carry is added by the chain kernel itself)
template <typename T>
cudaError_t fold(const Problem<T>& p, int d, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_levels == 1) return err;
  const int64_t items = p.m * d / 4;
  chain_attn_fold_kernel<T>
      <<<static_cast<unsigned>((items + FOLD_THREADS - 1) / FOLD_THREADS),
         FOLD_THREADS, 0, stream>>>(p, d);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_wgmma_d(const Problem<T>& p, cudaStream_t stream) {
  using C = bind_attn_wg::Cfg<D>;
  constexpr CUtensorMapDataType type = bind_attn_wg::Elem<T>::TMA;
  CUtensorMap tq, tk, tv;
  cudaError_t err = bind_gemm::make_map(
      &tq, type, p.q, p.m, D, p.q_stride ? p.n_levels : 1, p.q_stride,
      ROWS);
  if (err == cudaSuccess)
    err = bind_gemm::make_map(&tk, type, p.k, p.n, D,
                              p.k_stride ? p.n_levels : 1, p.k_stride,
                              C::BKV);
  if (err == cudaSuccess)
    err = bind_gemm::make_map(&tv, type, p.v, p.n, D,
                              p.v_stride ? p.n_levels : 1, p.v_stride,
                              C::BKV);
  if (err != cudaSuccess) return err;
  auto kern = chain_attn_wgmma_kernel<T, D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  kern<<<grid_of(p.m, p.n_levels, p.chunks), THREADS, C::SMEM, stream>>>(
      tq, tk, tv, p);
  return fold(p, D, stream);
}

template <int D>
cudaError_t launch_tf32_d(const Problem<float>& p, cudaStream_t stream) {
  using C = bind_attn_tf::Cfg<D>;
  auto kern = chain_attn_tf32_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  kern<<<grid_of(p.m, p.n_levels, p.chunks), THREADS, C::SMEM, stream>>>(p);
  return fold(p, D, stream);
}

// the tensor-core launch of p at head dim d (the route already chosen;
// p.per and p.mask are set here)
template <typename T>
cudaError_t launch(Problem<T> p, int d, cudaStream_t stream) {
  const int64_t tiles = (p.n + key_tile<T>(d) - 1) / key_tile<T>(d);
  if (!chunks_fit(tiles, p.chunks) || p.n_levels * p.chunks > 65535 ||
      p.m > 0x7fffffff || p.n > 0x7fffffff)
    return cudaErrorInvalidValue;
  p.per = (tiles + p.chunks - 1) / p.chunks;
  p.mask = bind_attn::Mask{false, false, 0};
  if constexpr (std::is_same_v<T, float>) {
    switch (d) {
      case 32: return launch_tf32_d<32>(p, stream);
      case 64: return launch_tf32_d<64>(p, stream);
      case 80: return launch_tf32_d<80>(p, stream);
      case 96: return launch_tf32_d<96>(p, stream);
      case 128: return launch_tf32_d<128>(p, stream);
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (d) {
      case 64: return launch_wgmma_d<T, 64>(p, stream);
      case 80: return launch_wgmma_d<T, 80>(p, stream);
      case 96: return launch_wgmma_d<T, 96>(p, stream);
      case 128: return launch_wgmma_d<T, 128>(p, stream);
      case 192: return launch_wgmma_d<T, 192>(p, stream);
      case 256: return launch_wgmma_d<T, 256>(p, stream);
      default: return cudaErrorInvalidValue;
    }
  }
}

}  // namespace bind_chain_tc
