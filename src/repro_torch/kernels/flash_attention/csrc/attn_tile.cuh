// The attention tile loop shared by the flash-attention kernel
// (csrc/flash_attention.cu) and the attn_step chain kernel
// (src/repro_torch/kernels/chain/csrc/chain.cu), so both sweep keys with the
// same online softmax and the same order of sums.
//
// One block of THREADS threads owns BQ query rows.  For every BKV-key tile it
//   1. stages the tile's keys, transposed, in shared memory and forms the
//      scores s = (q . k) * scale on a TM x TN register micro-tile per thread
//      (rows ty + LANES * i, keys tx + LANES * j; q stays staged, transposed,
//      for the whole sweep);
//   2. runs the reference's online softmax on them: masked keys give p = 0,
//      m_new = max(m, rowmax s), p = exp(s - m_new), corr = exp(m - m_new),
//      l = corr * l + sum p, acc = corr * acc + p v;
//   3. writes p to shared memory, stages the tile's values there in the keys'
//      place, and adds p v to the TM x (LANES * NJ) accumulator per thread.
// Row reductions are shuffles across the LANES threads of a row.  Products
// are one IEEE fused multiply-add each in the accumulator type (fp32 for f32
// and bf16 inputs, fp64 for f64), never TF32; exp is the accurate expf/exp.
//
// A masked key contributes exactly p = 0 (the reference computes exp(-1e30 -
// m_new), which is 0 unless no key of the row was visible yet; that garbage
// is wiped by corr = 0 at the row's first visible key, and survives only in
// a row that sees no key at all).  So a row's result does not depend on the
// tiling, and a row that sees no key gives zeros, as the oracle does.
//
// Shared memory, in accumulator elements, for head dims d (q, k) and dv (v):
// q^T d x (BQ + 1), the key/value tile max(d x (BKV + 1), BKV x 16 NJ), p
// BQ x (BKV + 1); the +1 columns keep transposed stores and column reads off
// one bank.

#pragma once

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "../../gemm/csrc/gemm_tile.cuh"

namespace bind_attn {

using bind_gemm::AccType;
using bind_gemm::from_acc;
using bind_gemm::mac;
using bind_gemm::to_acc;

constexpr int LANES = 16;               // row lanes x key lanes
constexpr int THREADS = LANES * LANES;  // 256
constexpr int WARPS = THREADS / 32;
constexpr int MAX_HEAD_DIM = 256;       // d and dv; NJ <= 16

// register micro-tile per thread: TM query rows x TN keys.  fp64 halves both
// so that d = dv = 256 still fits in shared memory.
template <typename Acc> struct Micro { static constexpr int TM = 4, TN = 4; };
template <> struct Micro<double> { static constexpr int TM = 2, TN = 2; };

template <typename Acc, int NJ> struct Tile {
  static constexpr int TM = Micro<Acc>::TM;
  static constexpr int TN = Micro<Acc>::TN;
  static constexpr int BQ = LANES * TM;   // query rows per block
  static constexpr int BKV = LANES * TN;  // keys per tile
  static constexpr int DVP = LANES * NJ;  // value columns, padded

  __host__ __device__ static size_t kv_elems(int d) {
    const size_t keys = static_cast<size_t>(d) * (BKV + 1);
    const size_t vals = static_cast<size_t>(BKV) * DVP;
    return keys > vals ? keys : vals;
  }
  __host__ __device__ static size_t smem_bytes(int d) {
    return sizeof(Acc) * (static_cast<size_t>(d) * (BQ + 1) + kv_elems(d) +
                          static_cast<size_t>(BQ) * (BKV + 1));
  }
};

// the reference's mask value: finite, not -inf
template <typename Acc> __device__ __forceinline__ Acc neg_big() {
  return Acc(-1e30);
}

// the scaled score s * scale.  ptxas may fuse a product that two uses share
// (here the row max and the exp argument s * scale - m) into an FMA where
// its register allocation favours it, which changes the exp argument's
// rounding.  double rounds the product on its own (__dmul_rn, never
// fused), so the f64 loop's bits do not depend on the kernel around it.
// float keeps the plain product: its bits rest on ptxas making the same
// choices in every kernel that runs the loop, which tools/ab_attn.py holds
// against another checkout.
__device__ __forceinline__ float scale_acc(float s, float scale) {
  return s * scale;
}
__device__ __forceinline__ double scale_acc(double s, double scale) {
  return __dmul_rn(s, scale);
}

__device__ __forceinline__ float exp_acc(float v) { return expf(v); }
__device__ __forceinline__ double exp_acc(double v) { return exp(v); }
__device__ __forceinline__ float max_acc(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double max_acc(double a, double b) {
  return fmax(a, b);
}

template <typename Acc> __device__ __forceinline__ Acc row_max(Acc v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off /= 2)
    v = max_acc(v, __shfl_xor_sync(0xffffffffu, v, off, LANES));
  return v;
}

template <typename Acc> __device__ __forceinline__ Acc row_sum(Acc v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off, LANES);
  return v;
}

// dst[k * (R + 1) + r] = src[(r0 + r) * d + k] for the R rows from r0 of a
// row-major (rows, d) matrix, zero past its last row.  Each warp reads rows
// along d (coalesced).
template <int R, typename T, typename Acc>
__device__ __forceinline__ void stage_transposed(const T* __restrict__ src,
                                                 int64_t rows, int d,
                                                 int64_t r0, Acc* dst) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < R; r += WARPS) {
    const int64_t gr = r0 + r;
    for (int k = lane; k < d; k += 32)
      dst[k * (R + 1) + r] = gr < rows ? to_acc(src[gr * d + k]) : Acc(0);
  }
}

// dst[c * DVP + j] = src[(k0 + c) * dv + j], zero past the last key or dv
template <int BKV, int DVP, typename T, typename Acc>
__device__ __forceinline__ void stage_values(const T* __restrict__ src,
                                             int64_t rows, int dv, int64_t k0,
                                             Acc* dst) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int c = warp; c < BKV; c += WARPS) {
    const int64_t gr = k0 + c;
    for (int j = lane; j < DVP; j += 32)
      dst[c * DVP + j] =
          (gr < rows && j < dv) ? to_acc(src[gr * dv + j]) : Acc(0);
  }
}

// Which keys a query row sees.  Positions are row and key indices from 0
// (top-left aligned, also when the row and key counts differ).
struct Mask {
  bool causal;      // key <= row
  bool windowed;    // row - key < window
  int64_t window;
};

// The online-softmax state of a thread's rows.
template <typename Acc, int NJ> struct Rows {
  static constexpr int TM = Tile<Acc, NJ>::TM;
  Acc acc[TM][NJ];
  Acc m[TM];
  Acc l[TM];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      m[i] = neg_big<Acc>();
      l[i] = Acc(0);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = Acc(0);
    }
  }
};

// Sweep key tiles [t0, t1) of K (n, d) and V (n, dv) for the query rows from
// q0, whose q^T is staged in Qt.  All THREADS threads of the block must call
// it (it synchronises the block); it begins with a barrier, so Qt may be
// written just before the call.
template <bool MASKED, int NJ, typename T, typename Acc>
__device__ void sweep(const T* __restrict__ K, const T* __restrict__ V,
                      int64_t n, int d, int dv, Acc scale, int64_t q0,
                      int64_t t0, int64_t t1, Mask mask, const Acc* Qt,
                      Acc* KV, Acc* P, Rows<Acc, NJ>& st) {
  using Sh = Tile<Acc, NJ>;
  constexpr int TM = Sh::TM, TN = Sh::TN, BQ = Sh::BQ, BKV = Sh::BKV,
                DVP = Sh::DVP;
  const int tx = threadIdx.x % LANES;
  const int ty = threadIdx.x / LANES;

  for (int64_t t = t0; t < t1; ++t) {
    const int64_t k0 = t * BKV;
    __syncthreads();  // the last tile's values (and Qt's writers) are done
    stage_transposed<BKV>(K, n, d, k0, KV);
    __syncthreads();

    Acc s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = Acc(0);
#pragma unroll 4
    for (int k = 0; k < d; ++k) {
      Acc a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Qt[k * (BQ + 1) + ty + LANES * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = KV[k * (BKV + 1) + tx + LANES * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = mac(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t row = q0 + ty + LANES * i;
      bool seen[TN];
      Acc top = neg_big<Acc>();
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int64_t key = k0 + tx + LANES * j;
        bool vis = key < n;
        if (MASKED) {
          if (mask.causal) vis = vis && row >= key;
          if (mask.windowed) vis = vis && row - key < mask.window;
        }
        seen[j] = vis;
        s[i][j] = scale_acc(s[i][j], scale);
        if (vis) top = max_acc(top, s[i][j]);
      }
      const Acc m_new = max_acc(st.m[i], row_max(top));
      Acc sum = Acc(0);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = seen[j] ? exp_acc(s[i][j] - m_new) : Acc(0);
        sum += s[i][j];
      }
      const Acc corr = exp_acc(st.m[i] - m_new);
      st.l[i] = corr * st.l[i] + row_sum(sum);
      st.m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) st.acc[i][jj] *= corr;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        P[(ty + LANES * i) * (BKV + 1) + tx + LANES * j] = s[i][j];
    }
    __syncthreads();  // keys read, p written
    stage_values<BKV, DVP>(V, n, dv, k0, KV);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      Acc a[TM], b[NJ];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = P[(ty + LANES * i) * (BKV + 1) + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) b[jj] = KV[c * DVP + tx + LANES * jj];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          st.acc[i][jj] = mac(a[i], b[jj], st.acc[i][jj]);
    }
  }
}

// Calls launch(std::integral_constant<int, NJ>()) with the value-column
// register blocks a kernel is instantiated for: the smallest of 1, 2, 4, 8,
// 16 that covers dv.  cudaErrorInvalidValue when dv > MAX_HEAD_DIM.
template <typename Launch>
cudaError_t with_value_blocks(int dv, Launch&& launch) {
  const int need = (dv + LANES - 1) / LANES;
  if (need <= 1) return launch(std::integral_constant<int, 1>());
  if (need <= 2) return launch(std::integral_constant<int, 2>());
  if (need <= 4) return launch(std::integral_constant<int, 4>());
  if (need <= 8) return launch(std::integral_constant<int, 8>());
  if (need <= 16) return launch(std::integral_constant<int, 16>());
  return cudaErrorInvalidValue;
}

}  // namespace bind_attn
