// Flash attention (prefill) for Hopper (sm_90a): out = softmax(q k^T * scale
// + mask) v per query head, one launch, the scores never written to memory.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:100
// flash_attention_pallas (body _attn_kernel :33): a (batch, q head, q block,
// kv block) grid with the kv axis innermost and sequential, carrying the
// online-softmax state (m, l, acc in f32) in VMEM scratch across it.  Here the
// blocks of a grid run in parallel in no order, so the sequential kv axis
// becomes a loop inside the block, and the state lives in registers:
//   * one block of 256 threads per (query tile of 64 rows, q head, batch);
//     GQA reads kv head h / (Hq / Hkv), as the reference's index map does;
//   * the block sweeps the key tiles the mask leaves (attn_tile.cuh): under
//     causal masking it stops at the tile holding its last row's position,
//     under a window it starts at the tile holding its first row's oldest
//     visible key.  These bounds come from the kernel's own 64-key tiles;
//     the wrapper's bq / bkv only pad, and the result does not depend on
//     either tiling;
//   * the reference's arithmetic: s = (q . k) * scale, masked to -1e30,
//     m_new = max(m, rowmax s), p = exp(s - m_new), corr = exp(m - m_new),
//     l = corr l + sum p, acc = corr acc + p v, out = acc / (l == 0 ? 1 : l);
//     f32 inside for f32 and bf16 inputs (IEEE FMA, never TF32), the output
//     in q's dtype; a row that sees no key gives zeros.
// Head dims up to 256 of any size: the value columns are padded to the
// register blocks of the instantiation (16, 32, 64, 128 or 256) and masked.
// At d = 256 a block takes 146 KB of shared memory, above the 48 KB default,
// so the launcher raises the limit with cudaFuncSetAttribute.
//
// What bounds it on an H100: operations.  Causal prefill at S = 8192 does
// 4 d Hq visible-pairs FLOP against a few hundred MB of q, k, v and out, far
// above the ridge point.  This kernel runs on the CUDA cores in f32 (67
// TFLOP/s peak) and reads shared memory for every pair of operands, as the
// GEMM does; tensor cores (wgmma on bf16 tiles fed by TMA) are left for a
// later change.
//
// C interface (bound with ctypes): device pointers, sizes and a cudaStream_t;
// each entry point launches on that stream without synchronising and returns
// cudaGetLastError() (0 on success).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tile.cuh"

namespace {

using namespace bind_attn;

template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                       const T* __restrict__ V, T* __restrict__ O,
                       int64_t hq, int64_t hkv, int64_t sq, int64_t skv,
                       int d, float scale, Mask mask) {
  using Acc = float;
  using Sh = Tile<Acc, NJ>;
  constexpr int TM = Sh::TM, BQ = Sh::BQ, BKV = Sh::BKV;
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* Qt = reinterpret_cast<Acc*>(smem);
  Acc* KV = Qt + static_cast<size_t>(d) * (BQ + 1);
  Acc* P = KV + Sh::kv_elems(d);

  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * BQ;
  const int64_t h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t hk = h / (hq / hkv);
  const T* q = Q + (b * hq + h) * sq * d;
  const T* k = K + (b * hkv + hk) * skv * d;
  const T* v = V + (b * hkv + hk) * skv * d;
  T* o = O + (b * hq + h) * sq * d;

  // the key tiles the mask leaves for rows [q0, q0 + BQ)
  int64_t t0 = 0;
  int64_t t1 = (skv + BKV - 1) / BKV;
  if (mask.causal) {
    const int64_t last = (q0 + BQ - 1) / BKV + 1;
    t1 = last < t1 ? last : t1;
  }
  if (mask.windowed) {
    const int64_t oldest = q0 - mask.window + 1;   // first row's oldest key
    if (oldest > 0) t0 = oldest / BKV;
  }

  stage_transposed<BQ>(q, sq, d, q0, Qt);
  Rows<Acc, NJ> st;
  st.reset();
  sweep<true, NJ>(k, v, skv, d, d, scale, q0, t0, t1, mask, Qt, KV, P, st);

  const int tx = threadIdx.x % LANES;
  const int ty = threadIdx.x / LANES;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t row = q0 + ty + LANES * i;
    if (row >= sq) continue;
    const Acc safe = st.l[i] == Acc(0) ? Acc(1) : st.l[i];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = tx + LANES * jj;
      if (col < d) o[row * d + col] = from_acc<T>(st.acc[i][jj] / safe);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch_nj(const void* q, const void* k, const void* v, void* out,
                      int64_t batch, int64_t hq, int64_t hkv, int64_t sq,
                      int64_t skv, int d, float scale, Mask mask,
                      cudaStream_t stream) {
  using Sh = Tile<float, NJ>;
  const size_t smem = Sh::smem_bytes(d);
  auto kern = flash_attention_kernel<T, NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((sq + Sh::BQ - 1) / Sh::BQ),
                  static_cast<unsigned>(hq), static_cast<unsigned>(batch));
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, sq, skv, d,
      scale, mask);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           int64_t batch, int64_t hq, int64_t hkv, int64_t sq, int64_t skv,
           int64_t d, double scale, int causal, int windowed, int64_t window,
           void* stream) {
  if (batch <= 0 || hq <= 0 || sq <= 0 || d <= 0)
    return static_cast<int>(cudaGetLastError());
  if (hkv <= 0 || hq % hkv != 0 || d > MAX_HEAD_DIM || hq > 65535 ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Mask mask{causal != 0, windowed != 0, window};
  const float s = static_cast<float>(scale);
  const int dd = static_cast<int>(d);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_value_blocks(dd, [&](auto nj) {
    return launch_nj<T, decltype(nj)::value>(q, k, v, out, batch, hq, hkv,
                                             sq, skv, dd, s, mask, st);
  }));
}

}  // namespace

extern "C" {

int bind_flash_attention_f32(const void* q, const void* k, const void* v,
                             void* out, int64_t batch, int64_t hq,
                             int64_t hkv, int64_t sq, int64_t skv, int64_t d,
                             double scale, int causal, int windowed,
                             int64_t window, void* stream) {
  return launch<float>(q, k, v, out, batch, hq, hkv, sq, skv, d, scale,
                       causal, windowed, window, stream);
}

int bind_flash_attention_bf16(const void* q, const void* k, const void* v,
                              void* out, int64_t batch, int64_t hq,
                              int64_t hkv, int64_t sq, int64_t skv, int64_t d,
                              double scale, int causal, int windowed,
                              int64_t window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, batch, hq, hkv, sq, skv, d,
                               scale, causal, windowed, window, stream);
}

}  // extern "C"
