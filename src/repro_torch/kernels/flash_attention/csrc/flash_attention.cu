// Flash attention (prefill) for Hopper (sm_90a): out = softmax(q k^T * scale
// + mask) v per query head, one launch, the scores never written to memory.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:100
// flash_attention_pallas (body _attn_kernel :33): a (batch, q head, q block,
// kv block) grid with the kv axis innermost and sequential, carrying the
// online-softmax state (m, l, acc in f32) in VMEM scratch across it.  Here the
// blocks of a grid run in parallel in no order, so the sequential kv axis
// becomes a loop inside the block, and the state lives in registers.
//
// Each call takes one of six routes, a pure function of the dtype, the
// head dim and the operands' alignment (route_of below; kernels/flash_
// attention/ops.py route() is the same rule in Python, and
// bind_flash_attention_route answers it for any operands):
//
//   F32_3XTF32  float32 with d in {32, 64, 80, 96, 128, 256}
//               (bind_attn_tf::tf32_head_dim) and q, k, v, out 16-byte
//               aligned: the tensor cores in 3xTF32 (attn_tf32.cuh; d 256
//               attn_tf32_wide.cuh);
//   F32_SIMT    any other float32 (other head dims, misaligned views):
//               the CUDA-core loop (attn_tile.cuh), any d <= 256;
//   BF16_WGMMA  bfloat16 with d in {64, 80, 96, 128, 192, 256}
//               (bind_attn_wg::wgmma_head_dim) and q, k, v, out 16-byte
//               aligned: the tensor cores, wgmma fed by TMA
//               (attn_wgmma.cuh);
//   BF16_SIMT   any other bfloat16 (other head dims, views at an odd
//               offset): the CUDA-core loop, fp32 inside;
//   F16_WGMMA   float16 where BF16_WGMMA takes bfloat16: the same
//               tensor-core loop instantiated for f16 (attn_wgmma.cuh's
//               Elem<__half>);
//   F16_SIMT    any other float16: the CUDA-core loop, fp32 inside, as
//               bf16_simt.
//
// The CUDA-core loop (flash_attention_kernel):
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
//   Head dims up to 256 of any size: the value columns are padded to the
//   register blocks of the instantiation (16, 32, 64, 128 or 256) and
//   masked.  At d = 256 a block takes 146 KB of shared memory, above the 48
//   KB default, so the launcher raises the limit with cudaFuncSetAttribute.
//   What bounds it on an H100: operations.  Causal prefill at S = 8192 does
//   4 d Hq visible-pairs FLOP against a few hundred MB of q, k, v and out,
//   far above the ridge point; the loop runs on the CUDA cores in f32 (67
//   TFLOP/s peak) and reads shared memory for every pair of operands, as
//   the GEMM's f32 route does.  Plain TF32 would miss the f32 tolerance
//   (2e-5); the float32 calls it still takes run bit for bit the kernel it
//   was.
//
// The 3xTF32 loop (flash_attention_tf32_kernel, attn_tf32.cuh): two
// warpgroups of 64 query rows, S = Q K^T and O += P V each as three TF32
// wgmma products (hi.hi + hi.lo + lo.hi) accumulated in fp32, the operands
// split into hi and lo (and V transposed) on their way into shared memory,
// the online softmax in fp32 with the accurate exp2f.  Bound: three TF32
// products at 495 TFLOP/s; the header says what its design does about
// shared memory, layouts and registers.  At d 256 (flash_attention_tf32_
// kernel's other block, attn_tf32_wide.cuh) a block is 64 query rows, each
// warpgroup owning half of O's columns, S split over d between them and
// summed once through shared memory.
//
// The tensor-core loop (flash_attention_wgmma_kernel, attn_wgmma.cuh, for
// bf16 and f16 alike): two
// warpgroups of 64 query rows each, sharing K and V tiles that TMA brings
// into a ring of shared memory, S = Q K^T and O += P V on wgmma, the
// online softmax on the accumulator registers, P kept in registers as
// wgmma's A operand.  Bound: the 16-bit tensor cores (989 TFLOP/s in bf16
// and f16) and, next to them, the exp2 of every score; the header says how
// the design splits the two, and why rounding P to bf16 stays within the
// reference's bf16 tolerance of 3e-2 (to f16 within 2^-11 of each p).  The
// same causal and windowed tile bounds, from its own 128-row query tiles
// and 128-key (64 at d > 128) key tiles.
//
// C interface (bound with ctypes): device pointers, sizes and a cudaStream_t;
// each entry point launches on that stream without synchronising and returns
// cudaGetLastError() (0 on success).  bind_flash_attention_route says which
// route a call takes.  bind_flash_attention_{bf16,f16,f32}_lse are the
// entry points that also hand the backward each row's log-sum-exp
// (attn_wgmma.cuh, attn_tf32.cuh): the training forward calls them, and
// only on the BF16_WGMMA, F16_WGMMA and F32_3XTF32 routes.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "attn_tf32.cuh"
#include "attn_tf32_wide.cuh"
#include "attn_tile.cuh"
#include "attn_wgmma.cuh"

namespace {

using namespace bind_attn;

enum Route : int {
  F32_SIMT = 0, BF16_SIMT = 1, BF16_WGMMA = 2, F32_3XTF32 = 3, F16_SIMT = 4,
  F16_WGMMA = 5
};
// the element types, numbered as kernel.py DTYPE_CODES numbers them
enum DType : int { F32 = 0, BF16 = 1, F16 = 2 };

template <typename T> constexpr DType dtype_of();
template <> constexpr DType dtype_of<float>() { return F32; }
template <> constexpr DType dtype_of<__nv_bfloat16>() { return BF16; }
template <> constexpr DType dtype_of<__half>() { return F16; }

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

inline Route route_of(DType dtype, int64_t d, const void* q, const void* k,
                      const void* v, const void* out) {
  const bool aligned =
      aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
  switch (dtype) {
    case F32:
      return bind_attn_tf::tf32_head_dim(d) && aligned ? F32_3XTF32
                                                       : F32_SIMT;
    case BF16:
      return bind_attn_wg::wgmma_head_dim(d) && aligned ? BF16_WGMMA
                                                        : BF16_SIMT;
    default:
      return bind_attn_wg::wgmma_head_dim(d) && aligned ? F16_WGMMA
                                                        : F16_SIMT;
  }
}

// the 3xTF32 block of head dim D: attn_tf32.cuh's up to d 128,
// attn_tf32_wide.cuh's at d 256 (both 256 threads)
template <int D, bool WIDE = (D > 128)> struct Tf32Block {
  static constexpr int BQ = bind_attn_tf::BQ;
  static constexpr size_t SMEM = bind_attn_tf::Cfg<D>::SMEM;
};
template <int D> struct Tf32Block<D, true> {
  static constexpr int BQ = bind_attn_tfw::BQ;
  static constexpr size_t SMEM = bind_attn_tfw::Cfg<D>::SMEM;
};
static_assert(bind_attn_tf::THREADS == bind_attn_tfw::THREADS, "threads");

// LSE: the training forward, which also writes each row's log-sum-exp
template <int D, bool LSE>
__global__ void __launch_bounds__(bind_attn_tf::THREADS, 1)
flash_attention_tf32_kernel(const bind_attn_tf::Shape sh,
                            float* __restrict__ lse) {
  extern __shared__ __align__(1024) unsigned char tf_smem[];
  if constexpr (D > 128)
    bind_attn_tfw::attention_block<D, LSE>(sh, tf_smem, lse);
  else
    bind_attn_tf::attention_block<D, LSE>(sh, tf_smem, lse);
}

template <int D, bool LSE>
cudaError_t launch_tf32_dl(const void* q, const void* k, const void* v,
                           void* out, float* lse, int64_t batch, int64_t hq,
                           int64_t hkv, int64_t sq, int64_t skv, float scale,
                           Mask mask, cudaStream_t stream) {
  using C = Tf32Block<D>;
  const int64_t tiles = (sq + C::BQ - 1) / C::BQ;
  if (tiles > 65535 || batch * hq > 0x7fffffff) return cudaErrorInvalidValue;
  auto kern = flash_attention_tf32_kernel<D, LSE>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * 1.4426950408889634f;   // scale log2(e)
  const bind_attn_tf::Shape sh{static_cast<const float*>(q),
                               static_cast<const float*>(k),
                               static_cast<const float*>(v),
                               static_cast<float*>(out),
                               hq, hkv, sq, skv, scale_log2, mask};
  const dim3 grid(static_cast<unsigned>(batch * hq),
                  static_cast<unsigned>(tiles));
  kern<<<grid, bind_attn_tf::THREADS, C::SMEM, stream>>>(sh, lse);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tf32_d(const void* q, const void* k, const void* v,
                          void* out, float* lse, int64_t batch, int64_t hq,
                          int64_t hkv, int64_t sq, int64_t skv, float scale,
                          Mask mask, cudaStream_t stream) {
  if (lse != nullptr)
    return launch_tf32_dl<D, true>(q, k, v, out, lse, batch, hq, hkv, sq,
                                   skv, scale, mask, stream);
  return launch_tf32_dl<D, false>(q, k, v, out, lse, batch, hq, hkv, sq, skv,
                                  scale, mask, stream);
}

cudaError_t launch_tf32(const void* q, const void* k, const void* v,
                        void* out, float* lse, int64_t batch, int64_t hq,
                        int64_t hkv, int64_t sq, int64_t skv, int d,
                        float scale, Mask mask, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_tf32_d<32>(q, k, v, out, lse, batch, hq, hkv, sq,
                                      skv, scale, mask, stream);
    case 64: return launch_tf32_d<64>(q, k, v, out, lse, batch, hq, hkv, sq,
                                      skv, scale, mask, stream);
    case 80: return launch_tf32_d<80>(q, k, v, out, lse, batch, hq, hkv, sq,
                                      skv, scale, mask, stream);
    case 96: return launch_tf32_d<96>(q, k, v, out, lse, batch, hq, hkv, sq,
                                      skv, scale, mask, stream);
    case 128: return launch_tf32_d<128>(q, k, v, out, lse, batch, hq, hkv,
                                        sq, skv, scale, mask, stream);
    case 256: return launch_tf32_d<256>(q, k, v, out, lse, batch, hq, hkv,
                                        sq, skv, scale, mask, stream);
    default: return cudaErrorInvalidValue;
  }
}

// T: __nv_bfloat16 (BF16_WGMMA) or __half (F16_WGMMA)
template <int D, typename T>
__global__ void __launch_bounds__(bind_attn_wg::THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             T* __restrict__ O, float* __restrict__ LSE,
                             const bind_attn_wg::Shape sh) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  bind_attn_wg::attention_block<T, D>(&tq, &tk, &tv, O, LSE, sh, wg_smem);
}

template <typename T, int D>
cudaError_t launch_wgmma_d(const void* q, const void* k, const void* v,
                           void* out, float* lse, int64_t batch, int64_t hq,
                           int64_t hkv, int64_t sq, int64_t skv, float scale,
                           Mask mask, cudaStream_t stream) {
  using C = bind_attn_wg::Cfg<D>;
  const int64_t tiles = (sq + bind_attn_wg::BQ - 1) / bind_attn_wg::BQ;
  // TMA coordinates are 32-bit; the query tiles are the grid's y
  if (tiles > 65535 || batch * hq > 0x7fffffff || sq > 0x7fffffff ||
      skv > 0x7fffffff)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t err = bind_attn_wg::make_maps<T, D>(&tq, &tk, &tv, q, k, v,
                                                  batch, hq, hkv, sq, skv);
  if (err != cudaSuccess) return err;
  auto kern = flash_attention_wgmma_kernel<D, T>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  const bind_attn_wg::Shape sh{hq, hkv, sq, skv,
                               scale * 1.4426950408889634f, mask};
  const dim3 grid(static_cast<unsigned>(batch * hq),
                  static_cast<unsigned>(tiles));
  kern<<<grid, bind_attn_wg::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<T*>(out), lse, sh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, float* lse, int64_t batch, int64_t hq,
                         int64_t hkv, int64_t sq, int64_t skv, int d,
                         float scale, Mask mask, cudaStream_t stream) {
  switch (d) {
    case 64: return launch_wgmma_d<T, 64>(q, k, v, out, lse, batch, hq, hkv,
                                          sq, skv, scale, mask, stream);
    case 80: return launch_wgmma_d<T, 80>(q, k, v, out, lse, batch, hq, hkv,
                                          sq, skv, scale, mask, stream);
    case 96: return launch_wgmma_d<T, 96>(q, k, v, out, lse, batch, hq, hkv,
                                          sq, skv, scale, mask, stream);
    case 128: return launch_wgmma_d<T, 128>(q, k, v, out, lse, batch, hq,
                                            hkv, sq, skv, scale, mask,
                                            stream);
    case 192: return launch_wgmma_d<T, 192>(q, k, v, out, lse, batch, hq,
                                            hkv, sq, skv, scale, mask,
                                            stream);
    case 256: return launch_wgmma_d<T, 256>(q, k, v, out, lse, batch, hq,
                                            hkv, sq, skv, scale, mask,
                                            stream);
    default: return cudaErrorInvalidValue;
  }
}

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

// lse: null, or a (B, Hq, Sq) float32 buffer for each row's log-sum-exp,
// which only the BF16_WGMMA, F16_WGMMA and F32_3XTF32 routes write (any
// other route refuses one)
template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int64_t batch, int64_t hq, int64_t hkv, int64_t sq,
           int64_t skv, int64_t d, double scale, int causal, int windowed,
           int64_t window, void* stream) {
  if (batch <= 0 || hq <= 0 || sq <= 0 || d <= 0)
    return static_cast<int>(cudaGetLastError());
  if (hkv <= 0 || hq % hkv != 0 || d > MAX_HEAD_DIM || hq > 65535 ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Mask mask{causal != 0, windowed != 0, window};
  const float s = static_cast<float>(scale);
  const int dd = static_cast<int>(d);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Route route = route_of(dtype_of<T>(), d, q, k, v, out);
  if (lse != nullptr && route != BF16_WGMMA && route != F16_WGMMA &&
      route != F32_3XTF32)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (!std::is_same_v<T, float>) {
    if (route == BF16_WGMMA || route == F16_WGMMA)
      return static_cast<int>(launch_wgmma<T>(q, k, v, out, lse, batch, hq,
                                              hkv, sq, skv, dd, s, mask, st));
  }
  if (route == F32_3XTF32)
    return static_cast<int>(launch_tf32(q, k, v, out, lse, batch, hq, hkv,
                                        sq, skv, dd, s, mask, st));
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
  return launch<float>(q, k, v, out, nullptr, batch, hq, hkv, sq, skv, d,
                       scale, causal, windowed, window, stream);
}

int bind_flash_attention_bf16(const void* q, const void* k, const void* v,
                              void* out, int64_t batch, int64_t hq,
                              int64_t hkv, int64_t sq, int64_t skv, int64_t d,
                              double scale, int causal, int windowed,
                              int64_t window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, nullptr, batch, hq, hkv, sq,
                               skv, d, scale, causal, windowed, window,
                               stream);
}

// bind_flash_attention_bf16 that also stores each row's log-sum-exp into
// lse, a (B, Hq, Sq) float32 buffer: only on the BF16_WGMMA route (any
// other operands give cudaErrorInvalidValue and launch nothing)
int bind_flash_attention_bf16_lse(const void* q, const void* k,
                                  const void* v, void* out, void* lse,
                                  int64_t batch, int64_t hq, int64_t hkv,
                                  int64_t sq, int64_t skv, int64_t d,
                                  double scale, int causal, int windowed,
                                  int64_t window, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<__nv_bfloat16>(q, k, v, out, static_cast<float*>(lse), batch,
                               hq, hkv, sq, skv, d, scale, causal, windowed,
                               window, stream);
}

// bind_flash_attention_f32 that also stores each row's log-sum-exp into
// lse, a (B, Hq, Sq) float32 buffer: only on the F32_3XTF32 route (any
// other operands give cudaErrorInvalidValue and launch nothing)
int bind_flash_attention_f32_lse(const void* q, const void* k,
                                 const void* v, void* out, void* lse,
                                 int64_t batch, int64_t hq, int64_t hkv,
                                 int64_t sq, int64_t skv, int64_t d,
                                 double scale, int causal, int windowed,
                                 int64_t window, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(q, k, v, out, static_cast<float*>(lse), batch, hq,
                       hkv, sq, skv, d, scale, causal, windowed, window,
                       stream);
}

int bind_flash_attention_f16(const void* q, const void* k, const void* v,
                             void* out, int64_t batch, int64_t hq,
                             int64_t hkv, int64_t sq, int64_t skv, int64_t d,
                             double scale, int causal, int windowed,
                             int64_t window, void* stream) {
  return launch<__half>(q, k, v, out, nullptr, batch, hq, hkv, sq, skv, d,
                        scale, causal, windowed, window, stream);
}

// bind_flash_attention_f16 that also stores each row's log-sum-exp into
// lse, a (B, Hq, Sq) float32 buffer: only on the F16_WGMMA route (any
// other operands give cudaErrorInvalidValue and launch nothing)
int bind_flash_attention_f16_lse(const void* q, const void* k,
                                 const void* v, void* out, void* lse,
                                 int64_t batch, int64_t hq, int64_t hkv,
                                 int64_t sq, int64_t skv, int64_t d,
                                 double scale, int causal, int windowed,
                                 int64_t window, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<__half>(q, k, v, out, static_cast<float*>(lse), batch, hq,
                        hkv, sq, skv, d, scale, causal, windowed, window,
                        stream);
}

// The route (enum Route) a call of element type dtype (F32 0, BF16 1, F16
// 2) with head dim d on these operands takes; -1 for another type.
int bind_flash_attention_route(int dtype, const void* q, const void* k,
                               const void* v, const void* out, int64_t d) {
  if (dtype < F32 || dtype > F16) return -1;
  return route_of(static_cast<DType>(dtype), d, q, k, v, out);
}

}  // extern "C"
