// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of
// out = softmax(q k^T * scale + mask) v, from q, k, v, out and dout, in two
// launches, the scores never written to memory.
//
// Replaces no TPU kernel: the reference takes attention's gradient from
// XLA's autodiff of its oracle (src/repro/kernels/flash_attention/ref.py
// attention, which src/repro/models/layers.py:168-173 calls under
// jax.value_and_grad); none of its pallas_call sites has a custom_vjp.  The
// port's training forward runs the flash-attention kernel
// (csrc/flash_attention.cu), so its gradient needs a kernel of its own;
// this file is separate so that the forward's build and bits stay as they
// were.
//
// Algorithm: FlashAttention-2's backward, without atomics.
//   1. dq kernel, one block of 256 threads per (64-row query tile, query
//      head, batch).  A first sweep over the key tiles the mask leaves
//      recomputes each row's log-sum-exp of the scaled, masked scores (lse =
//      m + log l; +inf for a row that sees no key), and delta = sum_c
//      dout_c out_c (FlashAttention's identity sum_j p_j dp_j = dout . out);
//      both go to a (B, Hq, Sq) float32 scratch pair.  A second sweep forms,
//      per key tile, p = exp(s - lse), dp = dout v^T, ds = p (dp - delta),
//      and adds ds k to dq in registers; dq * scale is written once.
//   2. dk/dv kernel, one block per (key tile, kv head, batch).  For every
//      query head of the kv head's group and every query tile that sees the
//      key tile it forms p^T and ds^T as in 1 (lse and delta read back) and
//      adds p^T dout to dv and ds^T q to dk in registers; dk * scale and dv
//      are written once.  The group's heads are a loop inside the block, so
//      GQA needs no atomics, every sum has one order, and the result is
//      deterministic (RecurrentGemma-9B has 16 query heads over one).
// Masks: a tile pair that no (row, key) of it sees is skipped in both
// kernels (causal: keys past a query tile's last row; window: keys older
// than its first row's window, and the mirror bounds for a key tile), so
// causal attention with a window is a band.  Inside a tile every (row, key)
// is tested; a row that sees no key has p = 0 everywhere, so its dq is 0
// and it adds nothing to dk or dv (the port's rule for such rows).  Rows and
// keys past Sq / Skv are zero-filled on the way into shared memory and
// masked.
//
// Arithmetic: float32 inside for every input type (f32, bf16, f16), IEEE
// fused multiply-adds (never TF32), the accurate expf / logf; each gradient
// is rounded to the input type once, at the end.  delta comes from the
// forward's output as it was stored, so in bf16 it carries that output's
// rounding; the plain version (ref.py attention_grad) forms sum_j p dp in
// float32, as autograd through the oracle does.
//
// Tiles: 64 query rows; 64 keys up to d = 128, 32 keys above (d = 256:
// RecurrentGemma-9B), so that the staged operands fit in shared memory:
// q, dout (64 x d each), k, v (keys x d each) and the score tiles in
// float32, rows padded to an odd stride so that column reads fall on
// distinct banks; 206 KB (dq) and 215 KB (dk/dv) at d = 256, above the 48
// KB default, raised with cudaFuncSetAttribute.  Thread (ty, tx) of the
// 16 x 16 owns score rows ty + 16 a and columns tx + 16 b, and output
// columns tx + 16 u of its rows, so every product is a register micro-tile
// of fused multiply-adds fed by shared-memory loads.
//
// What bounds it on an H100: operations.  Per head and visible (row, key)
// pair the gradient needs about 10 d FLOP (s, dp, dq, dk, dv: five products
// of 2 d); the CUDA-core kernels above do 16 d (they recompute s in both
// kernels and dp in both), in f32, at one block of 8 warps an SM, against
// the card's 67 TFLOP/s outside the tensor cores (989 in bf16 and f16 on
// them).  They are the f32_simt, bf16_simt and f16_simt routes.  The
// bf16_wgmma and f16_wgmma routes are on the tensor cores: wgmma fed by
// TMA, with the log-sum-exp the forward saved (attn_bwd_wgmma.cuh, one set
// of kernels for both types, whose header gives its design, its bound and
// its tolerance); so is the f32_3xtf32 route, each product three TF32
// wgmma (attn_bwd_tf32.cuh, the same).
//
// Routes (route_of below; kernels/flash_attention/ops.py bwd_route is the
// same rule in Python, and bind_flash_attention_bwd_route answers it for
// any operands): BF16_WGMMA for bfloat16 and F16_WGMMA for float16 with d
// in {64, 80, 96, 128, 192, 256} (bind_attn_wg::wgmma_head_dim, the
// forward's set), F32_3XTF32 for
// float32 with d in {32, 64, 80, 96, 128, 256} (bind_attn_tf::
// tf32_head_dim, the forward's set; d 256 on the blocks of
// attn_bwd_tf32_wide.cuh), each with q, k, v, out, dout and the saved
// log-sum-exp 16-byte aligned and a saved log-sum-exp; otherwise the
// CUDA-core route of the element type, which sweeps the keys for the
// log-sum-exp itself.
//
// C interface (bound with ctypes): device pointers, sizes and a
// cudaStream_t; each entry point launches on that stream without
// synchronising and returns cudaGetLastError() (0 on success).
// bind_flash_attention_bwd_{f32,bf16,f16} run the CUDA-core routes, with
// lse a scratch they write; bind_flash_attention_bwd_bf16_lse runs the
// BF16_WGMMA route and bind_flash_attention_bwd_f16_lse the F16_WGMMA
// route, each with lse the forward's and a head-group count, and
// bind_flash_attention_bwd_f32_lse the F32_3XTF32 route, with lse the
// forward's.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "attn_bwd_tf32.cuh"
#include "attn_bwd_wgmma.cuh"

namespace {

constexpr int LANES = 16;              // columns x rows of the thread grid
constexpr int THREADS = LANES * LANES; // 256
constexpr int BQ = 64;                 // query rows per tile
constexpr int RQ = BQ / LANES;         // query rows (or columns) per thread
constexpr int MAX_HEAD_DIM = 256;

// the routes, in the order of kernels/flash_attention/ops.py BWD_ROUTES
enum Route : int {
  F32_SIMT = 0, BF16_SIMT = 1, F16_SIMT = 2, BF16_WGMMA = 3, F32_3XTF32 = 4,
  F16_WGMMA = 5
};
// the element types, numbered as kernel.py DTYPE_CODES numbers them
enum DType : int { F32 = 0, BF16 = 1, F16 = 2 };

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the route of a backward of element type dtype at head dim d on these
// operands (lse: the forward's log-sum-exp, or null); -1 for another type
// or a head dim the kernels do not take
inline int route_of(int dtype, int64_t d, const void* q, const void* k,
                    const void* v, const void* out, const void* dout,
                    const void* lse) {
  if (dtype < F32 || dtype > F16 || d <= 0 || d > MAX_HEAD_DIM) return -1;
  const bool tensor_cores = lse != nullptr && aligned16(q) && aligned16(k) &&
                            aligned16(v) && aligned16(out) &&
                            aligned16(dout) && aligned16(lse);
  if (dtype == BF16 && bind_attn_wg::wgmma_head_dim(d) && tensor_cores)
    return BF16_WGMMA;
  if (dtype == F16 && bind_attn_wg::wgmma_head_dim(d) && tensor_cores)
    return F16_WGMMA;
  if (dtype == F32 && bind_attn_tf::tf32_head_dim(d) && tensor_cores)
    return F32_3XTF32;
  return dtype == F32 ? F32_SIMT : dtype == BF16 ? BF16_SIMT : F16_SIMT;
}

struct Mask {
  bool causal;      // key <= row
  bool windowed;    // row - key < window
  int64_t window;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ bool seen(const Mask& m, int64_t row, int64_t key,
                                     int64_t sq, int64_t skv) {
  if (row >= sq || key >= skv) return false;
  if (m.causal && key > row) return false;
  if (m.windowed && row - key >= m.window) return false;
  return true;
}

__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off, LANES));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off, LANES);
  return v;
}

// dst[r * LD + c] = src[(r0 + r) * d + c] in float32, for r < R and c < d;
// rows from `rows` on are zero.  Neighbouring threads read neighbouring
// elements.
template <typename T, int R, int LD>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          int64_t r0, int64_t rows, int d) {
  for (int e = threadIdx.x; e < R * d; e += THREADS) {
    const int r = e / d;
    const int c = e - r * d;
    const int64_t row = r0 + r;
    dst[r * LD + c] = row < rows ? to_f(src[row * d + c]) : 0.f;
  }
}

// out[a][b] = sum_{c < d} A[(ty + 16 a) LD + c] B[(tx + 16 b) LD + c]: a
// tile of row-by-row products of two row-major staged operands.
template <int RA, int RB, int LD>
__device__ __forceinline__ void nt(float (&out)[RA][RB], const float* A,
                                   const float* B, int d) {
  const int tx = threadIdx.x % LANES;
  const int ty = threadIdx.x / LANES;
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < RB; ++b) out[a][b] = 0.f;
#pragma unroll 4
  for (int c = 0; c < d; ++c) {
    float av[RA], bv[RB];
#pragma unroll
    for (int a = 0; a < RA; ++a) av[a] = A[(ty + LANES * a) * LD + c];
#pragma unroll
    for (int b = 0; b < RB; ++b) bv[b] = B[(tx + LANES * b) * LD + c];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < RB; ++b) out[a][b] = fmaf(av[a], bv[b], out[a][b]);
  }
}

// acc[a][u] += sum_{k < K} P[(ty + 16 a) LP + k] M[k LD + tx + 16 u]: rows
// of the staged score tile P times the staged operand M (K x d).
template <int RA, int NC, int K, int LP, int LD>
__device__ __forceinline__ void nn(float (&acc)[RA][NC], const float* P,
                                   const float* M) {
  const int tx = threadIdx.x % LANES;
  const int ty = threadIdx.x / LANES;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float pv[RA];
#pragma unroll
    for (int a = 0; a < RA; ++a) pv[a] = P[(ty + LANES * a) * LP + k];
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      const float m = M[k * LD + tx + LANES * u];
#pragma unroll
      for (int a = 0; a < RA; ++a) acc[a][u] = fmaf(pv[a], m, acc[a][u]);
    }
  }
}

// keys per tile for NC column blocks (head dims up to 16 NC)
template <int NC> struct Keys { static constexpr int BK = NC <= 8 ? 64 : 32; };

template <int NC> struct DqSmem {
  static constexpr int BK = Keys<NC>::BK;
  static constexpr int LD = LANES * NC + 1;
  static constexpr int LS = BK + 1;
  static constexpr size_t FLOATS =
      static_cast<size_t>(2 * BQ + 2 * BK) * LD + static_cast<size_t>(BQ) * LS;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <int NC> struct DkvSmem {
  static constexpr int BK = Keys<NC>::BK;
  static constexpr int LD = LANES * NC + 1;
  static constexpr int LP = BQ + 1;
  static constexpr size_t FLOATS = static_cast<size_t>(2 * BK + 2 * BQ) * LD +
                                   2 * static_cast<size_t>(BK) * LP + 2 * BQ;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

// ---------------------------------------------------------------------------
// 1. dq, with each row's lse and delta
// ---------------------------------------------------------------------------

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS, 1)
attention_bwd_dq_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                        const T* __restrict__ V, const T* __restrict__ O,
                        const T* __restrict__ dO, T* __restrict__ dQ,
                        float* __restrict__ LSE, float* __restrict__ DELTA,
                        int64_t hq, int64_t hkv, int64_t sq, int64_t skv,
                        int d, float scale, Mask mask) {
  using S = DqSmem<NC>;
  constexpr int BK = S::BK, LD = S::LD, LS = S::LS;
  constexpr int NB = BK / LANES;        // keys per thread in a score tile
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                     // BQ x LD
  float* dOs = Qs + BQ * LD;            // BQ x LD
  float* Ks = dOs + BQ * LD;            // BK x LD
  float* Vs = Ks + BK * LD;             // BK x LD
  float* dSs = Vs + BK * LD;            // BQ x LS

  const int tx = threadIdx.x % LANES;
  const int ty = threadIdx.x / LANES;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * BQ;
  const int64_t h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t hk = h / (hq / hkv);
  const int64_t qoff = (b * hq + h) * sq * d;
  const int64_t koff = (b * hkv + hk) * skv * d;
  const T* k = K + koff;
  const T* v = V + koff;
  const T* o = O + qoff;
  float* lse_out = LSE + (b * hq + h) * sq;
  float* delta_out = DELTA + (b * hq + h) * sq;

  load_rows<T, BQ, LD>(Qs, Q + qoff, q0, sq, d);
  load_rows<T, BQ, LD>(dOs, dO + qoff, q0, sq, d);
  __syncthreads();

  float delta[RQ];
#pragma unroll
  for (int a = 0; a < RQ; ++a) {
    const int r = ty + LANES * a;
    const int64_t row = q0 + r;
    float s = 0.f;
    if (row < sq)
      for (int c = tx; c < d; c += LANES)
        s = fmaf(dOs[r * LD + c], to_f(o[row * d + c]), s);
    delta[a] = row_sum(s);
  }

  // the key tiles some row of [q0, q0 + BQ) sees
  int64_t t0 = 0;
  int64_t t1 = (skv + BK - 1) / BK;
  if (mask.causal) {
    const int64_t last = (q0 + BQ - 1) / BK + 1;
    t1 = last < t1 ? last : t1;
  }
  if (mask.windowed) {
    const int64_t oldest = q0 - mask.window + 1;   // first row's oldest key
    if (oldest > 0) t0 = oldest / BK;
  }

  // sweep 1: each row's log-sum-exp
  float m[RQ], l[RQ];
#pragma unroll
  for (int a = 0; a < RQ; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
  }
  for (int64_t t = t0; t < t1; ++t) {
    __syncthreads();
    load_rows<T, BK, LD>(Ks, k, t * BK, skv, d);
    __syncthreads();
    float s[RQ][NB];
    nt<RQ, NB, LD>(s, Qs, Ks, d);
#pragma unroll
    for (int a = 0; a < RQ; ++a) {
      const int64_t row = q0 + ty + LANES * a;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NB; ++j)
        if (seen(mask, row, t * BK + tx + LANES * j, sq, skv))
          mx = fmaxf(mx, s[a][j] * scale);
      const float m_new = fmaxf(m[a], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NB; ++j)
        if (seen(mask, row, t * BK + tx + LANES * j, sq, skv))
          sum += expf(s[a][j] * scale - m_new);
      sum = row_sum(sum);
      const float corr = m[a] == -INFINITY ? 0.f : expf(m[a] - m_new);
      l[a] = l[a] * corr + sum;
      m[a] = m_new;
    }
  }
  float lse[RQ];
#pragma unroll
  for (int a = 0; a < RQ; ++a) {
    lse[a] = l[a] > 0.f ? m[a] + logf(l[a]) : INFINITY;
    const int64_t row = q0 + ty + LANES * a;
    if (tx == 0 && row < sq) {
      lse_out[row] = lse[a];
      delta_out[row] = delta[a];
    }
  }

  // sweep 2: dq += ds k
  float acc[RQ][NC];
#pragma unroll
  for (int a = 0; a < RQ; ++a)
#pragma unroll
    for (int u = 0; u < NC; ++u) acc[a][u] = 0.f;
  for (int64_t t = t0; t < t1; ++t) {
    __syncthreads();
    load_rows<T, BK, LD>(Ks, k, t * BK, skv, d);
    load_rows<T, BK, LD>(Vs, v, t * BK, skv, d);
    __syncthreads();
    float s[RQ][NB], dp[RQ][NB];
    nt<RQ, NB, LD>(s, Qs, Ks, d);
    nt<RQ, NB, LD>(dp, dOs, Vs, d);
#pragma unroll
    for (int a = 0; a < RQ; ++a) {
      const int64_t row = q0 + ty + LANES * a;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        float ds = 0.f;
        if (seen(mask, row, t * BK + tx + LANES * j, sq, skv))
          ds = expf(s[a][j] * scale - lse[a]) * (dp[a][j] - delta[a]);
        dSs[(ty + LANES * a) * LS + tx + LANES * j] = ds;
      }
    }
    __syncthreads();
    nn<RQ, NC, BK, LS, LD>(acc, dSs, Ks);
  }
  T* dq = dQ + qoff;
#pragma unroll
  for (int a = 0; a < RQ; ++a) {
    const int64_t row = q0 + ty + LANES * a;
    if (row >= sq) continue;
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      const int c = tx + LANES * u;
      if (c < d) dq[row * d + c] = from_f<T>(acc[a][u] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dk and dv, the group's query heads looped inside the block
// ---------------------------------------------------------------------------

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS, 1)
attention_bwd_dkv_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                         const T* __restrict__ V, const T* __restrict__ dO,
                         T* __restrict__ dK, T* __restrict__ dV,
                         const float* __restrict__ LSE,
                         const float* __restrict__ DELTA, int64_t hq,
                         int64_t hkv, int64_t sq, int64_t skv, int d,
                         float scale, Mask mask) {
  using S = DkvSmem<NC>;
  constexpr int BK = S::BK, LD = S::LD, LP = S::LP;
  constexpr int NA = BK / LANES;        // keys per thread
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                     // BK x LD
  float* Vs = Ks + BK * LD;             // BK x LD
  float* Qs = Vs + BK * LD;             // BQ x LD
  float* dOs = Qs + BQ * LD;            // BQ x LD
  float* Ps = dOs + BQ * LD;            // BK x LP
  float* dSs = Ps + BK * LP;            // BK x LP
  float* lse_s = dSs + BK * LP;         // BQ
  float* delta_s = lse_s + BQ;          // BQ

  const int tx = threadIdx.x % LANES;
  const int ty = threadIdx.x / LANES;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * BK;
  const int64_t hk = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t group = hq / hkv;
  const int64_t koff = (b * hkv + hk) * skv * d;

  load_rows<T, BK, LD>(Ks, K + koff, k0, skv, d);
  load_rows<T, BK, LD>(Vs, V + koff, k0, skv, d);

  // the query tiles some row of which sees a key of [k0, k0 + BK)
  int64_t qt0 = 0;
  int64_t qt1 = (sq + BQ - 1) / BQ;
  if (mask.causal) qt0 = k0 / BQ;
  if (mask.windowed) {
    // the last row that sees the tile's last key: row - key < window
    const int64_t last = k0 + BK - 1 + mask.window - 1;
    const int64_t end = last < 0 ? 0 : last / BQ + 1;
    qt1 = end < qt1 ? end : qt1;
  }

  float dk[NA][NC], dv[NA][NC];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      dk[a][u] = 0.f;
      dv[a][u] = 0.f;
    }

  for (int64_t g = 0; g < group; ++g) {
    const int64_t h = hk * group + g;
    const int64_t qoff = (b * hq + h) * sq * d;
    const float* lse = LSE + (b * hq + h) * sq;
    const float* dlt = DELTA + (b * hq + h) * sq;
    for (int64_t qt = qt0; qt < qt1; ++qt) {
      const int64_t q0 = qt * BQ;
      __syncthreads();
      load_rows<T, BQ, LD>(Qs, Q + qoff, q0, sq, d);
      load_rows<T, BQ, LD>(dOs, dO + qoff, q0, sq, d);
      if (threadIdx.x < BQ) {
        const int64_t row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < sq ? lse[row] : INFINITY;
        delta_s[threadIdx.x] = row < sq ? dlt[row] : 0.f;
      }
      __syncthreads();
      float s[NA][RQ], dp[NA][RQ];
      nt<NA, RQ, LD>(s, Ks, Qs, d);
      nt<NA, RQ, LD>(dp, Vs, dOs, d);
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const int64_t key = k0 + ty + LANES * a;
#pragma unroll
        for (int j = 0; j < RQ; ++j) {
          const int i = tx + LANES * j;
          float p = 0.f, ds = 0.f;
          if (seen(mask, q0 + i, key, sq, skv)) {
            p = expf(s[a][j] * scale - lse_s[i]);
            ds = p * (dp[a][j] - delta_s[i]);
          }
          Ps[(ty + LANES * a) * LP + i] = p;
          dSs[(ty + LANES * a) * LP + i] = ds;
        }
      }
      __syncthreads();
      nn<NA, NC, BQ, LP, LD>(dv, Ps, dOs);
      nn<NA, NC, BQ, LP, LD>(dk, dSs, Qs);
    }
  }
  T* dk_out = dK + koff;
  T* dv_out = dV + koff;
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int64_t key = k0 + ty + LANES * a;
    if (key >= skv) continue;
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      const int c = tx + LANES * u;
      if (c < d) {
        dk_out[key * d + c] = from_f<T>(dk[a][u] * scale);
        dv_out[key * d + c] = from_f<T>(dv[a][u]);
      }
    }
  }
}

template <typename T, int NC>
cudaError_t launch_nc(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, void* dq, void* dk,
                      void* dv, float* lse, float* delta, int64_t batch,
                      int64_t hq, int64_t hkv, int64_t sq, int64_t skv, int d,
                      float scale, Mask mask, cudaStream_t stream) {
  auto kdq = attention_bwd_dq_kernel<T, NC>;
  auto kdkv = attention_bwd_dkv_kernel<T, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(DqSmem<NC>::BYTES));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kdkv,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(DkvSmem<NC>::BYTES));
  if (err != cudaSuccess) return err;
  const T* Q = static_cast<const T*>(q);
  const T* K = static_cast<const T*>(k);
  const T* V = static_cast<const T*>(v);
  const T* dO = static_cast<const T*>(dout);
  if (sq > 0) {
    const dim3 grid(static_cast<unsigned>((sq + BQ - 1) / BQ),
                    static_cast<unsigned>(hq), static_cast<unsigned>(batch));
    kdq<<<grid, THREADS, DqSmem<NC>::BYTES, stream>>>(
        Q, K, V, static_cast<const T*>(o), dO, static_cast<T*>(dq), lse,
        delta, hq, hkv, sq, skv, d, scale, mask);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (skv > 0) {
    constexpr int BK = Keys<NC>::BK;
    const dim3 grid(static_cast<unsigned>((skv + BK - 1) / BK),
                    static_cast<unsigned>(hkv), static_cast<unsigned>(batch));
    kdkv<<<grid, THREADS, DkvSmem<NC>::BYTES, stream>>>(
        Q, K, V, dO, static_cast<T*>(dk), static_cast<T*>(dv), lse, delta,
        hq, hkv, sq, skv, d, scale, mask);
  }
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, void* lse,
           void* delta, int64_t batch, int64_t hq, int64_t hkv, int64_t sq,
           int64_t skv, int64_t d, double scale, int causal, int windowed,
           int64_t window, void* stream) {
  if (batch <= 0 || hq <= 0 || d <= 0)
    return static_cast<int>(cudaGetLastError());
  if (hkv <= 0 || hq % hkv != 0 || d > MAX_HEAD_DIM || hq > 65535 ||
      batch > 65535 || (sq + BQ - 1) / BQ > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const Mask mask{causal != 0, windowed != 0, window};
  const float s = static_cast<float>(scale);
  const int dd = static_cast<int>(d);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* L = static_cast<float*>(lse);
  float* D = static_cast<float*>(delta);
  cudaError_t err;
  if (d <= 64)
    err = launch_nc<T, 4>(q, k, v, o, dout, dq, dk, dv, L, D, batch, hq, hkv,
                          sq, skv, dd, s, mask, st);
  else if (d <= 128)
    err = launch_nc<T, 8>(q, k, v, o, dout, dq, dk, dv, L, D, batch, hq, hkv,
                          sq, skv, dd, s, mask, st);
  else
    err = launch_nc<T, 16>(q, k, v, o, dout, dq, dk, dv, L, D, batch, hq,
                           hkv, sq, skv, dd, s, mask, st);
  return static_cast<int>(err);
}

// The 16-bit backward on the tensor cores of element type T (BF16_WGMMA,
// F16_WGMMA: route), with the checks both entry points make
template <typename T>
int launch_wgmma(DType dtype, Route route, const void* q, const void* k,
                 const void* v, const void* o, const void* dout, void* dq,
                 void* dk, void* dv, const void* lse, void* delta, void* part,
                 int64_t batch, int64_t hq, int64_t hkv, int64_t sq,
                 int64_t skv, int64_t d, double scale, int causal,
                 int windowed, int64_t window, int64_t groups, void* stream) {
  if (route_of(dtype, d, q, k, v, o, dout, lse) != route || batch <= 0 ||
      hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 || skv <= 0 ||
      groups <= 0 || (hq / hkv) % groups != 0 ||
      (groups > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float s = static_cast<float>(scale);
  const bind_attn_bwd::Shape sh{
      hq, hkv, sq, skv, s, s * bind_attn_bwd::LOG2E,
      bind_attn::Mask{causal != 0, windowed != 0, window}, groups};
  return static_cast<int>(bind_attn_bwd::launch<T>(
      q, k, v, o, dout, dq, dk, dv, static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<float*>(part), batch, sh, d,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

int bind_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int64_t batch, int64_t hq, int64_t hkv, int64_t sq, int64_t skv,
    int64_t d, double scale, int causal, int windowed, int64_t window,
    void* stream) {
  return launch<float>(q, k, v, o, dout, dq, dk, dv, lse, delta, batch,
      hq, hkv, sq, skv, d, scale, causal, windowed, window, stream);
}

int bind_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int64_t batch, int64_t hq, int64_t hkv, int64_t sq, int64_t skv,
    int64_t d, double scale, int causal, int windowed, int64_t window,
    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse, delta,
      batch, hq, hkv, sq, skv, d, scale, causal, windowed, window, stream);
}

int bind_flash_attention_bwd_f16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int64_t batch, int64_t hq, int64_t hkv, int64_t sq, int64_t skv,
    int64_t d, double scale, int causal, int windowed, int64_t window,
    void* stream) {
  return launch<__half>(q, k, v, o, dout, dq, dk, dv, lse, delta, batch,
      hq, hkv, sq, skv, d, scale, causal, windowed, window, stream);
}

// The bf16 backward on the tensor cores (BF16_WGMMA): lse is the forward's
// (B, Hq, Sq) log-sum-exp, delta a (B, Hq, Sq) float32 scratch, part null
// when groups == 1 and otherwise a (2, B, groups, Hkv, Skv, D) float32
// scratch; groups (the dk/dv blocks' head groups) divides Hq / Hkv.
// Operands the route does not take give cudaErrorInvalidValue and launch
// nothing.
int bind_flash_attention_bwd_bf16_lse(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const void* lse,
    void* delta, void* part, int64_t batch, int64_t hq, int64_t hkv,
    int64_t sq, int64_t skv, int64_t d, double scale, int causal,
    int windowed, int64_t window, int64_t groups, void* stream) {
  return launch_wgmma<__nv_bfloat16>(
      BF16, BF16_WGMMA, q, k, v, o, dout, dq, dk, dv, lse, delta, part,
      batch, hq, hkv, sq, skv, d, scale, causal, windowed, window, groups,
      stream);
}

// The f16 backward on the tensor cores (F16_WGMMA): the arguments and
// checks of bind_flash_attention_bwd_bf16_lse, on float16 operands.
int bind_flash_attention_bwd_f16_lse(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const void* lse,
    void* delta, void* part, int64_t batch, int64_t hq, int64_t hkv,
    int64_t sq, int64_t skv, int64_t d, double scale, int causal,
    int windowed, int64_t window, int64_t groups, void* stream) {
  return launch_wgmma<__half>(
      F16, F16_WGMMA, q, k, v, o, dout, dq, dk, dv, lse, delta, part, batch,
      hq, hkv, sq, skv, d, scale, causal, windowed, window, groups, stream);
}

// The f32 backward on the tensor cores in 3xTF32 (F32_3XTF32): lse is the
// forward's (B, Hq, Sq) log-sum-exp, delta a (B, Hq, Sq) float32 scratch;
// at d 256 a kv head's query heads split into `groups` head groups across
// the dk / dv blocks, whose float32 partials go to part, a (2, B, groups,
// Hkv, Skv, D) scratch (null with one group, the only count below d 256).
// Operands the route does not take give cudaErrorInvalidValue and launch
// nothing.
int bind_flash_attention_bwd_f32_lse(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const void* lse,
    void* delta, void* part, int64_t batch, int64_t hq, int64_t hkv,
    int64_t sq, int64_t skv, int64_t d, double scale, int causal,
    int windowed, int64_t window, int64_t groups, void* stream) {
  if (route_of(F32, d, q, k, v, o, dout, lse) != F32_3XTF32 || batch <= 0 ||
      hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 || skv <= 0 ||
      delta == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const float s = static_cast<float>(scale);
  const bind_attn_bwd_tf::Shape sh{
      static_cast<const float*>(q),    static_cast<const float*>(k),
      static_cast<const float*>(v),    static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta),      static_cast<float*>(dq),
      static_cast<float*>(dk),         static_cast<float*>(dv),
      hq, hkv, sq, skv, s, s * bind_attn_bwd_tf::LOG2E,
      bind_attn::Mask{causal != 0, windowed != 0, window},
      static_cast<float*>(part), groups};
  return static_cast<int>(bind_attn_bwd_tf::launch(
      sh, batch, d, static_cast<cudaStream_t>(stream)));
}

// The route (enum Route) the backward of element type dtype (F32 0, BF16 1,
// F16 2) takes at head dim d on these operands, lse the forward's
// log-sum-exp or null (route_of); -1 for another type or a head dim the
// kernels do not take.
int bind_flash_attention_bwd_route(int dtype, int64_t d, const void* q,
                                   const void* k, const void* v,
                                   const void* out, const void* dout,
                                   const void* lse) {
  return route_of(dtype, d, q, k, v, out, dout, lse);
}

}  // extern "C"
