// The tile loops of the hand-written GEMM, shared by csrc/gemm.cu and the
// chain kernel (src/repro_torch/kernels/chain/csrc/chain.cu).  Both run
// one problem type, Problem<T> below: out = C + sum_l A_l @ B_l over L
// levels, the carry rounded to T after every level.  The GEMM is the case
// L = 1; the chain kernel's contract is bitwise equality with per-level
// replay through the GEMM, and it holds because both launch the same tile
// loop (gemm_routes.cuh picks it), level by level, with the same epilogue.
//
// This file holds what every route shares (the problem, the epilogue,
// cp.async, the panel loader) and the route of the CUDA cores, simt_tile:
// float16 inputs, and float32 and bfloat16 operands whose alignment or row
// lengths the tensor-core routes cannot take (gemm_routes.cuh: aligned
// float32 runs 3xTF32 on the tensor cores, gemm_tf32.cuh).  Every output
// element of simt_tile is one chain of IEEE fp32 fused multiply-adds
// (__fmaf_rn, no TF32) in ascending k from +0, so the result does not
// depend on the tiling (a zero-filled product past the ragged edge leaves
// a sum that is never -0 unchanged): it is bit for bit the one of the
// first GEMM kernel of the port.
//
// simt_tile: one block of 128 threads owns a 64x64 output tile (1024^2
// gives 256 blocks, two on most of the 132 SMs, whose barriers then
// interleave).  Each thread owns an 8x4 register micro-tile, rows ty*4 +
// {0..3} and 32 + ty*4 + {0..3}, columns tx*4 + {0..3}.  K panels of 32 go
// through a ring of three stages in shared memory (52 KB), both operands
// stored as they lie (A's rows padded by 4 floats, so the two rows a warp
// reads at once fall 16 banks apart).  Four K steps at a time, a thread
// reads 8 float4 of A (its 8 rows, k..k+3) and 4 float4 of B: 12 16-byte
// shared loads for 128 FMAs.  Panels are filled with cp.async while the
// FMAs of the panel before run, in 16-byte chunks when the operand allows
// (aligned base, rows of whole chunks) and element by element otherwise,
// zero-filled past the ragged edge; one __syncthreads() per panel.
// bfloat16 and float16 panels are converted to fp32 through registers on
// their way in.  Levels run as one stream of panels, so the ring does not drain
// between levels, and the carry stays in registers (out is written once,
// after the last level).
//
// What bounds it on an H100: FMA issue.  The card's 67 TFLOP/s outside the
// tensor cores is one warp FMA per cycle per scheduler; the loop adds a
// shared load per 10.7 FMAs, the loads and the barrier.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <type_traits>

namespace bind_gemm {

// out = C + sum_{l < L} A_l @ B_l with A_l = A + l * a_stride (M x K,
// row-major) and B_l = B + l * b_stride (K x N); after each level the sum
// is rounded to O and becomes the next level's C.  C may be NULL (L = 1).
// O, the type of C and out, is T unless the GEMM's caller asks for
// another output type (matmul's out_dtype: one level, no C); the
// accumulator stays T's (AccType) and is rounded once to O.
template <typename T, typename O = T> struct Problem {
  const T* A;
  int64_t a_stride;
  const T* B;
  int64_t b_stride;
  const O* C;
  O* out;
  int64_t M, N, K, L;
};

template <typename T> struct AccType { using type = float; };
template <> struct AccType<double> { using type = double; };

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_acc(__half x) { return __half2float(x); }
__device__ __forceinline__ double to_acc(double x) { return x; }

// accumulator value -> output type O, one rounding to nearest even (a
// float64 accumulator goes straight to a narrow type, never through
// float32)
template <typename O> __device__ __forceinline__ O acc_to(float v);
template <> __device__ __forceinline__ float acc_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 acc_to<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half acc_to<__half>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ double acc_to<double>(float v) {
  return static_cast<double>(v);
}
template <typename O> __device__ __forceinline__ O acc_to(double v);
template <> __device__ __forceinline__ double acc_to<double>(double v) {
  return v;
}
template <> __device__ __forceinline__ float acc_to<float>(double v) {
  return __double2float_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 acc_to<__nv_bfloat16>(double v) {
  return __double2bfloat16(v);
}
template <> __device__ __forceinline__ __half acc_to<__half>(double v) {
  return __double2half(v);
}

// accumulator value -> element type: acc_to<T> of T's own accumulator
template <typename T>
__device__ __forceinline__ T from_acc(typename AccType<T>::type v) {
  return acc_to<T>(v);
}

// fused multiply-add with one IEEE rounding (round to nearest even); the
// flash-attention tile loop (attn_tile.cuh) uses it too
__device__ __forceinline__ float mac(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double mac(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// The epilogue of level l for one element on the tensor-core routes, whose
// accumulators leave no registers for a carry: the level's sum v (from 0
// in the accumulator type) plus the carry (C at level 0, the previous
// level's out after it), rounded once to O.  The same thread wrote
// out[gm, gn] at level l - 1, so no barrier is needed between levels.
// simt_tile does the same with the carry in registers.
template <typename T, typename O>
__device__ __forceinline__ void store_level(const Problem<T, O>& p,
                                            int64_t l, int64_t gm,
                                            int64_t gn,
                                            typename AccType<T>::type v) {
  using Acc = typename AccType<T>::type;
  const O* carry = l == 0 ? p.C : p.out;
  const int64_t e = gm * p.N + gn;
  if (carry != nullptr) v = static_cast<Acc>(to_acc(carry[e])) + v;
  p.out[e] = acc_to<O>(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of BYTES bytes; when !in nothing is read and the bytes are
// zero-filled
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(BYTES), "r"(in ? BYTES : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// ------------------------------------------------------------ simt route --

constexpr int SIMT_BM = 64;                        // output tile rows
constexpr int SIMT_BN = 64;                        // output tile columns
constexpr int SIMT_BK = 32;                        // K panel
constexpr int SIMT_STAGES = 3;                     // panels in flight
constexpr int SIMT_TX = SIMT_BN / 4;               // 4 columns a thread
constexpr int SIMT_TY = SIMT_BM / 8;               // 8 rows a thread
constexpr int SIMT_THREADS = SIMT_TX * SIMT_TY;
constexpr int SIMT_HALF = SIMT_BM / 2;             // rows ty*4, HALF + ty*4
constexpr int SIMT_APAD = 4;   // rows 4 apart fall 16 banks apart

struct __align__(16) SimtStage {
  float As[SIMT_BM][SIMT_BK + SIMT_APAD];  // A panel: As[m][k]
  float Bs[SIMT_BK][SIMT_BN];              // B panel: Bs[k][n]
};
constexpr size_t SIMT_SMEM = SIMT_STAGES * sizeof(SimtStage);

// one element of a panel into shared memory in the accumulator type:
// float32 and float64 by cp.async, bfloat16 and float16 through a register
__device__ __forceinline__ void stage_elem(float* dst, const float* src,
                                           bool in) {
  cp_async<4>(dst, src, in);
}
__device__ __forceinline__ void stage_elem(double* dst, const double* src,
                                           bool in) {
  cp_async<8>(dst, src, in);
}
__device__ __forceinline__ void stage_elem(float* dst,
                                           const __nv_bfloat16* src,
                                           bool in) {
  *dst = in ? __bfloat162float(*src) : 0.0f;
}
__device__ __forceinline__ void stage_elem(float* dst, const __half* src,
                                           bool in) {
  *dst = in ? __half2float(*src) : 0.0f;
}

// Panel loader of one operand: a ROWS x COLS window of a row-major matrix
// into a shared array S[.][PITCH], by THREADS threads.  Each thread stages
// elements (or 16-byte chunks) at rows r + i * STEP of one column c;
// neighbours read along the rows.  Chunks (16-byte cp.async) need a
// 16-byte-aligned base, and a row stride and a level stride that are
// whole chunks; otherwise every element goes on its own (bfloat16 always:
// it is converted on the way).  Past the ragged edge both zero-fill.
template <typename T, typename S, int ROWS, int COLS, int PITCH,
          int THREADS>
struct PanelLoader {
  static constexpr int CHUNK = 16 / sizeof(S);             // elements
  static constexpr int STEP = THREADS / COLS;
  static constexpr int VSTEP = THREADS / (COLS / CHUNK);
  const T* base;        // element (row0 + r, col0 + c) of level 0
  int64_t ld;           // row stride (elements)
  int64_t rows_left;    // rows of the matrix from row0 + r on
  int64_t cols_left;    // columns of the matrix from col0 + c on
  int r, c;
  bool vec;

  __device__ __forceinline__ PanelLoader(const T* m, int64_t ld_,
                                         int64_t rows, int64_t cols,
                                         int64_t row0, int64_t col0,
                                         int64_t level_stride) {
    const int tid = threadIdx.x;
    ld = ld_;
    vec = false;
    if constexpr (std::is_same_v<T, S>)
      vec = reinterpret_cast<uintptr_t>(m) % 16 == 0 && ld % CHUNK == 0 &&
            level_stride % CHUNK == 0;
    r = vec ? tid / (COLS / CHUNK) : tid / COLS;
    c = vec ? (tid % (COLS / CHUNK)) * CHUNK : tid % COLS;
    base = m + (row0 + r) * ld + col0 + c;
    rows_left = rows - row0 - r;
    cols_left = cols - col0 - c;
  }

  // the window ``row_off`` rows and ``col_off`` columns further on, in the
  // level ``level_off`` elements on, into dst; ``fill`` is any valid
  // address (read for nothing) for elements past the edge.  A chunk lies
  // wholly inside or outside: ld, hence cols, is a whole number of chunks.
  __device__ __forceinline__ void load(S (*dst)[PITCH], const T* fill,
                                       int64_t level_off, int64_t row_off,
                                       int64_t col_off) const {
    const T* src = base + level_off + row_off * ld + col_off;
    const int64_t left = rows_left - row_off;
    const bool col_in = col_off < cols_left;
    if constexpr (std::is_same_v<T, S>) {
      if (vec) {
#pragma unroll
        for (int i = 0; i < ROWS / VSTEP; ++i) {
          const bool in = col_in && i * VSTEP < left;
          cp_async<16>(&dst[r + i * VSTEP][c], in ? src : fill, in);
          src += VSTEP * ld;
        }
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS / STEP; ++i) {
      const bool in = col_in && i * STEP < left;
      stage_elem(&dst[r + i * STEP][c], in ? src : fill, in);
      src += STEP * ld;
    }
  }
};

// The CUDA-core route.  All SIMT_THREADS threads of the block call it,
// with SIMT_SMEM bytes of dynamic shared memory at ``smem``.
template <typename T, typename O = T>
__device__ __forceinline__ void simt_tile(const Problem<T, O>& p,
                                          unsigned char* smem) {
  SimtStage* sm = reinterpret_cast<SimtStage*>(smem);
  const int tid = threadIdx.x;
  const int tx = tid % SIMT_TX;
  const int ty = tid / SIMT_TX;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * SIMT_BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * SIMT_BN;
  // K = 0 still runs one zero panel per level: the sum stays +0
  const int64_t nk = p.K > 0 ? (p.K + SIMT_BK - 1) / SIMT_BK : 1;
  const int64_t total = nk * p.L;

  // A's panel is BM rows x BK columns at (m0, k0); B's is BK rows x BN
  // columns at (k0, n0)
  const PanelLoader<T, float, SIMT_BM, SIMT_BK, SIMT_BK + SIMT_APAD,
                    SIMT_THREADS>
      la(p.A, p.K, p.M, p.K, m0, 0, p.a_stride);
  const PanelLoader<T, float, SIMT_BK, SIMT_BN, SIMT_BN, SIMT_THREADS> lb(
      p.B, p.N, p.K, p.N, 0, n0, p.b_stride);
  // the loader's position in the stream of panels: level, K offset, stage
  int64_t ll = 0, lk0 = 0;
  int ls = 0;
  auto load_next = [&]() {
    la.load(sm[ls].As, p.A, ll * p.a_stride, 0, lk0);
    lb.load(sm[ls].Bs, p.B, ll * p.b_stride, lk0, 0);
    lk0 += SIMT_BK;
    if (lk0 >= nk * SIMT_BK) { lk0 = 0; ++ll; }
    if (++ls == SIMT_STAGES) ls = 0;
  };
#pragma unroll
  for (int s = 0; s < SIMT_STAGES - 1; ++s) {
    if (s < total) load_next();
    cp_async_commit();
  }

  // acc: the level's sum from +0; carry: the previous level's result,
  // rounded to T, held in registers from level to level (C at level 0)
  float acc[8][4], carry[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  int cs = 0;          // stage of the panel computed now
  int64_t ck = 0;      // its panel index within the level
  int64_t cl = 0;      // its level
  for (int64_t t = 0; t < total; ++t) {
    cp_async_wait<SIMT_STAGES - 2>();   // this thread's copies of panel t
    __syncthreads();   // everyone's copies; everyone is done with t - 1
    if (t + SIMT_STAGES - 1 < total) load_next();   // into t - 1's stage
    cp_async_commit();
    const SimtStage& s = sm[cs];
#pragma unroll
    for (int k4 = 0; k4 < SIMT_BK; k4 += 4) {
      // 4 K steps at once: A[row][k4..k4+3] for the 8 rows, B[k4 + q][4
      // columns] for q < 4; then the FMAs in ascending k
      float4 a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            &s.As[i < 4 ? ty * 4 + i : SIMT_HALF + ty * 4 + i - 4][k4]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        b[q] = *reinterpret_cast<const float4*>(&s.Bs[k4 + q][tx * 4]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float bq[4] = {b[q].x, b[q].y, b[q].z, b[q].w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ai = q == 0 ? a[i].x
                           : q == 1 ? a[i].y
                           : q == 2 ? a[i].z
                                    : a[i].w;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = mac(ai, bq[j], acc[i][j]);
        }
      }
    }
    if (++cs == SIMT_STAGES) cs = 0;
    if (++ck == nk) {   // the level's sum is complete
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int64_t gm =
            m0 + (i < 4 ? ty * 4 + i : SIMT_HALF + ty * 4 + i - 4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int64_t gn = n0 + tx * 4 + j;
          const bool in = gm < p.M && gn < p.N;
          // as store_level, with the carry in registers after level 0
          // (0 + acc is acc: the sum is never -0)
          const float c =
              cl != 0 ? carry[i][j]
                      : (in && p.C != nullptr
                             ? static_cast<float>(to_acc(p.C[gm * p.N + gn]))
                             : 0.0f);
          const O r = acc_to<O>(c + acc[i][j]);
          carry[i][j] = static_cast<float>(to_acc(r));
          if (in && cl == p.L - 1) p.out[gm * p.N + gn] = r;
          acc[i][j] = 0.0f;
        }
      }
      ck = 0;
      ++cl;
    }
  }
}

}  // namespace bind_gemm
