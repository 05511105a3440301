// The tile loop of the hand-written GEMM, shared by csrc/gemm.cu and the
// chain kernel (src/repro_torch/kernels/chain/csrc/chain.cu), so the two
// sum every product in the same order with the same rounding and cannot
// drift apart: the chain kernel's contract is bitwise equality with
// per-level replay through the GEMM.
//
// One block of THREADS threads owns a BM x BN output tile.  Per K step of
// BK it stages a BM x BK panel of A (transposed, padded by one column
// against bank conflicts) and a BK x BN panel of B in shared memory,
// converted to the accumulator type; the ragged edge is zero-filled.  Each
// thread owns a TM x TN register micro-tile at rows ty + LANES_M * i,
// columns tx + LANES_N * j, so shared-memory reads broadcast and output
// stores coalesce.  Products are summed over K in ascending order, one IEEE
// fused multiply-add each (never TF32): fp32 for f32 and bf16 inputs, fp64
// for f64.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace bind_gemm {

constexpr int BM = 64;   // output tile rows
constexpr int BN = 64;   // output tile columns
constexpr int BK = 16;   // K step staged in shared memory
constexpr int TM = 4;    // micro-tile rows per thread
constexpr int TN = 4;    // micro-tile columns per thread
constexpr int LANES_M = BM / TM;            // 16
constexpr int LANES_N = BN / TN;            // 16
constexpr int THREADS = LANES_M * LANES_N;  // 256

template <typename T> struct AccType { using type = float; };
template <> struct AccType<double> { using type = double; };

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ double to_acc(double x) { return x; }

// accumulator value -> element type, rounding to nearest even
template <typename T>
__device__ __forceinline__ T from_acc(typename AccType<T>::type v);
template <> __device__ __forceinline__ float from_acc<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ double from_acc<double>(double v) {
  return v;
}

// fused multiply-add with one IEEE rounding (round to nearest even)
__device__ __forceinline__ float mac(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double mac(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// the block's shared-memory panels
template <typename Acc> struct Panels {
  Acc As[BK][BM + 1];  // A panel, transposed: As[k][m]
  Acc Bs[BK][BN];      // B panel: Bs[k][n]
};

// acc[i][j] += sum_k A[m0 + ty + LANES_M*i, k] * B[k, n0 + tx + LANES_N*j]
// over the whole K, row-major A (M x K) and B (K x N).  All THREADS
// threads of the block must call it (it synchronises the block).
template <typename T, typename Acc>
__device__ __forceinline__ void accumulate_tile(
    const T* __restrict__ A, const T* __restrict__ B, int64_t M, int64_t N,
    int64_t K, int64_t m0, int64_t n0, Panels<Acc>& sm, Acc (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int tx = tid % LANES_N;
  const int ty = tid / LANES_N;
  for (int64_t k0 = 0; k0 < K; k0 += BK) {
    // stage A[m0:m0+64, k0:k0+16]: neighbouring threads read along K
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int r = e / BK;
      const int c = e % BK;
      const int64_t gm = m0 + r;
      const int64_t gk = k0 + c;
      sm.As[c][r] = (gm < M && gk < K) ? to_acc(A[gm * K + gk]) : Acc(0);
    }
    // stage B[k0:k0+16, n0:n0+64]: neighbouring threads read along N
#pragma unroll
    for (int l = 0; l < (BK * BN) / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int r = e / BN;
      const int c = e % BN;
      const int64_t gk = k0 + r;
      const int64_t gn = n0 + c;
      sm.Bs[r][c] = (gk < K && gn < N) ? to_acc(B[gk * N + gn]) : Acc(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      Acc a[TM];
      Acc b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sm.As[kk][ty + i * LANES_M];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = sm.Bs[kk][tx + j * LANES_N];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = mac(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace bind_gemm
