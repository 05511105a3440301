// Tiled GEMM for Hopper (sm_90a): out = A @ B (+ C), row-major, one launch.
//
// Replaces the TPU kernel src/repro/kernels/gemm/kernel.py:47 matmul_pallas
// (body _matmul_kernel): C = A @ B with an fp32 accumulator over a
// sequential K grid axis and one store.  Here the blocks of the 2-D grid run
// in parallel in no order, so the TPU's sequential K axis becomes a loop
// over K inside each block, and the accumulator lives in registers instead
// of VMEM scratch.
//
// Design (simple and correct first):
//   * one block of 256 threads per 64x64 output tile; the tile loop (K
//     steps of 16 staged in shared memory, a 4x4 register micro-tile per
//     thread) lives in gemm_tile.cuh, shared with the chain kernel;
//   * the ragged edge is masked in the loads (zero fill) and in the stores,
//     so no padding copy is made for any (M, N, K);
//   * an optional C operand is added in the epilogue in the accumulator
//     type and cast once: matmul_accumulate (c + a@b) is one launch.
// Accumulation: f32 inputs take IEEE fp32 FMA (never TF32), bf16 inputs
// accumulate in fp32, f64 inputs in fp64.
//
// What bounds it on an H100: at the main path's leaf (1024^3, ib=1024 in
// Listing 1 and Strassen) the tile does 2*1024^3 = 2.1 GFLOP against 12 MB
// of f32 operands moved (A, B, out), about 180 FLOP per byte, far above the
// card's ridge point, so it is compute-bound.  This kernel runs on the CUDA
// cores (f32: 67 TFLOP/s peak) and reads shared memory for every FMA pair,
// so shared-memory bandwidth, not HBM, limits it.  Tensor cores (wgmma with
// TMA-fed shared-memory rings) are left for a later change.
//
// C interface (bound with ctypes): every entry point takes device pointers,
// the sizes and a cudaStream_t, launches on that stream without
// synchronising, and returns cudaGetLastError() (0 on success).  c may be
// NULL.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_tile.cuh"

namespace {

using namespace bind_gemm;

template <typename T>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
            const T* __restrict__ C, T* __restrict__ out,
            int64_t M, int64_t N, int64_t K) {
  using Acc = typename AccType<T>::type;
  __shared__ Panels<Acc> sm;

  const int tid = threadIdx.x;
  const int tx = tid % LANES_N;
  const int ty = tid / LANES_N;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  accumulate_tile<T, Acc>(A, B, M, N, K, m0, n0, sm, acc);

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gm = m0 + ty + i * LANES_M;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gn = n0 + tx + j * LANES_N;
      if (gn >= N) continue;
      Acc v = acc[i][j];
      if (C != nullptr) v = to_acc(C[gm * N + gn]) + v;
      out[gm * N + gn] = from_acc<T>(v);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* c, void* out,
           int64_t M, int64_t N, int64_t K, void* stream) {
  if (M > 0 && N > 0) {
    const dim3 grid(static_cast<unsigned>((N + BN - 1) / BN),
                    static_cast<unsigned>((M + BM - 1) / BM));
    gemm_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<const T*>(c), static_cast<T*>(out), M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int bind_gemm_f32(const void* a, const void* b, const void* c, void* out,
                  int64_t M, int64_t N, int64_t K, void* stream) {
  return launch<float>(a, b, c, out, M, N, K, stream);
}

int bind_gemm_bf16(const void* a, const void* b, const void* c, void* out,
                   int64_t M, int64_t N, int64_t K, void* stream) {
  return launch<__nv_bfloat16>(a, b, c, out, M, N, K, stream);
}

int bind_gemm_f64(const void* a, const void* b, const void* c, void* out,
                  int64_t M, int64_t N, int64_t K, void* stream) {
  return launch<double>(a, b, c, out, M, N, K, stream);
}

}  // extern "C"
