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
//   * one block of 256 threads per 64x64 output tile;
//   * per K step of 16, the block stages a 64x16 panel of A (transposed,
//     padded by one column against bank conflicts) and a 16x64 panel of B
//     in shared memory, converted to the accumulator type;
//   * each thread owns a 4x4 register micro-tile at rows ty+16i, columns
//     tx+16j, so shared-memory reads broadcast and output stores coalesce;
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

namespace {

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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(double* p, double v) { *p = v; }

// fused multiply-add with one IEEE rounding (round to nearest even)
__device__ __forceinline__ float mac(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double mac(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
            const T* __restrict__ C, T* __restrict__ out,
            int64_t M, int64_t N, int64_t K) {
  using Acc = typename AccType<T>::type;
  __shared__ Acc As[BK][BM + 1];  // A panel, transposed: As[k][m]
  __shared__ Acc Bs[BK][BN];      // B panel: Bs[k][n]

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

  for (int64_t k0 = 0; k0 < K; k0 += BK) {
    // stage A[m0:m0+64, k0:k0+16]: neighbouring threads read along K
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int r = e / BK;
      const int c = e % BK;
      const int64_t gm = m0 + r;
      const int64_t gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? to_acc(A[gm * K + gk]) : Acc(0);
    }
    // stage B[k0:k0+16, n0:n0+64]: neighbouring threads read along N
#pragma unroll
    for (int l = 0; l < (BK * BN) / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int r = e / BN;
      const int c = e % BN;
      const int64_t gk = k0 + r;
      const int64_t gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? to_acc(B[gk * N + gn]) : Acc(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      Acc a[TM];
      Acc b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * LANES_M];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * LANES_N];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = mac(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

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
      store(&out[gm * N + gn], v);
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
