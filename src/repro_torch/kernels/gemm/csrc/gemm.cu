// Tiled GEMM for Hopper (sm_90a): out = A @ B (+ C), row-major, one launch.
//
// Replaces the TPU kernel src/repro/kernels/gemm/kernel.py:47 matmul_pallas
// (body _matmul_kernel): C = A @ B with an fp32 accumulator over a
// sequential K grid axis and one store.  Here the blocks of the 2-D grid run
// in parallel in no order, so the TPU's sequential K axis becomes a loop
// over K inside each block, and the accumulator lives in registers instead
// of VMEM scratch.
//
// Each dtype has its own route (gemm_routes.cuh), each a tile loop shared
// with the chain kernel:
//   * float32 on the CUDA cores (gemm_tile.cuh): IEEE fp32 FMAs, never
//     TF32, in a pipelined loop (cp.async ring, 8x4 micro-tile, 16-byte
//     shared loads).  Bound on an H100: operations, 67 TFLOP/s at the
//     main path's 1024^3 leaf (2.1 GFLOP against 12 MB, about 180 FLOP per
//     byte); the loop issues 12 shared loads per 128 FMAs, so FMA issue,
//     not shared memory, is what it runs into;
//   * bfloat16 on the tensor cores (gemm_wgmma.cuh): wgmma fed by TMA, fp32
//     accumulators; operands TMA cannot read (misaligned, odd row strides)
//     take the CUDA-core loop instead.  Bound: 989 TFLOP/s, so at 1024^3
//     the latency of the K loop and the loads, which the TMA ring hides;
//   * float64 on the f64 tensor cores (gemm_dmma.cuh): DMMA m16n8k16.
//     Bound: operations, 67 TFLOP/s; shared-memory reads of the DMMA
//     operands come close to it first;
//   * float16 on the CUDA-core loop, converted to fp32 on the way in and
//     accumulated in fp32, rounded once to fp16.
// Every route masks the ragged edge itself (zero fill), so no padding copy
// is made for any (M, N, K), and adds an optional C once in the
// accumulator type before one rounding: matmul_accumulate (c + a@b) is one
// launch.
//
// C interface (bound with ctypes): every entry point takes device pointers,
// the sizes and a cudaStream_t, launches on that stream without
// synchronising, and returns cudaGetLastError() (0 on success).  c may be
// NULL.  bind_gemm_route says which route a problem takes.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "gemm_routes.cuh"

namespace {

using namespace bind_gemm;

template <typename T>
__global__ void __launch_bounds__(SIMT_THREADS)
gemm_simt_kernel(const Problem<T> p) {
  extern __shared__ __align__(16) unsigned char simt_smem[];
  simt_tile<T>(p, simt_smem);
}

__global__ void __launch_bounds__(WG_THREADS)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb,
                  const Problem<__nv_bfloat16> p) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  wgmma_tile(&ta, &tb, p, wg_smem);
}

__global__ void __launch_bounds__(DM_THREADS)
gemm_dmma_kernel(const Problem<double> p) {
  extern __shared__ __align__(16) unsigned char dm_smem[];
  dmma_tile(p, dm_smem);
}

template <typename T>
Problem<T> problem(const void* a, const void* b, const void* c, void* out,
                   int64_t M, int64_t N, int64_t K) {
  return Problem<T>{static_cast<const T*>(a), 0, static_cast<const T*>(b), 0,
                    static_cast<const T*>(c), static_cast<T*>(out), M, N, K,
                    1};
}

// float64 has no CUDA-core route: no simt kernel is instantiated for it
template <typename T>
int run(const void* a, const void* b, const void* c, void* out, int64_t M,
        int64_t N, int64_t K, void* stream) {
  const Problem<T> p = problem<T>(a, b, c, out, M, N, K);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same_v<T, double>)
    return static_cast<int>(
        launch(p, st, nullptr, gemm_wgmma_kernel, gemm_dmma_kernel));
  else
    return static_cast<int>(launch(p, st, gemm_simt_kernel<T>,
                                   gemm_wgmma_kernel, gemm_dmma_kernel));
}

}  // namespace

extern "C" {

int bind_gemm_f32(const void* a, const void* b, const void* c, void* out,
                  int64_t M, int64_t N, int64_t K, void* stream) {
  return run<float>(a, b, c, out, M, N, K, stream);
}

int bind_gemm_bf16(const void* a, const void* b, const void* c, void* out,
                   int64_t M, int64_t N, int64_t K, void* stream) {
  return run<__nv_bfloat16>(a, b, c, out, M, N, K, stream);
}

int bind_gemm_f64(const void* a, const void* b, const void* c, void* out,
                  int64_t M, int64_t N, int64_t K, void* stream) {
  return run<double>(a, b, c, out, M, N, K, stream);
}

int bind_gemm_f16(const void* a, const void* b, const void* c, void* out,
                  int64_t M, int64_t N, int64_t K, void* stream) {
  return run<__half>(a, b, c, out, M, N, K, stream);
}

// The route (bind_gemm::Route) a problem of element type dtype (0:
// float32, 1: bfloat16, 2: float64, 3: float16; kernel.py DTYPE_CODES)
// takes, for a chain with level strides a_stride and b_stride in elements
// (0 for the GEMM); -1 for another type.
int bind_gemm_route(int dtype, const void* a, int64_t a_stride,
                    const void* b, int64_t b_stride, int64_t M, int64_t N,
                    int64_t K) {
  switch (dtype) {
    case 3: return route_of(Problem<__half>{
        static_cast<const __half*>(a), a_stride, static_cast<const __half*>(b),
        b_stride, nullptr, nullptr, M, N, K, 1});
    case 0: return route_of(Problem<float>{
        static_cast<const float*>(a), a_stride, static_cast<const float*>(b),
        b_stride, nullptr, nullptr, M, N, K, 1});
    case 1: return route_of(Problem<__nv_bfloat16>{
        static_cast<const __nv_bfloat16*>(a), a_stride,
        static_cast<const __nv_bfloat16*>(b), b_stride, nullptr, nullptr, M,
        N, K, 1});
    case 2: return route_of(Problem<double>{
        static_cast<const double*>(a), a_stride,
        static_cast<const double*>(b), b_stride, nullptr, nullptr, M, N, K,
        1});
    default: return -1;
  }
}

}  // extern "C"
