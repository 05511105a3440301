// Tiled GEMM for Hopper (sm_90a): out = A @ B (+ C), row-major, one launch.
//
// Replaces the TPU kernel src/repro/kernels/gemm/kernel.py:47 matmul_pallas
// (body _matmul_kernel): C = A @ B with an fp32 accumulator over a
// sequential K grid axis and one store.  Here the blocks of the 2-D grid run
// in parallel in no order, so the TPU's sequential K axis becomes a loop
// over K inside each block, and the accumulator lives in registers instead
// of VMEM scratch.
//
// Each dtype has its own routes (gemm_routes.cuh), each a tile loop shared
// with the chain kernel:
//   * float32 on the TF32 tensor cores in 3xTF32 (gemm_tf32.cuh) when its
//     operands take 16-byte loads (16-byte-aligned A and B, K and N
//     multiples of 4): each operand split into a TF32 hi and lo, three
//     wgmma products a k8 step (hi.hi, hi.lo, lo.hi), each 32-wide K panel
//     summed from zero in its own accumulators and added to the sum in
//     registers with IEEE adds.  Bound on an H100: operations, three TF32
//     products at 495 TFLOP/s, 0.0130 ms at the main path's 1024^3 leaf
//     (2.1 GFLOP against 12 MB).  Every float32 result of this route is
//     within a few times the CUDA-core route's error of the exact
//     product, but no longer that route's bits;
//   * other float32 on the CUDA cores (gemm_tile.cuh): IEEE fp32 FMAs in
//     a pipelined loop (cp.async ring, 8x4 micro-tile, 16-byte shared
//     loads), any shape and alignment.  Bound: operations, 67 TFLOP/s;
//     the loop issues 12 shared loads per 128 FMAs, so FMA issue, not
//     shared memory, is what it runs into;
//   * bfloat16 on the tensor cores (gemm_wgmma.cuh): wgmma fed by TMA, fp32
//     accumulators; operands TMA cannot read (misaligned, odd row strides)
//     take the CUDA-core loop instead.  Bound: 989 TFLOP/s, so at 1024^3
//     the latency of the K loop and the loads, which the TMA ring hides;
//   * float64 on the f64 tensor cores (gemm_dmma.cuh): DMMA m16n8k16.
//     Bound: operations, 67 TFLOP/s; shared-memory reads of the DMMA
//     operands come close to it first;
//   * float16 on the tensor cores by bfloat16's rule and tile loop
//     (gemm_wgmma.cuh, f16 operands; same bound), and on the CUDA-core
//     loop where TMA cannot read the operands: converted to fp32 on the
//     way in and accumulated in fp32, rounded once to fp16.
// Every route masks the ragged edge itself (zero fill), so no padding copy
// is made for any (M, N, K), and adds an optional C once in the
// accumulator type before one rounding: matmul_accumulate (c + a@b) is one
// launch.
//
// Every route writes the accumulator, rounded once, in the output type
// its caller asks for (matmul's out_dtype: float32, bfloat16, float64 or
// float16 for any of the four input types; c, when given, is of the
// output type).  The output type does not choose the route; with the
// input's own type as output each route runs the same code as the chain
// kernel's (gemm_routes.cuh).
//
// C interface (bound with ctypes): every entry point takes device pointers,
// the sizes, the output type's code and a cudaStream_t, launches on that
// stream without synchronising, and returns cudaGetLastError() (0 on
// success).  c may be NULL.  bind_gemm_route says which route a problem
// takes.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "gemm_routes.cuh"

namespace {

using namespace bind_gemm;

template <typename T, typename O>
__global__ void __launch_bounds__(SIMT_THREADS)
gemm_simt_kernel(const Problem<T, O> p) {
  extern __shared__ __align__(16) unsigned char simt_smem[];
  simt_tile<T, O>(p, simt_smem);
}

template <typename T, typename O>
__global__ void __launch_bounds__(WG_THREADS)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb,
                  const Problem<T, O> p) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  wgmma_tile<T, O>(&ta, &tb, p, wg_smem);
}

template <typename O>
__global__ void __launch_bounds__(DM_THREADS)
gemm_dmma_kernel(const Problem<double, O> p) {
  extern __shared__ __align__(16) unsigned char dm_smem[];
  dmma_tile<O>(p, dm_smem);
}

template <typename O>
__global__ void __launch_bounds__(TF_THREADS)
gemm_tf32_kernel(const Problem<float, O> p) {
  extern __shared__ __align__(1024) unsigned char tf_smem[];
  tf32_tile<O>(p, tf_smem);
}

// each input type's kernels only: float64 has no CUDA-core route, float32
// no wgmma one, the 16-bit types neither DMMA nor 3xTF32
template <typename T, typename O>
int run(const void* a, const void* b, const void* c, void* out, int64_t M,
        int64_t N, int64_t K, void* stream) {
  const Problem<T, O> p{static_cast<const T*>(a), 0,
                        static_cast<const T*>(b), 0,
                        static_cast<const O*>(c), static_cast<O*>(out),
                        M, N, K, 1};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same_v<T, double>)
    return static_cast<int>(launch(p, st, nullptr, nullptr,
                                   gemm_dmma_kernel<O>, nullptr));
  else if constexpr (std::is_same_v<T, float>)
    return static_cast<int>(launch(p, st, gemm_simt_kernel<T, O>, nullptr,
                                   nullptr, gemm_tf32_kernel<O>));
  else
    return static_cast<int>(launch(p, st, gemm_simt_kernel<T, O>,
                                   gemm_wgmma_kernel<T, O>, nullptr,
                                   nullptr));
}

// run<T, O> for the output-type code out_dtype (the element-type codes of
// bind_gemm_route); cudaErrorInvalidValue for another code
template <typename T>
int run_to(int out_dtype, const void* a, const void* b, const void* c,
           void* out, int64_t M, int64_t N, int64_t K, void* stream) {
  switch (out_dtype) {
    case 0: return run<T, float>(a, b, c, out, M, N, K, stream);
    case 1: return run<T, __nv_bfloat16>(a, b, c, out, M, N, K, stream);
    case 2: return run<T, double>(a, b, c, out, M, N, K, stream);
    case 3: return run<T, __half>(a, b, c, out, M, N, K, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// out (of the type out_dtype names) = a @ b (+ c, of out's type)
int bind_gemm_f32(const void* a, const void* b, const void* c, void* out,
                  int64_t M, int64_t N, int64_t K, int out_dtype,
                  void* stream) {
  return run_to<float>(out_dtype, a, b, c, out, M, N, K, stream);
}

int bind_gemm_bf16(const void* a, const void* b, const void* c, void* out,
                   int64_t M, int64_t N, int64_t K, int out_dtype,
                   void* stream) {
  return run_to<__nv_bfloat16>(out_dtype, a, b, c, out, M, N, K, stream);
}

int bind_gemm_f64(const void* a, const void* b, const void* c, void* out,
                  int64_t M, int64_t N, int64_t K, int out_dtype,
                  void* stream) {
  return run_to<double>(out_dtype, a, b, c, out, M, N, K, stream);
}

int bind_gemm_f16(const void* a, const void* b, const void* c, void* out,
                  int64_t M, int64_t N, int64_t K, int out_dtype,
                  void* stream) {
  return run_to<__half>(out_dtype, a, b, c, out, M, N, K, stream);
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
