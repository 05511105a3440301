// What the 3xTF32 tile loops share: the float32 GEMM's (gemm_tf32.cuh) and
// flash attention's forward and backward (attn_tf32.cuh and the headers
// that draw on it).  Each splits an operand x into hi = tf32_rna(x) and a
// lo half, x - hi, and sums hi.hi + hi.lo + lo.hi in TF32 wgmma.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bind_tf32 {

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: for every finite x and +-inf the bits of (x + 0x1000) & ~0x1FFF on
// x's bits (a finite x within half a TF32 step of float32's largest
// becomes +-inf).  A NaN keeps its top 10 mantissa bits, so it stays a NaN
// unless all 10 are 0 (a signalling NaN of a small payload, which reads as
// +-inf, as the tensor cores read it).
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

// the threads' shared-memory stores, visible to the tensor cores' reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps the compiler from moving register accesses across an asm barrier
template <int N> __device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

}  // namespace bind_tf32
