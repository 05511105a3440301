// Which tile loop runs a GEMM problem, and its launch: shared by
// csrc/gemm.cu (one level) and the chain kernel (many), so that a chain
// and its per-level replay take the same route at every level.
//
// The route is a pure function of the dtype, the sizes and the operands'
// alignment (kernels/gemm/ops.py route() is the same rule in Python, and
// bind_gemm_route in gemm.cu answers it for any operands):
//
//   F32_3XTF32  float32 whose A and B the 16-byte loads can read: both
//               bases 16-byte aligned, K and N multiples of 4 (rows of
//               whole 16-byte chunks), K > 0, level strides multiples of 4
//               elements: the TF32 tensor cores, three products
//               (gemm_tf32.cuh);
//   F32_SIMT    any other float32: the CUDA cores (gemm_tile.cuh), any
//               shape;
//   BF16_WGMMA  bfloat16 whose A and B TMA can read: both bases 16-byte
//               aligned, K and N multiples of 8 (row strides multiples of
//               16 bytes), K > 0, level strides multiples of 16 bytes;
//   BF16_SIMT   any other bfloat16: the CUDA-core loop, fp32 accumulator;
//   F64_DMMA    float64: the f64 tensor cores (gemm_dmma.cuh), any shape;
//   F16_SIMT    any other float16: the CUDA-core loop, fp32 accumulator,
//               as bf16_simt;
//   F16_WGMMA   float16 under bfloat16's TMA rule: the same tile loop
//               (gemm_wgmma.cuh) with f16 operands.
//
// Each .cu file defines its own __global__ kernels around the shared tile
// loops (so a profile tells the GEMM's launches from the chain kernel's)
// and hands them to launch() below.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "gemm_dmma.cuh"
#include "gemm_tf32.cuh"
#include "gemm_tile.cuh"
#include "gemm_wgmma.cuh"

namespace bind_gemm {

enum Route : int {
  F32_SIMT = 0, BF16_SIMT = 1, BF16_WGMMA = 2, F64_DMMA = 3, F16_SIMT = 4,
  F32_3XTF32 = 5, F16_WGMMA = 6
};

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, typename O>
inline Route route_of(const Problem<T, O>& p) {
  if constexpr (std::is_same_v<T, float>) {
    const bool tc = aligned16(p.A) && aligned16(p.B) && p.K > 0 &&
                    p.K % 4 == 0 && p.N % 4 == 0 && p.a_stride % 4 == 0 &&
                    p.b_stride % 4 == 0;
    return tc ? F32_3XTF32 : F32_SIMT;
  } else if constexpr (std::is_same_v<T, double>) {
    return F64_DMMA;
  } else {
    const bool tma = aligned16(p.A) && aligned16(p.B) && p.K > 0 &&
                     p.K % 8 == 0 && p.N % 8 == 0 && p.a_stride % 8 == 0 &&
                     p.b_stride % 8 == 0;
    if constexpr (std::is_same_v<T, __half>)
      return tma ? F16_WGMMA : F16_SIMT;
    else
      return tma ? BF16_WGMMA : BF16_SIMT;
  }
}

inline unsigned blocks(int64_t n, int tile) {
  return static_cast<unsigned>((n + tile - 1) / tile);
}

// kernel<<<grid, threads, smem, stream>>>(args...), raising the kernel's
// dynamic shared-memory limit first when smem needs it
template <typename Kernel, typename... Args>
cudaError_t start(Kernel kernel, dim3 grid, int threads, size_t smem,
                  cudaStream_t stream, const Args&... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Launch problem p on its route: simt(Problem<T, O>) for F32_SIMT /
// BF16_SIMT / F16_SIMT, wgmma(map A, map B, Problem<T, O>) for
// BF16_WGMMA / F16_WGMMA, dmma(Problem<double, O>) for F64_DMMA,
// tf32(Problem<float, O>) for F32_3XTF32.  The output type O does not
// choose the route.  A kernel the element type never takes may be nullptr
// (its branch is not compiled).  Returns the launch's error (cudaSuccess
// when it went).
template <typename T, typename O, typename SimtK, typename WgmmaK,
          typename DmmaK, typename Tf32K>
cudaError_t launch(const Problem<T, O>& p, cudaStream_t stream, SimtK simt,
                   WgmmaK wgmma, DmmaK dmma, Tf32K tf32) {
  if (p.M <= 0 || p.N <= 0 || p.L <= 0) return cudaGetLastError();
  if constexpr (std::is_same_v<T, double>) {
    return start(dmma, dim3(blocks(p.N, DM_BN), blocks(p.M, DM_BM)),
                 DM_THREADS, DM_SMEM, stream, p);
  } else {
    if constexpr (std::is_same_v<T, float>) {
      if (route_of(p) == F32_3XTF32)
        return start(tf32, dim3(blocks(p.N, TF_BN), blocks(p.M, TF_BM)),
                     TF_THREADS, TF_SMEM, stream, p);
    }
    if constexpr (std::is_same_v<T, __nv_bfloat16> ||
                  std::is_same_v<T, __half>) {
      const Route r = route_of(p);
      if (r == BF16_WGMMA || r == F16_WGMMA) {
        CUtensorMap ta, tb;
        constexpr CUtensorMapDataType type = WgElem<T>::TMA;
        cudaError_t err = make_map(&ta, type, p.A, p.M, p.K,
                                   p.a_stride != 0 ? p.L : 1, p.a_stride);
        if (err == cudaSuccess)
          err = make_map(&tb, type, p.B, p.K, p.N,
                         p.b_stride != 0 ? p.L : 1, p.b_stride);
        if (err != cudaSuccess) return err;
        return start(wgmma, dim3(blocks(p.N, WG_BN), blocks(p.M, WG_BM)),
                     WG_THREADS, WG_SMEM, stream, ta, tb, p);
      }
    }
    return start(simt, dim3(blocks(p.N, SIMT_BN), blocks(p.M, SIMT_BM)),
                 SIMT_THREADS, SIMT_SMEM, stream, p);
  }
}

}  // namespace bind_gemm
