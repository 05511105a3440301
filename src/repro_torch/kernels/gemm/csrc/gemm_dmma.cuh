// The float64 route of the hand-written GEMM: the f64 tensor cores (DMMA),
// mma.sync.aligned.m16n8k16.row.col.f64, shared by csrc/gemm.cu and the
// chain kernel through gemm_routes.cuh.
//
// What bounds it on an H100: the f64 tensor cores, 67 TFLOP/s (the CUDA
// cores give half that in f64).  A 1024^3 product is 2.1 GFLOP against
// 24 MB of operands, far above the ridge point, so operations bound it in
// principle, but shared memory comes close first: every operand a DMMA
// takes is read from shared memory by each warp that needs it, 8 bytes a
// lane, so the warp tile sets the bytes per FLOP.  Here each warp
// owns a 32x32 output tile (2 x 4 DMMA tiles of 16x8, 32 f64 accumulators
// per thread) and reads 32 f64 fragments per 8 DMMAs of depth 16: 4 FLOP
// per byte read from shared memory, so the SM's 128 bytes a cycle (which
// the cp.async stores share) feed at most twice the tensor cores' 256 FLOP
// a cycle.  A larger warp tile would raise that but needs more registers
// than a thread has beside the fragments.  m16n8k16 is the deepest f64 shape, the most work for one
// instruction (Ampere's m8n8k4 does an eighth of it).
//
// dmma_tile: one block of 128 threads (2x2 warps) owns a 64x64 output
// tile (1024^2 gives 256 blocks, two per SM).  K panels of 16 go through
// a ring of three stages in shared memory, filled with cp.async (16-byte
// chunks when the operand allows, else 8 bytes per element; zero-filled
// past the ragged edge, so any shape and offset is taken; gemm_tile.cuh
// PanelLoader) while the DMMAs of the panel before run; one
// __syncthreads() per panel.  Rows are padded by 4 doubles so that every
// fragment load is free of bank conflicts.  The sum over K starts from 0
// in fp64; the epilogue adds C once and stores (gemm_tile.cuh
// store_level).

#pragma once

#include <cstdint>

#include "gemm_tile.cuh"

namespace bind_gemm {

constexpr int DM_BM = 64;
constexpr int DM_BN = 64;
constexpr int DM_BK = 16;
constexpr int DM_KD = 16;        // depth of one DMMA: m16n8k{4,8,16}
constexpr int DM_STAGES = 3;
constexpr int DM_MT = 2;         // 16-row DMMA tiles a warp
constexpr int DM_NT = 4;         // 8-column DMMA tiles a warp
constexpr int DM_WM = 16 * DM_MT;
constexpr int DM_WN = 8 * DM_NT;
constexpr int DM_WARPS_N = DM_BN / DM_WN;
constexpr int DM_THREADS = 32 * (DM_BM / DM_WM) * DM_WARPS_N;
constexpr int DM_PAD = 4;

struct __align__(16) DmmaStage {
  double As[DM_BM][DM_BK + DM_PAD];   // A panel: As[m][k]
  double Bs[DM_BK][DM_BN + DM_PAD];   // B panel: Bs[k][n]
};
constexpr size_t DM_SMEM = DM_STAGES * sizeof(DmmaStage);   // 56,832 bytes

// d (16x8) += a (16xKD) @ b (KD x 8).  Per lane, g = lane / 4, t = lane % 4:
// a[i] = A[g + 8 (i % 2)][t + 4 (i / 2)], b[i] = B[t + 4 i][g],
// d[i] = D[g + 8 (i / 2)][2 t + i % 2]
__device__ __forceinline__ void dmma(double (&d)[4],
                                     const double (&a)[DM_KD / 2],
                                     const double (&b)[DM_KD / 4]) {
  if constexpr (DM_KD == 4) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  } else if constexpr (DM_KD == 8) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
          "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  }
}

// The f64 route.  All DM_THREADS threads call it, with DM_SMEM bytes of
// dynamic shared memory at ``smem``.
template <typename O = double>
__device__ __forceinline__ void dmma_tile(const Problem<double, O>& p,
                                          unsigned char* smem) {
  DmmaStage* sm = reinterpret_cast<DmmaStage*>(smem);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = (warp / DM_WARPS_N) * DM_WM;   // the warp's part of the tile
  const int wn = (warp % DM_WARPS_N) * DM_WN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * DM_BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * DM_BN;
  const int64_t nk = p.K > 0 ? (p.K + DM_BK - 1) / DM_BK : 1;
  const int64_t total = nk * p.L;

  const PanelLoader<double, double, DM_BM, DM_BK, DM_BK + DM_PAD,
                    DM_THREADS>
      la(p.A, p.K, p.M, p.K, m0, 0, p.a_stride);
  const PanelLoader<double, double, DM_BK, DM_BN, DM_BN + DM_PAD,
                    DM_THREADS>
      lb(p.B, p.N, p.K, p.N, 0, n0, p.b_stride);
  int64_t ll = 0, lk0 = 0;
  int ls = 0;
  auto load_next = [&]() {
    la.load(sm[ls].As, p.A, ll * p.a_stride, 0, lk0);
    lb.load(sm[ls].Bs, p.B, ll * p.b_stride, lk0, 0);
    lk0 += DM_BK;
    if (lk0 >= nk * DM_BK) { lk0 = 0; ++ll; }
    if (++ls == DM_STAGES) ls = 0;
  };
#pragma unroll
  for (int s = 0; s < DM_STAGES - 1; ++s) {
    if (s < total) load_next();
    cp_async_commit();
  }

  double acc[DM_MT][DM_NT][4];
#pragma unroll
  for (int i = 0; i < DM_MT; ++i)
#pragma unroll
    for (int j = 0; j < DM_NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0;

  int cs = 0;
  int64_t ck = 0, cl = 0;
  for (int64_t step = 0; step < total; ++step) {
    cp_async_wait<DM_STAGES - 2>();
    __syncthreads();
    if (step + DM_STAGES - 1 < total) load_next();
    cp_async_commit();
    const DmmaStage& s = sm[cs];
#pragma unroll
    for (int k0 = 0; k0 < DM_BK; k0 += DM_KD) {
      double a[DM_MT][DM_KD / 2], b[DM_NT][DM_KD / 4];
#pragma unroll
      for (int i = 0; i < DM_MT; ++i)
#pragma unroll
        for (int r = 0; r < DM_KD / 2; ++r)
          a[i][r] = s.As[wm + 16 * i + g + 8 * (r % 2)][k0 + t + 4 * (r / 2)];
#pragma unroll
      for (int j = 0; j < DM_NT; ++j)
#pragma unroll
        for (int r = 0; r < DM_KD / 4; ++r)
          b[j][r] = s.Bs[k0 + t + 4 * r][wn + 8 * j + g];
#pragma unroll
      for (int i = 0; i < DM_MT; ++i)
#pragma unroll
        for (int j = 0; j < DM_NT; ++j) dmma(acc[i][j], a[i], b[j]);
    }
    if (++cs == DM_STAGES) cs = 0;
    if (++ck == nk) {
#pragma unroll
      for (int i = 0; i < DM_MT; ++i)
#pragma unroll
        for (int j = 0; j < DM_NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int64_t gm = m0 + wm + 16 * i + g + 8 * (r / 2);
            const int64_t gn = n0 + wn + 8 * j + 2 * t + r % 2;
            if (gm < p.M && gn < p.N) store_level(p, cl, gm, gn, acc[i][j][r]);
            acc[i][j][r] = 0.0;
          }
      ck = 0;
      ++cl;
    }
  }
}

}  // namespace bind_gemm
