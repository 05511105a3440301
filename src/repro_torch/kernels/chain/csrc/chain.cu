// Chain kernels for Hopper (sm_90a): a whole fused chain of one tagged op
// body in one launch, the carry kept in registers (or, on chain_dot's
// tensor-core routes, in the block's own output tile) from the first level
// to the last.
//
// Replaces the TPU kernel src/repro/core/executable_cache.py:242
// lookup_chain_pallas (the pallas_call at :313), which traces any body
// tagged __bind_kernel__ into one Pallas kernel: a fori_loop over the
// levels, the carry resident, chain-invariant ("single") operands loaded
// once, per-level "xs" / "xs_const" operands loaded per level, constants
// static.  A CUDA kernel cannot trace a Python body, so there is one kernel
// per tagged body the port has:
//
//   * chain_ewise, for kernels/linear_scan/ops.py scan_step (y <- a*y + x):
//     each thread owns one element of the carry and runs every level on it
//     in registers.  An operand of the body is the carry, a "single"
//     tensor of the carry's shape (read once), an "xs" stack (read per
//     level), a "const" scalar, or an "xs_const" per-level scalar array.
//     Bitwise equality with per-level serial replay is the contract.  Eager
//     PyTorch runs a*y + x as two launches, each rounded to the carry type
//     in the operator's math type (float for f32, bf16 and f16, double for
//     f64), with a Python scalar converted straight to that math type.  So
//     the kernel multiplies with __fmul_rn / __dmul_rn and adds with
//     __fadd_rn / __dadd_rn (never contracted into an FMA, whatever --fmad
//     says), rounds to bf16 / f16 after each of the two for bf16 / f16
//     (round_to), and takes constants as doubles converted to the math
//     type.
//     Bound on an H100: bytes.  It does 2 operations per element and
//     level; at 1024^2 f32 over 64 levels it moves 12.6 MB with a single x
//     (3.8 us at 3.35 TB/s) and 276.8 MB with a per-level x (82.6 us).
//     What held it back was instruction issue, not bytes: a switch on each
//     operand's kind for every element and level, about 30 instructions
//     where the body needs 2 (4 in bf16), and no xs load issued before the
//     level that uses it.  So there is one kernel per layout: the class of
//     each position (the carry, a value held from before the loop, a
//     per-level tensor, a per-level scalar) is a template argument, chosen
//     on the host (18 kernels a dtype: the carry at position 0 or 2, the
//     other two each in one of three classes; "single" and "const" share a
//     class, both loaded once; a carry at position 1 runs the carry-at-0
//     kernel with y and a swapped).  A thread takes 16 / sizeof(T)
//     neighbouring elements with 16-byte loads when every tensor is
//     16-byte aligned and n is a multiple of that, one element otherwise;
//     the levels run in groups of 8 whose xs loads all go out before the
//     group's dependent chain, and the grid is at most what the card holds
//     resident (2048 threads on each SM), so a per-level x streams with 8
//     loads a thread in flight.  The rounding sequence is the one above,
//     element by element and level by level, whatever the grouping.
//
//   * chain_dot, for kernels/gemm/ops.py gemm_tile (c <- c + a @ b): the
//     hand-written GEMM with a level loop outside its K loop.  It takes the
//     GEMM's route for the dtype and alignment (gemm_routes.cuh: f32 on the
//     TF32 tensor cores in 3xTF32 when 16-byte loads can read the operands
//     and on the CUDA cores otherwise, bf16 and f16 on the tensor cores with
//     wgmma and TMA or, when TMA cannot read the operands, on the CUDA
//     cores, f64 on the f64 tensor cores) and runs its tile loop with the
//     levels as one stream of K panels.  Each block owns an output tile
//     for the whole chain; per level it sums that level's A and B
//     ("single" or "xs") over K from 0,
//     adds the carry in the accumulator type and rounds to the carry's
//     type, as per-level matmul_accumulate does.  The carry stays in
//     registers on the CUDA-core route; on the tensor-core routes, whose
//     accumulators fill the registers, it lives in out, which the block
//     alone owns (the thread that wrote an element at one level reads it
//     at the next).  Per-level replay launches the same tile
//     loop with one level, so the two are bitwise equal in every dtype.
//     Bound on an H100: operations; 8 levels of 1024^3 f32 are 17.2 GFLOP,
//     0.104 ms as three TF32 products at 495 TFLOP/s (0.256 ms at the 67
//     TFLOP/s f32 rate outside the tensor cores, which a misaligned chain
//     takes).
//
//   * chain_attn, for kernels/flash_attention/ops.py attn_step (o <- o +
//     softmax(q k^T / sqrt(d)) v), one of seven routes, a pure function of
//     the dtype, d, dv, N and the alignment of every level's q, k and v
//     (attn_route below; kernels/chain/ops.py attn_route is the same rule
//     in Python, and bind_chain_route_attn answers it for any operands):
//
//       F32_3XTF32  float32 with d == dv in {32, 64, 80, 96, 128}, N >= 1
//                   and every level's q, k, v 16-byte aligned: flash
//                   attention's 3xTF32 block (chain_attn_tc.cuh);
//       BF16_WGMMA  bfloat16 with d == dv in {64, 80, 96, 128, 192, 256},
//                   N >= 1 and every level's q, k, v 16-byte aligned (TMA
//                   reads them): flash attention's wgmma block;
//       F16_WGMMA   float16 where BF16_WGMMA takes bfloat16;
//       F32_SIMT, BF16_SIMT, F16_SIMT, F64_SIMT  everything else: the
//                   CUDA-core loop below, unchanged.
//
//     chain_attn_tc.cuh says how the tensor-core routes split each level's
//     keys into chunks and merge them; this note is the CUDA-core loop's.
//     It is the flash-attention tile loop
//     (flash_attention/csrc/attn_tile.cuh, shared with flash_attention.cu),
//     level-parallel.  A level's acc / l depends only on that level's q, k
//     and v (the softmax state is reset at every level), never on the
//     carry; only the carry's update carry = round_T(carry + acc / l) must
//     run in level order.  So the grid is (row tile, level): block (r, l)
//     stages level l's q (or the shared one), sweeps level l's keys with
//     the online softmax, unmasked, and writes acc / l in the accumulator
//     type to a workspace of n_levels x M x dv; the last block of a row
//     tile to finish (a __threadfence and an atomic counter per row tile;
//     that block sets its counter back to 0, so no launch clears them)
//     adds the workspace into the carry in level order, rounding to the
//     carry's type after each level, and writes out.  The arithmetic per
//     element and the order of the carry's sum are those of the loop over
//     levels in one block that this kernel was, so it is bit for bit that
//     kernel in every dtype, and per-level serial replay (attn_step on a
//     CUDA tensor: this kernel with one level) stays bitwise equal.
//     Bound on an H100: operations; a 512-row Qwen3-14B query tile over 16
//     levels of 512 keys at d = dv = 128 is 2.1 GFLOP, 0.032 ms at 67
//     TFLOP/s.  What held the loop back was parallelism, not arithmetic:
//     ceil(m / 64) = 8 blocks on 132 SMs.  Level-parallel, that tile is 128
//     blocks (one wave: two of 83 KB fit on an SM), each one level's 16.8
//     MFLOP; the ordered sum reads 4 MB of workspace once.  This loop stays
//     on the CUDA cores in every dtype (fp32 FMA for f32, bf16 and f16,
//     fp64 for f64), so replay and the chain keep their bits.
//     The workspace grows with the chain: M x dv accumulators a level
//     (256 KB for that f32 tile, 8 MB for an 8192 x 128 f64 carry; on the
//     tensor-core routes S x M x (dv + 2) floats).  The wrapper bounds it
//     (kernels/chain/kernel.py WORKSPACE_BYTES, 64 MiB): a longer chain is
//     several launches of as many levels as fit, each starting from the
//     carry the last one wrote, which is the carry this kernel holds
//     anyway (rounded to T at every level), so the bits do not change.
//     Levels cannot be folded into partial sums instead: the carry is
//     rounded after every level.  Every block of this loop loads its row
//     tile's carry (32 KB of f32 from L2 at that tile, against the 1 MB of
//     k and v it reads), though only the last uses it, so that the sweep
//     runs under the same register pressure as in the loop over levels
//     (and keeps the bits ptxas's contractions give it).

// C interface (bound with ctypes): device pointers, sizes and a
// cudaStream_t; each entry point launches on that stream without
// synchronising and returns cudaGetLastError() (0 on success).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "../../flash_attention/csrc/attn_tile.cuh"
#include "../../gemm/csrc/gemm_routes.cuh"
#include "chain_attn_tc.cuh"

// chain_attn's tensor-core kernels are instantiated in chain_attn_tf32.cu
// and chain_attn_wgmma.cu, translation units of this library's own that
// kernels/_build.py compiles beside this one, in parallel: here they took
// the library's build from ~57 to ~82 s, the longest of the five
extern template cudaError_t bind_chain_tc::launch<float>(
    bind_chain_tc::Problem<float>, int, cudaStream_t);
extern template cudaError_t bind_chain_tc::launch<__nv_bfloat16>(
    bind_chain_tc::Problem<__nv_bfloat16>, int, cudaStream_t);
extern template cudaError_t bind_chain_tc::launch<__half>(
    bind_chain_tc::Problem<__half>, int, cudaStream_t);

namespace {

using namespace bind_gemm;

// ---------------------------------------------------------------- ewise --

// operand kinds; the numbering is the wrapper's (kernels/chain/kernel.py)
constexpr int CARRY = 0;
constexpr int SINGLE = 1;
constexpr int XS = 2;
constexpr int CONST = 3;
constexpr int XS_CONST = 4;

// what the level loop does with an operand, a template argument per
// position: the carry itself, a value held from before the loop (a SINGLE
// tensor or a CONST scalar), a per-level tensor (XS) or a per-level scalar
// (XS_CONST).  ewise_class maps each kind to its class.
constexpr int C_CARRY = 0;
constexpr int C_HELD = 1;
constexpr int C_XS = 2;
constexpr int C_XS_CONST = 3;

constexpr int EWISE_THREADS = 256;
constexpr int EWISE_UNROLL = 8;      // levels whose xs loads go out together

// the math type of one eager operator: float for f32, bf16 and f16,
// double for f64 (the GEMM's accumulator type)
template <typename T> using Math = typename AccType<T>::type;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// the result of one eager operator: rounded to the element type, back in
// the math type
template <typename T> __device__ __forceinline__ Math<T> round_to(Math<T> v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <> __device__ __forceinline__ float round_to<__half>(float v) {
  return __half2float(__float2half_rn(v));
}

// a Python scalar (passed as a double) in the math type
__device__ __forceinline__ float scalar_to(double s, float) {
  return __double2float_rn(s);
}
__device__ __forceinline__ double scalar_to(double s, double) { return s; }

struct Operand {
  const void* ptr;
  int kind;
  double scalar;
};

// W elements of a tensor from element e on, in the math type: one 16-byte
// load when W > 1 (the launcher checked the alignment)
template <typename T, int W>
__device__ __forceinline__ void load_w(const T* p, int64_t e,
                                       Math<T> (&dst)[W]) {
  if constexpr (W == 1) {
    dst[0] = to_acc(p[e]);
  } else {
    static_assert(W * sizeof(T) == 16, "one 16-byte chunk");
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p + e));
    const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int w = 0; w < W; ++w) dst[w] = to_acc(t[w]);
  }
}

// the values of an operand of class C held before the level loop (the
// carry's initial value for C_CARRY)
template <typename T, int C, int W>
__device__ __forceinline__ void load_held(const Operand& o, int64_t e,
                                          Math<T> (&dst)[W]) {
  if constexpr (C == C_CARRY || C == C_HELD) {
    if (C == C_HELD && o.kind == CONST) {
#pragma unroll
      for (int w = 0; w < W; ++w) dst[w] = scalar_to(o.scalar, Math<T>());
    } else {
      load_w<T, W>(static_cast<const T*>(o.ptr), e, dst);
    }
  }
}

// the per-level values of an operand of class C for levels l .. l + U - 1
// (those before n_levels): xs loads issued ahead of the chain they feed
template <typename T, int C, int W, int U>
__device__ __forceinline__ void load_levels(const Operand& o, int64_t e,
                                            int64_t n, int64_t l,
                                            int64_t n_levels,
                                            Math<T> (&dst)[U][W]) {
  if constexpr (C == C_XS) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (l + u < n_levels)
        load_w<T, W>(static_cast<const T*>(o.ptr) + (l + u) * n, e, dst[u]);
  } else if constexpr (C == C_XS_CONST) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (l + u < n_levels) {
        const Math<T> x = to_acc(static_cast<const T*>(o.ptr)[l + u]);
#pragma unroll
        for (int w = 0; w < W; ++w) dst[u][w] = x;
      }
  }
}

// the operand's value at level l + u for element w
template <int C, typename M, int W, int U>
__device__ __forceinline__ M value(M carry, const M (&held)[W],
                                   const M (&lv)[U][W], int u, int w) {
  if constexpr (C == C_CARRY) return carry;
  else if constexpr (C == C_HELD) return held[w];
  else return lv[u][w];
}

// W elements of the chain from element e on: v <- o1 * o0 + o2 (scan_step
// y <- a * y + x) n_levels times, where the operand of class C_CARRY is v
template <typename T, int C0, int C1, int C2, int W>
__device__ __forceinline__ void ewise_run(T* __restrict__ out,
                                          const Operand& o0,
                                          const Operand& o1,
                                          const Operand& o2, int64_t e,
                                          int64_t n, int64_t n_levels) {
  using M = Math<T>;
  constexpr int U = EWISE_UNROLL;
  M h0[W], h1[W], h2[W];
  load_held<T, C0, W>(o0, e, h0);
  load_held<T, C1, W>(o1, e, h1);
  load_held<T, C2, W>(o2, e, h2);
  M v[W];
#pragma unroll
  for (int w = 0; w < W; ++w)
    v[w] = C0 == C_CARRY ? h0[w] : (C1 == C_CARRY ? h1[w] : h2[w]);
  for (int64_t l = 0; l < n_levels; l += U) {
    M x0[U][W], x1[U][W], x2[U][W];
    load_levels<T, C0, W, U>(o0, e, n, l, n_levels, x0);
    load_levels<T, C1, W, U>(o1, e, n, l, n_levels, x1);
    load_levels<T, C2, W, U>(o2, e, n, l, n_levels, x2);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (l + u < n_levels) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const M y = value<C0>(v[w], h0, x0, u, w);
          const M a = value<C1>(v[w], h1, x1, u, w);
          const M x = value<C2>(v[w], h2, x2, u, w);
          v[w] = round_to<T>(add_rn(round_to<T>(mul_rn(a, y)), x));
        }
      }
    }
  }
  if constexpr (W == 1) {
    out[e] = from_acc<T>(v[0]);
  } else {
    uint4 raw;
    T* t = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int w = 0; w < W; ++w) t[w] = from_acc<T>(v[w]);
    *reinterpret_cast<uint4*>(out + e) = raw;
  }
}

// out = scan_step applied n_levels times to every element, one kernel per
// layout: the operand classes C0..C2 (exactly one C_CARRY) are template
// arguments, so the level loop holds no switch.  vec: every tensor operand
// and out 16-byte aligned and n a multiple of W (so every level's slice of
// an xs stack is too); then a thread takes W = 16 / sizeof(T) neighbouring
// elements with 16-byte loads, else one.
template <typename T, int C0, int C1, int C2>
__global__ void __launch_bounds__(EWISE_THREADS)
chain_ewise_kernel(T* __restrict__ out, Operand o0, Operand o1, Operand o2,
                   int64_t n, int64_t n_levels, bool vec) {
  constexpr int W = 16 / sizeof(T);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (vec) {
    for (int64_t g = first; g * W < n; g += stride)
      ewise_run<T, C0, C1, C2, W>(out, o0, o1, o2, g * W, n, n_levels);
  } else {
    for (int64_t e = first; e < n; e += stride)
      ewise_run<T, C0, C1, C2, 1>(out, o0, o1, o2, e, n, n_levels);
  }
}

// the class of kind k
inline int ewise_class(int k) {
  switch (k) {
    case CARRY: return C_CARRY;
    case XS: return C_XS;
    case XS_CONST: return C_XS_CONST;
    default: return C_HELD;      // SINGLE, CONST
  }
}

// the classes of a layout: the carry at CP, A and B at the other two
// positions in order
template <int CP, int A, int B> struct EwiseLayout {
  static constexpr int c0 = CP == 0 ? C_CARRY : A;
  static constexpr int c1 = CP == 1 ? C_CARRY : (CP == 0 ? A : B);
  static constexpr int c2 = CP == 2 ? C_CARRY : B;
};

inline int sm_count() {
  static const int count = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 132;
    return n;
  }();
  return count;
}

template <typename T, int CP, int A, int B>
cudaError_t launch_ewise_layout(T* out, const Operand (&o)[3], int64_t n,
                                int64_t n_levels, bool vec,
                                cudaStream_t stream) {
  using L = EwiseLayout<CP, A, B>;
  // enough blocks for every thread's elements, at most as many as are
  // resident on the card at once (2048 threads an SM); a grid-stride loop
  // takes the rest
  const int64_t per_thread = vec ? 16 / sizeof(T) : 1;
  const int64_t threads = (n + per_thread - 1) / per_thread;
  const int64_t want = (threads + EWISE_THREADS - 1) / EWISE_THREADS;
  const int64_t resident =
      static_cast<int64_t>(sm_count()) * (2048 / EWISE_THREADS);
  const unsigned grid = static_cast<unsigned>(want < resident ? want
                                                              : resident);
  chain_ewise_kernel<T, L::c0, L::c1, L::c2>
      <<<grid, EWISE_THREADS, 0, stream>>>(out, o[0], o[1], o[2], n,
                                           n_levels, vec);
  return cudaGetLastError();
}

template <typename T, int CP, int A>
cudaError_t ewise_pick_b(int b, T* out, const Operand (&o)[3], int64_t n,
                         int64_t n_levels, bool vec, cudaStream_t st) {
  switch (b) {
    case C_HELD:
      return launch_ewise_layout<T, CP, A, C_HELD>(out, o, n, n_levels, vec,
                                                   st);
    case C_XS:
      return launch_ewise_layout<T, CP, A, C_XS>(out, o, n, n_levels, vec,
                                                 st);
    case C_XS_CONST:
      return launch_ewise_layout<T, CP, A, C_XS_CONST>(out, o, n, n_levels,
                                                       vec, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int CP>
cudaError_t ewise_pick_a(int a, int b, T* out, const Operand (&o)[3],
                         int64_t n, int64_t n_levels, bool vec,
                         cudaStream_t st) {
  switch (a) {
    case C_HELD:
      return ewise_pick_b<T, CP, C_HELD>(b, out, o, n, n_levels, vec, st);
    case C_XS:
      return ewise_pick_b<T, CP, C_XS>(b, out, o, n, n_levels, vec, st);
    case C_XS_CONST:
      return ewise_pick_b<T, CP, C_XS_CONST>(b, out, o, n, n_levels, vec,
                                             st);
    default: return cudaErrorInvalidValue;
  }
}

// One kernel per layout with the carry at position 0 or 2, the other two
// positions in the classes C_HELD, C_XS, C_XS_CONST: 18 a dtype.  A carry
// at position 1 (scan_step's a) is launched as the carry at 0 with y and a
// swapped: the level computes round(a * y) with one IEEE multiply, which is
// commutative, so the bits are the same.
template <typename T>
int launch_ewise(void* out, const void* p0, int k0, double s0,
                 const void* p1, int k1, double s1, const void* p2, int k2,
                 double s2, int carry_pos, int64_t n, int64_t n_levels,
                 void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  Operand o[3] = {{p0, k0, s0}, {p1, k1, s1}, {p2, k2, s2}};
  if (carry_pos < 0 || carry_pos > 2 || o[carry_pos].kind != CARRY)
    return static_cast<int>(cudaErrorInvalidValue);
  if (carry_pos == 1) {
    const Operand y = o[0];
    o[0] = o[1];
    o[1] = y;
    carry_pos = 0;
  }
  // the classes of the two positions besides the carry, in order
  int cls[2], c = 0;
  bool vec = aligned16(out) && n % (16 / sizeof(T)) == 0;
  for (int p = 0; p < 3; ++p) {
    if (o[p].kind == SINGLE || o[p].kind == XS || o[p].kind == CARRY)
      vec = vec && aligned16(o[p].ptr);
    if (p != carry_pos) {
      if (o[p].kind == CARRY) return static_cast<int>(cudaErrorInvalidValue);
      cls[c++] = ewise_class(o[p].kind);
    }
  }
  T* dst = static_cast<T*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (carry_pos == 0)
    err = ewise_pick_a<T, 0>(cls[0], cls[1], dst, o, n, n_levels, vec, st);
  else
    err = ewise_pick_a<T, 2>(cls[0], cls[1], dst, o, n, n_levels, vec, st);
  return static_cast<int>(err);
}

// ------------------------------------------------------------------ dot --

// out = c + sum_l A_l @ B_l, the carry rounded to T after every level: the
// GEMM's route and tile loop (gemm_routes.cuh) with L levels, in kernels
// of this library's own names
template <typename T>
__global__ void __launch_bounds__(SIMT_THREADS)
chain_dot_simt_kernel(const Problem<T> p) {
  extern __shared__ __align__(16) unsigned char simt_smem[];
  simt_tile<T>(p, simt_smem);
}

template <typename T>
__global__ void __launch_bounds__(WG_THREADS)
chain_dot_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb,
                       const Problem<T> p) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  wgmma_tile(&ta, &tb, p, wg_smem);
}

__global__ void __launch_bounds__(DM_THREADS)
chain_dot_dmma_kernel(const Problem<double> p) {
  extern __shared__ __align__(16) unsigned char dm_smem[];
  dmma_tile(p, dm_smem);
}

__global__ void __launch_bounds__(TF_THREADS)
chain_dot_tf32_kernel(const Problem<float> p) {
  extern __shared__ __align__(1024) unsigned char tf_smem[];
  tf32_tile(p, tf_smem);
}

template <typename T>
int launch_dot(const void* c, const void* a, int64_t a_stride, const void* b,
               int64_t b_stride, void* out, int64_t M, int64_t N, int64_t K,
               int64_t n_levels, void* stream) {
  const Problem<T> p{static_cast<const T*>(a), a_stride,
                     static_cast<const T*>(b), b_stride,
                     static_cast<const T*>(c), static_cast<T*>(out),
                     M, N, K, n_levels};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // each dtype's kernels only, as the GEMM's run (gemm.cu)
  if constexpr (std::is_same_v<T, double>)   // no CUDA-core route for f64
    return static_cast<int>(launch(p, st, nullptr, nullptr,
                                   chain_dot_dmma_kernel, nullptr));
  else if constexpr (std::is_same_v<T, float>)
    return static_cast<int>(launch(p, st, chain_dot_simt_kernel<T>, nullptr,
                                   nullptr, chain_dot_tf32_kernel));
  else
    return static_cast<int>(launch(p, st, chain_dot_simt_kernel<T>,
                                   chain_dot_wgmma_kernel<T>, nullptr,
                                   nullptr));
}

// ----------------------------------------------------------------- attn --

// out = o after n_levels of o <- round(o + softmax(q_l k_l^T * scale) v_l);
// q_l = Q + l * q_stride (q_stride 0: the same q every level), likewise k, v.
// Block (r, y) computes the levels l = y, y + gridDim.y, ... of row tile r
// into work[l] (M x dv, the accumulator type); done[r] counts the blocks of
// row tile r that finished, and is 0 before and after the launch.
template <typename T, int NJ>
__global__ void __launch_bounds__(bind_attn::THREADS)
chain_attn_kernel(const T* __restrict__ O0, const T* __restrict__ Q,
                  int64_t q_stride, const T* __restrict__ K, int64_t k_stride,
                  const T* __restrict__ V, int64_t v_stride,
                  T* __restrict__ out, typename AccType<T>::type* work,
                  unsigned int* done, int64_t M, int64_t N, int d, int dv,
                  int64_t n_levels, typename AccType<T>::type scale) {
  using namespace bind_attn;
  using Acc = typename AccType<T>::type;
  using Sh = Tile<Acc, NJ>;
  constexpr int TM = Sh::TM, BQ = Sh::BQ, BKV = Sh::BKV;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last;
  Acc* Qt = reinterpret_cast<Acc*>(smem);
  Acc* KV = Qt + static_cast<size_t>(d) * (BQ + 1);
  Acc* P = KV + Sh::kv_elems(d);

  const int tx = threadIdx.x % LANES;
  const int ty = threadIdx.x / LANES;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * BQ;

  // the carry, rounded to T, in the accumulator type, held in registers
  // across the sweeps as the loop over levels held it (ptxas contracts
  // some of the sweep's multiplies and adds into FMAs by register
  // pressure, so the same pressure keeps the same bits); only the row
  // tile's last block adds into it
  Acc carry[TM][NJ];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t row = q0 + ty + LANES * i;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = tx + LANES * jj;
      carry[i][jj] = (row < M && col < dv) ? to_acc(O0[row * dv + col])
                                           : Acc(0);
    }
  }

  const Mask all{false, false, 0};
  const int64_t tiles = (N + BKV - 1) / BKV;
  Rows<Acc, NJ> st;
  for (int64_t l = blockIdx.y; l < n_levels; l += gridDim.y) {
    if (l == blockIdx.y || q_stride != 0)
      stage_transposed<BQ>(Q + l * q_stride, M, d, q0, Qt);
    st.reset();
    sweep<false, NJ>(K + l * k_stride, V + l * v_stride, N, d, dv, scale,
                     q0, 0, tiles, all, Qt, KV, P, st);
    Acc* w = work + l * M * dv;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t row = q0 + ty + LANES * i;
      const Acc safe = st.l[i] == Acc(0) ? Acc(1) : st.l[i];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int col = tx + LANES * jj;
        if (row < M && col < dv) w[row * dv + col] = st.acc[i][jj] / safe;
      }
    }
  }

  // the last block of the row tile adds the levels into the carry in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&done[blockIdx.x], 1u) + 1 == gridDim.y;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t row = q0 + ty + LANES * i;
    if (row >= M) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = tx + LANES * jj;
      if (col >= dv) continue;
      const Acc* w = work + row * dv + col;
      for (int64_t l = 0; l < n_levels; ++l)
        carry[i][jj] =
            to_acc(from_acc<T>(carry[i][jj] + __ldcg(w + l * M * dv)));
      out[row * dv + col] = from_acc<T>(carry[i][jj]);
    }
  }
  if (threadIdx.x == 0) done[blockIdx.x] = 0;
}

template <typename T, int NJ>
cudaError_t launch_attn_nj(const void* o, const void* q, int64_t q_stride,
                           const void* k, int64_t k_stride, const void* v,
                           int64_t v_stride, void* out, void* work,
                           void* done, int64_t M, int64_t N, int d, int dv,
                           int64_t n_levels, double scale,
                           cudaStream_t stream) {
  using Acc = typename AccType<T>::type;
  using Sh = bind_attn::Tile<Acc, NJ>;
  const size_t smem = Sh::smem_bytes(d);
  auto kern = chain_attn_kernel<T, NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((M + Sh::BQ - 1) / Sh::BQ),
                  static_cast<unsigned>(n_levels < 65535 ? n_levels : 65535));
  kern<<<grid, bind_attn::THREADS, smem, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(q), q_stride,
      static_cast<const T*>(k), k_stride, static_cast<const T*>(v), v_stride,
      static_cast<T*>(out), static_cast<Acc*>(work),
      static_cast<unsigned int*>(done), M, N, d, dv, n_levels,
      static_cast<Acc>(scale));
  return cudaGetLastError();
}

// chain_attn's routes, in the order of kernels/chain/ops.py ATTN_ROUTES
enum class AttnRoute : int {
  F32_SIMT = 0, BF16_SIMT = 1, F16_SIMT = 2, F64_SIMT = 3, F32_3XTF32 = 4,
  BF16_WGMMA = 5, F16_WGMMA = 6
};

// whether every level of an operand at p, stride elements of T apart from
// one level to the next, is 16-byte aligned
template <typename T>
inline bool levels_aligned(const void* p, int64_t stride, int64_t n_levels) {
  return aligned16(p) &&
         (n_levels <= 1 || (stride * static_cast<int64_t>(sizeof(T))) % 16 ==
                               0);
}

// the route of a chain of n_levels levels of element type T (see the note
// at the top)
template <typename T>
AttnRoute attn_route(const void* q, int64_t q_stride, const void* k,
                     int64_t k_stride, const void* v, int64_t v_stride,
                     int64_t n, int64_t d, int64_t dv, int64_t n_levels) {
  const bool aligned = levels_aligned<T>(q, q_stride, n_levels) &&
                       levels_aligned<T>(k, k_stride, n_levels) &&
                       levels_aligned<T>(v, v_stride, n_levels);
  const bool ok = aligned && d == dv && n >= 1;
  using R = AttnRoute;
  if constexpr (std::is_same_v<T, double>)
    return R::F64_SIMT;
  else if constexpr (std::is_same_v<T, float>)
    return ok && bind_chain_tc::chain_tf32_head_dim(d) ? R::F32_3XTF32
                                                       : R::F32_SIMT;
  else if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return ok && bind_attn_wg::wgmma_head_dim(d) ? R::BF16_WGMMA
                                                 : R::BF16_SIMT;
  else
    return ok && bind_attn_wg::wgmma_head_dim(d) ? R::F16_WGMMA : R::F16_SIMT;
}

// chunks: the tensor-core routes' chunks of a level's keys (the wrapper's
// attn_chunks; 1 on the CUDA-core routes, which take no chunks); work and
// done sized for the route (kernel.py attn_workspace)
template <typename T>
int launch_attn(const void* o, const void* q, int64_t q_stride, const void* k,
                int64_t k_stride, const void* v, int64_t v_stride, void* out,
                void* work, void* done, int64_t M, int64_t N, int64_t d,
                int64_t dv, int64_t n_levels, int64_t chunks, double scale,
                void* stream) {
  if (M <= 0 || dv <= 0) return static_cast<int>(cudaGetLastError());
  if (d <= 0 || d > bind_attn::MAX_HEAD_DIM || n_levels <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int di = static_cast<int>(d);
  const int dvi = static_cast<int>(dv);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AttnRoute route = attn_route<T>(q, q_stride, k, k_stride, v, v_stride,
                                        N, d, dv, n_levels);
  if constexpr (!std::is_same_v<T, double>) {
    if (route == AttnRoute::F32_3XTF32 || route == AttnRoute::BF16_WGMMA ||
        route == AttnRoute::F16_WGMMA) {
      const bind_chain_tc::Problem<T> p{
          static_cast<const T*>(o),    static_cast<T*>(out),
          static_cast<const T*>(q),    q_stride,
          static_cast<const T*>(k),    k_stride,
          static_cast<const T*>(v),    v_stride,
          static_cast<float*>(work),   static_cast<unsigned int*>(done),
          M,                           N,
          n_levels,                    static_cast<int>(chunks),
          0,                           static_cast<float>(scale) *
                                           1.4426950408889634f,
          bind_attn::Mask{false, false, 0}};
      if (chunks < 1 || chunks > bind_chain_tc::MAX_CHUNKS)
        return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(bind_chain_tc::launch(p, di, st));
    }
  }
  if (chunks != 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(bind_attn::with_value_blocks(dvi, [&](auto nj) {
    return launch_attn_nj<T, decltype(nj)::value>(
        o, q, q_stride, k, k_stride, v, v_stride, out, work, done, M, N, di,
        dvi, n_levels, scale, st);
  }));
}

}  // namespace

extern "C" {

#define BIND_CHAIN_ENTRY_POINTS(SUFFIX, T)                                   \
  int bind_chain_ewise_##SUFFIX(void* out, const void* p0, int k0,          \
                                double s0, const void* p1, int k1,          \
                                double s1, const void* p2, int k2,          \
                                double s2, int carry_pos, int64_t n,        \
                                int64_t n_levels, void* stream) {           \
    return launch_ewise<T>(out, p0, k0, s0, p1, k1, s1, p2, k2, s2,         \
                           carry_pos, n, n_levels, stream);                 \
  }                                                                         \
  int bind_chain_dot_##SUFFIX(const void* c, const void* a,                 \
                              int64_t a_stride, const void* b,              \
                              int64_t b_stride, void* out, int64_t M,       \
                              int64_t N, int64_t K, int64_t n_levels,       \
                              void* stream) {                               \
    return launch_dot<T>(c, a, a_stride, b, b_stride, out, M, N, K,         \
                         n_levels, stream);                                 \
  }                                                                         \
  int bind_chain_attn_##SUFFIX(const void* o, const void* q,                \
                               int64_t q_stride, const void* k,             \
                               int64_t k_stride, const void* v,             \
                               int64_t v_stride, void* out, void* work,     \
                               void* done, int64_t M, int64_t N, int64_t d, \
                               int64_t dv, int64_t n_levels,                \
                               int64_t chunks, double scale,                \
                               void* stream) {                              \
    return launch_attn<T>(o, q, q_stride, k, k_stride, v, v_stride, out,    \
                          work, done, M, N, d, dv, n_levels, chunks, scale, \
                          stream);                                          \
  }

BIND_CHAIN_ENTRY_POINTS(f32, float)
BIND_CHAIN_ENTRY_POINTS(bf16, __nv_bfloat16)
BIND_CHAIN_ENTRY_POINTS(f64, double)
BIND_CHAIN_ENTRY_POINTS(f16, __half)

#undef BIND_CHAIN_ENTRY_POINTS

// The route (enum AttnRoute) a chain_attn launch of element type dtype
// (the GEMM's codes: f32 0, bf16 1, f64 2, f16 3) on these operands takes;
// -1 for another code.
int bind_chain_route_attn(int dtype, const void* q, int64_t q_stride,
                          const void* k, int64_t k_stride, const void* v,
                          int64_t v_stride, int64_t n, int64_t d, int64_t dv,
                          int64_t n_levels) {
  AttnRoute r;
  switch (dtype) {
    case 0: r = attn_route<float>(q, q_stride, k, k_stride, v, v_stride, n,
                                  d, dv, n_levels); break;
    case 1: r = attn_route<__nv_bfloat16>(q, q_stride, k, k_stride, v,
                                          v_stride, n, d, dv, n_levels);
            break;
    case 2: r = attn_route<double>(q, q_stride, k, k_stride, v, v_stride, n,
                                   d, dv, n_levels); break;
    case 3: r = attn_route<__half>(q, q_stride, k, k_stride, v, v_stride, n,
                                   d, dv, n_levels); break;
    default: return -1;
  }
  return static_cast<int>(r);
}

}  // extern "C"
