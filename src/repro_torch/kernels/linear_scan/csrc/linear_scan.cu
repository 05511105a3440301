// Chunked linear scan for Hopper (sm_90a): y_t = a_t * y_{t-1} + x_t over
// (B, S, D), y_{-1} = 0, f32 inside, the output in x's dtype (float32,
// bfloat16 or float16: entry points bind_linear_scan_{f32,bf16,f16}).
//
// Replaces the TPU kernel src/repro/kernels/linear_scan/kernel.py:50
// linear_scan_pallas (body _linear_scan_kernel :32): a (batch, chunk) grid
// whose chunk axis runs in order, an associative scan inside each chunk and
// a (1, D) f32 carry in VMEM scratch from one chunk to the next.  A GPU grid
// runs in no order, so here the carry crosses chunks by a single-pass
// chained scan with a decoupled look-back, in one launch:
//
//   * A tile is one chunk of CHUNK = 128 steps of one batch row by a slab of
//     W columns (ROW_BYTES = 128 bytes of a row: 32 f32 or 64 bf16 / f16),
//     one block of W threads, one thread per column.  A block takes its
//     tile by ticket from an atomic counter, chunk-major ((chunk, batch,
//     slab) in that order), so every tile it may wait on belongs to a block
//     that is running or done: no tile waits on one that has not started.
//   * The block stages its tile's a and x in shared memory (32 KB): with
//     one TMA copy each (cp.async.bulk.tensor, a 3-D box of W columns x 128
//     steps x 1 batch row, completion on an mbarrier), or, when TMA cannot
//     read the operands, with coalesced loads (the two routes, below).  The
//     serial loops then read shared memory column by column, without bank
//     conflicts.
//   * Aggregate: per column, from zero, in step order, prod = prod * a_t and
//     h = a_t * h + x_t: the chunk's (A, X), y_end = A * y_in + X, published
//     at once.
//   * Look-back, per column (each column's chain is its own): the thread
//     reads the words of LOOK preceding chunks at a time, spinning until,
//     from c - 1 back to the nearest chunk that has published its carry
//     out, every chunk has published its aggregate, then steps h <- A_i h +
//     X_i forward from that carry out over the aggregates in between: never
//     two aggregates composed pairwise, whose rounding would differ.  The
//     carry into a chunk is thus the same fold over chunks 0 .. c-1
//     whichever chunk the walk stops at.
//   * Carry out: A * h_in + X, the carry into the next chunk, published
//     before the tile's own output; then the recurrence again from h_in, y
//     written from registers, a coalesced row a step.
//
// Bits: every product and sum is rounded on its own (__fmul_rn /
// __fadd_rn, never contracted into an FMA), the aggregate, the carry chain
// and the output recurrence in the order of the three-pass kernel this
// replaced (chunk pass, per-column carry pass, apply pass), so the output
// is that kernel's bit for bit; kernels/linear_scan/ref.py
// linear_scan_chunked is the same computation in PyTorch.  a = 0 gives x
// exactly.
//
// Publication without fences: a chunk's aggregate is one 64-bit word (the
// bits of A and X) and its carry out one 32-bit word, per column, each
// stored and loaded whole (st/ld.relaxed.gpu, single-copy atomic), so a
// reader sees a value or the word's "not yet" pattern, never half of one,
// and no other memory depends on the word.  The "not yet" pattern is every
// bit set, written by a cudaMemsetAsync of the scratch before every launch
// on the same stream (so a captured CUDA graph resets it on every replay);
// a published word never has it, since its values are results of IEEE
// operations on the card, whose only NaN is 0x7fffffff.  The ticket
// counter is in the same memset and starts from 0xffffffff + 1 = 0.
//
// What bounds it on an H100: bytes.  2 operations per element against a and
// x read once and y written once (3 S D elements: 0.120 ms in f32 at RG-LRU
// width (1, 8192, 4096)), plus 12 bytes of scratch per (batch, chunk,
// column), 3/128 of a float32 step row's bytes.  HBM stays busy while a
// tile waits in its look-back because enough blocks are resident (6 per SM
// at 33 KB of shared memory each): a block that waits holds no load slot,
// and the next tiles' copies are in flight in the other blocks.
//
// Routes (route_of, answered by bind_linear_scan_route and mirrored by
// kernels/linear_scan/ops.py route): "tma" when a and x start 16-byte
// aligned and a row (D elements) is a multiple of 16 bytes, as TMA needs;
// else "ldg", the same tile staged by coalesced loads.  The two give the
// same bits.
//
// C interface (bound with ctypes): device pointers, sizes and a
// cudaStream_t; each entry point launches on that stream without
// synchronising and returns cudaGetLastError() (0 on success).  The chunk
// argument must be CHUNK.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 128;      // steps per chunk: kernels/linear_scan/kernel.py
constexpr int ROW_BYTES = 128;  // a tile's row: one 128-byte segment

enum Route : int { ROUTE_TMA = 0, ROUTE_LDG = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ float step(float a, float h, float x) {
  return __fadd_rn(__fmul_rn(a, h), x);
}

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// waits for the barrier's first phase; a copy that never lands (a bad
// tensor map) traps after about a second instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 28)) asm volatile("trap;\n");
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  }
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(batch),
      "r"(smem_addr(bar))
      : "memory");
}
// single-copy atomic accesses at device scope: a reader sees a word whole,
// as it was before or after the store
__device__ __forceinline__ uint32_t load_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ uint64_t load_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void store_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ void store_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

// ---- the kernel -----------------------------------------------------------------

// A word not yet published has every bit set (the memset before each
// launch).  A published word never does: its values are results of IEEE
// operations on the card, whose only NaN is 0x7fffffff.
constexpr uint32_t UNSET = 0xffffffffu;
constexpr uint64_t UNSET_PAIR = ~uint64_t{0};

struct Scan {
  int64_t batch, s, d, n_chunks, n_slabs;
  uint64_t* AX;      // (batch, n_chunks, d): a chunk's aggregate, the bits
                     // of prod a_t (low half) and its recurrence from 0
  uint32_t* H;       // the bits of the chunk's carry out
  uint32_t* ticket;  // the last ticket taken (UNSET: none yet)
};

__device__ __forceinline__ uint64_t pack(float a, float x) {
  return static_cast<uint64_t>(__float_as_uint(x)) << 32 |
         __float_as_uint(a);
}
__device__ __forceinline__ float step_over(uint64_t ax, float h) {
  return step(__uint_as_float(static_cast<uint32_t>(ax)), h,
              __uint_as_float(static_cast<uint32_t>(ax >> 32)));
}

// The carry into chunk c of one column (``row``: the column's word of
// chunk 0): the nearest earlier chunk's carry out, stepped forward over the
// aggregates of the chunks between.  Reads LOOK chunks back at a time and
// spins until, from c - 1 back to the nearest carry out, every chunk has
// published at least its aggregate; chunk -1's carry out is 0.
constexpr int LOOK = 4;

__device__ __forceinline__ float carry_in(const Scan& p, int64_t row,
                                          int64_t c) {
  int64_t top = c - 1;  // the window's first chunk
  // a predecessor that never publishes (a fault) traps after seconds
  // instead of hanging the card
  for (uint32_t spins = 0;; ++spins) {
    if (spins == (1u << 22)) asm volatile("trap;\n");
    uint32_t hw[LOOK];
    uint64_t aw[LOOK];
#pragma unroll
    for (int q = 0; q < LOOK; ++q) {
      const int64_t i = top - q;
      hw[q] = i >= 0 ? load_relaxed(p.H + row + i * p.d) : 0u;
      aw[q] = i >= 0 ? load_relaxed(p.AX + row + i * p.d) : UNSET_PAIR;
    }
    int found = -1;      // the window's nearest carry out
    bool ready = true;   // every chunk before it has its aggregate
#pragma unroll
    for (int q = 0; q < LOOK; ++q) {
      if (found < 0 && ready) {
        if (hw[q] != UNSET)
          found = q;
        else if (aw[q] == UNSET_PAIR)
          ready = false;
      }
    }
    if (found >= 0) {
      float h = 0.0f;
#pragma unroll
      for (int q = LOOK - 1; q >= 0; --q) {
        if (q == found) h = __uint_as_float(hw[q]);
        if (q < found) h = step_over(aw[q], h);
      }
      // chunks of the windows before this one, seen published
      for (int64_t i = top + 1; i < c; ++i)
        h = step_over(load_relaxed(p.AX + row + i * p.d), h);
      return h;
    }
    if (ready)
      top -= LOOK;
    else
      __nanosleep(64);
  }
}

template <typename T, bool TMA>
__global__ void __launch_bounds__(ROW_BYTES / sizeof(T))
linear_scan_kernel(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap x_map,
                   const T* __restrict__ a, const T* __restrict__ x,
                   T* __restrict__ y, const Scan p) {
  constexpr int W = ROW_BYTES / sizeof(T);
  __shared__ __align__(128) T sa[CHUNK * W];
  __shared__ __align__(128) T sx[CHUNK * W];
  __shared__ uint64_t bar;
  __shared__ uint32_t s_ticket;

  const int j = threadIdx.x;
  if (j == 0) {
    s_ticket = atomicAdd(p.ticket, 1u) + 1u;
    if (TMA) mbar_init(&bar);
  }
  __syncthreads();
  const uint32_t ticket = s_ticket;
  const int64_t per_chunk = p.batch * p.n_slabs;
  const int64_t c = ticket / per_chunk;
  const int64_t b = (ticket % per_chunk) / p.n_slabs;
  const int64_t slab = ticket % p.n_slabs;
  const int64_t t0 = c * CHUNK;
  const int steps = static_cast<int>(p.s - t0 < CHUNK ? p.s - t0 : CHUNK);
  const int64_t col = slab * W + j;
  const bool live = col < p.d;

  // the tile into shared memory: rows are steps, W columns each
  if (TMA) {
    if (j == 0) {
      mbar_expect(&bar, 2u * CHUNK * W * sizeof(T));
      tma_load(sa, &a_map, &bar, static_cast<int>(slab * W),
               static_cast<int>(t0), static_cast<int>(b));
      tma_load(sx, &x_map, &bar, static_cast<int>(slab * W),
               static_cast<int>(t0), static_cast<int>(b));
    }
    mbar_wait(&bar);
  } else {
    if (live) {
      const int64_t base = (b * p.s + t0) * p.d + col;
#pragma unroll 16
      for (int t = 0; t < steps; ++t) {
        sa[t * W + j] = a[base + t * p.d];
        sx[t * W + j] = x[base + t * p.d];
      }
    }
    __syncthreads();
  }
  if (!live) return;

  // the chunk's aggregate, from zero
  float prod = 1.0f;
  float agg = 0.0f;
#pragma unroll 16
  for (int t = 0; t < steps; ++t) {
    const float at = to_f32(sa[t * W + j]);
    agg = step(at, agg, to_f32(sx[t * W + j]));
    prod = __fmul_rn(prod, at);
  }
  const int64_t row = b * p.n_chunks * p.d + col;
  const int64_t cell = row + c * p.d;
  const bool last = c == p.n_chunks - 1;
  float h = 0.0f;  // the carry into this chunk
  if (c > 0) {
    if (!last) store_relaxed(p.AX + cell, pack(prod, agg));
    h = carry_in(p, row, c);
  }
  if (!last) store_relaxed(p.H + cell, __float_as_uint(step(prod, h, agg)));

  // the chunk's output, from its carry
  T* out = y + (b * p.s + t0) * p.d + col;
#pragma unroll 16
  for (int t = 0; t < steps; ++t) {
    h = step(to_f32(sa[t * W + j]), h, to_f32(sx[t * W + j]));
    out[t * p.d] = from_f32<T>(h);
  }
}

// ---- host side --------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no
// -lcuda); NULL when the driver has none
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

template <typename T> CUtensorMapDataType tma_type();
template <> CUtensorMapDataType tma_type<float>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}
template <> CUtensorMapDataType tma_type<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <> CUtensorMapDataType tma_type<__half>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

// (batch, s, d) row-major, read in boxes of W columns x CHUNK steps x 1
// batch row; the ragged edges are TMA's zero fill
template <typename T>
cudaError_t make_map(CUtensorMap* map, const void* base, int64_t batch,
                     int64_t s, int64_t d) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * sizeof(T),
                                 static_cast<cuuint64_t>(s * d) * sizeof(T)};
  const cuuint32_t box[3] = {ROW_BYTES / sizeof(T), CHUNK, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, tma_type<T>(), 3, const_cast<void*>(base), dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int route_of(int64_t elem_bytes, const void* a, const void* x, int64_t d) {
  const bool aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return aligned && (d * elem_bytes) % 16 == 0 ? ROUTE_TMA : ROUTE_LDG;
}

// all the shared memory the SM has, so that 6 blocks of 33 KB fit
template <typename T, bool TMA>
cudaError_t prefer_shared() {
  static const cudaError_t err = cudaFuncSetAttribute(
      linear_scan_kernel<T, TMA>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  return err;
}

// scratch: 3 * batch * ceil(s / CHUNK) * d + 1 words of 4 bytes: AX (two
// words a column and chunk), H, then the ticket counter; every bit set
// before each launch
template <typename T>
int launch(const void* a, const void* x, void* y, void* scratch,
           int64_t batch, int64_t s, int64_t d, int64_t chunk,
           void* stream) {
  if (batch <= 0 || s <= 0 || d <= 0)
    return static_cast<int>(cudaGetLastError());
  if (chunk != CHUNK) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int W = ROW_BYTES / sizeof(T);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Scan p;
  p.batch = batch;
  p.s = s;
  p.d = d;
  p.n_chunks = (s + CHUNK - 1) / CHUNK;
  p.n_slabs = (d + W - 1) / W;
  const int64_t cells = batch * p.n_chunks * d;
  const int64_t tiles = p.n_chunks * batch * p.n_slabs;
  if (tiles >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  p.AX = static_cast<uint64_t*>(scratch);
  p.H = reinterpret_cast<uint32_t*>(p.AX + cells);
  p.ticket = p.H + cells;
  cudaError_t err = cudaMemsetAsync(scratch, 0xff,
                                    (3 * cells + 1) * sizeof(uint32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap a_map{}, x_map{};
  const T* at = static_cast<const T*>(a);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (route_of(sizeof(T), a, x, d) == ROUTE_TMA) {
    if ((err = make_map<T>(&a_map, a, batch, s, d)) != cudaSuccess ||
        (err = make_map<T>(&x_map, x, batch, s, d)) != cudaSuccess ||
        (err = prefer_shared<T, true>()) != cudaSuccess)
      return static_cast<int>(err);
    linear_scan_kernel<T, true><<<static_cast<unsigned>(tiles), W, 0, st>>>(
        a_map, x_map, at, xt, yt, p);
  } else {
    if ((err = prefer_shared<T, false>()) != cudaSuccess)
      return static_cast<int>(err);
    linear_scan_kernel<T, false><<<static_cast<unsigned>(tiles), W, 0, st>>>(
        a_map, x_map, at, xt, yt, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// the route a launch on these operands takes (0 tma, 1 ldg); dtype codes
// 0 f32, 1 bf16, 2 f16; -1 for any other code
int bind_linear_scan_route(int dtype, const void* a, const void* x,
                           int64_t d) {
  if (dtype < 0 || dtype > 2) return -1;
  return route_of(dtype == 0 ? 4 : 2, a, x, d);
}

int bind_linear_scan_f32(const void* a, const void* x, void* y, void* scratch,
                         int64_t batch, int64_t s, int64_t d, int64_t chunk,
                         void* stream) {
  return launch<float>(a, x, y, scratch, batch, s, d, chunk, stream);
}

int bind_linear_scan_bf16(const void* a, const void* x, void* y,
                          void* scratch, int64_t batch, int64_t s, int64_t d,
                          int64_t chunk, void* stream) {
  return launch<__nv_bfloat16>(a, x, y, scratch, batch, s, d, chunk, stream);
}

int bind_linear_scan_f16(const void* a, const void* x, void* y,
                         void* scratch, int64_t batch, int64_t s, int64_t d,
                         int64_t chunk, void* stream) {
  return launch<__half>(a, x, y, scratch, batch, s, d, chunk, stream);
}

}  // extern "C"
