// Chunked linear scan for Hopper (sm_90a): y_t = a_t * y_{t-1} + x_t over
// (B, S, D), y_{-1} = 0, f32 inside, the output in x's dtype (float32,
// bfloat16 or float16: entry points bind_linear_scan_{f32,bf16,f16}).
//
// Replaces the TPU kernel src/repro/kernels/linear_scan/kernel.py:50
// linear_scan_pallas (body _linear_scan_kernel :32): a (batch, chunk) grid
// whose chunk axis runs in order, an associative scan inside each chunk and
// a (1, D) f32 carry in VMEM scratch from one chunk to the next.  A GPU grid
// runs in no order, and one thread per column would give RecurrentGemma-9B's
// RG-LRU (B = 1, D = 4096) only 4096 threads for 8192 serial steps, so the
// carry crosses chunks in a pass of its own.  Three launches, one thread per
// (batch, chunk, column) in the first and last, per (batch, column) in the
// second:
//   1. linear_scan_chunk_kernel: per chunk, from zero, the chunk's transfer
//      pair (A, X): y_end = A * y_in + X, with A = prod a_t and X the scan's
//      last value;
//   2. linear_scan_carry_kernel: per column, in chunk order, each chunk's
//      incoming carry h_in (h <- A h + X), written over X;
//   3. linear_scan_apply_kernel: per chunk, the recurrence again from h_in,
//      y_t = a_t * y_{t-1} + x_t: the value A_t h_in + X_t of the TPU
//      kernel's y = A * h_in + X, with the oracle's rounding order.
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, never
// contracted into an FMA), as the oracle's a * h + x is; a = 0 gives x
// exactly.  The chunk length is the wrapper's (kernels/linear_scan/kernel.py).
//
// What bounds it on an H100: bytes.  It does 2 operations per element
// against at least a and x read and y written (3 S D elements: 0.120 ms in
// f32 at S = 8192, D = 4096).  Passes 1 and 3 both read a and x, so it moves
// 5 S D elements plus the (B, S / chunk, D) f32 scratch; a single pass with
// a decoupled look-back across chunks is left for a later change.
//
// C interface (bound with ctypes): device pointers, sizes and a
// cudaStream_t; each entry point launches on that stream without
// synchronising and returns cudaGetLastError() (0 on success).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

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

// one thread per (batch, chunk, column); columns fastest (coalesced)
struct Cell {
  int64_t base;   // (b * S + first step of the chunk) * D + column
  int64_t steps;  // steps in the chunk
};

__device__ __forceinline__ bool cell(int64_t idx, int64_t s, int64_t d,
                                     int64_t n_chunks, int64_t chunk,
                                     int64_t batch, Cell& c) {
  if (idx >= batch * n_chunks * d) return false;
  const int64_t col = idx % d;
  const int64_t ch = (idx / d) % n_chunks;
  const int64_t b = idx / (d * n_chunks);
  const int64_t t0 = ch * chunk;
  c.base = (b * s + t0) * d + col;
  c.steps = (s - t0) < chunk ? (s - t0) : chunk;
  return true;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
linear_scan_chunk_kernel(const T* __restrict__ a, const T* __restrict__ x,
                         float* __restrict__ A, float* __restrict__ X,
                         int64_t batch, int64_t s, int64_t d, int64_t chunk,
                         int64_t n_chunks) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  Cell c;
  if (!cell(idx, s, d, n_chunks, chunk, batch, c)) return;
  float prod = 1.0f;
  float h = 0.0f;
#pragma unroll 8
  for (int64_t t = 0; t < c.steps; ++t) {
    const float at = to_f32(a[c.base + t * d]);
    h = step(at, h, to_f32(x[c.base + t * d]));
    prod = __fmul_rn(prod, at);
  }
  A[idx] = prod;
  X[idx] = h;
}

// per (batch, column): H[c] <- the carry into chunk c, written over X[c]
__global__ void __launch_bounds__(THREADS)
linear_scan_carry_kernel(const float* __restrict__ A, float* __restrict__ X,
                         int64_t batch, int64_t d, int64_t n_chunks) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= batch * d) return;
  const int64_t b = idx / d;
  const int64_t col = idx % d;
  float h = 0.0f;
  for (int64_t ch = 0; ch < n_chunks; ++ch) {
    const int64_t at = (b * n_chunks + ch) * d + col;
    const float xc = X[at];
    X[at] = h;
    h = step(A[at], h, xc);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
linear_scan_apply_kernel(const T* __restrict__ a, const T* __restrict__ x,
                         const float* __restrict__ H, T* __restrict__ y,
                         int64_t batch, int64_t s, int64_t d, int64_t chunk,
                         int64_t n_chunks) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  Cell c;
  if (!cell(idx, s, d, n_chunks, chunk, batch, c)) return;
  float h = H[idx];
#pragma unroll 8
  for (int64_t t = 0; t < c.steps; ++t) {
    const int64_t at = c.base + t * d;
    h = step(to_f32(a[at]), h, to_f32(x[at]));
    y[at] = from_f32<T>(h);
  }
}

unsigned blocks_for(int64_t threads) {
  return static_cast<unsigned>((threads + THREADS - 1) / THREADS);
}

// scratch: 2 * batch * n_chunks * d floats (A, then X / H)
template <typename T>
int launch(const void* a, const void* x, void* y, void* scratch,
           int64_t batch, int64_t s, int64_t d, int64_t chunk,
           void* stream) {
  if (batch <= 0 || s <= 0 || d <= 0)
    return static_cast<int>(cudaGetLastError());
  if (chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_chunks = (s + chunk - 1) / chunk;
  const int64_t cells = batch * n_chunks * d;
  float* A = static_cast<float*>(scratch);
  float* X = A + cells;
  linear_scan_chunk_kernel<T><<<blocks_for(cells), THREADS, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), A, X, batch, s, d,
      chunk, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  linear_scan_carry_kernel<<<blocks_for(batch * d), THREADS, 0, st>>>(
      A, X, batch, d, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  linear_scan_apply_kernel<T><<<blocks_for(cells), THREADS, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), X,
      static_cast<T*>(y), batch, s, d, chunk, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

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
