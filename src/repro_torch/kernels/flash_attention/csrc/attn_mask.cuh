// The per-element masks of the tensor-core backward routes (attn_bwd_
// wgmma.cuh, attn_bwd_tf32.cuh, attn_bwd_tf32_wide.cuh), in 32-bit
// positions relative to a tile: 64-bit ones cost the dk/dv kernels
// registers they do not have (bf16_wgmma's at d 128 spilled with them).

#pragma once

#include <cstdint>

#include "attn_tile.cuh"

namespace bind_attn {

// whether a row sees a key diff = row - key before it, `left` keys short
// of Skv (left > 0: the key exists), under a window of win keys
__device__ __forceinline__ bool visible(const Mask& mask, int diff, int left,
                                        int win) {
  bool vis = left > 0;
  if (mask.causal) vis = vis && diff >= 0;
  if (mask.windowed) vis = vis && diff < win;
  return vis;
}

// the window as a 32-bit count (a window of 2^30 or more keys hides none
// of the at most 2^31 - 1 keys TMA can address)
__device__ __forceinline__ int window32(const Mask& mask) {
  return static_cast<int>(mask.window < (1 << 30) ? mask.window : (1 << 30));
}

// min(a, cap) as a 32-bit count, for a >= 0 of any size
__device__ __forceinline__ int capped(int64_t a, int cap) {
  return static_cast<int>(a < cap ? a : cap);
}

}  // namespace bind_attn
