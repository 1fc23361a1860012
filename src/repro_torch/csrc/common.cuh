// Helpers shared by the port's kernels.
#pragma once

#include <cuda_runtime.h>

// NaN-propagating max/min: the same semantics as jnp.maximum/jnp.minimum
// and torch.maximum/torch.minimum (fmaxf/fminf would drop a NaN).
__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float pmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// Deterministic block-wide sum: a fixed shuffle tree inside each warp,
// then warp 0 folds the per-warp partials in warp order.  The order
// depends only on blockDim, never on the data or on scheduling.
// Every thread of the block must call it; all of them get the total.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const unsigned full = 0xffffffffu;
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(full, v, off));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  __syncthreads();                 // scratch may hold a previous result
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < n_warps ? scratch[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      w = __fadd_rn(w, __shfl_down_sync(full, w, off));
    if (lane == 0) scratch[32] = w;
  }
  __syncthreads();
  return scratch[32];
}
