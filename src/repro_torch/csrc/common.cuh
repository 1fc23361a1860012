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

// Deterministic block-wide sums of N values per thread at once (N <= 32),
// for kernels that keep N partial sums in registers: a fixed shuffle tree
// inside each warp for each value, then thread j < N folds value j's
// per-warp partials in warp order.  Thread j (j < N) gets value j's total;
// the others get 0.  `scratch` holds N * (blockDim.x / 32) floats.  The
// order depends only on blockDim, never on the data, the grid or
// scheduling.  Every thread of the block must call it; blockDim.x must be
// a multiple of 32.
template <int N>
__device__ __forceinline__ float block_sum_n(float (&v)[N], float* scratch) {
  static_assert(N >= 1 && N <= 32, "one value per lane of the last fold");
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int j = 0; j < N; ++j)
    for (int off = 16; off > 0; off >>= 1)
      v[j] = __fadd_rn(v[j], __shfl_down_sync(full, v[j], off));
  __syncthreads();                 // scratch may hold a previous result
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) scratch[warp * N + j] = v[j];
  }
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x < N)
    for (int w = 0; w < n_warps; ++w)
      total = __fadd_rn(total, scratch[w * N + threadIdx.x]);
  return total;
}
