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

// The power of the interval from read (t0, e0) to read (t1, e1) of a
// counter wrapping at w (0: none): ref.py's wrapped_diff, reassociated
// as e1 + (w - e0) when w > 0 and dE < -w/2 (both subtractions
// Sterbenz-exact in float32), over max(t1 - t0, 1e-12); IEEE-rounded
// intrinsics and an IEEE division, so nvcc can neither contract nor
// reassociate it and the result is the plain version's bit for bit.
// A zero dE (a repeated read: ~16% of a counter's intervals when the
// tool reads faster than the counter updates) sends the IEEE division to
// its slow path, so it is not divided: dE / dt is then dE itself (a zero
// of dE's sign, as dt >= 1e-12 > 0), or NaN when dt is NaN.
__device__ __forceinline__ float wrapped_power(float e1, float e0, float t1,
                                               float t0, float w) {
  float de = __fsub_rn(e1, e0);
  if (w > 0.0f && de < -0.5f * w) de = __fadd_rn(e1, __fsub_rn(w, e0));
  const float dt = pmax(__fsub_rn(t1, t0), 1e-12f);
  const float q = __fdiv_rn(de == 0.0f ? 1.0f : de, dt);
  return de == 0.0f && dt == dt ? de : q;
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
