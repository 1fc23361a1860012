// power_reconstruct_rows: per-row wrap-corrected dE/dt over (F, S) rows.
//
// Replaces the TPU kernel power_reconstruct_rows_kernel (_pr_rows_kernel)
// in src/repro/kernels/power_reconstruct/kernel.py.
//
// out[i, 0] = 0;  for j >= 1:
//   de = e[i,j] - e[i,j-1]
//   de = e[i,j] + (w[i] - e[i,j-1])   if w[i] > 0 and de < -w[i]/2
//   out[i, j] = de / max(t[i,j] - t[i,j-1], 1e-12)
// exactly as ref.py's wrapped_diff (the wrap correction is reassociated so
// both subtractions are Sterbenz-exact in float32).
//
// Bound on the H100: device memory.  Each element is read twice (e, t),
// written once, with ~5 flops between: 12 bytes per element against
// 3.35 TB/s.  Design: one thread per (row, column), threads of a warp on
// consecutive columns so every load and store is coalesced; the
// neighbour at j-1 comes from the same cache lines (L1 hit); the row's
// wrap period is loaded once per block into shared memory.  Every
// operation is the IEEE-rounded intrinsic (__fsub_rn, __fadd_rn,
// __fdiv_rn), so nvcc can neither contract nor reassociate the wrap
// expression.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void pr_rows_kernel(const float* __restrict__ e,
                               const float* __restrict__ t,
                               const float* __restrict__ wrap,
                               float* __restrict__ out, int F, int S) {
  __shared__ float w_row;
  const int col = blockIdx.x * kThreads + threadIdx.x;
  for (int row = blockIdx.y; row < F; row += gridDim.y) {
    __syncthreads();
    if (threadIdx.x == 0) w_row = wrap[row];
    __syncthreads();
    if (col >= S) continue;
    const size_t base = static_cast<size_t>(row) * S;
    if (col == 0) {
      out[base] = 0.0f;
      continue;
    }
    const float w = w_row;
    const float e1 = e[base + col];
    const float e0 = e[base + col - 1];
    float de = __fsub_rn(e1, e0);
    if (w > 0.0f && de < -0.5f * w) de = __fadd_rn(e1, __fsub_rn(w, e0));
    const float dt = __fsub_rn(t[base + col], t[base + col - 1]);
    out[base + col] = __fdiv_rn(de, pmax(dt, 1e-12f));
  }
}

}  // namespace

extern "C" int pr_rows_launch(const float* e, const float* t,
                              const float* wrap, float* out, int F, int S,
                              void* stream) {
  if (F <= 0 || S <= 0) return 0;
  dim3 grid((S + kThreads - 1) / kThreads, F < 65535 ? F : 65535);
  pr_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      e, t, wrap, out, F, S);
  return static_cast<int>(cudaGetLastError());
}
