// power_reconstruct_fleet: the fused fleet front end over raw padded reads.
//
// Replaces the TPU kernel power_reconstruct_fleet_kernel (_pr_fleet_kernel)
// in src/repro/kernels/power_reconstruct/kernel.py.
//
// Per row i (n = n_row[i], w = wrap[i]) and column j:
//   valid_j      = j < n
//   valid_out_j  = j >= 1 && valid_j && t[i,j] > t[i,j-1]   (dedup+mono)
//   power[i,j]   = valid_out_j ? dE / max(t[i,j] - t[i,j-1], 1e-12) : 0
//       dE = e[i,j] - e[i,j-1], or e[i,j] + (w - e[i,j-1]) when w > 0 and
//       dE < -w/2 (ref.py's wrapped_diff, reassociated: both subtractions
//       Sterbenz-exact in float32)
//   reordered[i] = OR over j >= 1 of (valid_j && valid_{j-1}
//                                      && t[i,j] < t[i,j-1])
//
// Bound on the H100: device memory.  Each element reads e and t (8 bytes)
// and writes power and the 1-byte valid flag (5 bytes): 13 bytes per
// element against 3.35 TB/s, a handful of flops between.  Design: one
// block per row, threads stride over the row with neighbouring threads on
// neighbouring columns, so every load and store is coalesced and the j-1
// neighbour comes from the same cache lines.  The row's reordered flag is
// the block's __syncthreads_or, written by thread 0: an OR does not
// depend on order, so no atomics and no second pass.  Every arithmetic
// operation is an IEEE-rounded intrinsic (no contraction), the division
// is IEEE, so power is bit-identical to the plain version.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pr_fleet_kernel(const float* __restrict__ e, const float* __restrict__ t,
                const float* __restrict__ wrap, const int* __restrict__ n_row,
                float* __restrict__ power, unsigned char* __restrict__ valid,
                unsigned char* __restrict__ reordered, int S) {
  const int row = blockIdx.x;
  const size_t base = static_cast<size_t>(row) * S;
  const float w = wrap[row];
  const int n = n_row[row];
  int back = 0;
  for (int col = threadIdx.x; col < S; col += kThreads) {
    if (col == 0) {
      power[base] = 0.0f;
      valid[base] = 0;
      continue;
    }
    const float t1 = t[base + col];
    const float t0 = t[base + col - 1];
    const bool v1 = col < n;
    back |= (v1 && col - 1 < n && t1 < t0) ? 1 : 0;
    const bool keep = v1 && t1 > t0;
    float p = 0.0f;
    if (keep) {
      const float e1 = e[base + col];
      const float e0 = e[base + col - 1];
      float de = __fsub_rn(e1, e0);
      if (w > 0.0f && de < -0.5f * w) de = __fadd_rn(e1, __fsub_rn(w, e0));
      p = __fdiv_rn(de, pmax(__fsub_rn(t1, t0), 1e-12f));
    }
    power[base + col] = p;
    valid[base + col] = keep ? 1 : 0;
  }
  back = __syncthreads_or(back);
  if (threadIdx.x == 0) reordered[row] = back ? 1 : 0;
}

}  // namespace

extern "C" int pr_fleet_launch(const float* e, const float* t,
                               const float* wrap, const int* n_row,
                               float* power, unsigned char* valid,
                               unsigned char* reordered, int F, int S,
                               void* stream) {
  if (F <= 0 || S <= 0) return 0;
  pr_fleet_kernel<<<F, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      e, t, wrap, n_row, power, valid, reordered, S);
  return static_cast<int>(cudaGetLastError());
}
