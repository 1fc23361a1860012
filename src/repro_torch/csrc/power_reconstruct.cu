// power_reconstruct: dE/dt over (F, S) rows with ONE scalar wrap period.
//
// Replaces the TPU kernel power_reconstruct_kernel (_pr_kernel) in
// src/repro/kernels/power_reconstruct/kernel.py.
//
// out[i, 0] = 0;  for j >= 1:
//   de = e[i,j] - e[i,j-1]
//   de = de + wrap            if wrap > 0 and de < -wrap/2
//   out[i, j] = de / max(t[i,j] - t[i,j-1], 1e-12)
// The correction is the plain `de + wrap` of ref.py's
// reconstruct_power_ref, NOT the reassociated form of the rows and fleet
// kernels: this kernel's oracle rounds `de + wrap`, and so does the kernel.
//
// Bound on the H100: device memory (read e and t, write out: 12 bytes per
// element against 3.35 TB/s).  Design: as power_reconstruct_rows.cu, one
// thread per (row, column) with a warp on consecutive columns, so every
// access is coalesced and the j-1 neighbour is an L1 hit; the period is a
// kernel argument.  IEEE-rounded intrinsics and an IEEE division keep the
// result bit-identical to the plain version.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void pr_kernel(const float* __restrict__ e,
                          const float* __restrict__ t,
                          float* __restrict__ out, int F, int S,
                          float wrap) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= S) return;
  for (int row = blockIdx.y; row < F; row += gridDim.y) {
    const size_t base = static_cast<size_t>(row) * S;
    if (col == 0) {
      out[base] = 0.0f;
      continue;
    }
    float de = __fsub_rn(e[base + col], e[base + col - 1]);
    if (wrap > 0.0f && de < -0.5f * wrap) de = __fadd_rn(de, wrap);
    const float dt = __fsub_rn(t[base + col], t[base + col - 1]);
    out[base + col] = __fdiv_rn(de, pmax(dt, 1e-12f));
  }
}

}  // namespace

extern "C" int pr_launch(const float* e, const float* t, float* out, int F,
                         int S, float wrap, void* stream) {
  if (F <= 0 || S <= 0) return 0;
  dim3 grid((S + kThreads - 1) / kThreads, F < 65535 ? F : 65535);
  pr_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      e, t, out, F, S, wrap);
  return static_cast<int>(cudaGetLastError());
}
