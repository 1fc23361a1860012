// fleet_attribute: wrapped dE/dt and per-phase integration fused, on raw
// cumulative-counter chunks.
//
// Replaces the TPU kernel fleet_attribute_kernel (_fa_kernel) in
// src/repro/kernels/fleet_attribute/kernel.py.
//
// For (R, S) rows of counter reads (t, e), per-row wrap period w[r]
// (0 = none) and P phase windows [a_j, b_j):
//   p_i   = wrapped_dE_i / max(t_i - t_{i-1}, 1e-12)   (i >= 1; p_0 = 0)
//   E[r,j] = sum_i p_i * max(min(t_i, b_j) - max(t_{i-1}, a_j), 0)
// with t_{-1} = t_0.  dE is ref.py's wrapped_diff, reassociated
// (e_i + (w - e_{i-1}) when w > 0 and dE < -w/2).  A duplicate read
// republishes (t, E): a zero-width interval with dE = 0, so it adds
// exactly 0 J.  max/min propagate NaN as torch.maximum/jnp.maximum do.
//
// Bound on the H100: float32 operations (~6 per element and phase,
// against 8 bytes per element for all phases), as phase_integrate.cu.
// Design: phase_integrate.cu's, with the power of each interval formed in
// registers from the row's two neighbouring reads, so the power row never
// exists in memory: one block per row, threads striding over the row, a
// 32-phase tile of partial sums and window edges in registers, then the
// fixed-order block fold of common.cuh (no atomics, no split across
// blocks: a row's energy depends neither on R nor on scheduling).  dE/dt
// uses IEEE-rounded intrinsics and an IEEE division exactly as
// power_reconstruct_rows.cu, so each interval's power equals the plain
// version's bit for bit; only the summation order differs.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPT = 32;          // phases per tile: the pipeline's PHASE_ALIGN

__global__ void __launch_bounds__(kThreads)
fa_kernel(const float* __restrict__ t, const float* __restrict__ e,
          const float* __restrict__ wrap, const float* __restrict__ ab,
          float* __restrict__ out, int S, int P) {
  __shared__ float s_ab[2 * kPT];
  __shared__ float scratch[(kThreads / 32) * kPT];
  const int row = blockIdx.x;
  const size_t base = static_cast<size_t>(row) * S;
  const float w = wrap[row];
  for (int p0 = 0; p0 < P; p0 += kPT) {
    __syncthreads();               // the previous tile is done with s_ab
    if (threadIdx.x < 2 * kPT) {
      const int j = p0 + (threadIdx.x >> 1);
      s_ab[threadIdx.x] = j < P ? ab[2 * p0 + threadIdx.x] : 0.0f;
    }
    __syncthreads();
    float a[kPT], b[kPT], acc[kPT];
#pragma unroll
    for (int j = 0; j < kPT; ++j) {
      a[j] = s_ab[2 * j];
      b[j] = s_ab[2 * j + 1];
      acc[j] = 0.0f;
    }
    for (int i = threadIdx.x; i < S; i += kThreads) {
      const float hi_t = t[base + i];
      float lo_t = hi_t;
      float p = 0.0f;
      if (i > 0) {
        lo_t = t[base + i - 1];
        const float e1 = e[base + i];
        const float e0 = e[base + i - 1];
        float de = __fsub_rn(e1, e0);
        if (w > 0.0f && de < -0.5f * w) de = __fadd_rn(e1, __fsub_rn(w, e0));
        p = __fdiv_rn(de, pmax(__fsub_rn(hi_t, lo_t), 1e-12f));
      }
#pragma unroll
      for (int j = 0; j < kPT; ++j) {
        const float ov =
            pmax(__fsub_rn(pmin(hi_t, b[j]), pmax(lo_t, a[j])), 0.0f);
        acc[j] = __fadd_rn(acc[j], __fmul_rn(ov, p));
      }
    }
    const float total = block_sum_n<kPT>(acc, scratch);
    if (threadIdx.x < kPT && p0 + threadIdx.x < P)
      out[static_cast<size_t>(row) * P + p0 + threadIdx.x] = total;
  }
}

}  // namespace

extern "C" int fa_launch(const float* t, const float* e, const float* wrap,
                         const float* ab, float* out, int R, int S, int P,
                         void* stream) {
  if (R <= 0 || P <= 0) return 0;
  fa_kernel<<<R, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, e, wrap, ab, out, S, P);
  return static_cast<int>(cudaGetLastError());
}
