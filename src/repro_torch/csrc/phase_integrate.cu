// phase_integrate: per-phase energy of sample-and-hold power rows.
//
// Replaces the TPU kernel phase_integrate_kernel (_pi_kernel) in
// src/repro/kernels/phase_integrate/kernel.py.
//
//   E[r, j] = sum_i p[r,i] * max(min(t[r,i], b_j) - max(t[r,i-1], a_j), 0)
// with t[r,-1] = t[r,0] (column 0 is a zero-width interval), for (R, S)
// rows and P phase windows [a_j, b_j); max/min propagate NaN as
// torch.maximum/jnp.maximum do (the ingest carry column may be -inf).
//
// Bound on the H100: float32 operations.  Per (element, phase) the
// overlap and its product take ~6 operations against 8 bytes read per
// element for all phases, so at P = 32 the work is ~24 operations per
// byte, above the card's 67 TFLOP/s / 3.35 TB/s = 20.  Design: one block
// per row; its threads stride over the row (coalesced loads), each keeps
// the partial sums of one 32-phase tile in registers and the tile's
// window edges in registers too (loaded once per tile through shared
// memory), so the inner loop touches no memory but the two row values.
// The block then folds the 32 sums with the fixed-order tree of
// common.cuh: no atomics and no split across blocks, so a row's energy
// depends neither on R nor on scheduling.  Products and sums are
// IEEE-rounded without contraction, as the plain version computes them;
// only the summation order differs from it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPT = 32;          // phases per tile: the pipeline's PHASE_ALIGN

__global__ void __launch_bounds__(kThreads)
pi_kernel(const float* __restrict__ t, const float* __restrict__ w,
          const float* __restrict__ ab, float* __restrict__ out, int S,
          int P) {
  __shared__ float s_ab[2 * kPT];
  __shared__ float scratch[(kThreads / 32) * kPT];
  const int row = blockIdx.x;
  const size_t base = static_cast<size_t>(row) * S;
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
      const float lo_t = i > 0 ? t[base + i - 1] : hi_t;
      const float p = w[base + i];
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

extern "C" int pi_launch(const float* t, const float* w, const float* ab,
                         float* out, int R, int S, int P, void* stream) {
  if (R <= 0 || P <= 0) return 0;
  pi_kernel<<<R, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, w, ab, out, S, P);
  return static_cast<int>(cudaGetLastError());
}
