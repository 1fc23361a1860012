// phase_integrate: per-phase energy of sample-and-hold power rows.
//
// Replaces the TPU kernel phase_integrate_kernel (_pi_kernel) in
// src/repro/kernels/phase_integrate/kernel.py.
//
//   E[r, j] = sum_i p[r,i] * max(min(t[r,i], b_j) - max(t[r,i-1], a_j), 0)
// with t[r,-1] = t[r,0] (column 0 is a zero-width interval), for (R, S)
// rows and any number P of phase windows [a_j, b_j) (overlapping,
// unsorted or empty); max/min propagate NaN as torch.maximum/jnp.maximum
// do (the ingest carry column may be -inf).
//
// Why this design: a warp takes a slice of kSlice consecutive samples (kE
// a lane, coalesced) and adds its integral over each phase window into
// the warp's sums; phase_windows.cuh skips the windows the slice cannot
// touch, integrates the windows that cover it once, and takes the rest
// one by one or in dense half-tiles.  The argument that skipping is bit
// for bit the dense sum, and which inputs take the NaN-propagating
// branch (a slice holding a non-finite time or watt, a window with a NaN
// edge), are written there.  Column 0 is the zero-width interval
// (t[r,0], t[r,0]] at its own watt, as in the plain version.
//
// Tiles: one block of kThreads per row (a row's energy depends neither on
// R nor on scheduling: no atomics, no split across blocks); warp w takes
// slices w, w + kWarps, ... and the block folds the warps' sums in warp
// order at the end; the windows go 32 to a ballot, their edges
// read from device memory (L1) once a slice, so the row is read once
// whatever P is.  Shared memory: kWarps x P float sums (P <= kMaxP a
// launch: the entry launches once per kMaxP phases; 1 KB at P = 32).
// 64 registers a thread (__launch_bounds__: 4 blocks an SM, the batch
// path's 512 rows in one wave), no spills (-Xptxas=-v, sm_90a).
// Bound on the H100: device memory (8 bytes a sample) whenever windows
// are skipped or cover; the dense half-tiles are bound by the six
// instructions of a term (min, max, sub, max, mul, add).  Products and
// sums are IEEE-rounded without contraction, as the plain version
// computes them; only the summation order differs from it.
#include "phase_windows.cuh"

namespace {

namespace pw = phase_windows;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kE = 8;                    // samples a lane holds per slice
constexpr int kSlice = 32 * kE;          // a warp's slice of a row
constexpr int kMaxP = 1024;              // phases a launch

__global__ void __launch_bounds__(kThreads, 4)
pi_kernel(const float* __restrict__ t, const float* __restrict__ w,
          const float* __restrict__ ab, float* __restrict__ out, int S,
          int P, int ldo) {
  extern __shared__ float acc_s[];         // [kWarps][P]: a warp's sums
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * S;
  float* acc = acc_s + warp * P;
  for (int j = lane; j < P; j += 32) acc[j] = 0.0f;
  __syncwarp();
  for (int i0 = warp * kSlice; i0 < S; i0 += kWarps * kSlice) {
    // the slice; samples past the row read as t = 0, p = 0 (exact zero
    // terms unless an edge is NaN, which every real sample makes NaN too)
    float lo[kE], hi[kE], p[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int i = i0 + 32 * e + lane;
      const bool in = i < S;
      hi[e] = in ? t[base + i] : 0.0f;
      lo[e] = in ? t[base + (i > 0 ? i - 1 : 0)] : 0.0f;
      p[e] = in ? w[base + i] : 0.0f;
    }
    float span_lo, span_hi;
    const bool finite = pw::slice_span(lo, hi, p, S - i0, span_lo, span_hi);
    pw::integrate_slice(lo, hi, p, finite, span_lo, span_hi, ab, P, acc);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < P; j += kThreads) {
    float total = 0.0f;
    for (int k = 0; k < kWarps; ++k)
      total = __fadd_rn(total, acc_s[k * P + j]);
    out[static_cast<size_t>(blockIdx.x) * ldo + j] = total;
  }
}

}  // namespace

extern "C" int pi_launch(const float* t, const float* w, const float* ab,
                         float* out, int R, int S, int P, void* stream) {
  if (R <= 0 || P <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S <= 0)                      // no interval: every energy is 0
    return static_cast<int>(cudaMemsetAsync(
        out, 0, sizeof(float) * static_cast<size_t>(R) * P, s));
  for (int p0 = 0; p0 < P; p0 += kMaxP) {
    const int pc = P - p0 < kMaxP ? P - p0 : kMaxP;
    pi_kernel<<<R, kThreads, sizeof(float) * kWarps * pc, s>>>(
        t, w, ab + 2 * p0, out + p0, S, pc, P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
