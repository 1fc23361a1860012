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
// Why this design.  Phase windows are few and long against a slice of
// samples: the pipeline pads its phase list to 32 with empty windows
// [0, 0), and real phases partition the run, so an interval of a row
// overlaps one or two windows and every other term is max(<= 0, 0) * p,
// an exact zero.  A warp takes a slice of kSlice consecutive samples (kE
// a lane, coalesced), reduces the slice's time span [min t_lo, max t_hi]
// with shuffles (no assumption that t is sorted), and asks each window
// once, a lane a window (a ballot of 32), how it meets the span:
//   - not at all (empty, a >= b, or ending at or before the span or
//     starting at or after it): every term of a finite slice is +0 or
//     -0, and adding a zero leaves a sum that is not -0 unchanged, so the
//     window is skipped, bit for bit the dense sum in the same order;
//   - covering it (a <= every t_lo, b >= every t_hi): min(t_hi, b) = t_hi
//     and max(t_lo, a) = t_lo, so every covering window has the same
//     integral over the slice, computed once (32 windows that all span
//     the run cost one integral a slice);
//   - partially (an edge inside the span): integrated one by one, or, if
//     more than kSparse, all 32 at once, half a tile at a time, each
//     lane's 16 sums transposed across the warp by 31 shuffles.
// A slice's integral for a window is each lane's kE terms summed in
// order, then folded across the warp by the butterfly of xor 16, 8, 4,
// 2, 1 (the transpose folds in the same pairs, so every path gives the
// same bits); a warp adds it into its sum for the window in shared
// memory, slice after slice, and the block folds the warps' sums in warp
// order at the end.  For sorted rows a window has at most two partial
// slices, so the dense half-tiles run only where many window edges
// meet one slice, or where a row's times are out of order.
// Inputs that cannot take the fast way:
//   - a slice holding a non-finite t or p (a NaN or inf watt, NaN time,
//     the -inf carry column: decided by __all_sync) integrates every
//     window one by one with the NaN-propagating min/max, so NaN and inf
//     land where the plain version puts them (a NaN watt: every phase of
//     its row);
//   - a window with a NaN edge is never skipped, never covering, and
//     takes the NaN-propagating min/max too.
// Elsewhere the hardware min/max (FMNMX) is used: on operands without a
// NaN it differs from the NaN-propagating form at most in the sign of a
// zero, which the subtraction or max(., 0) removes.
//
// Tiles: one block of kThreads per row (a row's energy depends neither on
// R nor on scheduling: no atomics, no split across blocks); warp w takes
// slices w, w + kWarps, ...; the windows go 32 to a ballot, their edges
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
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kE = 8;                    // samples a lane holds per slice
constexpr int kSlice = 32 * kE;          // a warp's slice of a row
constexpr int kHalf = 16;                // windows a dense half-tile
constexpr int kSparse = 6;               // at most this many: one by one
constexpr int kMaxP = 1024;              // phases a launch
constexpr unsigned kFull = 0xffffffffu;

// The overlap of interval (lo, hi] with window [a, b), max(., 0).  kNaN:
// the NaN-propagating min/max; otherwise the hardware's.
template <bool kNaN>
__device__ __forceinline__ float overlap(float lo, float hi, float a,
                                         float b) {
  return kNaN ? pmax(__fsub_rn(pmin(hi, b), pmax(lo, a)), 0.0f)
              : fmaxf(__fsub_rn(fminf(hi, b), fmaxf(lo, a)), 0.0f);
}

// This lane's kE terms of a window that covers the slice's span (a <=
// every t_lo, b >= every t_hi): min(t_hi, b) = t_hi and max(t_lo, a) =
// t_lo, so the sum is lane_sum<false>'s, bit for bit, for every such window.
__device__ __forceinline__ float cover_sum(const float (&lo)[kE],
                                           const float (&hi)[kE],
                                           const float (&p)[kE]) {
  float s = 0.0f;
#pragma unroll
  for (int e = 0; e < kE; ++e)
    s = __fadd_rn(s, __fmul_rn(fmaxf(__fsub_rn(hi[e], lo[e]), 0.0f), p[e]));
  return s;
}

// This lane's kE terms of window [a, b), summed in order.
template <bool kNaN>
__device__ __forceinline__ float lane_sum(const float (&lo)[kE],
                                          const float (&hi)[kE],
                                          const float (&p)[kE], float a,
                                          float b) {
  float s = 0.0f;
#pragma unroll
  for (int e = 0; e < kE; ++e)
    s = __fadd_rn(s, __fmul_rn(overlap<kNaN>(lo[e], hi[e], a, b), p[e]));
  return s;
}

__global__ void __launch_bounds__(kThreads, 4)
pi_kernel(const float* __restrict__ t, const float* __restrict__ w,
          const float* __restrict__ ab, float* __restrict__ out, int S,
          int P, int ldo) {
  extern __shared__ float acc_s[];         // [kWarps][P]: a warp's sums
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * S;
  const float inf = __int_as_float(0x7f800000);
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
    // x * 0 is 0 for a finite x and NaN otherwise
    float z = 0.0f;
    float span_lo = inf, span_hi = -inf;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      z = __fmaf_rn(hi[e], 0.0f, __fmaf_rn(lo[e], 0.0f,
                                           __fmaf_rn(p[e], 0.0f, z)));
      const bool in = i0 + 32 * e + lane < S;
      span_lo = fminf(span_lo, in ? lo[e] : inf);
      span_hi = fmaxf(span_hi, in ? hi[e] : -inf);
    }
    const bool finite = __all_sync(kFull, z == 0.0f);
    for (int off = 16; off > 0; off >>= 1) {
      span_lo = fminf(span_lo, __shfl_xor_sync(kFull, span_lo, off));
      span_hi = fmaxf(span_hi, __shfl_xor_sync(kFull, span_hi, off));
    }
    for (int j0 = 0; j0 < P; j0 += 32) {
      // lane k holds window j0 + k
      const int j = j0 + lane;
      const bool has = j < P;
      const float a = has ? ab[2 * j] : 0.0f;
      const float b = has ? ab[2 * j + 1] : 0.0f;
      // every term of a skipped window is +0 or -0 (NaN edges compare
      // false and are never skipped)
      unsigned todo = __ballot_sync(
          kFull, has && !(finite && (a >= b || b <= span_lo ||
                                     a >= span_hi)));
      const unsigned exact =
          finite ? __ballot_sync(kFull, a != a || b != b) : kFull;
      // the windows covering the whole span of a finite slice share one
      // integral (folded by the same butterfly as any window's)
      const unsigned cover =
          finite ? todo & __ballot_sync(kFull, a <= span_lo && b >= span_hi)
                 : 0u;
      if (cover) {
        float s = cover_sum(lo, hi, p);
        for (int off = 16; off > 0; off >>= 1)
          s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
        if ((cover >> lane) & 1u) acc[j] = __fadd_rn(acc[j], s);
        todo &= ~cover;
      }
      if (__popc(todo) > kSparse && !(todo & exact)) {
        // many windows: all 32, half a tile at a time, each lane's sums
        // transposed across the warp so that lanes k and k + 16 get
        // window k's total; only the windows of todo are added
#pragma unroll
        for (int h = 0; h < 32; h += kHalf) {
          if (!((todo >> h) & ((1u << kHalf) - 1))) continue;
          float s[kHalf];
#pragma unroll
          for (int k = 0; k < kHalf; ++k)
            s[k] = lane_sum<false>(lo, hi, p, __shfl_sync(kFull, a, h + k),
                                   __shfl_sync(kFull, b, h + k));
#pragma unroll
          for (int k = 0; k < kHalf; ++k)
            s[k] = __fadd_rn(s[k], __shfl_xor_sync(kFull, s[k], 16));
#pragma unroll
          for (int width = kHalf / 2; width > 0; width >>= 1) {
            // keep the half of s[0, 2 width) this lane's bit selects,
            // add the partner lane's copy of it
            const bool upper = lane & width;
#pragma unroll
            for (int k = 0; k < width; ++k) {
              const float give = upper ? s[k] : s[k + width];
              const float keep = upper ? s[k + width] : s[k];
              s[k] = __fadd_rn(keep, __shfl_xor_sync(kFull, give, width));
            }
          }
          const int k = h + (lane & (kHalf - 1));
          if (lane < kHalf && ((todo >> k) & 1u))
            acc[j0 + k] = __fadd_rn(acc[j0 + k], s[0]);
        }
      } else {
        // few windows, or a NaN-propagating one: one at a time, the
        // same butterfly folding the lanes
        while (todo) {
          const int k = __ffs(todo) - 1;
          todo &= todo - 1;
          const float a_k = __shfl_sync(kFull, a, k);
          const float b_k = __shfl_sync(kFull, b, k);
          float s = (exact >> k) & 1u ? lane_sum<true>(lo, hi, p, a_k, b_k)
                                      : lane_sum<false>(lo, hi, p, a_k, b_k);
          for (int off = 16; off > 0; off >>= 1)
            s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
          if (lane == 0) acc[j0 + k] = __fadd_rn(acc[j0 + k], s);
        }
      }
    }
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
