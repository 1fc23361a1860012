// The per-phase integral of a warp's slice of sample-and-hold intervals,
// shared by phase_integrate.cu (B6: power rows) and fleet_attribute.cu
// (B7: power formed in registers from counter reads).
//
// A warp holds a slice of 32 x kE intervals, kE a lane: interval k of a
// lane is (lo[k], hi[k]] at power p[k], and intervals past the row are
// lo = hi = p = 0.  For each phase window [a_j, b_j) the slice adds
//   sum_k p[k] * max(min(hi[k], b_j) - max(lo[k], a_j), 0)
// into the warp's sum for the window, acc[j] (shared memory).
//
// Why a window can be skipped.  Phase windows are few and long against a
// slice: the pipeline pads its phase list to 32 with empty windows
// [0, 0), and real phases partition the run, so an interval meets one or
// two windows and every other term is max(<= 0, 0) * p, an exact zero.
// slice_span reduces the slice's time span [min lo, max hi] with shuffles
// (no assumption that times are sorted) and decides whether every lo, hi
// and p of the slice is finite; integrate_slice then asks each window
// once, a lane a window (a ballot of 32), how it meets the span:
//   - not at all (empty, a >= b, or ending at or before the span or
//     starting at or after it): every term of a finite slice is +0 or
//     -0 (-0 where p < 0: a counter stepping back by less than half its
//     wrap, or a read out of order).  Adding a zero of either sign leaves
//     a sum that is not -0 unchanged, and these sums are never -0: each
//     starts at +0, and under round-to-nearest an addition gives -0 only
//     from two -0 operands (an exact cancellation x + (-x) gives +0).  So
//     the skip is bit for bit the dense sum in the same order, whatever
//     the signs of p;
//   - covering it (a <= every lo, b >= every hi): min(hi, b) = hi and
//     max(lo, a) = lo, so every covering window has the same integral
//     over the slice, computed once (cover_sum);
//   - partially (an edge inside the span): integrated one by one, or, if
//     more than kSparse, all 32 at once, half a tile at a time, each
//     lane's 16 sums transposed across the warp by 31 shuffles.
// A slice's integral for a window is each lane's kE terms summed in
// order, then folded across the warp by the butterfly of xor 16, 8, 4,
// 2, 1 (the transpose folds in the same pairs, so every path gives the
// same bits); the warp adds it into acc[j], slice after slice.
// For sorted rows a window has at most two partial slices, so the dense
// half-tiles run only where many window edges meet one slice, or where a
// row's times are out of order.
// Inputs that cannot take the fast way:
//   - a slice holding a non-finite lo, hi or p (a NaN or inf watt, a NaN
//     time, a -inf carry column: decided by __all_sync) integrates every
//     window one by one with the NaN-propagating min/max, so NaN and inf
//     land where the plain version puts them;
//   - a window with a NaN edge is never skipped, never covering, and
//     takes the NaN-propagating min/max too.
// Elsewhere the hardware min/max (FMNMX) is used: on operands without a
// NaN it differs from the NaN-propagating form at most in the sign of a
// zero, which the subtraction or max(., 0) removes.  Products and sums
// are IEEE-rounded without contraction, as the plain version computes
// them; only the summation order differs from it.
#pragma once

#include "common.cuh"

namespace phase_windows {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kHalf = 16;                // windows a dense half-tile
constexpr int kSparse = 6;               // at most this many: one by one

// The overlap of interval (lo, hi] with window [a, b), max(., 0).  kNaN:
// the NaN-propagating min/max; otherwise the hardware's.
template <bool kNaN>
__device__ __forceinline__ float overlap(float lo, float hi, float a,
                                         float b) {
  return kNaN ? pmax(__fsub_rn(pmin(hi, b), pmax(lo, a)), 0.0f)
              : fmaxf(__fsub_rn(fminf(hi, b), fmaxf(lo, a)), 0.0f);
}

// This lane's kE terms of a window that covers the slice's span (a <=
// every lo, b >= every hi): min(hi, b) = hi and max(lo, a) = lo, so the
// sum is lane_sum<false>'s, bit for bit, for every such window.
template <int kE>
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
template <bool kNaN, int kE>
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

// The slice's span over its first `left` intervals (interval k of lane
// l is the slice's 32 k + l-th), reduced across the warp into every lane;
// returns whether every lo, hi and p of the slice is finite (x * 0 is 0
// for a finite x and NaN otherwise).
template <int kE>
__device__ __forceinline__ bool slice_span(const float (&lo)[kE],
                                           const float (&hi)[kE],
                                           const float (&p)[kE], int left,
                                           float& span_lo, float& span_hi) {
  const int lane = threadIdx.x & 31;
  const float inf = __int_as_float(0x7f800000);
  float z = 0.0f;
  span_lo = inf;
  span_hi = -inf;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    z = __fmaf_rn(hi[e], 0.0f, __fmaf_rn(lo[e], 0.0f,
                                         __fmaf_rn(p[e], 0.0f, z)));
    const bool in = 32 * e + lane < left;
    span_lo = fminf(span_lo, in ? lo[e] : inf);
    span_hi = fmaxf(span_hi, in ? hi[e] : -inf);
  }
  const bool finite = __all_sync(kFull, z == 0.0f);
  for (int off = 16; off > 0; off >>= 1) {
    span_lo = fminf(span_lo, __shfl_xor_sync(kFull, span_lo, off));
    span_hi = fmaxf(span_hi, __shfl_xor_sync(kFull, span_hi, off));
  }
  return finite;
}

// Add the slice's integral over windows j0 .. j0 + 31 (those below P)
// into acc; lane k holds window j0 + k's edges a, b (every lane of the
// warp calls it).
template <int kE>
__device__ __forceinline__ void integrate_tile(
    const float (&lo)[kE], const float (&hi)[kE], const float (&p)[kE],
    bool finite, float span_lo, float span_hi, float a, float b, int j0,
    int P, float* acc) {
  const int lane = threadIdx.x & 31;
  const int j = j0 + lane;
  const bool has = j < P;
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

// Add the slice's integral over each of the P windows ab[2 j], ab[2 j +
// 1] into acc[j] (the warp's sums; every lane of the warp calls it).
template <int kE>
__device__ __forceinline__ void integrate_slice(
    const float (&lo)[kE], const float (&hi)[kE], const float (&p)[kE],
    bool finite, float span_lo, float span_hi,
    const float* __restrict__ ab, int P, float* acc) {
  const int lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < P; j0 += 32) {
    // lane k holds window j0 + k
    const int j = j0 + lane;
    const bool has = j < P;
    const float a = has ? ab[2 * j] : 0.0f;
    const float b = has ? ab[2 * j + 1] : 0.0f;
    integrate_tile(lo, hi, p, finite, span_lo, span_hi, a, b, j0, P, acc);
  }
}

}  // namespace phase_windows
