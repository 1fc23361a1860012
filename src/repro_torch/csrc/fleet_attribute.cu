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
// Why this design.  The streaming path's chunk is 1024 reads plus the
// carry column, about one read's interval meets a real phase window, and
// the 26 windows that pad the phase list to 32 are empty: the work is
// the bytes, 8 a read, and a launch's fixed cost.  So B7 is B6's integral
// (phase_windows.cuh: windows a slice cannot touch are skipped, bit for
// bit; the windows covering it share one integral; NaN and inf take the
// NaN-propagating branch) over intervals whose power is formed in
// registers: interval i >= 1 is (t_{i-1}, t_i] at wrapped_power (common.cuh,
// the plain version's bits), lane l of a warp holds intervals i0 + 32 k +
// l + 1 (coalesced loads of t and e), and takes its left reads from lane
// l - 1 by a shuffle; lane 0 takes them from lane 31's previous interval,
// and for its first from one load of the column before the slice.  The
// power row never exists in memory.  The division is most of an
// interval's arithmetic; wrapped_power keeps the repeated reads (dE = 0,
// about a sixth of the chunk's intervals) off its slow path, the largest
// single gain among the designs tried.  Column 0's own term is p_0 = 0 times
// a zero-width overlap: NaN exactly when t_0 or an edge is NaN, and then
// interval 1's term is NaN too (its left end is t_0), so for S >= 2 it
// is left out; for S = 1 it is the whole row and is written directly.
// Inputs that cannot take the fast way are phase_windows.cuh's: a slice
// with a non-finite time or power (a NaN or inf read, the -inf carry
// column, dt = inf) and a window with a NaN edge.
//
// Tiles: one block of kWarps warps per row; warp w takes the slices of
// 32 x kE intervals w, w + kWarps, ... (1024 intervals: one slice a warp,
// every warp busy; kE = 8, four warps a row, and two rows a block were
// slower at both 1025 and 4097 columns), adds their integrals into its
// own sums in shared memory, and the block folds the warps' sums in warp
// order, so a row's energy depends neither on R nor on scheduling (no
// atomics, no split across blocks).  The first 32 windows' edges are
// loaded once, with the reads; P <= kMaxP a launch (the entry launches
// once per kMaxP phases; 1 KB of shared memory at P = 32).  64 registers
// a thread (__launch_bounds__: 4 blocks an SM, the 512 rows in one wave),
// no spills (-Xptxas=-v, sm_90a).
// Bound on the H100: device memory (8 bytes a read) and, at the chunk's
// size, the launch itself; the dense half-tiles (shuffled reads, many
// interior windows) are bound by the six instructions of a term.
#include "phase_windows.cuh"

namespace {

namespace pw = phase_windows;

constexpr int kE = 4;                    // intervals a lane holds per slice
constexpr int kSlice = 32 * kE;          // a warp's slice of a row
constexpr int kWarps = 8;                // warps a row (a block)
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxP = 1024;              // phases a launch

// The reads a lane needs for its intervals of the slice starting at
// interval i0 (interval i closes at column i + 1): their right ends, and
// for lane 0 the column before the slice.  Past the row: 0.
struct SliceReads {
  float t[kE], e[kE], t_left, e_left;
};

__device__ __forceinline__ void load_slice(const float* __restrict__ tr,
                                           const float* __restrict__ er,
                                           int i0, int n_int,
                                           SliceReads& r) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kE; ++k) {
    const int i = i0 + 32 * k + lane;
    r.t[k] = i < n_int ? tr[i + 1] : 0.0f;
    r.e[k] = i < n_int ? er[i + 1] : 0.0f;
  }
  const bool left = lane == 0 && i0 < n_int;
  r.t_left = left ? tr[i0] : 0.0f;
  r.e_left = left ? er[i0] : 0.0f;
}

__global__ void __launch_bounds__(kThreads, 4)
fa_kernel(const float* __restrict__ t, const float* __restrict__ e,
          const float* __restrict__ wrap, const float* __restrict__ ab,
          float* __restrict__ out, int S, int P, int ldo) {
  extern __shared__ float acc_s[];         // [kWarps][P]: a warp's sums
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x;
  const int n_int = S - 1;                 // intervals 1 .. S - 1
  const float* tr = t + static_cast<size_t>(row) * S;
  const float* er = e + static_cast<size_t>(row) * S;
  SliceReads cur;
  load_slice(tr, er, warp * kSlice, n_int, cur);
  // the first 32 windows' edges, a lane a window, loaded with the reads
  const float a0 = lane < P ? ab[2 * lane] : 0.0f;
  const float b0 = lane < P ? ab[2 * lane + 1] : 0.0f;
  const float w = wrap[row];
  float* acc = acc_s + warp * P;
  for (int j = lane; j < P; j += 32) acc[j] = 0.0f;
  __syncwarp();
  for (int i0 = warp * kSlice; i0 < n_int; i0 += kWarps * kSlice) {
    if (i0 != warp * kSlice) load_slice(tr, er, i0, n_int, cur);
    // lane l takes its left reads from lane l - 1; lane 0 from the
    // column before the slice, then from lane 31's previous interval
    float lo[kE], hi[kE], p[kE];
    float lt = cur.t_left, le = cur.e_left;
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      const float rt = __shfl_sync(pw::kFull, cur.t[k], (lane + 31) & 31);
      const float re = __shfl_sync(pw::kFull, cur.e[k], (lane + 31) & 31);
      const float t0 = lane ? rt : lt;
      const float e0 = lane ? re : le;
      const bool in = i0 + 32 * k + lane < n_int;
      hi[k] = cur.t[k];
      lo[k] = in ? t0 : 0.0f;
      p[k] = in ? wrapped_power(cur.e[k], e0, hi[k], t0, w) : 0.0f;
      lt = rt;
      le = re;
    }
    float span_lo, span_hi;
    const bool finite =
        pw::slice_span(lo, hi, p, n_int - i0, span_lo, span_hi);
    for (int j0 = 0; j0 < P; j0 += 32) {
      float a = a0, b = b0;
      if (j0) {
        const bool has = j0 + lane < P;
        a = has ? ab[2 * (j0 + lane)] : 0.0f;
        b = has ? ab[2 * (j0 + lane) + 1] : 0.0f;
      }
      pw::integrate_tile(lo, hi, p, finite, span_lo, span_hi, a, b, j0, P,
                         acc);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < P; j += kThreads) {
    float total = 0.0f;
    for (int k = 0; k < kWarps; ++k)
      total = __fadd_rn(total, acc_s[k * P + j]);
    if (S == 1) {                          // column 0's term alone
      const float t0 = t[row];
      total = __fmul_rn(pw::overlap<true>(t0, t0, ab[2 * j], ab[2 * j + 1]),
                        0.0f);
    }
    out[static_cast<size_t>(row) * ldo + j] = total;
  }
}

}  // namespace

extern "C" int fa_launch(const float* t, const float* e, const float* wrap,
                         const float* ab, float* out, int R, int S, int P,
                         void* stream) {
  if (R <= 0 || P <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S <= 0)                      // no interval: every energy is 0
    return static_cast<int>(cudaMemsetAsync(
        out, 0, sizeof(float) * static_cast<size_t>(R) * P, s));
  for (int p0 = 0; p0 < P; p0 += kMaxP) {
    const int pc = P - p0 < kMaxP ? P - p0 : kMaxP;
    fa_kernel<<<R, kThreads, sizeof(float) * kWarps * pc, s>>>(
        t, e, wrap, ab + 2 * p0, out + p0, S, pc, P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
