// grid_resample: per-row masked lower bound + hold/linear regrid.
//
// Replaces the TPU kernel grid_resample_kernel (_gr_kernel ->
// grid_resample_ref) in src/repro/kernels/grid_resample/kernel.py.
//
// For row r and grid point g, with q = grid[g] + delay[r] (float32 add):
//   idx  = first j in [first[r], n[r]) with t[r, j] >= q  (n[r] if none);
//   mask = t[first] <= q <= t[n-1] and n > first;
//   hold:   out = v[clip(idx, first, n-1)];
//   linear: interpolate between clip(idx, first+1, n-1) and its left
//           neighbour, fraction clipped to [0, 1];
//   out = 0 where the mask is off.
// A -inf sentinel column (the streaming tail prepends one) is never
// selected for a finite query: -inf < q moves the search right.
// Rows must be non-decreasing in [first, n), as every caller's rows are
// (slots outside it may hold anything: no search leaves [first, n)).  On
// such a row the lower bound is unique, so the index is bit-identical to
// the reference's halving loop (ref.py's searchsorted_rows) and to
// torch.searchsorted however it is found.
//
// Why this design.  A block takes a row and all of its grid points, and
// copies the row's times and values into shared memory once, with
// 4-byte cp.async (a row starts at any 4-byte offset: the windowed rows
// are 2338 samples wide, so 16-byte copies would need an aligned
// superset), so the row crosses the memory system once and every probe
// of every search hits shared memory.
// The grid is sorted (the op pads it by repeating its last point), so a
// warp's 32 consecutive queries grid[g] + d are non-decreasing (float32
// rounding is monotone) and their lower bounds lie between those of the
// chunk's first query and of the next chunk's first query: a 32-query
// chunk spans ~17 samples of a windowed or batch row.  A warp takes a
// contiguous run of chunks in passes of at most kPass.  One search over
// the row's whole [first, n), a lane for each chunk's first query and one
// for the pass's last, bounds every chunk's range [lo_c, hi_c]; each
// query is then resolved inside its chunk's range.  A range's length is
// the same in every lane, so the search halves the length rather than
// the bounds (~5 steps of 7 instructions on a chunk, against the
// reference loop's 13 to 15 steps of 12 over the whole row), kILP chunks
// in lockstep so that their shared-memory loads overlap.
// Inputs that cannot take that way:
//   - a chunk whose queries are not in order (an unsorted or NaN grid;
//     tested once a chunk, each lane against the next query) searches
//     each lane over the whole [first, n): the same index on a sorted
//     row;
//   - a row longer than the shared memory holds (S > 29055 on the H100)
//     is not staged: the probes go to device memory (through L1).
// Tried in trial builds and not kept, each slower at both shapes: no
// staging (each warp reading its slice of the row through L1: the end
// passes' scattered probes cross L2), persistent blocks double-buffering
// their rows (at the batch shape one 140 KB block an SM), and fewer
// registers for more blocks an SM (spills).
//
// Tiles: one block a row, a warp per 16 chunks of the grid, 4 to 16
// warps (4 on the windowed path's 2048 points, 16 on the batch path's
// 16384); chunks split evenly over the warps.  Shared memory: 8 * S + 4
// bytes, dynamic, after the opt-in to the device's limit (227 KB on the
// H100; 18.7 KB a windowed row, 70.2 KB a batch row).  64 registers a
// thread, no spills (-Xptxas=-v, sm_90a).
// Bound on the H100: device memory.  Each row's times and values are read
// once and the (F, G) value and mask written (5 bytes an output, most of
// the bytes at the windowed shape); the stores are coalesced (a warp
// writes 128 contiguous bytes of values and 32 of mask).  At the batch
// shape the searches' instructions (~100 a query) take about as long as
// the bytes and the blocks of a wave copy and search in step, so the two
// add up rather than overlap (PERF.md, B5).  Arithmetic uses the
// IEEE-rounded intrinsics (no contraction) and NaN-propagating min/max,
// as the reference does.
#include "common.cuh"

namespace {

constexpr int kChunksPerWarp = 16;   // a block has a warp per 16 chunks,
constexpr int kMinWarps = 4;         // 4 to 16 warps
constexpr int kMaxWarps = 16;
constexpr int kPass = 31;            // chunks one end pass serves
constexpr int kILP = 8;              // chunks searched in lockstep
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// The lower bound of q in [base, base + len) (base + len if none), len the
// same in every lane: of the n = len + 1 candidates base .. base + len,
// keep the upper half while the slot just below it is below q.  After
// bit_width(len) steps n is 1 and base the answer; more steps change
// nothing (half is 0; the probe may then be base - 1).  kStaged: t is
// the staged row, whose slot -1 exists, so a probe needs no clamp.
template <bool kStaged>
__device__ __forceinline__ int lower_bound(const float* t, int S, float q,
                                           int base, int len, int steps) {
  int n = len + 1;
  for (int it = 0; it < steps; ++it) {
    const int half = n >> 1;
    const int probe = base + half - 1;
    if (t[kStaged ? probe : min(max(probe, 0), S - 1)] < q) base += half;
    n -= half;
  }
  return base;
}

__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
               "l"(src));
}

// A warp's pass over chunks [c0, c0 + nc) (nc <= kPass) of one row (t, v:
// the row, staged (kStaged: t[-1] exists, so a probe needs no clamp) or
// not; out, mask: the row's outputs).
template <bool kLinear, bool kStaged>
__device__ __forceinline__ void resample_pass(
    const float* t, const float* v, int S, int n, int first, float d,
    const float* __restrict__ grid, int G, int c0, int nc, int n_steps,
    float* __restrict__ out, unsigned char* __restrict__ mask) {
  const int lane = threadIdx.x & 31;
  const int last = max(n - 1, 0);
  const int hold_max = min(last, S - 1);
  const float t_first = t[min(first, S - 1)];
  const float t_last = t[min(last, S - 1)];
  const int g_stop = min(32 * (c0 + nc), G);       // the pass's end
  // the end pass: lane c < nc takes chunk c0 + c's first query, lane nc
  // the pass's last
  const float q_end = __fadd_rn(
      grid[lane < nc ? 32 * (c0 + lane) : g_stop - 1], d);
  int lb_end = first;
  if (lane <= nc)
    lb_end = lower_bound<kStaged>(t, S, q_end, first, max(n - first, 0),
                                  n_steps);
  for (int b = 0; b < nc; b += kILP) {
    // kILP chunks at once (past nc: a copy of the last, not written).
    // A chunk's candidates base .. base + n_c - 1 are warp-uniform.
    float q[kILP];
    int base[kILP], n_c[kILP];      // n_c: candidates left
    int steps = 0;
#pragma unroll
    for (int i = 0; i < kILP; ++i) {
      const int c = min(b + i, nc - 1);
      const int g = 32 * (c0 + c) + lane;
      q[i] = __fadd_rn(grid[min(g, G - 1)], d);
      // in order: no query above the next one (lane 31's next is the
      // next chunk's first, lane c + 1's end query)
      const float q_down = __shfl_down_sync(kFull, q[i], 1);
      const float q_chunk = __shfl_sync(kFull, q_end, c + 1);
      const bool ordered =
          g + 1 >= g_stop || q[i] <= (lane < 31 ? q_down : q_chunk);
      const bool in_order = __all_sync(kFull, ordered);
      const int lo_c = __shfl_sync(kFull, lb_end, c);
      const int hi_c = __shfl_sync(kFull, lb_end, c + 1);
      base[i] = in_order ? lo_c : first;
      n_c[i] = max(in_order ? hi_c - lo_c : n - first, 0) + 1;
      steps = max(steps, 32 - __clz(n_c[i] - 1));
    }
    // lower_bound's steps, the kILP chunks in lockstep
    for (int it = 0; it < steps; ++it) {
#pragma unroll
      for (int i = 0; i < kILP; ++i) {
        const int half = n_c[i] >> 1;
        const int probe = base[i] + half - 1;
        if (t[kStaged ? probe : min(max(probe, 0), S - 1)] < q[i])
          base[i] += half;
        n_c[i] -= half;
      }
    }
#pragma unroll
    for (int i = 0; i < kILP; ++i) {
      const int g = 32 * (c0 + b + i) + lane;
      if (b + i >= nc || g >= G) continue;
      const int idx = base[i];
      const bool m = (q[i] >= t_first) && (q[i] <= t_last) && (n > first);
      float o;
      if (!kLinear) {
        // idx >= first: clip(idx, first, n - 1), kept inside the row
        o = v[max(min(idx, hold_max), 0)];
      } else {
        const int j_hi = min(max(idx, first + 1), last);
        const int j_lo = max(j_hi - 1, 0);
        const int ia = min(max(j_lo, 0), S - 1);
        const int ib = min(max(j_hi, 0), S - 1);
        const float t_lo = t[ia], t_hi = t[ib];
        const float v_lo = v[ia], v_hi = v[ib];
        float frac = __fdiv_rn(__fsub_rn(q[i], t_lo),
                               pmax(__fsub_rn(t_hi, t_lo), 1e-12f));
        frac = pmin(pmax(frac, 0.0f), 1.0f);
        o = __fadd_rn(v_lo, __fmul_rn(frac, __fsub_rn(v_hi, v_lo)));
      }
      out[g] = m ? o : 0.0f;
      mask[g] = m ? 1 : 0;
    }
  }
}

template <bool kLinear, bool kStaged>
__global__ void __launch_bounds__(32 * kMaxWarps)
gr_kernel(const float* __restrict__ times, const float* __restrict__ values,
          const int* __restrict__ n_row, const int* __restrict__ first_row,
          const float* __restrict__ grid, const float* __restrict__ delays,
          float* __restrict__ out, unsigned char* __restrict__ mask, int S,
          int G, int n_steps) {
  extern __shared__ float staged[];  // kStaged: a pad, t[S], v[S]
  const int row = blockIdx.x;
  const float* t = times + static_cast<size_t>(row) * S;
  const float* v = values + static_cast<size_t>(row) * S;
  if (kStaged) {
    for (int j = threadIdx.x; j < S; j += blockDim.x) {
      copy4_async(staged + 1 + j, t + j);
      copy4_async(staged + S + 1 + j, v + j);
    }
  }
  const int n = n_row[row];
  const int first = first_row[row];
  const float d = delays[row];
  if (kStaged) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    t = staged + 1;
    v = staged + S + 1;
  }
  // warp w: chunks [w C / W, (w + 1) C / W) in passes of at most kPass
  const long long chunks = (G + 31) / 32;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int cw0 = static_cast<int>(warp * chunks / warps);
  const int len = static_cast<int>((warp + 1) * chunks / warps) - cw0;
  const int passes = (len + kPass - 1) / kPass;
  const size_t at = static_cast<size_t>(row) * G;
  for (int p = 0; p < passes; ++p) {
    const int c0 = cw0 + p * len / passes;
    const int c1 = cw0 + (p + 1) * len / passes;
    resample_pass<kLinear, kStaged>(t, v, S, n, first, d, grid, G, c0,
                                    c1 - c0, n_steps, out + at, mask + at);
  }
}

// the kernel's opt-in to the device's whole shared memory, once per
// device (the driver keeps it); *bytes: the device's limit
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int (&opted)[kMaxDevices], int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && opted[dev] > 0) {
    *bytes = opted[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(bytes,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
  if (err == cudaSuccess && dev < kMaxDevices) opted[dev] = *bytes;
  return err;
}

template <bool kLinear>
int launch(const float* times, const float* values, const int* n_row,
           const int* first_row, const float* grid, const float* delays,
           float* out, unsigned char* mask, int F, int S, int G,
           int n_steps, cudaStream_t stream) {
  static int opted[kMaxDevices] = {};        // the limit, once known
  int limit = 0;
  const cudaError_t err = opt_in(gr_kernel<kLinear, true>, opted, &limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(S) + 1);
  const int n_chunks = (G + 31) / 32;
  const int warps = min(kMaxWarps, max(kMinWarps, (n_chunks + kChunksPerWarp
                                                   - 1) / kChunksPerWarp));
  if (smem <= static_cast<size_t>(limit)) {
    gr_kernel<kLinear, true><<<F, 32 * warps, smem, stream>>>(
        times, values, n_row, first_row, grid, delays, out, mask, S, G,
        n_steps);
  } else {
    gr_kernel<kLinear, false><<<F, 32 * warps, 0, stream>>>(
        times, values, n_row, first_row, grid, delays, out, mask, S, G,
        n_steps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int grid_resample_launch(const float* times, const float* values,
                                    const int* n_row, const int* first_row,
                                    const float* grid, const float* delays,
                                    float* out, unsigned char* mask, int F,
                                    int S, int G, int n_steps, int linear,
                                    void* stream) {
  if (F <= 0 || G <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S <= 0) {                    // no sample: every mask is off
    const size_t fg = static_cast<size_t>(F) * G;
    const cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * fg, s);
    return static_cast<int>(err != cudaSuccess
                                ? err : cudaMemsetAsync(mask, 0, fg, s));
  }
  return linear ? launch<true>(times, values, n_row, first_row, grid,
                               delays, out, mask, F, S, G, n_steps, s)
                : launch<false>(times, values, n_row, first_row, grid,
                                delays, out, mask, F, S, G, n_steps, s);
}
