// grid_resample: per-row masked lower bound + hold/linear regrid.
//
// Replaces the TPU kernel grid_resample_kernel (_gr_kernel ->
// grid_resample_ref) in src/repro/kernels/grid_resample/kernel.py.
//
// For row r and grid point g, with q = grid[g] + delay[r] (float32 add):
//   idx  = first j in [first[r], n[r]) with t[r, j] >= q  (n[r] if none),
//          found by the same branch-free halving loop as ref.py's
//          searchsorted_rows: ceil(log2 S) + 1 steps, so the index is the
//          unique lower bound, bit-identical to torch.searchsorted;
//   mask = t[first] <= q <= t[n-1] and n > first;
//   hold:   out = v[clip(idx, first, n-1)];
//   linear: interpolate between clip(idx, first+1, n-1) and its left
//           neighbour, fraction clipped to [0, 1];
//   out = 0 where the mask is off.
// A -inf sentinel column (the streaming tail prepends one) is never
// selected for a finite query: -inf < q moves the search right.
//
// Bound on the H100: device memory (each row's times and values are read,
// the (F, G) value and mask written; the search is ~log2(S) compares per
// output from on-chip memory).  Design: one block per (row, tile of
// kTile grid points).  The block stages the row's times and values in
// shared memory when 8*S bytes fit the default 48 KB (S ~ 2.2k on the
// main path, ~17 KB), so the ~12 dependent probes of every search hit
// shared memory instead of L2; longer rows probe device memory directly.
// Threads of a warp take consecutive grid points, so the stores are
// coalesced.  Arithmetic uses the IEEE-rounded intrinsics (no
// contraction) and NaN-propagating min/max, as the reference does.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;          // grid points per block
constexpr int kSmemBytes = 48 * 1024;

template <bool kLinear, bool kStaged>
__global__ void gr_kernel(const float* __restrict__ times,
                          const float* __restrict__ values,
                          const int* __restrict__ n_row,
                          const int* __restrict__ first_row,
                          const float* __restrict__ grid,
                          const float* __restrict__ delays,
                          float* __restrict__ out,
                          unsigned char* __restrict__ mask, int F, int S,
                          int G, int n_steps) {
  extern __shared__ float staged[];
  const int g_lo = blockIdx.x * kTile;
  const int g_hi = min(G, g_lo + kTile);
  for (int row = blockIdx.y; row < F; row += gridDim.y) {
    const float* t = times + static_cast<size_t>(row) * S;
    const float* v = values + static_cast<size_t>(row) * S;
    if (kStaged) {
      __syncthreads();               // the previous row's probes are done
      for (int j = threadIdx.x; j < S; j += kThreads) {
        staged[j] = t[j];
        staged[S + j] = v[j];
      }
      __syncthreads();
      t = staged;
      v = staged + S;
    }
    const int n = n_row[row];
    const int first = first_row[row];
    const float d = delays[row];
    const int last = max(n - 1, 0);
    const float t_first = t[min(first, S - 1)];
    const float t_last = t[min(last, S - 1)];
    for (int g = g_lo + threadIdx.x; g < g_hi; g += kThreads) {
      const float q = __fadd_rn(grid[g], d);
      int lo = first;
      int hi = n;
      for (int it = 0; it < n_steps; ++it) {
        const int mid = (lo + hi) / 2;
        const float tm = t[min(max(mid, 0), S - 1)];
        const bool right = (tm < q) && (mid < hi);
        lo = right ? mid + 1 : lo;
        hi = right ? hi : min(mid, hi);
      }
      const bool m = (q >= t_first) && (q <= t_last) && (n > first);
      float o;
      if (!kLinear) {
        const int j = min(max(lo, first), last);
        o = v[min(max(j, 0), S - 1)];
      } else {
        const int j_hi = min(max(lo, first + 1), last);
        const int j_lo = max(j_hi - 1, 0);
        const int a = min(max(j_lo, 0), S - 1);
        const int b = min(max(j_hi, 0), S - 1);
        const float t_lo = t[a], t_hi = t[b];
        const float v_lo = v[a], v_hi = v[b];
        float frac = __fdiv_rn(__fsub_rn(q, t_lo),
                               pmax(__fsub_rn(t_hi, t_lo), 1e-12f));
        frac = pmin(pmax(frac, 0.0f), 1.0f);
        o = __fadd_rn(v_lo, __fmul_rn(frac, __fsub_rn(v_hi, v_lo)));
      }
      const size_t at = static_cast<size_t>(row) * G + g;
      out[at] = m ? o : 0.0f;
      mask[at] = m ? 1 : 0;
    }
  }
}

template <bool kLinear>
int launch(const float* times, const float* values, const int* n_row,
           const int* first_row, const float* grid, const float* delays,
           float* out, unsigned char* mask, int F, int S, int G,
           int n_steps, cudaStream_t stream) {
  dim3 blocks((G + kTile - 1) / kTile, F < 65535 ? F : 65535);
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(S);
  if (smem <= kSmemBytes) {
    gr_kernel<kLinear, true><<<blocks, kThreads, smem, stream>>>(
        times, values, n_row, first_row, grid, delays, out, mask, F, S, G,
        n_steps);
  } else {
    gr_kernel<kLinear, false><<<blocks, kThreads, 0, stream>>>(
        times, values, n_row, first_row, grid, delays, out, mask, F, S, G,
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
  return linear ? launch<true>(times, values, n_row, first_row, grid,
                               delays, out, mask, F, S, G, n_steps, s)
                : launch<false>(times, values, n_row, first_row, grid,
                                delays, out, mask, F, S, G, n_steps, s);
}
