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
// element against 3.35 TB/s, a handful of flops between.  Keeping the
// memory busy takes ~2.3 MB of loads in flight (3.35 TB/s x ~0.7 us), so
// the loads go first: a thread takes one run of 4 columns a round, and
// issues the next round's 16-byte loads of t and e before it computes
// this one (e whatever the keep mask: the same cache lines are read
// either way); at 256 threads a row and ~4 rows an SM that is ~32 KB in
// flight an SM, above the ~18 KB an SM's share of that needs.  Two or
// four runs a round without the overlap were slower (four, or 512
// threads a row, also take more registers a block than 4 blocks an SM
// allow, so the 512 rows no longer fit one wave).  Columns at or past n
// are not read (their outputs are 0).  Column j's left
// neighbour comes from the lane before by a shuffle; lane 0 loads it
// (one extra 8 bytes a warp and round, from the cache lines of the warp
// before).  Power is stored as float4 and the four valid flags as one
// 32-bit word.
// A row starts at element row * S, 16-byte aligned only when S % 4 == 0,
// so each row has a scalar head (the columns before its first 16-byte
// boundary) and tail (after its last) of at most 3 columns each around
// the aligned body, taken by threads 0-2 and 32-34: their reads are
// issued before the body's and their outputs written after it, so they
// add no round trip.  Rows keep one block each.
// Inputs that cannot take the fast way: t or e (or the outputs) not
// 16-byte aligned at element 0 (a view at an odd offset) run the scalar
// kernel, one column a thread, with the same arithmetic.
// The row's reordered flag is the block's __syncthreads_or, written by
// thread 0: an OR does not depend on order, so no atomics and no second
// pass.  Every arithmetic operation is an IEEE-rounded intrinsic (no
// contraction), the division is IEEE (wrapped_power, common.cuh), so
// power is bit-identical to the plain version.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Column j's power and keep flag from its reads (t1, e1) and its left
// neighbour's (t0, e0); v1: j < n; left: j >= 1.  ORs a step back of a
// valid pair into `back`.
__device__ __forceinline__ float column(float t1, float t0, float e1,
                                        float e0, float w, bool v1,
                                        bool left, bool& keep, int& back) {
  back |= (left && v1 && t1 < t0) ? 1 : 0;
  keep = left && v1 && t1 > t0;
  return keep ? wrapped_power(e1, e0, t1, t0, w) : 0.0f;
}

// One column taken on its own (the scalar head and tail, and the
// unaligned kernel): its reads and its left neighbour's, then its outputs.
struct Col {
  int col;                                 // -1: none
  float t1, t0, e1, e0;
};

__device__ __forceinline__ Col load_col(const float* __restrict__ e,
                                        const float* __restrict__ t,
                                        size_t base, int col, int n) {
  Col c{col, 0.0f, 0.0f, 0.0f, 0.0f};
  if (col >= 1 && col < n) {
    c.t1 = t[base + col];
    c.t0 = t[base + col - 1];
    c.e1 = e[base + col];
    c.e0 = e[base + col - 1];
  }
  return c;
}

__device__ __forceinline__ void store_col(const Col& c, size_t base, int n,
                                          float w, float* __restrict__ power,
                                          unsigned char* __restrict__ valid,
                                          int& back) {
  bool keep;
  power[base + c.col] = column(c.t1, c.t0, c.e1, c.e0, w, c.col < n,
                               c.col >= 1, keep, back);
  valid[base + c.col] = keep ? 1 : 0;
}

// A thread's 4-column run q of the row's aligned body (columns head + 4 q
// .. + 3) as read: t and e, and for lane 0 the column before the run.
// Runs past the body or starting at or past n read as 0.
struct Run {
  float4 t, e;
  float t_left, e_left;
};

__device__ __forceinline__ Run load_run(const float4* __restrict__ t4,
                                        const float4* __restrict__ e4,
                                        const float* __restrict__ t,
                                        const float* __restrict__ e,
                                        size_t base, int head, int nq, int q,
                                        int n) {
  const int col = head + 4 * q;
  const bool ld = q < nq && col < n;
  const bool left = ld && (threadIdx.x & 31) == 0 && col > 0;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return Run{ld ? t4[q] : zero, ld ? e4[q] : zero,
             left ? t[base + col - 1] : 0.0f,
             left ? e[base + col - 1] : 0.0f};
}

__global__ void __launch_bounds__(kThreads)
pr_fleet_kernel(const float* __restrict__ e, const float* __restrict__ t,
                const float* __restrict__ wrap, const int* __restrict__ n_row,
                float* __restrict__ power, unsigned char* __restrict__ valid,
                unsigned char* __restrict__ reordered, int S) {
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const size_t base = static_cast<size_t>(row) * S;
  const float w = wrap[row];
  const int n = n_row[row];
  int head = static_cast<int>((4 - (base & 3)) & 3);
  if (head > S) head = S;
  const int nq = (S - head) >> 2;          // aligned 4-column runs
  const int tail = head + 4 * nq;
  int back = 0;
  // the head's and the tail's columns (at most 3 each): thread k takes
  // head column k, thread 32 + k tail column k; their reads are issued
  // before the body's, their outputs written after it
  const int tid = threadIdx.x;
  int side_col = -1;
  if (tid < head)
    side_col = tid;
  else if (tid >= 32 && tid - 32 < S - tail)
    side_col = tail + tid - 32;
  const Col side = load_col(e, t, base, side_col, n);

  const float4* t4 = reinterpret_cast<const float4*>(t + base + head);
  const float4* e4 = reinterpret_cast<const float4*>(e + base + head);
  float4* p4 = reinterpret_cast<float4*>(power + base + head);
  uint32_t* v4 = reinterpret_cast<uint32_t*>(valid + base + head);
  // thread i takes runs i, i + kThreads, ...: each round's loads are
  // issued before the round before is computed and stored
  Run cur = load_run(t4, e4, t, e, base, head, nq, tid, n);
  for (int q0 = 0; q0 < nq; q0 += kThreads) {
    const int q = q0 + tid;
    const Run next = load_run(t4, e4, t, e, base, head, nq, q + kThreads, n);
    const int col = head + 4 * q;
    const bool live = q < nq;              // past the body: no column
    float t0 = __shfl_up_sync(kFull, cur.t.w, 1);
    float e0 = __shfl_up_sync(kFull, cur.e.w, 1);
    if (lane == 0) {
      t0 = cur.t_left;
      e0 = cur.e_left;
    }
    bool k0, k1, k2, k3;
    float4 pq;
    pq.x = column(cur.t.x, t0, cur.e.x, e0, w, live && col < n, col >= 1,
                  k0, back);
    pq.y = column(cur.t.y, cur.t.x, cur.e.y, cur.e.x, w,
                  live && col + 1 < n, true, k1, back);
    pq.z = column(cur.t.z, cur.t.y, cur.e.z, cur.e.y, w,
                  live && col + 2 < n, true, k2, back);
    pq.w = column(cur.t.w, cur.t.z, cur.e.w, cur.e.z, w,
                  live && col + 3 < n, true, k3, back);
    if (live) {
      p4[q] = pq;
      v4[q] = static_cast<uint32_t>(k0) | static_cast<uint32_t>(k1) << 8 |
              static_cast<uint32_t>(k2) << 16 |
              static_cast<uint32_t>(k3) << 24;
    }
    cur = next;
  }
  if (side.col >= 0) store_col(side, base, n, w, power, valid, back);
  back = __syncthreads_or(back);
  if (threadIdx.x == 0) reordered[row] = back ? 1 : 0;
}

// Rows whose pointers are not 16-byte aligned: one column a thread.
__global__ void __launch_bounds__(kThreads)
pr_fleet_scalar_kernel(const float* __restrict__ e,
                       const float* __restrict__ t,
                       const float* __restrict__ wrap,
                       const int* __restrict__ n_row,
                       float* __restrict__ power,
                       unsigned char* __restrict__ valid,
                       unsigned char* __restrict__ reordered, int S) {
  const int row = blockIdx.x;
  const size_t base = static_cast<size_t>(row) * S;
  const float w = wrap[row];
  const int n = n_row[row];
  int back = 0;
  for (int col = threadIdx.x; col < S; col += kThreads)
    store_col(load_col(e, t, base, col, n), base, n, w, power, valid, back);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t vec = reinterpret_cast<uintptr_t>(e) |
                        reinterpret_cast<uintptr_t>(t) |
                        reinterpret_cast<uintptr_t>(power);
  if (vec % 16 == 0 && reinterpret_cast<uintptr_t>(valid) % 4 == 0)
    pr_fleet_kernel<<<F, kThreads, 0, s>>>(e, t, wrap, n_row, power, valid,
                                           reordered, S);
  else
    pr_fleet_scalar_kernel<<<F, kThreads, 0, s>>>(e, t, wrap, n_row, power,
                                                  valid, reordered, S);
  return static_cast<int>(cudaGetLastError());
}
