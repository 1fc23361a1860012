// selective_scan_bwd: the gradient of B10 (selective_scan.cu).
//
// No TPU kernel to replace: the reference trains its Mamba block through
// XLA's autodiff of the jnp chunked scan (src/repro/models/mamba.py,
// _chunk_scan under lax.scan).  Here the forward keeps the state entering
// every kChunk-th step (h_chunk), and this kernel walks the sequence
// backwards a chunk at a time.  With g the gradient of the loss with
// respect to the state, per channel (b, d) and for t = L-1 .. 0 (g starts
// as dh_last, or 0):
//   1. g += dy_t C_t                        (g is now dL/dh_t)
//   2. dC_t += dy_t h_t, dB_t += g (dt_t x_t)       (summed over d)
//   3. s = sum_n g B_t, dx_t = s dt_t
//   4. ddt_t = s x_t + sum_n g h_{t-1} abar_t A
//   5. dA += g h_{t-1} abar_t dt_t                   (summed over b, t)
//   6. g = abar_t g
// and dh0 = g at the end.  h_{t-1} and h_t come from recomputing the
// chunk's states from its checkpoint with the forward's own step
// (selective_scan.cuh: ss_abar, then ss_step_abar, which is ss_step), so
// they are the forward's bit for bit; nothing is ever divided by abar
// (it underflows to 0 for large dt |A|).
//
// Bound on the H100, at the training step's (2, 2048, 16384, 16) with x
// in bf16: the function's 12 FP32 operations a state update (the
// recomputed step's 3, the walk's 9: chip_smoke.py SCAN_BWD_FP32_OPS) on
// the FP32 pipes, 0.38 ms, above its bytes (dt, x, dy, the checkpoints,
// B, C and A read once, the gradients written once: 0.32 ms) and its
// B L D N exponentials on the special-function units (0.26 ms).  Each
// exponential is the IEEE expf (the forward's bits), ~10 FP32-pipe
// instructions beside its SFU op, so the recompute is most of the work.
//
// Design: a block of 128 threads, each holding kNS = 2 states of a
// channel; LN = 4 .. 32 lanes share a channel's N <= 64 states (8 at N =
// 16: 16 channels a block), padded with A = 0 and B = C = 0 so the
// padding stays 0.  For each chunk, from the last:
//   - its inputs (dt, x, dy of the block's channels, B_t and C_t) were
//     staged by cp.async into one of two buffers while the chunk before
//     ran, and its checkpoint loaded while the chunk before was summed;
//   - recompute: each thread steps its two states through the chunk,
//     taking each exponential once: the decay abar_t stays in registers
//     (64 a thread) for the walk, the state h_t goes to shared memory;
//   - dC[t, n] = sum_d dy[t, d] h_t[d, n], summed over the block's
//     channels in ascending order from shared memory by the threads that
//     own (t, n), before the walk;
//   - the walk back touches only its own registers and its own column of
//     shared memory: g_t replaces h_t (which the walk no longer needs),
//     and each step's partial sums over the thread's two states of
//     sum_n g B and sum_n g h abar A replace that step's decays in the
//     registers, so no shuffle runs in the walk;
//   - after it, the partial sums are added over the channel's lanes by a
//     fixed halving exchange (64/LN values a lane; 56 shuffles a chunk at
//     LN = 8), giving ddt and dx of kChunk / LN steps a lane, stored
//     from there; dB[t, n] = sum_d (dt x)[t, d] g_t[d, n] is summed like
//     dC.
// dB and dC of a chunk are then summed over a cluster of 8 blocks (the
// same batch row, 8 consecutive channel groups) in rank order through
// distributed shared memory, each rank a slice, one chunk behind so the
// cluster barrier's wait is hidden by the next chunk's recompute; one
// partial per cluster goes to a (parts, Bt, L, N) buffer: 128 parts at
// the training shape (67 MB of scratch, a quarter of the first
// version's part per 32 channels).  A fold adds the parts in order, and
// dA's per-row sums
// (each thread's, over t in its reverse order) over b in order.  No
// float atomics: every sum has a fixed order, so two runs give the same
// bits.  Shared memory at N = 16 with x in bf16: 32 KB of states, 2 x 8
// KB of inputs, 2 x 4 KB of the cluster's dB/dC: 56 KB, four blocks (16
// warps) an SM at 128 registers a thread.  A short last chunk runs all
// kChunk steps on inputs staged as zeros, so no step of the recompute
// or the walk branches.
#include <cooperative_groups.h>

#include "selective_scan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kNS = 2;             // states a thread holds
constexpr int kCluster = 8;        // blocks a dB/dC partial sums
constexpr int kVals = 2 * kChunk;  // a thread's walk sums a chunk

template <typename TD, typename TX, int LN>
struct Geom {
  static constexpr int CH = kThreads / LN;     // channels a block
  static constexpr int NP = LN * kNS;          // states a channel, padded
  // shared bytes: the states (kChunk x kNS rows of kThreads), then two
  // input buffers (dt, x, dy: kChunk x CH; B, C: kChunk x NP), then two
  // dB/dC buffers (2 x kChunk x NP)
  static constexpr int kStates = kChunk * kNS * kThreads * 4;
  static constexpr int kDt = 0;
  static constexpr int kX = (kDt + kChunk * CH * sizeof(TD) + 15) / 16 * 16;
  static constexpr int kDy = (kX + kChunk * CH * sizeof(TX) + 15) / 16 * 16;
  static constexpr int kB = (kDy + kChunk * CH * sizeof(TX) + 15) / 16 * 16;
  static constexpr int kC = kB + kChunk * NP * 4;
  static constexpr int kInput = kC + kChunk * NP * 4;
  static constexpr int kSums = 2 * kChunk * NP * 4;
  static constexpr int kBytes = kStates + 2 * kInput + 2 * kSums;
};

// the word of thread tid's value in state row r: the thread XOR-swizzled
// by r & 3, so the dB/dC sums, which read one column a channel, hit 32
// banks
__device__ __forceinline__ int hidx(int r, int tid) {
  return r * kThreads + (tid ^ ((r & 3) << 3));
}

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 4 bytes global -> shared, asynchronously; zeros where !ok
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                 "l"(src), "r"(ok ? 4 : 0));
}

// 16 bytes global -> shared, asynchronously; zeros where !ok
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                 "l"(src), "r"(ok ? 16 : 0));
}

// rows t0 .. t0 + kChunk - 1, channels c0 .. c0 + CH - 1 of a (Bt, L, D)
// array (row0 = the batch row's first element) into dst[s][c], zeros
// past nt steps or D channels: by 16-byte cp.async where `vec` (every
// row's pieces 16-byte aligned and wholly in or out of range: the
// launcher checks D, CH and the base), else float by 4-byte cp.async,
// bf16 by pairs where `pairs` (D even, 4-byte aligned base), else by
// plain loads and stores
template <int CH, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* row0, int D,
                                           int t0, int nt, int c0, int vec,
                                           bool pairs) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // a piece
  if (CH % kPer == 0 && vec) {
    constexpr int kItems = kChunk * CH / kPer;
#pragma unroll
    for (int k = 0; k < (kItems + kThreads - 1) / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int s = i * kPer / CH, c = i * kPer % CH;
      const bool ok = i < kItems && s < nt && c0 + c < D;
      if (i < kItems)
        cp16(dst + i * kPer,
             ok ? row0 + static_cast<size_t>(t0 + s) * D + c0 + c : row0,
             ok);
    }
  } else if (sizeof(T) == 4 || pairs) {
    constexpr int kEl = sizeof(T) == 4 ? 1 : 2;
    constexpr int kItems = kChunk * CH / kEl;
#pragma unroll
    for (int k = 0; k < (kItems + kThreads - 1) / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int s = i * kEl / CH, c = i * kEl % CH;
      const bool ok = i < kItems && s < nt && c0 + c < D;
      if (i < kItems)
        cp4(dst + i * kEl,
            ok ? row0 + static_cast<size_t>(t0 + s) * D + c0 + c : row0, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * CH; i += kThreads) {
      const int s = i / CH, c = i % CH;
      dst[i] = s < nt && c0 + c < D
          ? row0[static_cast<size_t>(t0 + s) * D + c0 + c]
          : from_f32<T>(0.0f);
    }
  }
}

// the chunk's inputs into an input buffer (not committed); `vec` bit 0:
// dt's rows by 16 bytes, bit 1: x's and dy's, bit 2: B's and C's (N a
// multiple of 4); the pointers are the batch row's first elements
template <typename TD, typename TX, int LN>
__device__ __forceinline__ void stage(unsigned char* buf, const TD* dt,
                                      const TX* x, const TX* dy,
                                      const float* Bm, const float* Cm,
                                      int D, int N, int t0, int nt, int c0,
                                      int vec, bool pairs) {
  using G = Geom<TD, TX, LN>;
  stage_rows<G::CH>(reinterpret_cast<TD*>(buf + G::kDt), dt, D, t0, nt, c0,
                    vec & 1, pairs);
  stage_rows<G::CH>(reinterpret_cast<TX*>(buf + G::kX), x, D, t0, nt, c0,
                    vec & 2, pairs);
  stage_rows<G::CH>(reinterpret_cast<TX*>(buf + G::kDy), dy, D, t0, nt, c0,
                    vec & 2, pairs);
  float* sb = reinterpret_cast<float*>(buf + G::kB);
  float* sc = reinterpret_cast<float*>(buf + G::kC);
  constexpr int kEl4 = kChunk * G::NP / 4;
  if (vec & 4) {
#pragma unroll
    for (int k = 0; k < (kEl4 + kThreads - 1) / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int s = 4 * i / G::NP, n = 4 * i % G::NP;
      const bool ok = i < kEl4 && s < nt && n < N;
      const size_t at = static_cast<size_t>(t0 + s) * N + n;
      if (i < kEl4) {
        cp16(sb + 4 * i, ok ? Bm + at : Bm, ok);
        cp16(sc + 4 * i, ok ? Cm + at : Cm, ok);
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < kChunk * G::NP; i += kThreads) {
    const int s = i / G::NP, n = i % G::NP;
    const bool ok = s < nt && n < N;
    const size_t at = static_cast<size_t>(t0 + s) * N + n;
    cp4(sb + i, ok ? Bm + at : Bm, ok);
    cp4(sc + i, ok ? Cm + at : Cm, ok);
  }
}

// two consecutive values of a staged row, widened (p 2-element aligned)
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// v[0 .. kVals) of each of a channel's LN lanes, added over the lanes by
// halving exchanges (lane bit M = LN/2 first, then M/2, ...): lane ln
// ends with the sums of values [ln kVals / LN, (ln + 1) kVals / LN) in
// v[0 .. kVals / LN)
template <int M, int Half>
__device__ __forceinline__ void lane_sums(float (&v)[kVals], int ln) {
  if constexpr (M >= 1) {
    const bool up = ln & M;
#pragma unroll
    for (int i = 0; i < Half; ++i) {
      const float send = up ? v[i] : v[i + Half];
      const float keep = up ? v[i + Half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
    }
    lane_sums<M / 2, Half / 2>(v, ln);
  }
}

// eight consecutive values of a staged row, widened (p 16-byte aligned)
__device__ __forceinline__ void ld8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// sum over the block's channels c = 0 .. CH-1, in order, of w[c] times
// state (or g) n of channel c at step s; w = row s of a staged array, or
// dt x of rows s of dt and x (read eight channels a load where CH allows)
template <int CH, int LN, typename T>
__device__ __forceinline__ float channel_sum(const float* sH, const T* w,
                                             int s, int n) {
  const int r = s * kNS + (n & 1);
  const float* row = sH + r * kThreads;
  const int sw = (r & 3) << 3, col = n / kNS;
  float acc = 0.0f;
  if constexpr (CH % 8 == 0) {
#pragma unroll
    for (int c0 = 0; c0 < CH; c0 += 8) {
      float wv[8];
      ld8(w + s * CH + c0, wv);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        acc = fmaf(wv[c], row[((c0 + c) * LN + col) ^ sw], acc);
    }
  } else {
#pragma unroll
    for (int c = 0; c < CH; c += 2) {
      const float2 wv = ld2(w + s * CH + c);
      acc = fmaf(wv.x, row[(c * LN + col) ^ sw], acc);
      acc = fmaf(wv.y, row[((c + 1) * LN + col) ^ sw], acc);
    }
  }
  return acc;
}
template <int CH, int LN, typename TD, typename TX>
__device__ __forceinline__ float channel_sum(const float* sH, const TD* dt,
                                             const TX* x, int s, int n) {
  const int r = s * kNS + (n & 1);
  const float* row = sH + r * kThreads;
  const int sw = (r & 3) << 3, col = n / kNS;
  float acc = 0.0f;
  if constexpr (CH % 8 == 0) {
#pragma unroll
    for (int c0 = 0; c0 < CH; c0 += 8) {
      float tv[8], xv[8];
      ld8(dt + s * CH + c0, tv);
      ld8(x + s * CH + c0, xv);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        acc = fmaf(ss_dx(tv[c], xv[c]), row[((c0 + c) * LN + col) ^ sw],
                   acc);
    }
  } else {
#pragma unroll
    for (int c = 0; c < CH; c += 2) {
      const float2 tv = ld2(dt + s * CH + c), xv = ld2(x + s * CH + c);
      acc = fmaf(ss_dx(tv.x, xv.x), row[(c * LN + col) ^ sw], acc);
      acc = fmaf(ss_dx(tv.y, xv.y), row[((c + 1) * LN + col) ^ sw], acc);
    }
  }
  return acc;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

template <typename TD, typename TX, int LN>
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kThreads, 4)
ssb_kernel(const TD* __restrict__ dt, const TX* __restrict__ x,
           const float* __restrict__ Bm, const float* __restrict__ Cm,
           const float* __restrict__ A, const float* __restrict__ h_chunk,
           const TX* __restrict__ dy, const float* __restrict__ dh_last,
           TD* __restrict__ ddt, TX* __restrict__ dx,
           float* __restrict__ part_b, float* __restrict__ part_c,
           float* __restrict__ part_a, float* __restrict__ dh0, int Bt,
           int L, int D, int N, int vec, int pairs) {
  using G = Geom<TD, TX, LN>;
  constexpr int CH = G::CH, NP = G::NP;
  constexpr int kStepsRound = kThreads / NP;    // dB/dC: steps a round
  constexpr int kRounds = kChunk / kStepsRound;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sH = reinterpret_cast<float*>(smem);
  unsigned char* inbuf = smem + G::kStates;
  float* sums = reinterpret_cast<float*>(inbuf + 2 * G::kInput);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int part = blockIdx.x / kCluster;

  const int tid = threadIdx.x;
  const int ch = tid / LN, ln = tid % LN;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CH;
  const int d = c0 + ch;
  const bool live = d < D;
  const int n_ckpt = (L + kChunk - 1) / kChunk;
  const size_t state0 = (static_cast<size_t>(b) * D + d) * N;
  float a[kNS], g[kNS], da[kNS], hc[kNS];
#pragma unroll
  for (int j = 0; j < kNS; ++j) {
    const int n = ln * kNS + j;
    const bool ok = live && n < N;
    a[j] = ok ? A[static_cast<size_t>(d) * N + n] : 0.0f;
    g[j] = ok && dh_last != nullptr ? dh_last[state0 + n] : 0.0f;
    da[j] = 0.0f;
  }
  // the checkpoint entering chunk k, this thread's states
  auto ckpt = [&](int k, float (&h)[kNS]) {
    const float* hk = h_chunk
        + ((static_cast<size_t>(b) * n_ckpt + k) * D + d) * N;
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      const int n = ln * kNS + j;
      h[j] = live && n < N ? hk[n] : 0.0f;
    }
  };
  // chunk it's dB (which 0) and dC (1) summed over the cluster's ranks in
  // order, this rank's slice, into the parts buffers
  auto reduce = [&](int it) {
    const int t0 = (n_ckpt - 1 - it) * kChunk;
    const int nt = min(kChunk, L - t0);
    const float* mine = sums + (it & 1) * (2 * kChunk * NP);
    constexpr int kPer = 2 * kChunk * NP / kCluster;
    for (int i = tid; i < kPer; i += kThreads) {
      const int v = rank * kPer + i;
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < kCluster; ++q)
        acc = __fadd_rn(acc, cluster.map_shared_rank(mine, q)[v]);
      const int which = v / (kChunk * NP);
      const int s = v % (kChunk * NP) / NP, n = v % NP;
      if (s < nt && n < N)
        (which == 0 ? part_b : part_c)[
            ((static_cast<size_t>(part) * Bt + b) * L + t0 + s) * N + n] =
            acc;
    }
  };

  // the batch row's inputs
  const size_t rowD = static_cast<size_t>(b) * L * D;
  const size_t rowN = static_cast<size_t>(b) * L * N;
  const TD* dt_b = dt + rowD;
  const TX* x_b = x + rowD;
  const TX* dy_b = dy + rowD;
  const float* B_b = Bm + rowN;
  const float* C_b = Cm + rowN;
  if (n_ckpt > 0) {
    const int t0 = (n_ckpt - 1) * kChunk;
    stage<TD, TX, LN>(inbuf, dt_b, x_b, dy_b, B_b, C_b, D, N, t0,
                      min(kChunk, L - t0), c0, vec, pairs);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int it = 0; it < n_ckpt; ++it) {
    const int k = n_ckpt - 1 - it;
    const int t0 = k * kChunk;
    const int nt = min(kChunk, L - t0);
    unsigned char* cur = inbuf + (it & 1) * G::kInput;
    if (it == 0) ckpt(k, hc);              // later chunks': after the walk
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // this chunk's inputs are in, and every thread is done with the
    // chunk before, whose buffer the next chunk's inputs now fill
    __syncthreads();
    if (k > 0)                             // the next chunk, meanwhile
      stage<TD, TX, LN>(inbuf + ((it + 1) & 1) * G::kInput, dt_b, x_b,
                        dy_b, B_b, C_b, D, N, t0 - kChunk, kChunk, c0, vec,
                        pairs);
    asm volatile("cp.async.commit_group;\n" ::);
    const TD* sDt = reinterpret_cast<const TD*>(cur + G::kDt);
    const TX* sX = reinterpret_cast<const TX*>(cur + G::kX);
    const TX* sDy = reinterpret_cast<const TX*>(cur + G::kDy);
    const float* sB = reinterpret_cast<const float*>(cur + G::kB);
    const float* sC = reinterpret_cast<const float*>(cur + G::kC);
    // recompute: the chunk's states (to shared memory) and decays (kept).
    // Every chunk runs kChunk steps: a short last chunk's missing steps
    // were staged as zeros (dt = dy = B = C = 0), which leave h and g as
    // they are (abar = 1, nothing added) and add nothing to dA; their
    // outputs and sums are never written.
    float v[kVals];
    {
      float h[kNS] = {hc[0], hc[1]};
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        const float dtv = as_f32(sDt[s * CH + ch]);
        const float dxv = ss_dx(dtv, as_f32(sX[s * CH + ch]));
#pragma unroll
        for (int j = 0; j < kNS; ++j) {
          const float ab = ss_abar(dtv, a[j]);
          h[j] = ss_step_abar(h[j], ab, dxv, sB[s * NP + ln * kNS + j]);
          sH[hidx(s * kNS + j, tid)] = h[j];
          v[s * kNS + j] = ab;
        }
      }
    }
    __syncthreads();                       // the states are in
    // dC from the states, summed over the channels in order: thread tid
    // owns state n of steps tid / NP + k kStepsRound (kept in registers
    // until the cluster's buffer is free)
    float dc[kRounds];
#pragma unroll
    for (int k = 0; k < kRounds; ++k)
      dc[k] = channel_sum<CH, LN>(sH, sDy, tid / NP + k * kStepsRound,
                                  tid % NP);
    __syncthreads();                       // dC has read the states
    // the walk back: own registers and own column only
#pragma unroll
    for (int s = kChunk - 1; s >= 0; --s) {
      {
        const float dtv = as_f32(sDt[s * CH + ch]);
        const float dyv = as_f32(sDy[s * CH + ch]);
        float ps = 0.0f, pa = 0.0f;
#pragma unroll
        for (int j = 0; j < kNS; ++j) {
          const int n = ln * kNS + j;
          const float hp = s > 0 ? sH[hidx((s - 1) * kNS + j, tid)] : hc[j];
          const float ab = v[s * kNS + j];
          g[j] = fmaf(dyv, sC[s * NP + n], g[j]);
          sH[hidx(s * kNS + j, tid)] = g[j];   // g_t into h_t's slot
          ps = fmaf(g[j], sB[s * NP + n], ps);
          const float gh = g[j] * hp * ab;
          pa = fmaf(gh, a[j], pa);
          da[j] = fmaf(gh, dtv, da[j]);
          g[j] = ab * g[j];
        }
        v[2 * s] = ps;                     // the decays are spent
        v[2 * s + 1] = pa;
      }
    }
    lane_sums<LN / 2, kVals / 2>(v, ln);
    if (k > 0) ckpt(k - 1, hc);            // the next chunk's, early
    // ddt and dx of this lane's steps s0 .. s0 + kChunk / LN - 1
    constexpr int kSteps = kChunk / LN;
    const int s0 = ln * kSteps;
    float out_dt[kSteps], out_dx[kSteps];
#pragma unroll
    for (int q = 0; q < kSteps; ++q) {
      const float dtv = as_f32(sDt[(s0 + q) * CH + ch]);
      const float xv = as_f32(sX[(s0 + q) * CH + ch]);
      out_dt[q] = fmaf(v[2 * q], xv, v[2 * q + 1]);
      out_dx[q] = v[2 * q] * dtv;
    }
    __syncthreads();                       // every g_t is in
    if (it > 0) {                          // the chunk before's dB/dC
      cluster_wait();
      reduce(it - 1);
    }
    // dB from g, summed like dC, and dC, into the cluster's buffer
    float* dbc = sums + (it & 1) * (2 * kChunk * NP);
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const int p = tid + k * kThreads;
      dbc[p] = channel_sum<CH, LN>(sH, sDt, sX, tid / NP + k * kStepsRound,
                                   tid % NP);
      dbc[kChunk * NP + p] = dc[k];
    }
    cluster_arrive();                      // this chunk's dB/dC are in
    // ddt and dx straight from the lanes (kSteps consecutive steps of a
    // channel each): the staged inputs stay for the next chunk's barrier
    if (live) {
#pragma unroll
      for (int q = 0; q < kSteps; ++q) {
        if (s0 + q < nt) {
          const size_t at = static_cast<size_t>(t0 + s0 + q) * D + d;
          ddt[rowD + at] = from_f32<TD>(out_dt[q]);
          dx[rowD + at] = from_f32<TX>(out_dx[q]);
        }
      }
    }
  }
  if (n_ckpt > 0) {
    cluster_wait();
    reduce(n_ckpt - 1);
  }
  cluster_arrive();                        // no block leaves while another
  cluster_wait();                          // reads its shared memory
  if (live) {
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      const int n = ln * kNS + j;
      if (n < N) {
        part_a[state0 + n] = da[j];
        dh0[state0 + n] = g[j];
      }
    }
  }
}

// out[m] = sum over p = 0 .. P-1 of parts[p][m], in order of p
__global__ void fold_kernel(const float* __restrict__ parts,
                            float* __restrict__ out, int P, long long M) {
  const long long m = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (m >= M) return;
  float s = parts[m];
  for (int p = 1; p < P; ++p) s += parts[p * M + m];
  out[m] = s;
}

int fold(const float* parts, float* out, int P, long long M,
         cudaStream_t st) {
  if (M <= 0) return 0;
  if (P <= 0) return static_cast<int>(cudaMemsetAsync(out, 0, M * 4, st));
  constexpr int kFoldThreads = 256;
  fold_kernel<<<static_cast<unsigned>((M + kFoldThreads - 1)
                                      / kFoldThreads),
                kFoldThreads, 0, st>>>(parts, out, P, M);
  return static_cast<int>(cudaGetLastError());
}

template <typename TD, typename TX, int LN>
int launch_ln(const void* dt, const void* x, const float* Bm,
              const float* Cm, const float* A, const float* h_chunk,
              const void* dy, const float* dh_last, void* ddt, void* dx,
              float* part_b, float* part_c, float* part_a, float* dh0,
              int Bt, int L, int D, int N, int parts, cudaStream_t st) {
  using G = Geom<TD, TX, LN>;
  const int groups = (D + G::CH - 1) / G::CH;
  if (parts != (groups + kCluster - 1) / kCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssb_kernel<TD, TX, LN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // bf16 pairs by 4-byte copies where no pair straddles a row
  const auto addr = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p);
  };
  const int pairs = D % 2 == 0 && ((addr(dt) | addr(x) | addr(dy)) & 3) == 0;
  // rows by 16-byte pieces where each row's pieces are aligned
  const auto rows16 = [&](const void* p, int elt) {
    return (D * elt) % 16 == 0 && (G::CH * elt) % 16 == 0 && addr(p) % 16 == 0;
  };
  const int vec = (rows16(dt, sizeof(TD)) ? 1 : 0) |
                  (rows16(x, sizeof(TX)) && rows16(dy, sizeof(TX)) ? 2 : 0) |
                  (N % 4 == 0 && (addr(Bm) | addr(Cm)) % 16 == 0 ? 4 : 0);
  ssb_kernel<TD, TX, LN><<<dim3(parts * kCluster, Bt), kThreads, G::kBytes,
                           st>>>(
      static_cast<const TD*>(dt), static_cast<const TX*>(x), Bm, Cm, A,
      h_chunk, static_cast<const TX*>(dy), dh_last, static_cast<TD*>(ddt),
      static_cast<TX*>(dx), part_b, part_c, part_a, dh0, Bt, L, D, N, vec,
      pairs);
  return static_cast<int>(cudaGetLastError());
}

template <typename TD, typename TX>
int launch(const void* dt, const void* x, const float* Bm, const float* Cm,
           const float* A, const float* h_chunk, const void* dy,
           const float* dh_last, void* ddt, void* dx, float* dB, float* dC,
           float* dA, float* dh0, float* part_b, float* part_c,
           float* part_a, int Bt, int L, int D, int N, int parts,
           void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > 64 || Bt < 0 || L < 0 || D < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bln = static_cast<long long>(Bt) * L * N;
  if (Bt == 0 || D == 0 || L == 0) {     // dB, dC and dA are sums of none
    int rc = fold(part_b, dB, 0, bln, st);
    if (rc == 0) rc = fold(part_c, dC, 0, bln, st);
    if (rc == 0) rc = fold(part_a, dA, 0, static_cast<long long>(D) * N, st);
    if (rc == 0 && L == 0 && dh0 != nullptr) {
      // no step: dh0 is dh_last (or 0)
      const size_t bytes = static_cast<size_t>(Bt) * D * N * 4;
      rc = static_cast<int>(
          dh_last != nullptr
              ? cudaMemcpyAsync(dh0, dh_last, bytes,
                                cudaMemcpyDeviceToDevice, st)
              : cudaMemsetAsync(dh0, 0, bytes, st));
    }
    return rc;
  }
  int rc;
  if (N <= 8)
    rc = launch_ln<TD, TX, 4>(dt, x, Bm, Cm, A, h_chunk, dy, dh_last, ddt,
                              dx, part_b, part_c, part_a, dh0, Bt, L, D, N,
                              parts, st);
  else if (N <= 16)
    rc = launch_ln<TD, TX, 8>(dt, x, Bm, Cm, A, h_chunk, dy, dh_last, ddt,
                              dx, part_b, part_c, part_a, dh0, Bt, L, D, N,
                              parts, st);
  else if (N <= 32)
    rc = launch_ln<TD, TX, 16>(dt, x, Bm, Cm, A, h_chunk, dy, dh_last, ddt,
                               dx, part_b, part_c, part_a, dh0, Bt, L, D, N,
                               parts, st);
  else
    rc = launch_ln<TD, TX, 32>(dt, x, Bm, Cm, A, h_chunk, dy, dh_last, ddt,
                               dx, part_b, part_c, part_a, dh0, Bt, L, D, N,
                               parts, st);
  if (rc == 0) rc = fold(part_b, dB, parts, bln, st);
  if (rc == 0) rc = fold(part_c, dC, parts, bln, st);
  if (rc == 0) rc = fold(part_a, dA, Bt, static_cast<long long>(D) * N, st);
  return rc;
}

}  // namespace

// dt's type, then x's (and dy's, ddt's in dt's, dx's in x's).  part_b and
// part_c: (parts, Bt, L, N) float32 scratch, parts = ceil(D / (8 CH)) with
// CH = 128 / LN channels a block (kernel.py bwd_channels: 8 CH channels a
// part); part_a: (Bt, D, N) float32 scratch; dh_last may be null (a zero
// gradient of h_last).
#define SSB_ENTRY(NAME, TD, TX)                                              \
  extern "C" int NAME(const void* dt, const void* x, const float* Bm,        \
                      const float* Cm, const float* A, const float* h_chunk, \
                      const void* dy, const float* dh_last, void* ddt,       \
                      void* dx, float* dB, float* dC, float* dA, float* dh0, \
                      float* part_b, float* part_c, float* part_a, int Bt,   \
                      int L, int D, int N, int parts, void* stream) {        \
    return launch<TD, TX>(dt, x, Bm, Cm, A, h_chunk, dy, dh_last, ddt, dx,   \
                          dB, dC, dA, dh0, part_b, part_c, part_a, Bt, L, D, \
                          N, parts, stream);                                 \
  }

// blocks of the backward that fit on an SM for dt's and x's types (0:
// float32, 1: bf16) and N, with its shared memory (-1 on a bad argument)
extern "C" int ssb_blocks_per_sm(int dt_bf16, int x_bf16, int N) {
  if (N < 1 || N > 64 || dt_bf16 > x_bf16) return -1;
  int blocks = -1;
  const auto occ = [&](auto kernel, int bytes) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads,
                                                  bytes);
  };
  using F = float;
  using H = __nv_bfloat16;
  const auto pick = [&](auto td, auto tx) {
    using TD = decltype(td);
    using TX = decltype(tx);
    if (N <= 8) occ(ssb_kernel<TD, TX, 4>, Geom<TD, TX, 4>::kBytes);
    else if (N <= 16) occ(ssb_kernel<TD, TX, 8>, Geom<TD, TX, 8>::kBytes);
    else if (N <= 32) occ(ssb_kernel<TD, TX, 16>, Geom<TD, TX, 16>::kBytes);
    else occ(ssb_kernel<TD, TX, 32>, Geom<TD, TX, 32>::kBytes);
  };
  if (dt_bf16) pick(H{}, H{});
  else if (x_bf16) pick(F{}, H{});
  else pick(F{}, F{});
  return blocks;
}

SSB_ENTRY(ssb_launch_f32_f32, float, float)
SSB_ENTRY(ssb_launch_f32_bf16, float, __nv_bfloat16)
SSB_ENTRY(ssb_launch_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
