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
// (selective_scan.cuh), so they are the forward's bit for bit; nothing is
// ever divided by abar (it underflows to 0 for large dt |A|).
//
// Bound on the H100, at the training step's (2, 2048, 16384, 16) with x
// in bf16: the function's 12 FP32 operations a state update (the
// recomputed step's 3, the walk's 9: chip_smoke.py SCAN_BWD_FP32_OPS) on
// the FP32 pipes, 0.38 ms, above its bytes (dt, x, dy, the checkpoints,
// B, C and A read once, the gradients written once: 0.32 ms) and its
// B L D N exponentials on the special-function units (0.26 ms); the
// dB/dC partials, this design's scratch, add ~0.16 ms of traffic.  This
// kernel is the simple, right one: the walk is a dependent chain per
// channel, it takes each exponential twice (the recompute's and the
// walk's), its states go through shared memory twice, and the dB/dC sums
// take 6 NS shuffles a step; making it fast is later work.
//
// Design: the forward's layout, kLanes = 4 threads sharing a channel's
// N <= 64 states (NS each, padded with A = 0 and B = C = 0, so the padding
// stays 0), A's row and g in registers.  A block holds CH channels (32,
// or 16 at N > 32, where a thread holds 16 states) of one batch row and,
// for each chunk from the last:
//   - stages the chunk's dt, x, dy (its channels) and B_t, C_t in shared
//     memory, widened to float32;
//   - recomputes the chunk's kChunk + 1 states (the checkpoint, then one
//     per step) into shared memory, each thread its own column;
//   - walks the chunk backwards: the sums over n (steps 3 and 4) across
//     the channel's four lanes by a shuffle butterfly, whose every lane
//     ends with the same sum; dB_t's and dC_t's contributions summed over
//     a warp's 8 channels by a butterfly over lanes 4, 8, 16 apart, each
//     warp's sum kept in shared memory;
//   - then writes ddt and dx coalesced, and the block's dB/dC partials
//     (its warps' sums added in warp order) to a (D/CH, Bt, L, N) buffer.
// A second kernel folds the partials over the channel blocks in block
// order, and dA's per-row sums (each thread's, over t in its reverse
// order) over b in order.  No float atomics: every sum has a fixed order,
// so two runs give the same bits.
#include "selective_scan.cuh"

namespace {

template <int NS> struct Geom {
  static constexpr int kThreads = NS == 16 ? 64 : 128;
  static constexpr int CH = kThreads / kLanes;  // channels a block
  static constexpr int NP = kLanes * NS;        // states a channel, padded
  static constexpr int W = kThreads / 32;       // warps a block
  // shared floats: the states, dt/x/dy and ddt/dx, B and C, dB/dC sums
  static constexpr int kFloats = (kChunk + 1) * NS * kThreads
                                 + 5 * kChunk * CH + 2 * kChunk * NP
                                 + 2 * W * kChunk * NP;
};

__device__ __forceinline__ float ld_f32(const float* p) { return *p; }
__device__ __forceinline__ float ld_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename TD, typename TX, int NS>
__global__ void __launch_bounds__(Geom<NS>::kThreads)
ssb_kernel(const TD* __restrict__ dt, const TX* __restrict__ x,
           const float* __restrict__ Bm, const float* __restrict__ Cm,
           const float* __restrict__ A, const float* __restrict__ h_chunk,
           const TX* __restrict__ dy, const float* __restrict__ dh_last,
           TD* __restrict__ ddt, TX* __restrict__ dx,
           float* __restrict__ part_b, float* __restrict__ part_c,
           float* __restrict__ part_a, float* __restrict__ dh0, int Bt,
           int L, int D, int N) {
  using G = Geom<NS>;
  constexpr int NT = G::kThreads, CH = G::CH, NP = G::NP, W = G::W;
  constexpr unsigned kFull = 0xffffffffu;
  extern __shared__ __align__(16) float smem[];
  float* sH = smem;                          // [kChunk + 1][NS][NT]
  float* sDt = sH + (kChunk + 1) * NS * NT;  // [kChunk][CH] each
  float* sX = sDt + kChunk * CH;
  float* sDy = sX + kChunk * CH;
  float* sGdt = sDy + kChunk * CH;
  float* sGdx = sGdt + kChunk * CH;
  float* sB = sGdx + kChunk * CH;            // [kChunk][NP] each
  float* sC = sB + kChunk * NP;
  float* sPB = sC + kChunk * NP;             // [W][kChunk][NP] each
  float* sPC = sPB + W * kChunk * NP;

  const int tid = threadIdx.x;
  const int ch = tid / kLanes, ln = tid % kLanes;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CH;
  const int d = c0 + ch;
  const bool live = d < D;
  const int n_ckpt = (L + kChunk - 1) / kChunk;
  const size_t state0 = (static_cast<size_t>(b) * D + d) * N;
  float a[NS], g[NS], da[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int n = ln * NS + j;
    const bool ok = live && n < N;
    a[j] = ok ? A[static_cast<size_t>(d) * N + n] : 0.0f;
    g[j] = ok && dh_last != nullptr ? dh_last[state0 + n] : 0.0f;
    da[j] = 0.0f;
  }

  for (int k = n_ckpt - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int nt = min(kChunk, L - t0);
    __syncthreads();                     // the last chunk's reads are done
    for (int i = tid; i < kChunk * CH; i += NT) {
      const int s = i / CH, c = i % CH;
      const bool ok = s < nt && c0 + c < D;
      const size_t at = (static_cast<size_t>(b) * L + t0 + s) * D + c0 + c;
      sDt[i] = ok ? ld_f32(dt + at) : 0.0f;
      sX[i] = ok ? ld_f32(x + at) : 0.0f;
      sDy[i] = ok ? ld_f32(dy + at) : 0.0f;
    }
    for (int i = tid; i < kChunk * NP; i += NT) {
      const int s = i / NP, n = i % NP;
      const bool ok = s < nt && n < N;
      const size_t at = (static_cast<size_t>(b) * L + t0 + s) * N + n;
      sB[i] = ok ? Bm[at] : 0.0f;
      sC[i] = ok ? Cm[at] : 0.0f;
    }
    float h[NS];
    const float* hc = h_chunk
        + ((static_cast<size_t>(b) * n_ckpt + k) * D + d) * N;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int n = ln * NS + j;
      h[j] = live && n < N ? hc[n] : 0.0f;
      sH[j * NT + tid] = h[j];
    }
    __syncthreads();                     // the chunk's inputs are staged
    // the chunk's states, as the forward stepped them
    for (int s = 0; s < nt; ++s) {
      const float dtv = sDt[s * CH + ch];
      const float dxv = ss_dx(dtv, sX[s * CH + ch]);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        h[j] = ss_step(h[j], dtv, dxv, a[j], sB[s * NP + ln * NS + j]);
        sH[((s + 1) * NS + j) * NT + tid] = h[j];
      }
    }
    // the walk back, t = t0 + nt - 1 .. t0
    for (int s = nt - 1; s >= 0; --s) {
      const float dtv = sDt[s * CH + ch], xv = sX[s * CH + ch];
      const float dyv = sDy[s * CH + ch];
      const float dxv = ss_dx(dtv, xv);
      float ps = 0.0f, pa = 0.0f, cb[NS], cc[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int n = ln * NS + j;
        const float hp = sH[(s * NS + j) * NT + tid];        // h_{t-1}
        const float ht = sH[((s + 1) * NS + j) * NT + tid];  // h_t
        const float ab = ss_abar(dtv, a[j]);
        g[j] = fmaf(dyv, sC[s * NP + n], g[j]);
        cc[j] = dyv * ht;
        cb[j] = g[j] * dxv;
        ps = fmaf(g[j], sB[s * NP + n], ps);
        const float gh = g[j] * hp * ab;
        pa = fmaf(gh, a[j], pa);
        da[j] = fmaf(gh, dtv, da[j]);
        g[j] = ab * g[j];
      }
      ps += __shfl_xor_sync(kFull, ps, 1);
      ps += __shfl_xor_sync(kFull, ps, 2);
      pa += __shfl_xor_sync(kFull, pa, 1);
      pa += __shfl_xor_sync(kFull, pa, 2);
      if (ln == 0) {
        sGdt[s * CH + ch] = fmaf(ps, xv, pa);
        sGdx[s * CH + ch] = ps * dtv;
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int off = kLanes; off < 32; off <<= 1) {
          cb[j] += __shfl_xor_sync(kFull, cb[j], off);
          cc[j] += __shfl_xor_sync(kFull, cc[j], off);
        }
      }
      if (lane < kLanes) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          sPB[(warp * kChunk + s) * NP + ln * NS + j] = cb[j];
          sPC[(warp * kChunk + s) * NP + ln * NS + j] = cc[j];
        }
      }
    }
    __syncthreads();                     // the chunk's sums are in
    for (int i = tid; i < kChunk * CH; i += NT) {
      const int s = i / CH, c = i % CH;
      if (s < nt && c0 + c < D) {
        const size_t at = (static_cast<size_t>(b) * L + t0 + s) * D + c0 + c;
        ddt[at] = from_f32<TD>(sGdt[i]);
        dx[at] = from_f32<TX>(sGdx[i]);
      }
    }
    for (int i = tid; i < kChunk * NP; i += NT) {
      const int s = i / NP, n = i % NP;
      if (s < nt && n < N) {
        float sb = sPB[i], sc = sPC[i];
#pragma unroll
        for (int w = 1; w < W; ++w) {
          sb += sPB[w * kChunk * NP + i];
          sc += sPC[w * kChunk * NP + i];
        }
        const size_t at =
            ((static_cast<size_t>(blockIdx.x) * Bt + b) * L + t0 + s) * N + n;
        part_b[at] = sb;
        part_c[at] = sc;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int n = ln * NS + j;
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

template <typename TD, typename TX, int NS>
int launch_ns(const void* dt, const void* x, const float* Bm,
              const float* Cm, const float* A, const float* h_chunk,
              const void* dy, const float* dh_last, void* ddt, void* dx,
              float* part_b, float* part_c, float* part_a, float* dh0,
              int Bt, int L, int D, int N, int parts, cudaStream_t st) {
  using G = Geom<NS>;
  if (parts != (D + G::CH - 1) / G::CH)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = G::kFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssb_kernel<TD, TX, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssb_kernel<TD, TX, NS><<<dim3(parts, Bt), G::kThreads, bytes, st>>>(
      static_cast<const TD*>(dt), static_cast<const TX*>(x), Bm, Cm, A,
      h_chunk, static_cast<const TX*>(dy), dh_last, static_cast<TD*>(ddt),
      static_cast<TX*>(dx), part_b, part_c, part_a, dh0, Bt, L, D, N);
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
  if (N < 1 || N > 16 * kLanes || Bt < 0 || L < 0 || D < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bln = static_cast<long long>(Bt) * L * N;
  if (Bt == 0 || D == 0) {               // dB, dC and dA are sums of none
    int rc = fold(part_b, dB, 0, bln, st);
    if (rc == 0) rc = fold(part_c, dC, 0, bln, st);
    if (rc == 0) rc = fold(part_a, dA, 0, static_cast<long long>(D) * N, st);
    return rc;
  }
  int rc;
  if (N <= 4 * kLanes)
    rc = launch_ns<TD, TX, 4>(dt, x, Bm, Cm, A, h_chunk, dy, dh_last, ddt,
                              dx, part_b, part_c, part_a, dh0, Bt, L, D, N,
                              parts, st);
  else if (N <= 8 * kLanes)
    rc = launch_ns<TD, TX, 8>(dt, x, Bm, Cm, A, h_chunk, dy, dh_last, ddt,
                              dx, part_b, part_c, part_a, dh0, Bt, L, D, N,
                              parts, st);
  else
    rc = launch_ns<TD, TX, 16>(dt, x, Bm, Cm, A, h_chunk, dy, dh_last, ddt,
                               dx, part_b, part_c, part_a, dh0, Bt, L, D, N,
                               parts, st);
  if (rc == 0) rc = fold(part_b, dB, parts, bln, st);
  if (rc == 0) rc = fold(part_c, dC, parts, bln, st);
  if (rc == 0) rc = fold(part_a, dA, Bt, static_cast<long long>(D) * N, st);
  return rc;
}

}  // namespace

// dt's type, then x's (and dy's, ddt's in dt's, dx's in x's).  part_b and
// part_c: (parts, Bt, L, N) float32 scratch, parts = ceil(D / CH) with CH
// = 32 channels a block (16 at N > 32); part_a: (Bt, D, N) float32
// scratch; dh_last may be null (a zero gradient of h_last).
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

SSB_ENTRY(ssb_launch_f32_f32, float, float)
SSB_ENTRY(ssb_launch_f32_bf16, float, __nv_bfloat16)
SSB_ENTRY(ssb_launch_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
