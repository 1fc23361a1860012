// xcorr_align: normalized correlation of every stream with a lag bank.
//
// Replaces the TPU kernel xcorr_align_kernel (_xc_kernel ->
// xcorr_scores_ref) in src/repro/kernels/xcorr_align/kernel.py.
//
//   cnt  = max(sum_g m[f,g], 1);  mean = sum_g x*m / cnt
//   xc   = (x - mean) * m;        den_x = sqrt(sum_g xc^2)
//   den_r[l] = sqrt(sum_g bank[l,g]^2)
//   out[f,l] = (sum_g xc[f,g] * bank[l,g]) / (den_x[f] * den_r[l] + 1e-12)
//
// The bank is (L_out, G) with only its first L_real rows real: the op pads
// the lag count to LAG_ALIGN with zero rows, whose scores are exactly 0.
// The kernel writes those zeros and runs the product over the real rows
// only (129 of 256 lags on the main path).
//
// Bound on the H100: float32 operations (2*F*L_real*G for the product
// against ~8*F*G bytes).  Hopper's wgmma has no float32 path and TF32
// keeps ~3 decimal digits, which the 1e-5 bound on the scores does not
// allow, so the product runs on the SIMT FMA units.  Design, in two
// launches:
//   prepare  blocks [0, F): per stream row, masked mean, centring (xc is
//            kept in a scratch buffer), ||xc|| by a deterministic block
//            sum, and the zero scores of the padded lags;
//            blocks [F, F + L_real): ||bank_l||;
//   scores   a shared-memory tiled product, kBM x kBN outputs per block,
//            kTM x kTN per thread read as vectors from shared memory,
//            depth kBK per stage with the next stage prefetched into
//            registers, and the divide fused into the epilogue.
// Each output (f, l) is accumulated by ONE thread over g = 0..G-1 in
// order, kBK products at a time with FFMA into a stage sum that is then
// added to the running sum: no split-K, no atomics.  A row's score
// therefore never depends on F or on which other rows are scored with
// it — the invariant the reference pins with ROW_ALIGN.  With F*L_real
// outputs and no split-K the grid is small (a few warps per SM at the
// windowed path's shapes), so the tiles are kept small to spread it over
// all SMs.
// sqrt and the divide are IEEE.
#include "common.cuh"

namespace {

constexpr int kRowThreads = 256;
constexpr int kBM = 32, kBN = 32, kBK = 32;
constexpr int kTM = 2, kTN = 4;
constexpr int kPad = 4;           // keeps vector reads aligned
constexpr int kGemmThreads = (kBM / kTM) * (kBN / kTN);
static_assert((kBM * kBK) % kGemmThreads == 0, "A tile load");
static_assert((kBN * kBK) % kGemmThreads == 0, "B tile load");
static_assert(kBM % 4 == 0 && kBN % 4 == 0 && kBK % 8 == 0, "tile map");

__global__ void prepare_kernel(const float* __restrict__ x,
                               const float* __restrict__ m,
                               const float* __restrict__ bank,
                               float* __restrict__ xc,
                               float* __restrict__ den_x,
                               float* __restrict__ den_r,
                               float* __restrict__ out, int F, int G,
                               int L_out, int L_real) {
  __shared__ float scratch[33];
  if (blockIdx.x >= F) {                      // a bank row's norm
    const int l = blockIdx.x - F;
    const size_t base = static_cast<size_t>(l) * G;
    float s = 0.0f;
    for (int g = threadIdx.x; g < G; g += kRowThreads) {
      const float v = bank[base + g];
      s = __fadd_rn(s, __fmul_rn(v, v));
    }
    const float total = block_sum(s, scratch);
    if (threadIdx.x == 0) den_r[l] = __fsqrt_rn(total);
    return;
  }
  const int f = blockIdx.x;
  const size_t base = static_cast<size_t>(f) * G;
  float s_m = 0.0f, s_xm = 0.0f;
  for (int g = threadIdx.x; g < G; g += kRowThreads) {
    const float mv = m[base + g];
    s_m = __fadd_rn(s_m, mv);
    s_xm = __fadd_rn(s_xm, __fmul_rn(x[base + g], mv));
  }
  const float cnt = pmax(block_sum(s_m, scratch), 1.0f);
  const float mean = __fdiv_rn(block_sum(s_xm, scratch), cnt);
  float s_sq = 0.0f;
  for (int g = threadIdx.x; g < G; g += kRowThreads) {
    const float c = __fmul_rn(__fsub_rn(x[base + g], mean), m[base + g]);
    xc[base + g] = c;
    s_sq = __fadd_rn(s_sq, __fmul_rn(c, c));
  }
  const float total = block_sum(s_sq, scratch);
  if (threadIdx.x == 0) den_x[f] = __fsqrt_rn(total);
  for (int l = L_real + threadIdx.x; l < L_out; l += kRowThreads)
    out[static_cast<size_t>(f) * L_out + l] = 0.0f;
}

// N consecutive floats from 16-byte-aligned shared memory as vectors.
template <int N>
__device__ __forceinline__ void load_frag(const float* p, float* v) {
  static_assert(N % 4 == 0, "fragment of whole float4s");
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
  }
}
template <>
__device__ __forceinline__ void load_frag<2>(const float* p, float* v) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x; v[1] = q.y;
}

__global__ void __launch_bounds__(kGemmThreads)
scores_kernel(const float* __restrict__ xc, const float* __restrict__ bank,
              const float* __restrict__ den_x,
              const float* __restrict__ den_r, float* __restrict__ out,
              int F, int G, int L_out, int L_real) {
  constexpr int kALoads = kBM * kBK / kGemmThreads;
  constexpr int kBLoads = kBN * kBK / kGemmThreads;
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);     // output column (lag) group
  const int ty = tid / (kBN / kTN);     // output row (stream) group
  const int f0 = blockIdx.y * kBM;
  const int l0 = blockIdx.x * kBN;
  float ra[kALoads], rb[kBLoads];
  // Tile element e of a kRows x kBK tile: 8 consecutive g of one row per
  // 8 threads (one 32-byte sector), 4 rows per warp.  Stored k-major, a
  // warp's 32 stores then fall in 32 distinct banks.
  auto row_of = [](int e, int rows) { return (e >> 3) % rows; };
  auto k_of = [](int e, int rows) { return (e & 7) + 8 * (e / (8 * rows)); };
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kALoads; ++i) {
      const int e = tid + i * kGemmThreads;
      const int f = f0 + row_of(e, kBM), g = k0 + k_of(e, kBM);
      ra[i] = (f < F && g < G) ? xc[static_cast<size_t>(f) * G + g] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      const int e = tid + i * kGemmThreads;
      const int l = l0 + row_of(e, kBN), g = k0 + k_of(e, kBN);
      rb[i] = (l < L_real && g < G) ? bank[static_cast<size_t>(l) * G + g]
                                    : 0.0f;
    }
  };
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  fetch(0);
  for (int k0 = 0; k0 < G; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kALoads; ++i) {
      const int e = tid + i * kGemmThreads;
      As[k_of(e, kBM)][row_of(e, kBM)] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      const int e = tid + i * kGemmThreads;
      Bs[k_of(e, kBN)][row_of(e, kBN)] = rb[i];
    }
    __syncthreads();
    if (k0 + kBK < G) fetch(k0 + kBK);  // in flight during the FMAs
    // blocked summation: the stage's kBK products are summed on their
    // own, then added to the running sum, so rounding grows with
    // kBK + G/kBK terms instead of G (a plain running sum over the
    // batch path's ~16k grid points drifts ~1e-5 from the plain version)
    float part[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) part[i][j] = 0.0f;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[kTM], b[kTN];
      load_frag<kTM>(&As[k][ty * kTM], a);
      load_frag<kTN>(&Bs[k][tx * kTN], b);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int f = f0 + ty * kTM + i;
    if (f >= F) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int l = l0 + tx * kTN + j;
      if (l >= L_real) continue;
      const float den = __fadd_rn(__fmul_rn(den_x[f], den_r[l]), 1e-12f);
      out[static_cast<size_t>(f) * L_out + l] = __fdiv_rn(acc[i][j], den);
    }
  }
}

}  // namespace

extern "C" int xcorr_align_launch(const float* x, const float* m,
                                  const float* bank, float* xc,
                                  float* den_x, float* den_r, float* out,
                                  int F, int G, int L_out, int L_real,
                                  void* stream) {
  if (F <= 0 || L_out <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  prepare_kernel<<<F + L_real, kRowThreads, 0, s>>>(
      x, m, bank, xc, den_x, den_r, out, F, G, L_out, L_real);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc || L_real <= 0) return rc;
  dim3 blocks((L_real + kBN - 1) / kBN, (F + kBM - 1) / kBM);
  scores_kernel<<<blocks, kGemmThreads, 0, s>>>(xc, bank, den_x, den_r, out,
                                                F, G, L_out, L_real);
  return static_cast<int>(cudaGetLastError());
}
