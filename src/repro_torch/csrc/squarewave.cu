// squarewave: the paper's calibrated vector-FMA load (§IV-B).
//
// Replaces the TPU kernel squarewave_kernel (_sw_kernel) in
// src/repro/kernels/squarewave/kernel.py.
//
//   b = x * 1e-6;  acc = x;  repeat K times: acc = fma(acc, a, b)
// with a = 1.000000119 rounded to the element type, per element of a
// contiguous array of n elements; 2*K FLOPs per element.
//
// Bound on the H100: by construction neither.  The chain length K is
// calibrated (kernels/squarewave/ops.py) so that the FMAs take as long
// as reading and writing the array: 2*K*n / peak = 2*n*itemsize / 3.35
// TB/s.  Design: each thread loads one 16-byte vector (4 float32,
// 8 bfloat16 as 4 packed pairs, or 2 float64), runs its lanes as
// independent chains interleaved step by step, so the FMA pipe has 2-4
// independent operations behind each dependent one, and stores the
// vector back; threads stride over the array (grid-stride loop, a few
// blocks per SM resident), and a scalar tail takes the n % vector
// elements past the last whole vector.  K is a runtime argument, so the
// chain cannot be folded.  Each step is one IEEE fused multiply-add
// (__fmaf_rn, __fma_rn, __hfma2 on __nv_bfloat162): one rounding where
// the plain version's `acc * a + b` rounds twice.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

__global__ void __launch_bounds__(kThreads)
sw_f32_kernel(const float* __restrict__ x, float* __restrict__ y,
              long long n, int K) {
  const float a = static_cast<float>(1.000000119);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads
                          + threadIdx.x;
  const long long n_vec = n / 4;
  const float4* xv = reinterpret_cast<const float4*>(x);
  float4* yv = reinterpret_cast<float4*>(y);
  for (long long i = first; i < n_vec; i += stride) {
    const float4 v = xv[i];
    const float b0 = __fmul_rn(v.x, 1e-6f), b1 = __fmul_rn(v.y, 1e-6f);
    const float b2 = __fmul_rn(v.z, 1e-6f), b3 = __fmul_rn(v.w, 1e-6f);
    float c0 = v.x, c1 = v.y, c2 = v.z, c3 = v.w;
    for (int k = 0; k < K; ++k) {
      c0 = __fmaf_rn(c0, a, b0);
      c1 = __fmaf_rn(c1, a, b1);
      c2 = __fmaf_rn(c2, a, b2);
      c3 = __fmaf_rn(c3, a, b3);
    }
    yv[i] = make_float4(c0, c1, c2, c3);
  }
  for (long long i = n_vec * 4 + first; i < n; i += stride) {
    const float b = __fmul_rn(x[i], 1e-6f);
    float c = x[i];
    for (int k = 0; k < K; ++k) c = __fmaf_rn(c, a, b);
    y[i] = c;
  }
}

__global__ void __launch_bounds__(kThreads)
sw_f64_kernel(const double* __restrict__ x, double* __restrict__ y,
              long long n, int K) {
  const double a = 1.000000119;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads
                          + threadIdx.x;
  const long long n_vec = n / 2;
  const double2* xv = reinterpret_cast<const double2*>(x);
  double2* yv = reinterpret_cast<double2*>(y);
  for (long long i = first; i < n_vec; i += stride) {
    const double2 v = xv[i];
    const double b0 = __dmul_rn(v.x, 1e-6), b1 = __dmul_rn(v.y, 1e-6);
    double c0 = v.x, c1 = v.y;
    for (int k = 0; k < K; ++k) {
      c0 = __fma_rn(c0, a, b0);
      c1 = __fma_rn(c1, a, b1);
    }
    yv[i] = make_double2(c0, c1);
  }
  for (long long i = n_vec * 2 + first; i < n; i += stride) {
    const double b = __dmul_rn(x[i], 1e-6);
    double c = x[i];
    for (int k = 0; k < K; ++k) c = __fma_rn(c, a, b);
    y[i] = c;
  }
}

// b = x * 1e-6 as PyTorch computes a bfloat16 tensor times a Python
// float: in float32, rounded once to bfloat16.
__device__ __forceinline__ __nv_bfloat16 scaled_bf16(__nv_bfloat16 v) {
  return __float2bfloat16_rn(__fmul_rn(__bfloat162float(v), 1e-6f));
}

__device__ __forceinline__ __nv_bfloat162 scaled_bf162(__nv_bfloat162 v) {
  return __halves2bfloat162(scaled_bf16(__low2bfloat16(v)),
                            scaled_bf16(__high2bfloat16(v)));
}

// Eight bfloat16 as four packed pairs: one 16-byte load or store.
struct __align__(16) Bf16x8 {
  __nv_bfloat162 h[4];
};

__global__ void __launch_bounds__(kThreads)
sw_bf16_kernel(const __nv_bfloat16* __restrict__ x,
               __nv_bfloat16* __restrict__ y, long long n, int K) {
  const __nv_bfloat16 a1 =
      __float2bfloat16_rn(static_cast<float>(1.000000119));
  const __nv_bfloat162 a = __halves2bfloat162(a1, a1);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads
                          + threadIdx.x;
  const long long n_vec = n / 8;
  const Bf16x8* xv = reinterpret_cast<const Bf16x8*>(x);
  Bf16x8* yv = reinterpret_cast<Bf16x8*>(y);
  for (long long i = first; i < n_vec; i += stride) {
    const Bf16x8 v = xv[i];
    const __nv_bfloat162 b0 = scaled_bf162(v.h[0]);
    const __nv_bfloat162 b1 = scaled_bf162(v.h[1]);
    const __nv_bfloat162 b2 = scaled_bf162(v.h[2]);
    const __nv_bfloat162 b3 = scaled_bf162(v.h[3]);
    __nv_bfloat162 c0 = v.h[0], c1 = v.h[1], c2 = v.h[2], c3 = v.h[3];
    for (int k = 0; k < K; ++k) {
      c0 = __hfma2(c0, a, b0);
      c1 = __hfma2(c1, a, b1);
      c2 = __hfma2(c2, a, b2);
      c3 = __hfma2(c3, a, b3);
    }
    Bf16x8 out;
    out.h[0] = c0;
    out.h[1] = c1;
    out.h[2] = c2;
    out.h[3] = c3;
    yv[i] = out;
  }
  for (long long i = n_vec * 8 + first; i < n; i += stride) {
    const __nv_bfloat16 b = scaled_bf16(x[i]);
    __nv_bfloat16 c = x[i];
    for (int k = 0; k < K; ++k) c = __hfma(c, a1, b);
    y[i] = c;
  }
}

// Enough blocks for every vector, capped at kBlocksPerSM per SM (the
// grid-stride loop takes the rest).
int grid_for(long long n_vec) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSM;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

}  // namespace

extern "C" int sw_launch_f32(const float* x, float* y, long long n, int K,
                             void* stream) {
  if (n <= 0) return 0;
  sw_f32_kernel<<<grid_for(n / 4), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(x, y, n, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sw_launch_f64(const double* x, double* y, long long n, int K,
                             void* stream) {
  if (n <= 0) return 0;
  sw_f64_kernel<<<grid_for(n / 2), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(x, y, n, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sw_launch_bf16(const __nv_bfloat16* x, __nv_bfloat16* y,
                              long long n, int K, void* stream) {
  if (n <= 0) return 0;
  sw_bf16_kernel<<<grid_for(n / 8), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(x, y, n, K);
  return static_cast<int>(cudaGetLastError());
}
