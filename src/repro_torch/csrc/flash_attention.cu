// flash_attention: causal or full GQA attention with an online softmax and
// an optional tanh soft-cap.
//
// Replaces the TPU kernel flash_attention_kernel (_fa_kernel) in
// src/repro/kernels/flash_attention/kernel.py.
//
//   s[i,j] = q_i . k_j / sqrt(D);  s = cap * tanh(s / cap) if cap > 0;
//   s[i,j] = -1e30 where causal and j > i;   o_i = softmax_j(s[i,:]) v
// for q (B, Hq, S, D) and k/v (B, Hkv, S, D), query head h reading kv
// head h / (Hq / Hkv) (jnp.repeat's order in the reference), float32
// accumulation, the output in q's type (float32 or bfloat16).
//
// Bound on the H100: at the serve path's shapes (S ~ 1000, D = 128) the
// work, 4*S*S*D/2 operations a head causal, sits above the bytes (q, k,
// v and o read or written once), so the bound is the bf16 tensor-core
// rate.  This first version does not reach the tensor cores: it is a
// plain SIMT kernel with float32 FMAs.  Design: one block per
// (batch*query head, 64-row query tile); the tile's queries stay in
// shared memory as float32, the block walks 64-key tiles of k (stored
// transposed, padded against bank conflicts) and v, and each of its 256
// threads owns 4 query rows x 4 keys of a score tile and 4 rows x D/16
// output columns, so the per-row running max and sum (m, l) are folded
// by shuffles inside one half-warp and never leave registers.  The
// causal loop stops at the diagonal tile; keys past S are masked, so
// any S >= 1 runs.  Strides are arguments (the head dimension must be
// contiguous), so the model's (B, S, H, D) activations go in as they
// are, without a transpose.  Shared memory exceeds 48 KB and is opted
// into with cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kKPad = kBK + 1;   // transposed k row: conflict-free stores
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Strides {                 // in elements; the D axis is contiguous
  long long b, h, s;
};

template <int D>
constexpr int smem_floats() {
  return kBQ * D + D * kKPad + kBK * D + kBQ * kKPad;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Hq, int group,
          int S, Strides sq, Strides sk, Strides sv, Strides so,
          int causal, float cap, float sqrt_d) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kBQ][D]
  float* Ks = Qs + kBQ * D;            // [D][kKPad], transposed
  float* Vs = Ks + D * kKPad;          // [kBK][D]
  float* Ps = Vs + kBK * D;            // [kBQ][kKPad]
  constexpr int C = D / 16;            // output columns per thread
  const int tid = threadIdx.x;
  const int ty = tid >> 4;             // rows 4*ty .. 4*ty+3
  const int tx = tid & 15;             // keys tx+16j, columns tx+16c
  const int h = blockIdx.y % Hq;
  const int b = blockIdx.y / Hq;
  const int hk = h / group;
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  T* ob = o + b * so.b + h * so.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    Qs[i] = q0 + r < S ? to_f32(qb[(q0 + r) * sq.s + d]) : 0.0f;
  }
  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;
  }
  const int n_keys = causal ? min(S, q0 + kBQ) : S;
  const int n_tiles = (n_keys + kBK - 1) / kBK;
  const unsigned full = 0xffffffffu;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                   // the last tile's k/v are consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool ok = k0 + r < S;
      Ks[d * kKPad + r] = ok ? to_f32(kb[(k0 + r) * sk.s + d]) : 0.0f;
      Vs[i] = ok ? to_f32(vb[(k0 + r) * sv.s + d]) : 0.0f;
    }
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[d * kKPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    // scale, cap, mask; then the online-softmax update per row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float x = __fdiv_rn(s[i][j], sqrt_d);
        if (cap > 0.0f) x = cap * tanhf(__fdiv_rn(x, cap));
        if (key >= S || (causal && key > row)) x = kNegInf;
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(full, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(4 * ty + i) * kKPad + tx + 16 * j] = p;
        rs += p;
      }
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(full, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= corr;
    }
    __syncwarp();                      // rows 4ty.. are this half-warp's
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * ty + i) * kKPad + kk];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float vv = Vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < C; ++c)
      ob[row * so.s + tx + 16 * c] = from_f32<T>(__fdiv_rn(acc[i][c], den));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, const long long* st, int causal,
           float cap, void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, B * Hq);
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  fa_kernel<T, D><<<grid, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hq / Hkv, S, sq, sk,
      sv, so, causal, cap, sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 int64, (batch, head, seq) for q, k, v and o in turn.
#define FA_ENTRY(NAME, T, D)                                                 \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o,  \
                      int B, int Hq, int Hkv, int S,                         \
                      const long long* strides, int causal, float cap,       \
                      void* stream) {                                        \
    return launch<T, D>(q, k, v, o, B, Hq, Hkv, S, strides, causal, cap,     \
                        stream);                                             \
  }

FA_ENTRY(fa_launch_f32_d64, float, 64)
FA_ENTRY(fa_launch_f32_d128, float, 128)
FA_ENTRY(fa_launch_bf16_d64, __nv_bfloat16, 64)
FA_ENTRY(fa_launch_bf16_d128, __nv_bfloat16, 128)
