// flash_attention_bwd: the gradient of flash_attention (B9) with respect
// to q, k and v, for training.
//
// Replaces no TPU kernel: the reference trains through XLA's autodiff of
// its jnp attention (src/repro/models/layers.py _attend), and its Pallas
// B9 has no custom_vjp.  On the card the port's attention is B9, so its
// gradient is this kernel, behind the autograd Function of
// kernels/flash_attention/kernel.py (FlashAttention).
//
// FlashAttention-2's backward.  With s = q.k / sqrt(D), s_c = cap *
// tanh(s / cap) (s_c = s without a cap), the forward's masks, and the
// row's log-sum-exp L (the forward writes it), P = exp(s_c - L) is
// recomputed tile by tile, never stored:
//   delta_i = sum_d dO_id O_id                       (pre-pass)
//   dV_j    = sum_i P_ij dO_i
//   dP_ij   = dO_i . v_j
//   dS_ij   = P_ij (dP_ij - delta_i) (1 - tanh^2(s/cap) with a cap) / sqrt(D)
//   dQ_i    = sum_j dS_ij k_j,   dK_j = sum_i dS_ij q_i
// for q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), any strides with a
// contiguous head dimension, as the forward takes them; dq/dk/dv take
// the same strides arguments.  The cases are the forward's: causal with
// or without a window (Sk == Sq), non-causal with any Sk, the cap, D in
// {64, 128}.
//
// Three kernels, launched in order on one stream:
//   1. delta: one warp a row (float32 products, a fixed shuffle tree);
//   2. dK/dV: one block a (batch, kv head, 64-key tile).  It loops over
//      the Hq/Hkv query heads of its group and, for each, over the query
//      tiles that can see its keys (from the diagonal tile when causal, up
//      to the window's last when windowed), in that fixed order, and
//      keeps dK and dV in registers throughout: GQA's sum over the query
//      heads is a loop, not atomics;
//   3. dQ: one block a (batch, query head, 64-row query tile), looping
//      over the key tiles the forward visits.
// No atomics anywhere and every sum in a fixed order: two runs give the
// same bits (ROADMAP "Fold-order determinism").
//
// bfloat16 -> the tensor cores (mma.sync.m16n8k16, bf16 in, float32
// accumulate), 4 warps of 16 own rows a block; the loop steps 32 rows of
// the other side at a time, so a thread holds 16 score and 16 dP
// accumulators beside its 2 x D/2 gradient accumulators (dK and dV, or
// dQ) and no operand fragments between products: every fragment is read
// from shared memory by ldmatrix where it is used.  P and dS are rounded
// to bf16 as the A operands of their products (dV += P^T dO, dK += dS^T
// Q, dQ += dS K), as the forward rounds P for P V; dP, delta and the
// gradients' sums stay float32.  Tiles are copied with cp.async, not
// double-buffered.
// float32 -> SIMT kernels (float32 FMAs), 256 threads a block, each
// thread 4 own rows x 4 columns of a 64 x 64 score tile and 4 rows x D/16
// columns of the gradients; tiles in shared memory at a pitch of D + 1
// floats, so both a row-wise and a column-wise walk are free of bank
// conflicts (149 KB at D = 128, one block an SM).
//
// Bound on the H100: five S x S products of D, 10 B Hq Sq Sk D
// operations, halved when causal: 2.58e11 at the training shape (2,
// 24/8, 2048, 128), 0.26 ms at the bf16 dense rate (989 TFLOP/s), far
// above the bytes.  This first version is simple: the tiles are small,
// ldmatrix feeds every mma from shared memory and nothing overlaps the
// copies, so it sits well above that bound (PERF.md section 6).
#include "flash_attention.cuh"

namespace {

constexpr int kOwn = 64;           // own rows a block (keys, or queries)

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 x) {
  return __bfloat162float(x);
}

// ------------------------------------------------------- 1. the pre-pass

constexpr int kDeltaWarps = 8;

template <typename T>
__global__ void __launch_bounds__(32 * kDeltaWarps)
fa_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ delta, int Hq, int S, int D,
                    long long n_rows, Strides so, Strides sdo) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kDeltaWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int i = static_cast<int>(row % S);
  const long long bh = row / S;
  const int h = static_cast<int>(bh % Hq);
  const long long b = bh / Hq;
  const T* orow = o + b * so.b + h * so.h + i * so.s;
  const T* drow = dout + b * sdo.b + h * sdo.h + i * sdo.s;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f(orow[d]), to_f(drow[d]), acc);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// Is (row, key) scored by the forward?
__device__ __forceinline__ bool scored(int row, int key, int S, int Sk,
                                       int causal, int window) {
  return row < S && key < Sk && !(causal && key > row) &&
         !(window > 0 && row - key >= window);
}

// The query tiles of `rows` rows that see keys k0 .. k0 + kOwn - 1.
__device__ __forceinline__ void query_tiles(int k0, int rows, int S,
                                            int causal, int window,
                                            int& first, int& end) {
  first = causal ? k0 / rows : 0;
  end = (S + rows - 1) / rows;
  if (window > 0) end = min(end, (k0 + kOwn - 1 + window - 1) / rows + 1);
}

// The key tiles of `cols` keys that queries q0 .. q0 + kOwn - 1 see.
__device__ __forceinline__ void key_tiles(int q0, int cols, int Sk,
                                          int causal, int window,
                                          int& first, int& end) {
  const int n_keys = causal ? min(Sk, q0 + kOwn) : Sk;
  end = (n_keys + cols - 1) / cols;
  first = window > 0 ? max(q0 - window + 1, 0) / cols : 0;
}

// ------------------------------------------------- float32: SIMT kernels

constexpr int kF32Threads = 256;
constexpr int kF32Tile = 64;       // rows of the other side a step
constexpr int kPPad = kF32Tile + 1;

template <int D>
constexpr int f32_bwd_smem_bytes() {
  return (4 * kOwn * (D + 1) + kOwn * kPPad + 2 * kF32Tile) *
         static_cast<int>(sizeof(float));
}

// rows r0.. of a (rows x D) tile at pitch D + 1, zeros past n
__device__ __forceinline__ void f32_rows(float* dst, const float* src,
                                         long long stride, int r0, int n,
                                         int rows, int D) {
  for (int i = threadIdx.x; i < rows * D; i += kF32Threads) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] = r0 + r < n ? src[(r0 + r) * stride + d] : 0.0f;
  }
}

// The score-side arithmetic shared by both float32 kernels: from the raw
// product qk and dP of one (row, key), -> (p, dS).
__device__ __forceinline__ void f32_p_ds(float qk, float dp, float lse,
                                         float dl, bool ok, float cap,
                                         float sqrt_d, float& p,
                                         float& ds) {
  float x = __fdiv_rn(qk, sqrt_d);
  float dc = 1.0f;
  if (cap > 0.0f) {
    const float t = tanhf(__fdiv_rn(x, cap));
    x = cap * t;
    dc = 1.0f - t * t;
  }
  p = ok ? expf(x - lse) : 0.0f;
  ds = __fdiv_rn(p * (dp - dl) * dc, sqrt_d);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
fa_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int Hq, int Hkv, int S, int Sk,
                Strides sq, Strides sk, Strides sv, Strides sdo,
                Strides sdk, Strides sdv, int causal, int window, float cap,
                float sqrt_d) {
  constexpr int DP = D + 1;
  constexpr int C = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                      // [kOwn][DP]
  float* Vs = Ks + kOwn * DP;
  float* Qs = Vs + kOwn * DP;            // [kF32Tile][DP]
  float* Os = Qs + kF32Tile * DP;        // dO
  float* Ps = Os + kF32Tile * DP;        // [kOwn][kPPad]: P, then dS
  float* Ls = Ps + kOwn * kPPad;         // the tile's lse
  float* Dl = Ls + kF32Tile;             // and delta
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;  // keys 4ty.., queries tx+16j
  const int hk = blockIdx.y % Hkv;
  const int b = blockIdx.y / Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.x * kOwn;
  f32_rows(Ks, k + b * sk.b + hk * sk.h, sk.s, k0, Sk, kOwn, D);
  f32_rows(Vs, v + b * sv.b + hk * sv.h, sv.s, k0, Sk, kOwn, D);
  float dka[4][C], dva[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dka[i][c] = dva[i][c] = 0.0f;
  int qt_first, qt_end;
  query_tiles(k0, kF32Tile, S, causal, window, qt_first, qt_end);
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const long long lrow = (static_cast<long long>(b) * Hq + h) * S;
    for (int qt = qt_first; qt < qt_end; ++qt) {
      const int q0 = qt * kF32Tile;
      __syncthreads();                   // the last tile is consumed
      f32_rows(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, kF32Tile, D);
      f32_rows(Os, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S, kF32Tile,
               D);
      if (tid < kF32Tile) {
        const bool in = q0 + tid < S;
        Ls[tid] = in ? lse[lrow + q0 + tid] : 0.0f;
        Dl[tid] = in ? delta[lrow + q0 + tid] : 0.0f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(4 * ty + i) * DP + d];
          vv[i] = Vs[(4 * ty + i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qs[(tx + 16 * j) * DP + d];
          ov[j] = Os[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + 4 * ty + i, col = tx + 16 * j;
          float p, ds;
          f32_p_ds(s[i][j], dp[i][j], Ls[col], Dl[col],
                   scored(q0 + col, key, S, Sk, causal, window), cap,
                   sqrt_d, p, ds);
          Ps[(4 * ty + i) * kPPad + col] = p;
          s[i][j] = ds;
        }
      __syncthreads();
      // dV += P^T dO
#pragma unroll 4
      for (int r = 0; r < kF32Tile; ++r) {
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * ty + i) * kPPad + r];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float ov = Os[r * DP + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) dva[i][c] = fmaf(pv[i], ov, dva[i][c]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ps[(4 * ty + i) * kPPad + tx + 16 * j] = s[i][j];
      __syncthreads();
      // dK += dS^T Q
#pragma unroll 4
      for (int r = 0; r < kF32Tile; ++r) {
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * ty + i) * kPPad + r];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float qv = Qs[r * DP + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) dka[i][c] = fmaf(pv[i], qv, dka[i][c]);
        }
      }
    }
  }
  float* dkb = dk + b * sdk.b + hk * sdk.h;
  float* dvb = dv + b * sdv.b + hk * sdv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= Sk) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dkb[key * sdk.s + tx + 16 * c] = dka[i][c];
      dvb[key * sdv.s + tx + 16 * c] = dva[i][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
fa_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int Hq, int Hkv, int S, int Sk,
              Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq,
              int causal, int window, float cap, float sqrt_d) {
  constexpr int DP = D + 1;
  constexpr int C = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                      // [kOwn][DP]
  float* Os = Qs + kOwn * DP;            // dO
  float* Ks = Os + kOwn * DP;            // [kF32Tile][DP]
  float* Vs = Ks + kF32Tile * DP;
  float* Ps = Vs + kF32Tile * DP;        // [kOwn][kPPad]: dS
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;  // rows 4ty.., keys tx+16j
  const int h = blockIdx.y % Hq;
  const int b = blockIdx.y / Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kOwn;
  const long long lrow = static_cast<long long>(blockIdx.y) * S;
  f32_rows(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, kOwn, D);
  f32_rows(Os, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S, kOwn, D);
  float lr[4], dl[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    lr[i] = row < S ? lse[lrow + row] : 0.0f;
    dl[i] = row < S ? delta[lrow + row] : 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;
  }
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;
  int t_first, t_end;
  key_tiles(q0, kF32Tile, Sk, causal, window, t_first, t_end);
  for (int t = t_first; t < t_end; ++t) {
    const int k0 = t * kF32Tile;
    __syncthreads();                     // the last tile is consumed
    f32_rows(Ks, kb, sk.s, k0, Sk, kF32Tile, D);
    f32_rows(Vs, vb, sv.s, k0, Sk, kF32Tile, D);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(4 * ty + i) * DP + d];
        ov[i] = Os[(4 * ty + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * DP + d];
        vv[j] = Vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + 4 * ty + i, key = k0 + tx + 16 * j;
        float p, ds;
        f32_p_ds(s[i][j], dp[i][j], lr[i], dl[i],
                 scored(row, key, S, Sk, causal, window), cap, sqrt_d, p,
                 ds);
        Ps[(4 * ty + i) * kPPad + tx + 16 * j] = ds;
      }
    __syncwarp();                        // rows 4ty.. are this half-warp's
    // dQ += dS K
#pragma unroll 4
    for (int r = 0; r < kF32Tile; ++r) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * ty + i) * kPPad + r];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float kv = Ks[r * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], kv, acc[i][c]);
      }
    }
  }
  float* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) dqb[row * sdq.s + tx + 16 * c] = acc[i][c];
  }
}

// ------------------------------------ bfloat16: tensor cores (mma.sync)

constexpr int kMmaThreads = 128;     // 4 warps x 16 own rows
constexpr int kMmaStep = 32;         // rows of the other side a step

template <int D>
__host__ __device__ constexpr int bwd_pitch() { return D + 8; }

template <int D>
constexpr int mma_bwd_smem_bytes() {  // 2 x own, 2 x step tiles, lse/delta
  return 2 * (kOwn + kMmaStep) * bwd_pitch<D>() *
             static_cast<int>(sizeof(bf16)) +
         2 * kMmaStep * static_cast<int>(sizeof(float));
}

// rows r0.. of a (rows x D) bf16 tile at pitch D + 8, by cp.async, zeros
// past n (not committed: the caller commits)
template <int D>
__device__ __forceinline__ void mma_rows(bf16* dst, const bf16* src,
                                         long long stride, int r0, int n,
                                         int rows) {
  constexpr int CH = D / 8;            // 16-byte chunks a row
  for (int c = threadIdx.x; c < rows * CH; c += kMmaThreads) {
    const int r = c / CH, cc = c % CH;
    const bool ok = r0 + r < n;
    const bf16* from = ok ? src + (r0 + r) * stride + cc * 8 : src;
    cp_async16(smem_u32(dst + r * bwd_pitch<D>() + cc * 8), from, ok);
  }
}

// P and dS (scaled to the raw product) of one accumulator element,
// from its score and dP; Lg is the row's lse times log2(e)
__device__ __forceinline__ void mma_p_ds(float& s, float& dp, float Lg,
                                         float dl, bool ok, float rsd,
                                         float cap) {
  float x = s * rsd;
  float dc = 1.0f;
  if (cap > 0.0f) {
    const float t = tanhf(x / cap);
    x = cap * t;
    dc = 1.0f - t * t;
  }
  const float p = ok ? exp2f(x * kLog2e - Lg) : 0.0f;
  s = p;
  dp = p * (dp - dl) * dc * rsd;
}

// the A fragments of columns 16kk.. from a 16 x 32 accumulator tile
__device__ __forceinline__ void acc_to_a(const float (&x)[4][4], int kk,
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
fa_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int Hq, int Hkv, int S, int Sk,
                Strides sq, Strides sk, Strides sv, Strides sdo,
                Strides sdk, Strides sdv, int causal, int window, float rsd,
                float cap) {
  constexpr int P = bwd_pitch<D>();
  constexpr int KD = D / 16;           // k-steps over the head dimension
  constexpr int ND = D / 8;            // n-tiles of a gradient row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // [kOwn][P]
  bf16* Vs = Ks + kOwn * P;
  bf16* Qs = Vs + kOwn * P;                       // [kMmaStep][P]
  bf16* Os = Qs + kMmaStep * P;                   // dO
  float* Ls = reinterpret_cast<float*>(Os + kMmaStep * P);
  float* Dl = Ls + kMmaStep;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int hk = blockIdx.x % Hkv;
  const int b = blockIdx.x / Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.y * kOwn;
  mma_rows<D>(Ks, k + b * sk.b + hk * sk.h, sk.s, k0, Sk, kOwn);
  mma_rows<D>(Vs, v + b * sv.b + hk * sv.h, sv.s, k0, Sk, kOwn);
  cp_async_commit();
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;
  const int key0 = k0 + warp * 16 + g;   // this thread's keys: +0, +8
  int qt_first, qt_end;
  query_tiles(k0, kMmaStep, S, causal, window, qt_first, qt_end);
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const long long lrow = (static_cast<long long>(b) * Hq + h) * S;
    for (int qt = qt_first; qt < qt_end; ++qt) {
      const int q0 = qt * kMmaStep;
      mma_rows<D>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, kMmaStep);
      mma_rows<D>(Os, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S,
                  kMmaStep);
      cp_async_commit();
      if (tid < kMmaStep) {
        const bool in = q0 + tid < S;
        Ls[tid] = in ? lse[lrow + q0 + tid] * kLog2e : 0.0f;
        Dl[tid] = in ? delta[lrow + q0 + tid] : 0.0f;
      }
      cp_async_wait<0>();
      __syncthreads();                   // the tiles are in shared memory
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries a warp
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ka[4], va[4];
        ld_a(Ks, P, warp * 16, kk * 16, lane, ka);
        ld_a(Vs, P, warp * 16, kk * 16, lane, va);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t qf[4], of[4];
          ld_b_nk(Qs, P, np * 16, kk * 16, lane, qf);
          ld_b_nk(Os, P, np * 16, kk * 16, lane, of);
          mma_bf16(s[2 * np], ka, qf[0], qf[1]);
          mma_bf16(s[2 * np + 1], ka, qf[2], qf[3]);
          mma_bf16(dp[2 * np], va, of[0], of[1]);
          mma_bf16(dp[2 * np + 1], va, of[2], of[3]);
        }
      }
      // P^T and dS^T in place
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * n + 2 * c4 + (e & 1);
          const int key = key0 + 8 * (e >> 1);
          mma_p_ds(s[n][e], dp[n][e], Ls[col], Dl[col],
                   scored(q0 + col, key, S, Sk, causal, window), rsd, cap);
        }
      // dV += P^T dO and dK += dS^T Q, over the 32 queries
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t pa[4], da[4];
        acc_to_a(s, kk, pa);
        acc_to_a(dp, kk, da);
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t of[4], qf[4];
          ld_b_kn(Os, P, kk * 16, dn * 16, lane, of);
          mma_bf16(dva[2 * dn], pa, of[0], of[1]);
          mma_bf16(dva[2 * dn + 1], pa, of[2], of[3]);
          ld_b_kn(Qs, P, kk * 16, dn * 16, lane, qf);
          mma_bf16(dka[2 * dn], da, qf[0], qf[1]);
          mma_bf16(dka[2 * dn + 1], da, qf[2], qf[3]);
        }
      }
      __syncthreads();                   // Qs, Os, Ls, Dl are free
    }
  }
  cp_async_wait<0>();                    // no tile was loaded (no query)
  bf16* dkb = dk + b * sdk.b + hk * sdk.h;
  bf16* dvb = dv + b * sdv.b + hk * sdv.h;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = 8 * n + 2 * c4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= Sk) continue;
      *reinterpret_cast<__nv_bfloat162*>(dkb + key * sdk.s + col) =
          __floats2bfloat162_rn(dka[n][2 * r], dka[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + key * sdv.s + col) =
          __floats2bfloat162_rn(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
fa_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int Hq, int Hkv, int S, int Sk,
              Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq,
              int causal, int window, float rsd, float cap) {
  constexpr int P = bwd_pitch<D>();
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [kOwn][P]
  bf16* Os = Qs + kOwn * P;                       // dO
  bf16* Ks = Os + kOwn * P;                       // [kMmaStep][P]
  bf16* Vs = Ks + kMmaStep * P;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int h = blockIdx.x % Hq;
  const int b = blockIdx.x / Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.y * kOwn;
  const long long lrow = static_cast<long long>(blockIdx.x) * S;
  mma_rows<D>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, kOwn);
  mma_rows<D>(Os, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S, kOwn);
  cp_async_commit();
  const int row0 = q0 + warp * 16 + g;   // this thread's rows: +0, +8
  float lg[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lg[r] = row < S ? lse[lrow + row] * kLog2e : 0.0f;
    dl[r] = row < S ? delta[lrow + row] : 0.0f;
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  const bf16* kb = k + b * sk.b + hk * sk.h;
  const bf16* vb = v + b * sv.b + hk * sv.h;
  int t_first, t_end;
  key_tiles(q0, kMmaStep, Sk, causal, window, t_first, t_end);
  for (int t = t_first; t < t_end; ++t) {
    const int k0 = t * kMmaStep;
    mma_rows<D>(Ks, kb, sk.s, k0, Sk, kMmaStep);
    mma_rows<D>(Vs, vb, sv.s, k0, Sk, kMmaStep);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();                     // the tiles are in shared memory
    // S = Q K^T and dP = dO V^T: 16 rows x 32 keys a warp
    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], oa[4];
      ld_a(Qs, P, warp * 16, kk * 16, lane, qa);
      ld_a(Os, P, warp * 16, kk * 16, lane, oa);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t kf[4], vf[4];
        ld_b_nk(Ks, P, np * 16, kk * 16, lane, kf);
        ld_b_nk(Vs, P, np * 16, kk * 16, lane, vf);
        mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
        mma_bf16(dp[2 * np], oa, vf[0], vf[1]);
        mma_bf16(dp[2 * np + 1], oa, vf[2], vf[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * n + 2 * c4 + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        mma_p_ds(s[n][e], dp[n][e], lg[e >> 1], dl[e >> 1],
                 scored(row, key, S, Sk, causal, window), rsd, cap);
      }
    // dQ += dS K, over the 32 keys
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t da[4];
      acc_to_a(dp, kk, da);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t kf[4];
        ld_b_kn(Ks, P, kk * 16, dn * 16, lane, kf);
        mma_bf16(acc[2 * dn], da, kf[0], kf[1]);
        mma_bf16(acc[2 * dn + 1], da, kf[2], kf[3]);
      }
    }
    __syncthreads();                     // Ks, Vs are free
  }
  cp_async_wait<0>();
  bf16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = 8 * n + 2 * c4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      *reinterpret_cast<__nv_bfloat162*>(dqb + row * sdq.s + col) =
          __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------ launchers

// strides: 24 int64, (batch, head, seq) for q, k, v, o, dO, dq, dk, dv
template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, int B,
                 int Hq, int S, int D, const long long* st,
                 cudaStream_t stream) {
  const long long n_rows = static_cast<long long>(B) * Hq * S;
  const unsigned blocks =
      static_cast<unsigned>((n_rows + kDeltaWarps - 1) / kDeltaWarps);
  fa_bwd_delta_kernel<T><<<blocks, 32 * kDeltaWarps, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, Hq, S,
      D, n_rows, strides_of(st, 3), strides_of(st, 4));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_f32(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int Hq,
                   int Hkv, int S, int Sk, const long long* st, int causal,
                   int window, float cap, void* stream_ptr) {
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  int rc = launch_delta<float>(o, dout, delta, B, Hq, S, D, st, stream);
  if (rc) return rc;
  const int smem = f32_bwd_smem_bytes<D>();
  static bool opted_kv[kMaxDevices] = {}, opted_q[kMaxDevices] = {};
  cudaError_t err = opt_in(fa_bwd_dkdv_f32<D>, smem, opted_kv);
  if (err == cudaSuccess) err = opt_in(fa_bwd_dq_f32<D>, smem, opted_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float sqrt_d = sqrtf(static_cast<float>(D));
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* df = static_cast<const float*>(dout);
  fa_bwd_dkdv_f32<D><<<dim3((Sk + kOwn - 1) / kOwn, B * Hkv), kF32Threads,
                       smem, stream>>>(
      qf, kf, vf, df, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), Hq, Hkv, S, Sk, strides_of(st, 0),
      strides_of(st, 1), strides_of(st, 2), strides_of(st, 4),
      strides_of(st, 6), strides_of(st, 7), causal, window, cap, sqrt_d);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  fa_bwd_dq_f32<D><<<dim3((S + kOwn - 1) / kOwn, B * Hq), kF32Threads, smem,
                     stream>>>(
      qf, kf, vf, df, lse, delta, static_cast<float*>(dq), Hq, Hkv, S, Sk,
      strides_of(st, 0), strides_of(st, 1), strides_of(st, 2),
      strides_of(st, 4), strides_of(st, 5), causal, window, cap, sqrt_d);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_bf16(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const float* lse,
                    float* delta, void* dq, void* dk, void* dv, int B,
                    int Hq, int Hkv, int S, int Sk, const long long* st,
                    int causal, int window, float cap, void* stream_ptr) {
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  int rc = launch_delta<bf16>(o, dout, delta, B, Hq, S, D, st, stream);
  if (rc) return rc;
  const int smem = mma_bwd_smem_bytes<D>();
  static bool opted_kv[kMaxDevices] = {}, opted_q[kMaxDevices] = {};
  cudaError_t err = opt_in(fa_bwd_dkdv_mma<D>, smem, opted_kv);
  if (err == cudaSuccess) err = opt_in(fa_bwd_dq_mma<D>, smem, opted_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float rsd = 1.0f / sqrtf(static_cast<float>(D));
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* db = static_cast<const bf16*>(dout);
  fa_bwd_dkdv_mma<D><<<dim3(B * Hkv, (Sk + kOwn - 1) / kOwn), kMmaThreads,
                       smem, stream>>>(
      qb, kb, vb, db, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Hq, Hkv, S, Sk, strides_of(st, 0),
      strides_of(st, 1), strides_of(st, 2), strides_of(st, 4),
      strides_of(st, 6), strides_of(st, 7), causal, window, rsd, cap);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  fa_bwd_dq_mma<D><<<dim3(B * Hq, (S + kOwn - 1) / kOwn), kMmaThreads, smem,
                     stream>>>(
      qb, kb, vb, db, lse, delta, static_cast<bf16*>(dq), Hq, Hkv, S, Sk,
      strides_of(st, 0), strides_of(st, 1), strides_of(st, 2),
      strides_of(st, 4), strides_of(st, 5), causal, window, rsd, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// S: query rows, Sk: keys; lse: the forward's (B, Hq, S) float32; delta:
// (B, Hq, S) float32 scratch; strides: 24 int64 (see launch_delta);
// window: 0 for none.  dq, dk, dv are written whole (no accumulation).
#define FA_BWD_ENTRY(NAME, LAUNCH)                                           \
  extern "C" int NAME(const void* q, const void* k, const void* v,           \
                      const void* o, const void* dout, const float* lse,     \
                      float* delta, void* dq, void* dk, void* dv, int B,     \
                      int Hq, int Hkv, int S, int Sk,                        \
                      const long long* strides, int causal, int window,      \
                      float cap, void* stream) {                             \
    if (B <= 0 || S <= 0 || Hq <= 0) return 0;                               \
    if (Sk <= 0 || Hkv <= 0 || Hq % Hkv || (causal && Sk != S) ||            \
        (window > 0 && !causal))                                             \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    return LAUNCH(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S,   \
                  Sk, strides, causal, window, cap, stream);                 \
  }

FA_BWD_ENTRY(fa_bwd_launch_f32_d64, launch_bwd_f32<64>)
FA_BWD_ENTRY(fa_bwd_launch_f32_d128, launch_bwd_f32<128>)
FA_BWD_ENTRY(fa_bwd_launch_bf16_d64, launch_bwd_bf16<64>)
FA_BWD_ENTRY(fa_bwd_launch_bf16_d128, launch_bwd_bf16<128>)
