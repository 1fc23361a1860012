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
// or without a window, non-causal, any Sk, the cap, D in {64, 128}, a
// query offset and a (B, Sk) key mask (kExt instances, as the forward's:
// the kernels without them carry neither).  A row with no valid key
// (the forward wrote +inf as its lse) has, in the reference, a softmax
// uniform over all Sk keys of scores that do not depend on q or k: it
// sends nothing to dq or dk (P = exp(s - inf) = 0 wherever it is scored,
// and every tile that holds it is masked) and dout / Sk to every key's
// dv, which fa_bwd_empty_kernel sums over the group's such rows in a
// fixed order and the dK/dV kernels add to dv.  The dK/dV loop over
// query rows starts at max(0, key0 - q_offset) under causality.
//
// Kernels, launched in order on one stream:
//   1. delta: a warp a row (float32), or in bf16 D/8 lanes a row with
//      16-byte loads (float32 products, a fixed shuffle tree); then,
//      where a row may have no key, the empty-row pass (vsum);
//   2. dK/dV: one block a (batch, kv head, tile of keys).  It loops over
//      the Hq/Hkv query heads of its group and, for each, over the query
//      tiles that can see its keys (from the diagonal tile when causal, up
//      to the window's last when windowed), in that fixed order, and
//      keeps dK and dV in registers throughout: GQA's sum over the query
//      heads is a loop, not atomics;
//   3. dQ: one block a (batch, query head, tile of rows, key part),
//      looping over the key tiles the forward visits;
//   4. (non-causal with Sk > 512 only) the fold of dQ's key parts.
// No atomics anywhere and every sum in a fixed order: two runs give the
// same bits (ROADMAP "Fold-order determinism").
//
// bfloat16 -> warpgroups on the tensor cores (wgmma, bf16 in, float32
// accumulate; helpers in wgmma_bf16.cuh).  A block is a producer
// warpgroup and one or two consumer warpgroups of 64 own rows each (two
// where that still leaves a block for each of the 132 SMs: 128 keys or
// rows a block at the training shapes, 64 at whisper's).  The producer
// copies the block's own tiles once (K and V, or Q and dO) and then the
// other side, 64 rows a stage, into a ring of 3 slots by TMA
// (tensor maps built on the host; each box one 8 KB panel of 64 rows
// in the 128-byte swizzle, rows past the end read as zeros) and, for
// dK/dV, the rows' lse and delta by cp.async, completing each slot on
// its `full` mbarrier; the consumers' warps mark it empty when their
// products are done, so copies run ahead of the products.  setmaxnreg
// gives the consumers the producer's registers (40 / 232, or 240 with
// one consumer).  Every
// product is a wgmma: dK/dV computes S^T = K Q^T and dP^T = V dO^T with
// both operands in shared memory, turns the accumulators into P^T and
// dS^T in place and, rounded to bf16 as register A operands, into dV +=
// P^T dO and dK += dS^T Q, dO and Q read from the same slot as
// MN-major (transposed) B operands; dQ computes S = Q K^T and dP = dO
// V^T, then dQ += dS K.  So the design runs 7 products where the
// function needs 5 (S and dP are recomputed in dQ).  Masks are applied
// only to tiles that cross the causal diagonal, the window's edge or a
// ragged end (a loop of its own: a mask test in the one loop cost more
// than a third of the kernel); tiles that score nothing are skipped.
// P = 2^x on the SFU (ex2.approx, 2 ulp; P is rounded to bf16 for its
// product), computed while the dP product still runs; the cap's tanh is
// compiled in only for a capped call.  The two
// warpgroups run in step: tried and not kept (slower, PERF.md section
// 6): letting them take turns on named barriers, and issuing the next
// stage's S and dP before this stage's exponentials in dQ (ptxas then
// serializes the wgmma).  Under causal
// masking dQ's row blocks start longest first.  Non-causal calls with
// more than 512 keys split dQ's keys into parts of whole 64-key tiles,
// whose points are a function of Sk alone (kernel.py dq_key_parts), so
// a short grid (cross-attention: 8 heads x 128 rows) still fills the
// card; the parts' float32 partials are added in part order.  P and dS
// are rounded to bf16 as the A operands of their products (dV += P^T
// dO, dK += dS^T Q, dQ += dS K), as the forward rounds P for P V; dP,
// delta and the gradients' sums stay float32.
// float32 -> 3xTF32 on the tensor cores (mma.sync m16n8k8 .tf32, the
// forward's route: flash_attention.cu), 8 warps a block: 4 pairs of 16
// own rows, the two warps of a pair taking the two halves of each
// 64-row stage of the other side, their partial sums added in a fixed
// order at the end (pair_sum; 8 warps an SM where one block fits: a
// warp's dependent mma.sync chains need a second warp on its SM
// sub-partition, scripts/mma_tf32_rate.py).  Every product splits its
// operands into tf32 hi/lo as their fragments are loaded (scalar loads
// from float32 tiles at a pitch of D + 4: no bank conflicts) and runs
// lo*hi, hi*lo, hi*hi a k-step of 8, two k-steps at a time from zero,
// each such sum added to its float32 total with IEEE adds (mma.sync's
// accumulation drifts toward zero along a long chain:
// flash_attention.cuh mma_3xtf32_x2; dK, dV and dQ sum thousands of
// products).  dK/dV: S^T = K Q^T and dP^T = V dO^T (K's and V's rows as
// A), P^T and dS^T in place, then dV += P^T dO and dK += dS^T Q with the
// accumulators as A fragments (the S-accumulator handoff of
// flash_attention.cuh: Q's and dO's rows read in the matching order);
// dQ: S = Q K^T, dP = dO V^T, dQ += dS K.  The streamed tiles (Q, dO and
// the rows' lse and delta; or K and V) are double-buffered by cp.async:
// stage i + 1 copies while stage i is multiplied, rows past the end
// zero-filled; 203 KB of shared memory at D = 128, 104 KB at D = 64.
// dQ's keys split as bf16's (kernel.py dq_key_parts: non-causal past 512
// keys), the parts' float32 partials folded in part order.  Masks only
// on the warps' blocks that cross the diagonal, the window's edge or a
// ragged end; blocks that score nothing are skipped.  Scores times
// 1/sqrt(D), expf and tanhf IEEE.
//
// Bound on the H100: five products of D a scored pair, 10 B Hq D x the
// scored pairs operations: 1.29e11 at the training shape (2, 24/8, 2048,
// 128) causal (2.10e6 scored pairs a head), 0.1304 ms at the bf16 dense
// rate (989 TFLOP/s), far above the bytes; in float32 three TF32
// products each at the TF32 rate (495 TFLOP/s), 0.781 ms, against 1.92
// ms at the fp32 FMA rate (chip_smoke.py check_attention_backward
// computes both from each call's shape).
#include "flash_attention.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kOwn = 64;           // own rows a block (keys, or queries)

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

// The helpers named *_at take the kExt instances' query offset: row i
// sits at position qo + i.  The kernels without kExt call the helpers
// without it, as they did before the offset (a template parameter
// added to those helpers changed how their kernels compiled), so that
// those instances keep their code: `kExt ? f_at(..., qo) : f(...)`
// emits only the arm it takes.

// Is (row, key) scored by the forward?
__device__ __forceinline__ bool scored(int row, int key, int S, int Sk,
                                       int causal, int window) {
  return row < S && key < Sk && !(causal && key > row) &&
         !(window > 0 && row - key >= window);
}
__device__ __forceinline__ bool scored_at(int row, int key, int S, int Sk,
                                          int causal, int window, int qo) {
  return row < S && key < Sk && !(causal && key > qo + row) &&
         !(window > 0 && qo + row - key >= window);
}

// The query tiles of `rows` rows that see keys k0 .. k0 + kOwn - 1.
__device__ __forceinline__ void query_tiles(int k0, int rows, int S,
                                            int causal, int window,
                                            int& first, int& end) {
  first = causal ? k0 / rows : 0;
  end = (S + rows - 1) / rows;
  if (window > 0) end = min(end, (k0 + kOwn - 1 + window - 1) / rows + 1);
}

// The same for keys k0 .. k0 + own - 1 and rows at positions qo + i (the
// kExt instances): from row max(0, k0 - qo) under causality, to the
// window's last row k0 + own - 1 + window - 1 - qo.
__device__ __forceinline__ void query_tiles_at(int k0, int own, int rows,
                                               int S, int causal, int window,
                                               int qo, int& first,
                                               int& end) {
  first = causal ? max(k0 - qo, 0) / rows : 0;
  end = (S + rows - 1) / rows;
  if (window > 0) {
    const int last = k0 + own - 1 + window - 1 - qo;
    end = last < 0 ? 0 : min(end, last / rows + 1);
  }
}

// The rows a dK/dV block's keys add dout / Sk to dv for: a row with no
// valid key (lse +inf, flash_attention.cu no_key_lse) has a softmax
// uniform over all Sk keys in the reference.  vsum (B, Hkv, D): the sum
// of those rows' dout over the group's query heads, then the rows, over
// Sk.  A block a (batch, kv head); warp w adds the group's rows
// w, w + 16, ... in order (the lse test is warp-uniform), lane l columns
// l, l + 32, ...; then the 16 warps' sums are added in warp order: a
// fixed order, no atomics.
constexpr int kEmptyWarps = 16;

template <typename T, int D>
__global__ void __launch_bounds__(32 * kEmptyWarps)
fa_bwd_empty_kernel(const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ vsum,
                    int Hq, int Hkv, int S, int Sk, Strides sdo) {
  constexpr int C = D / 32;                // a lane's columns
  __shared__ float warps[kEmptyWarps][D];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int group = Hq / Hkv;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  for (int t = w; t < group * S; t += kEmptyWarps) {
    const int h = hk * group + t / S, i = t % S;
    if (lse[(b * Hq + h) * S + i] != no_key_lse()) continue;
    const T* row = dout + b * sdo.b + h * sdo.h + i * sdo.s;
#pragma unroll
    for (int c = 0; c < C; ++c)
      acc[c] = __fadd_rn(acc[c], to_f(row[lane + 32 * c]));
  }
#pragma unroll
  for (int c = 0; c < C; ++c) warps[w][lane + 32 * c] = acc[c];
  __syncthreads();
  if (threadIdx.x >= D) return;
  float sum = warps[0][threadIdx.x];
  for (int i = 1; i < kEmptyWarps; ++i)
    sum = __fadd_rn(sum, warps[i][threadIdx.x]);
  vsum[static_cast<long long>(blockIdx.x) * D + threadIdx.x] =
      __fdiv_rn(sum, static_cast<float>(Sk));
}

// The key mask of keys k0 + lane (lane < 16) .. as a warp-uniform "all
// valid" (a dK/dV warp's 16 own keys; kvm null: all valid)
__device__ __forceinline__ bool own_keys_valid(const unsigned char* mb,
                                               int k0, int Sk, int lane) {
  const int key = k0 + lane;
  return __all_sync(0xffffffffu,
                    lane >= 16 || mb == nullptr || (key < Sk && mb[key]));
}

// ------------------------------------ float32: 3xTF32 on the tensor cores

constexpr int kF32BwdThreads = 256;  // 4 warp pairs x 16 own rows
constexpr int kF32Tile = 64;         // rows of the other side a stage

template <int D>
constexpr int f32_dkdv_smem_bytes() {  // K, V; 2 x (Q, dO); 2 x (lse, delta)
  return (6 * kOwn * f32_pitch<D>() + 4 * kF32Tile) *
         static_cast<int>(sizeof(float));
}
template <int D>
constexpr int f32_dq_smem_bytes() {    // Q, dO; 2 x (K, V)
  return 6 * kOwn * f32_pitch<D>() * static_cast<int>(sizeof(float));
}

// Does a (16 or 64 rows from r0) x (cols from c0) block score nothing
// (dead), or everything (interior: no mask to apply)?  rows are queries.
__device__ __forceinline__ bool f32_dead(int r0, int nr, int c0, int nc,
                                         int S, int Sk, int causal,
                                         int window) {
  return r0 >= S || c0 >= Sk || (causal && c0 > r0 + nr - 1) ||
         (window > 0 && r0 - (c0 + nc - 1) >= window);
}
__device__ __forceinline__ bool f32_interior(int r0, int nr, int c0, int nc,
                                             int S, int Sk, int causal,
                                             int window) {
  return r0 + nr <= S && c0 + nc <= Sk && (!causal || c0 + nc - 1 <= r0) &&
         (window <= 0 || r0 + nr - 1 - c0 < window);
}
// (the same with rows at positions qo + r, before the key mask)
__device__ __forceinline__ bool f32_dead_at(int r0, int nr, int c0, int nc,
                                            int S, int Sk, int causal,
                                            int window, int qo) {
  return r0 >= S || c0 >= Sk || (causal && c0 > qo + r0 + nr - 1) ||
         (window > 0 && qo + r0 - (c0 + nc - 1) >= window);
}
__device__ __forceinline__ bool f32_interior_at(int r0, int nr, int c0,
                                                int nc, int S, int Sk,
                                                int causal, int window,
                                                int qo) {
  return r0 + nr <= S && c0 + nc <= Sk &&
         (!causal || c0 + nc - 1 <= qo + r0) &&
         (window <= 0 || qo + r0 + nr - 1 - c0 < window);
}

// P and dS of one score, from the raw products s = q.k and dp = dO.v,
// the row's lse L and delta dl; in place (s <- P, dp <- dS)
template <bool kEdge>
__device__ __forceinline__ void f32_p_ds(float& s, float& dp, float L,
                                         float dl, bool ok, float rsd,
                                         float cap, float rcap) {
  float x = s * rsd;
  float dc = 1.0f;
  if (cap > 0.0f) {
    const float t = tanhf(x * rcap);
    x = cap * t;
    dc = 1.0f - t * t;
  }
  const float p = !kEdge || ok ? expf(x - L) : 0.0f;
  s = p;
  dp = p * (dp - dl) * dc * rsd;
}

// The pair's partial sums, combined in a fixed order: warp w + 4 (half 1)
// leaves its accumulators in `red` (rows r0 .., D floats a row, this
// warp's 16 rows), warp w (half 0) adds them to its own with IEEE adds
template <int D>
__device__ __forceinline__ void pair_sum(float (&acc)[D / 8][4], float* red,
                                         int rows0, int half, int g,
                                         int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* row = red + (rows0 + g + 8 * r) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (half == 1) {
        row[8 * j] = acc[j][2 * r];
        row[8 * j + 1] = acc[j][2 * r + 1];
      }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* row = red + (rows0 + g + 8 * r) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (half == 0) {
        acc[j][2 * r] = __fadd_rn(acc[j][2 * r], row[8 * j]);
        acc[j][2 * r + 1] = __fadd_rn(acc[j][2 * r + 1], row[8 * j + 1]);
      }
  }
}

// dK/dV: block (b * Hkv + kv head, key tile of kOwn keys; the first key
// tiles, which causal masking gives the most query tiles, launch first),
// 8 warps: warp w owns keys k0 + 16 (w % 4) .. and takes half w / 4 of
// each stage's queries.  For each query head of the group and each query
// tile that can see the keys, in that order (stage i), the stage's Q, dO
// and rows' lse and delta are copied into buffer i % 2 while stage i - 1
// is multiplied.  dK and dV stay in registers: GQA's sum over the group is
// this loop, not atomics; at the end each pair adds its two halves in a
// fixed order (pair_sum).  kExt: the query offset, the key mask (the own
// keys' bytes, read once) and vsum (fa_bwd_empty_kernel), added to dv.
template <int D, bool kExt>
__global__ void __launch_bounds__(kF32BwdThreads, 1)
fa_bwd_dkdv_tf32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int Hq, int Hkv, int S, int Sk,
                 Strides sq, Strides sk, Strides sv, Strides sdo,
                 Strides sdk, Strides sdv, int causal, int window,
                 float rsd, float cap, float rcap, int vec, int q_offset,
                 const unsigned char* __restrict__ kvm,
                 const float* __restrict__ vsum) {
  constexpr int P = f32_pitch<D>();
  constexpr int QW = kF32Tile / 2;         // a warp's queries of a stage
  constexpr int NQ = QW / 8;               // their n-tiles
  constexpr int ND = D / 8;
  constexpr int T = kF32BwdThreads;
  extern __shared__ __align__(16) float fsm[];
  float* Ks = fsm;                         // [kOwn][P]
  float* Vs = Ks + kOwn * P;
  float* Qs = Vs + kOwn * P;               // [2][kF32Tile][P]
  float* Os = Qs + 2 * kF32Tile * P;       // dO
  float* Ls = Os + 2 * kF32Tile * P;       // [2][kF32Tile]: lse
  float* Dl = Ls + 2 * kF32Tile;           // and delta
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int w4 = warp & 3, half = warp >> 2;
  const int hk = blockIdx.x % Hkv;
  const int b = blockIdx.x / Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.y * kOwn;
  const int kw = k0 + 16 * w4;             // this warp's keys
  const int qo = kExt ? q_offset : 0;
  int qt_first, qt_end;
  if constexpr (kExt)
    query_tiles_at(k0, kOwn, kF32Tile, S, causal, window, qo, qt_first,
                   qt_end);
  else
    query_tiles(k0, kF32Tile, S, causal, window, qt_first, qt_end);
  const int n_tiles = max(qt_end - qt_first, 0);
  const int n = group * n_tiles;

  auto load_stage = [&](int i) {
    const int buf = i & 1;
    const int h = hk * group + i / n_tiles;
    const int q0 = (qt_first + i % n_tiles) * kF32Tile;
    f32_tile_async<D, kF32Tile, T>(Qs + buf * kF32Tile * P,
                                   q + b * sq.b + h * sq.h, sq.s, q0, S, vec,
                                   tid);
    f32_tile_async<D, kF32Tile, T>(Os + buf * kF32Tile * P,
                                   dout + b * sdo.b + h * sdo.h, sdo.s, q0, S,
                                   vec, tid);
    if (tid < 2 * kF32Tile) {
      const long long at = (static_cast<long long>(b) * Hq + h) * S + q0;
      const int r = tid & (kF32Tile - 1);
      const bool ok = q0 + r < S;
      const float* src = tid < kF32Tile ? lse : delta;
      cp_async4(smem_u32((tid < kF32Tile ? Ls : Dl) + buf * kF32Tile + r),
                ok ? src + at + r : src, ok);
    }
  };
  f32_tile_async<D, kOwn, T>(Ks, k + b * sk.b + hk * sk.h, sk.s, k0, Sk,
                             vec, tid);
  f32_tile_async<D, kOwn, T>(Vs, v + b * sv.b + hk * sv.h, sv.s, k0, Sk,
                             vec, tid);
  if (n > 0) load_stage(0);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.0f;
  const float* ka = Ks + (16 * w4 + g) * P + t4;   // A rows: own keys
  const float* va = Vs + (16 * w4 + g) * P + t4;
  for (int i = 0; i < n; ++i) {
    const int buf = i & 1;
    const int qc = (qt_first + i % n_tiles) * kF32Tile + QW * half;
    cp_async_wait<0>();                    // stage i has landed, and every
    __syncthreads();                       // warp is done with stage i - 1
    if (i + 1 < n) {
      load_stage(i + 1);
      cp_async_commit();
    }
    if (kExt ? f32_dead_at(qc, QW, kw, 16, S, Sk, causal, window, qo)
             : f32_dead(qc, QW, kw, 16, S, Sk, causal, window))
      continue;
    // (kExt: the key mask of this thread's keys kw + g, kw + g + 8 in
    // ok_lo, ok_hi, and whether the warp's 16 are all valid)
    bool edge, ok_lo = true, ok_hi = true;
    if constexpr (kExt) {
      const unsigned char* mb =
          kvm != nullptr ? kvm + static_cast<long long>(b) * Sk : nullptr;
      ok_lo = mb == nullptr || (kw + g < Sk && mb[kw + g]);
      ok_hi = mb == nullptr || (kw + g + 8 < Sk && mb[kw + g + 8]);
      edge = !f32_interior_at(qc, QW, kw, 16, S, Sk, causal, window, qo)
             || !own_keys_valid(mb, kw, Sk, lane);
    } else {
      edge = !f32_interior(qc, QW, kw, 16, S, Sk, causal, window);
    }
    const float* Qt = Qs + (buf * kF32Tile + QW * half) * P;  // its rows
    const float* Ot = Os + (buf * kF32Tile + QW * half) * P;
    const float* Lt = Ls + buf * kF32Tile + QW * half;
    const float* Dt = Dl + buf * kF32Tile + QW * half;
    float s[NQ][4], dp[NQ][4];             // keys x queries
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    products_nk<D, NQ>(s, ka, Qt, g, t4);    // S^T = K Q^T
    products_nk<D, NQ>(dp, va, Ot, g, t4);   // dP^T = V dO^T
    // P^T and dS^T in place: element (j, e) is key kw + g + 8 (e / 2),
    // query qc + 8j + 2 t4 + e % 2
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t4 + (e & 1);
        if (edge) {
          if constexpr (kExt)
            f32_p_ds<true>(s[j][e], dp[j][e], Lt[col], Dt[col],
                           scored_at(qc + col, kw + g + 8 * (e >> 1), S,
                                     Sk, causal, window, qo) &&
                               ((e >> 1) ? ok_hi : ok_lo),
                           rsd, cap, rcap);
          else
            f32_p_ds<true>(s[j][e], dp[j][e], Lt[col], Dt[col],
                           scored(qc + col, kw + g + 8 * (e >> 1), S, Sk,
                                  causal, window), rsd, cap, rcap);
        } else
          f32_p_ds<false>(s[j][e], dp[j][e], Lt[col], Dt[col], true, rsd,
                          cap, rcap);
      }
    products_kn<D, NQ>(dva, s, Ot, g, t4);   // dV += P^T dO
    products_kn<D, NQ>(dka, dp, Qt, g, t4);  // dK += dS^T Q
  }
  cp_async_wait<0>();
  __syncthreads();                         // the stages' buffers are free
  pair_sum<D>(dva, Qs, 16 * w4, half, g, t4);
  pair_sum<D>(dka, Qs + kOwn * D, 16 * w4, half, g, t4);
  if (half == 1) return;
  float* dkb = dk + b * sdk.b + hk * sdk.h;
  float* dvb = dv + b * sdv.b + hk * sdv.h;
  if constexpr (kExt) {
    if (vsum != nullptr) {                 // the rows with no key
      const float* u = vsum + static_cast<long long>(blockIdx.x) * D;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int col = 8 * j + 2 * t4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dva[j][2 * r] = __fadd_rn(dva[j][2 * r], u[col]);
          dva[j][2 * r + 1] = __fadd_rn(dva[j][2 * r + 1], u[col + 1]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw + g + 8 * r;
    if (key >= Sk) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int col = 8 * j + 2 * t4;
      dkb[key * sdk.s + col] = dka[j][2 * r];
      dkb[key * sdk.s + col + 1] = dka[j][2 * r + 1];
      dvb[key * sdv.s + col] = dva[j][2 * r];
      dvb[key * sdv.s + col + 1] = dva[j][2 * r + 1];
    }
  }
}

// dQ: block (b * Hq + head, row tile, key part), 8 warps: warp w owns rows
// q0 + 16 (w % 4) .. and takes half w / 4 of each key tile; under causal
// masking the row tiles go last first (the longest first).  The key
// range is the part's [z part_keys, (z + 1) part_keys) when part_keys > 0
// (a function of Sk alone, kernel.py dq_key_parts), else all keys.  K
// and V tiles are copied into buffer i % 2 while tile i - 1 is
// multiplied.  Each pair adds its two halves in a fixed order (pair_sum);
// dQ leaves as float32, or as the part's partial (dq_part: (parts, B,
// Hq, S, D)) that dq_fold adds in part order.  kExt: the query offset and
// the key mask (a warp's 32 keys of a tile as one ballot word).
template <int D, bool kExt>
__global__ void __launch_bounds__(kF32BwdThreads, 1)
fa_bwd_dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dq,
               float* __restrict__ dq_part, int Hq, int Hkv, int S, int Sk,
               Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq,
               int causal, int window, float rsd, float cap, float rcap,
               int part_keys, int vec, int q_offset,
               const unsigned char* __restrict__ kvm) {
  constexpr int P = f32_pitch<D>();
  constexpr int KW = kF32Tile / 2;         // a warp's keys of a tile
  constexpr int NK = KW / 8;
  constexpr int ND = D / 8;
  constexpr int T = kF32BwdThreads;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                         // [kOwn][P]
  float* Os = Qs + kOwn * P;               // dO
  float* Ks = Os + kOwn * P;               // [2][kF32Tile][P]
  float* Vs = Ks + 2 * kF32Tile * P;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int w4 = warp & 3, half = warp >> 2;
  const int h = blockIdx.x % Hq;
  const int b = blockIdx.x / Hq;
  const int hk = h / (Hq / Hkv);
  const int rb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = rb * kOwn;
  const int rw = q0 + 16 * w4;             // this warp's rows
  const int qo = kExt ? q_offset : 0;
  const unsigned char* mb =
      kExt && kvm != nullptr ? kvm + static_cast<long long>(b) * Sk : nullptr;
  const int key_lo = part_keys > 0 ? blockIdx.z * part_keys : 0;
  const int key_hi = part_keys > 0 ? min(Sk, key_lo + part_keys) : Sk;
  int n_keys, t_first;
  if constexpr (kExt) {
    n_keys = min(causal ? min(Sk, qo + q0 + kOwn) : Sk, key_hi);
    t_first = max(window > 0 ? max(qo + q0 - window + 1, 0) / kF32Tile : 0,
                  key_lo / kF32Tile);
  } else {
    n_keys = min(causal ? min(Sk, q0 + kOwn) : Sk, key_hi);
    t_first = max(
        window > 0 ? max(q0 - window + 1, 0) / kF32Tile : 0,
        key_lo / kF32Tile);
  }
  const int n = max((n_keys + kF32Tile - 1) / kF32Tile - t_first, 0);
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;

  auto load_stage = [&](int i) {
    const int buf = i & 1;
    const int c0 = (t_first + i) * kF32Tile;
    f32_tile_async<D, kF32Tile, T>(Ks + buf * kF32Tile * P, kb, sk.s, c0, Sk,
                                   vec, tid);
    f32_tile_async<D, kF32Tile, T>(Vs + buf * kF32Tile * P, vb, sv.s, c0, Sk,
                                   vec, tid);
  };
  f32_tile_async<D, kOwn, T>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, vec,
                             tid);
  f32_tile_async<D, kOwn, T>(Os, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S,
                             vec, tid);
  if (n > 0) load_stage(0);
  cp_async_commit();

  const int row0 = rw + g;                 // this thread's rows: +0, +8
  const long long lrow = static_cast<long long>(blockIdx.x) * S;
  float lr[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lr[r] = row < S ? lse[lrow + row] : 0.0f;
    dl[r] = row < S ? delta[lrow + row] : 0.0f;
  }
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const float* qa = Qs + (16 * w4 + g) * P + t4;   // A rows: own queries
  const float* oa = Os + (16 * w4 + g) * P + t4;
  for (int i = 0; i < n; ++i) {
    const int buf = i & 1;
    const int cw = (t_first + i) * kF32Tile + KW * half;  // its keys
    cp_async_wait<0>();                    // tile i has landed, and every
    __syncthreads();                       // warp is done with tile i - 1
    if (i + 1 < n) {
      load_stage(i + 1);
      cp_async_commit();
    }
    if (kExt ? f32_dead_at(rw, 16, cw, KW, S, Sk, causal, window, qo)
             : f32_dead(rw, 16, cw, KW, S, Sk, causal, window))
      continue;
    uint32_t bits = ~0u;                   // the key mask of keys cw ..
    bool edge;
    if constexpr (kExt) {
      if (mb != nullptr) bits = key_bits(mb, cw, Sk, lane);
      edge = !f32_interior_at(rw, 16, cw, KW, S, Sk, causal, window, qo)
             || bits != ~0u;
    } else {
      edge = !f32_interior(rw, 16, cw, KW, S, Sk, causal, window);
    }
    const float* Kt = Ks + (buf * kF32Tile + KW * half) * P;
    const float* Vt = Vs + (buf * kF32Tile + KW * half) * P;
    float s[NK][4], dp[NK][4];             // rows x keys
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    products_nk<D, NK>(s, qa, Kt, g, t4);    // S = Q K^T
    products_nk<D, NK>(dp, oa, Vt, g, t4);   // dP = dO V^T
    // P and dS in place: element (j, e) is row row0 + 8 (e / 2), key cw +
    // 8j + 2 t4 + e % 2
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        if (edge) {
          if constexpr (kExt)
            f32_p_ds<true>(s[j][e], dp[j][e], lr[r], dl[r],
                           scored_at(row0 + 8 * r,
                                     cw + 8 * j + 2 * t4 + (e & 1), S,
                                     Sk, causal, window, qo) &&
                               ((bits >> (8 * j + 2 * t4 + (e & 1))) & 1u),
                           rsd, cap, rcap);
          else
            f32_p_ds<true>(s[j][e], dp[j][e], lr[r], dl[r],
                           scored(row0 + 8 * r, cw + 8 * j + 2 * t4 + (e & 1),
                                  S, Sk, causal, window), rsd, cap, rcap);
        } else
          f32_p_ds<false>(s[j][e], dp[j][e], lr[r], dl[r], true, rsd, cap,
                          rcap);
      }
    products_kn<D, NK>(acc, dp, Kt, g, t4);  // dQ += dS K
  }
  cp_async_wait<0>();
  __syncthreads();                         // the tiles' buffers are free
  pair_sum<D>(acc, Ks, 16 * w4, half, g, t4);
  if (half == 1) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    float* out = dq_part != nullptr
        ? dq_part + ((static_cast<long long>(blockIdx.z) * gridDim.x
                      + blockIdx.x) * S + row) * D
        : dq + b * sdq.b + h * sdq.h + row * sdq.s;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      out[8 * j + 2 * t4] = acc[j][2 * r];
      out[8 * j + 2 * t4 + 1] = acc[j][2 * r + 1];
    }
  }
}

// ----------------------------------- bfloat16: warpgroups on wgmma

constexpr int kTile = 64;            // rows a consumer warpgroup owns, and
                                     // rows of the streamed side a stage
constexpr int kStages = 3;           // ring slots of the streamed side

// A block: warpgroup 0 copies (the producer), warpgroups 1 .. NWG multiply
// (consumers, 64 own rows each).  Shared memory: the two own tiles, then
// the ring; every tile in the swizzled layout of wgmma_bf16.cuh.
template <int D, int NWG>
struct WgGeom {
  static constexpr int kThreads = 128 * (NWG + 1);
  static constexpr int kOwn = kTile * NWG;
  static constexpr int kOwnBytes = kOwn * D * 2;
  static constexpr int kStepBytes = kTile * D * 2;
  // a dK/dV stage: Q, dO, then the rows' lse and delta
  static constexpr int kKvStage =
      (2 * kStepBytes + 2 * kTile * 4 + 1023) / 1024 * 1024;
  static constexpr int kQStage = 2 * kStepBytes;   // a dQ stage: K, V
  static constexpr int kKvSmem = 2 * kOwnBytes + kStages * kKvStage + 1024;
  static constexpr int kQSmem = 2 * kOwnBytes + kStages * kQStage + 1024;
  // the block's registers at launch (65,536 / (kThreads kMinBlocks), at
  // most 248 a thread), moved to the consumers by setmaxnreg; one
  // warpgroup of D = 64 fits two blocks an SM
  static constexpr int kMinBlocks = NWG == 1 && D == 64 ? 2 : 1;
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs =
      NWG == 2 ? 232 : (kMinBlocks == 2 ? 216 : 240);
  static constexpr int kLaunchRegs =
      65536 / kMinBlocks / kThreads / 8 * 8 < 248
          ? 65536 / kMinBlocks / kThreads / 8 * 8 : 248;
  static_assert(kProducerRegs + NWG * kConsumerRegs <=
                    kLaunchRegs * (NWG + 1),
                "setmaxnreg within the block's registers");
};

// the four operands' tensor maps (wgmma_bf16.cuh bf16_map)
struct Maps {
  CUtensorMap q, k, v, dout;
};

__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t{1023});
}

// The query tiles (kTile rows) that see keys k0 .. k0 + own - 1.
__device__ __forceinline__ void wg_query_tiles(int k0, int own, int S,
                                               int causal, int window,
                                               int& first, int& end) {
  first = causal ? k0 / kTile : 0;
  end = (S + kTile - 1) / kTile;
  if (window > 0) end = min(end, (k0 + own - 1 + window - 1) / kTile + 1);
}

// Does a (rows r0 .. r0 + 63) x (keys c0 .. c0 + 63) tile score nothing
// (dead), or everything (interior: no mask to apply)?
__device__ __forceinline__ bool tile_dead(int r0, int c0, int S, int Sk,
                                          int causal, int window) {
  return r0 >= S || c0 >= Sk || (causal && c0 > r0 + kTile - 1) ||
         (window > 0 && r0 - (c0 + kTile - 1) >= window);
}
__device__ __forceinline__ bool tile_interior(int r0, int c0, int S, int Sk,
                                              int causal, int window) {
  return r0 + kTile <= S && c0 + kTile <= Sk &&
         (!causal || c0 + kTile - 1 <= r0) &&
         (window <= 0 || r0 + kTile - 1 - c0 < window);
}
// (the same with rows at positions qo + r, before the key mask)
__device__ __forceinline__ bool tile_dead_at(int r0, int c0, int S, int Sk,
                                             int causal, int window,
                                             int qo) {
  return r0 >= S || c0 >= Sk || (causal && c0 > qo + r0 + kTile - 1) ||
         (window > 0 && qo + r0 - (c0 + kTile - 1) >= window);
}
__device__ __forceinline__ bool tile_interior_at(int r0, int c0, int S,
                                                 int Sk, int causal,
                                                 int window, int qo) {
  return r0 + kTile <= S && c0 + kTile <= Sk &&
         (!causal || c0 + kTile - 1 <= qo + r0) &&
         (window <= 0 || qo + r0 + kTile - 1 - c0 < window);
}

// 2^x on the special-function unit (ex2.approx: 2 ulp; P is rounded to
// bf16 before its product anyway)
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P and dS (scaled to the raw product) of one accumulator element, from
// its score s and dP; Lg is the row's lse times log2(e), rcap 1 / cap.
// The cap's tanh is compiled in only where kCap (a kernel with it pays
// for it on every element even where the branch is not taken).
template <bool kCap>
__device__ __forceinline__ void wg_p_ds(float& s, float& dp, float Lg,
                                        float dl, bool ok, float rsd,
                                        float cap, float rcap) {
  float x = s * rsd;
  float dc = 1.0f;
  if constexpr (kCap) {
    const float t = tanhf(x * rcap);
    x = cap * t;
    dc = 1.0f - t * t;
  }
  const float p = ok ? exp2_sfu(x * kLog2e - Lg) : 0.0f;
  s = p;
  dp = kCap ? p * (dp - dl) * dc * rsd : p * (dp - dl) * rsd;
}

// Without a cap the element-wise work goes in two halves: P (from S)
// while the product for dP still runs, then dS.  P's half:
__device__ __forceinline__ float wg_p(float s, float Lg, bool ok,
                                      float rsd) {
  const float x = s * rsd;
  return ok ? exp2_sfu(x * kLog2e - Lg) : 0.0f;
}

// P and dS in place on a 64 x 64 tile: with a cap both at once (S and dP
// have landed), without one P alone (dS follows once dP has landed).
// Masked only where kEdge: edge tiles and interior tiles take loops of
// their own, since a mask test in one loop would be a branch taken apart
// element by element.  dK/dV's tile is transposed: element 4j + r is key
// key0 + 8 (r / 2), query q0 + 8j + 2 t4 + r % 2 (Ls, Dl the queries' lse
// and delta; with kExt, qo the query offset and ok_lo, ok_hi the key
// mask of the thread's two keys).
template <bool kEdge, bool kCap, bool kExt = false>
__device__ __forceinline__ void kv_elements(
    float (&s)[32], float (&dp)[32], const float* Ls, const float* Dl,
    int q0, int key0, int t4, int S, int Sk, int causal, int window,
    float rsd, float cap, float rcap, int qo = 0, bool ok_lo = true,
    bool ok_hi = true) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int col = 8 * j + 2 * t4 + (r & 1);
      bool ok;
      if constexpr (kExt)
        ok = !kEdge || (scored_at(q0 + col, key0 + 8 * (r >> 1), S, Sk,
                                  causal, window, qo) &&
                        ((r >> 1) ? ok_hi : ok_lo));
      else
        ok = !kEdge || scored(q0 + col, key0 + 8 * (r >> 1), S,
                              Sk, causal, window);
      if constexpr (kCap)
        wg_p_ds<true>(s[4 * j + r], dp[4 * j + r], Ls[col] * kLog2e,
                      Dl[col], ok, rsd, cap, rcap);
      else
        s[4 * j + r] = wg_p(s[4 * j + r], Ls[col] * kLog2e, ok, rsd);
    }
}

// dQ's tile: element 4j + r is row row0 + 8 (r / 2), key c0 + 8j + 2 t4 +
// r % 2 (lg, dl the two rows' lse times log2(e) and delta; with kExt, qo
// the query offset and mlo, mhi the key mask of keys c0 .., c0 + 32 ..)
template <bool kEdge, bool kCap, bool kExt = false>
__device__ __forceinline__ void q_elements(
    float (&s)[32], float (&dp)[32], const float (&lg)[2],
    const float (&dl)[2], int row0, int c0, int t4, int S, int Sk,
    int causal, int window, float rsd, float cap, float rcap, int qo = 0,
    uint32_t mlo = ~0u, uint32_t mhi = ~0u) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      bool ok;
      if constexpr (kExt)
        ok = !kEdge ||
             (scored_at(row0 + 8 * (r >> 1),
                        c0 + 8 * j + 2 * t4 + (r & 1), S, Sk, causal,
                        window, qo) &&
              (((j < 4 ? mlo : mhi) >> (8 * (j & 3) + 2 * t4 + (r & 1))) &
               1u));
      else
        ok = !kEdge || scored(row0 + 8 * (r >> 1),
                              c0 + 8 * j + 2 * t4 + (r & 1), S,
                              Sk, causal, window);
      if constexpr (kCap)
        wg_p_ds<true>(s[4 * j + r], dp[4 * j + r], lg[r >> 1], dl[r >> 1],
                      ok, rsd, cap, rcap);
      else
        s[4 * j + r] = wg_p(s[4 * j + r], lg[r >> 1], ok, rsd);
    }
}

// every consumer warp's arrival on a barrier initialised with 4 NWG
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) wg::mbar_arrive(bar);
}

// dK/dV: block (b * Hkv + kv head, key block of kOwn keys).  The
// producer copies the block's K and V once (TMA), then for each query
// head of the group and each query tile that can see the keys, in that
// order, Q and dO (TMA) and the rows' lse and delta (cp.async) into the
// ring.  Consumer c (keys kw0 .. kw0 + 63) for each stage: S^T = K Q^T
// and dP^T = V dO^T (wgmma, both operands in shared memory, K-major), P^T
// and dS^T in place in the accumulators (masked only on tiles that cross
// the diagonal, the window's edge or the ragged ends; tiles that score
// nothing are skipped), rounded to bf16 as register A operands, then dV
// += P^T dO and dK += dS^T Q (dO and Q read MN-major from the same slot).
// dK and dV stay in registers.  kExt: the query offset, the key mask (the
// own keys' bytes, read once) and vsum (fa_bwd_empty_kernel), added to dv.
template <int D, int NWG, bool kCap, bool kExt>
__global__ void __launch_bounds__(WgGeom<D, NWG>::kThreads,
                                  WgGeom<D, NWG>::kMinBlocks)
fa_bwd_dkdv_wg(const __grid_constant__ Maps maps,
               const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dk,
               bf16* __restrict__ dv, int Hq, int Hkv, int S, int Sk,
               Strides sdk, Strides sdv, int causal, int window, float rsd,
               float cap, int q_offset,
               const unsigned char* __restrict__ kvm,
               const float* __restrict__ vsum) {
  using G = WgGeom<D, NWG>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages], own_full;
  unsigned char* Ks = align_1k(smem_raw);
  unsigned char* Vs = Ks + G::kOwnBytes;
  unsigned char* ring = Vs + G::kOwnBytes;
  const int hk = blockIdx.x % Hkv;
  const int b = blockIdx.x / Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.y * G::kOwn;
  const int qo = kExt ? q_offset : 0;
  int qt_first, qt_end;
  if constexpr (kExt)
    query_tiles_at(k0, G::kOwn, kTile, S, causal, window, qo, qt_first,
                   qt_end);
  else
    wg_query_tiles(k0, G::kOwn, S, causal, window, qt_first, qt_end);
  const int n_tiles = max(qt_end - qt_first, 0);
  const int n = group * n_tiles;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      wg::mbar_init(&full[i], 128 + 1);    // the lse copies, the TMA
      wg::mbar_init(&empty[i], 4 * NWG);
    }
    wg::mbar_init(&own_full, 1);
  }
  __syncthreads();
  if (threadIdx.x < 128) {                 // the producer
    wg::setmaxnreg_dec<G::kProducerRegs>();
    const int p = threadIdx.x;
    if (p == 0) {
      wg::mbar_expect_tx(&own_full, 2 * G::kOwnBytes);
      wg::tma_tile<G::kOwn, D>(Ks, &maps.k, k0, hk, b, &own_full);
      wg::tma_tile<G::kOwn, D>(Vs, &maps.v, k0, hk, b, &own_full);
    }
    for (int i = 0; i < n; ++i) {
      const int slot = i % kStages;
      if (i >= kStages) wg::mbar_wait(&empty[slot], (i / kStages - 1) & 1);
      const int h = hk * group + i / n_tiles;
      const int q0 = (qt_first + i % n_tiles) * kTile;
      unsigned char* st = ring + slot * G::kKvStage;
      if (p == 0) {
        wg::mbar_expect_tx(&full[slot], 2 * G::kStepBytes);
        wg::tma_tile<kTile, D>(st, &maps.q, q0, h, b, &full[slot]);
        wg::tma_tile<kTile, D>(st + G::kStepBytes, &maps.dout, q0, h, b,
                               &full[slot]);
      }
      const long long at = (static_cast<long long>(b) * Hq + h) * S + q0;
      float* L = reinterpret_cast<float*>(st + 2 * G::kStepBytes);
      wg::load_floats(L, lse + at, S - q0, kTile, p);
      wg::load_floats(L + kTile, delta + at, S - q0, kTile, p - kTile);
      wg::cp_arrive(&full[slot]);        // when this thread's have landed
    }
    wg::cp_wait_all();
    return;
  }
  wg::setmaxnreg_inc<G::kConsumerRegs>();
  const float rcap = kCap ? 1.0f / cap : 0.0f;
  const int c = (threadIdx.x >> 7) - 1;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw0 = k0 + kTile * c;          // this warpgroup's keys

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dka[e] = dva[e] = 0.0f;
  wg::mbar_wait(&own_full, 0);
  for (int i = 0; i < n; ++i) {
    const int slot = i % kStages;
    const int q0 = (qt_first + i % n_tiles) * kTile;
    const unsigned char* st = ring + slot * G::kKvStage;
    wg::mbar_wait(&full[slot], (i / kStages) & 1);
    // (the products are issued and waited for within one branch: ptxas
    // serializes wgmma whose wait lies on another path)
    if (!(kExt ? tile_dead_at(q0, kw0, S, Sk, causal, window, qo)
               : tile_dead(q0, kw0, S, Sk, causal, window))) {
      // (kExt: the key mask of the thread's two keys kw0 + 16 warp + g,
      // + 8 in ok_lo, ok_hi, and whether the warp's 16 are all valid)
      bool edge, ok_lo = true, ok_hi = true;
      if constexpr (kExt) {
        const unsigned char* mb =
            kvm != nullptr ? kvm + static_cast<long long>(b) * Sk : nullptr;
        const int key = kw0 + 16 * warp + g;
        ok_lo = mb == nullptr || (key < Sk && mb[key]);
        ok_hi = mb == nullptr || (key + 8 < Sk && mb[key + 8]);
        edge = !tile_interior_at(q0, kw0, S, Sk, causal, window, qo) ||
               !own_keys_valid(mb, kw0 + 16 * warp, Sk, lane);
      } else {
        edge = !tile_interior(q0, kw0, S, Sk, causal, window);
      }
      float s[32], dp[32];
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wg::mma_ss_n64(s, wg::sw128_kmajor<G::kOwn>(Ks, kTile * c, kk),
                       wg::sw128_kmajor<kTile>(st, 0, kk), kk > 0);
      wg::commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wg::mma_ss_n64(dp, wg::sw128_kmajor<G::kOwn>(Vs, kTile * c, kk),
                       wg::sw128_kmajor<kTile>(st + G::kStepBytes, 0, kk),
                       kk > 0);
      wg::commit();
      const float* Ls = reinterpret_cast<const float*>(st + 2 * G::kStepBytes);
      const float* Dl = Ls + kTile;
      // P^T and dS^T in place (keys kw0 + 16 warp + g + 8 (r / 2))
      if constexpr (kCap) {
        wg::wait<0>();
        wg::fence_regs(s);
        wg::fence_regs(dp);
      } else {
        wg::wait<1>();                     // S^T (dP^T still running)
        wg::fence_regs(s);
      }
      const int key0 = kw0 + 16 * warp + g;
      if constexpr (kExt) {
        if (edge)
          kv_elements<true, kCap, true>(s, dp, Ls, Dl, q0, key0, t4, S, Sk,
                                        causal, window, rsd, cap, rcap, qo,
                                        ok_lo, ok_hi);
        else
          kv_elements<false, kCap, true>(s, dp, Ls, Dl, q0, key0, t4, S, Sk,
                                         causal, window, rsd, cap, rcap, qo,
                                         ok_lo, ok_hi);
      } else {
        if (edge)
          kv_elements<true, kCap>(s, dp, Ls, Dl, q0, key0, t4, S, Sk, causal,
                                  window, rsd, cap, rcap);
        else
          kv_elements<false, kCap>(s, dp, Ls, Dl, q0, key0, t4, S, Sk,
                                   causal, window, rsd, cap, rcap);
      }
      if constexpr (!kCap) {
        wg::wait<0>();
        wg::fence_regs(dp);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            dp[4 * j + r] = s[4 * j + r]
                * (dp[4 * j + r] - Dl[8 * j + 2 * t4 + (r & 1)]) * rsd;
      }
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wg::acc_to_a(s, kk, pa[kk]);
        wg::acc_to_a(dp, kk, da[kk]);
      }
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::mma_rs<D>(dva, pa[kk],
                      wg::sw128_mnmajor<kTile>(st + G::kStepBytes, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::mma_rs<D>(dka, da[kk], wg::sw128_mnmajor<kTile>(st, kk), 1);
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(dva);
      wg::fence_regs(dka);
    }
    warp_arrive(&empty[slot]);
  }
  bf16* dkb = dk + b * sdk.b + hk * sdk.h;
  bf16* dvb = dv + b * sdv.b + hk * sdv.h;
  if constexpr (kExt) {
    if (vsum != nullptr) {                 // the rows with no key
      const float* u =
          vsum + (static_cast<long long>(b) * Hkv + hk) * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dva[4 * j + 2 * r] = __fadd_rn(dva[4 * j + 2 * r], u[8 * j]);
          dva[4 * j + 2 * r + 1] =
              __fadd_rn(dva[4 * j + 2 * r + 1], u[8 * j + 1]);
        }
    }
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kw0 + 16 * warp + g + 8 * r;
      if (key >= Sk) continue;
      *reinterpret_cast<__nv_bfloat162*>(dkb + key * sdk.s + col) =
          __floats2bfloat162_rn(dka[4 * j + 2 * r], dka[4 * j + 2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + key * sdv.s + col) =
          __floats2bfloat162_rn(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
    }
  }
}

// dQ: block (b * Hq + head, row block, key part).  Under causal masking
// the row blocks go last first (the longest first).  The key range is
// the part's [z part_keys, (z + 1) part_keys) when part_keys > 0 (a
// function of Sk alone, kernel.py dq_key_parts), else all keys.  The
// producer copies the block's Q and dO once, then K and V a key tile a
// stage (TMA).  Consumer c (rows rw0 .. rw0 + 63): S = Q K^T and dP = dO
// V^T (both operands K-major), P and dS in place, dQ += dS K (K
// MN-major).  dQ leaves as bf16, or as the part's float32 partial
// (dq_part: (parts, B, Hq, S, D)) that dq_fold adds in part order.  kExt:
// the query offset and the key mask (a stage's 64 keys as two ballot
// words a warp).
template <int D, int NWG, bool kCap, bool kExt>
__global__ void __launch_bounds__(WgGeom<D, NWG>::kThreads,
                                  WgGeom<D, NWG>::kMinBlocks)
fa_bwd_dq_wg(const __grid_constant__ Maps maps,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, float* __restrict__ dq_part, int Hq,
             int Hkv, int S, int Sk, Strides sdq, int causal, int window,
             float rsd, float cap, int part_keys, int q_offset,
             const unsigned char* __restrict__ kvm) {
  using G = WgGeom<D, NWG>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages], own_full;
  unsigned char* Qs = align_1k(smem_raw);
  unsigned char* Os = Qs + G::kOwnBytes;
  unsigned char* ring = Os + G::kOwnBytes;
  const int h = blockIdx.x % Hq;
  const int b = blockIdx.x / Hq;
  const int hk = h / (Hq / Hkv);
  const int rb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = rb * G::kOwn;
  const int qo = kExt ? q_offset : 0;
  const int key_lo = part_keys > 0 ? blockIdx.z * part_keys : 0;
  const int key_hi = part_keys > 0 ? min(Sk, key_lo + part_keys) : Sk;
  int n_keys, t_first;
  if constexpr (kExt) {
    n_keys = min(causal ? min(Sk, qo + q0 + G::kOwn) : Sk, key_hi);
    t_first = max(window > 0 ? max(qo + q0 - window + 1, 0) / kTile : 0,
                  key_lo / kTile);
  } else {
    n_keys = min(causal ? min(Sk, q0 + G::kOwn) : Sk, key_hi);
    t_first = max(
        window > 0 ? max(q0 - window + 1, 0) / kTile : 0, key_lo / kTile);
  }
  const int n = max((n_keys + kTile - 1) / kTile - t_first, 0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      wg::mbar_init(&full[i], 1);
      wg::mbar_init(&empty[i], 4 * NWG);
    }
    wg::mbar_init(&own_full, 1);
  }
  __syncthreads();
  if (threadIdx.x < 128) {                 // the producer: one thread
    wg::setmaxnreg_dec<G::kProducerRegs>();
    if (threadIdx.x != 0) return;
    wg::mbar_expect_tx(&own_full, 2 * G::kOwnBytes);
    wg::tma_tile<G::kOwn, D>(Qs, &maps.q, q0, h, b, &own_full);
    wg::tma_tile<G::kOwn, D>(Os, &maps.dout, q0, h, b, &own_full);
    for (int i = 0; i < n; ++i) {
      const int slot = i % kStages;
      if (i >= kStages)
        wg::mbar_wait(&empty[slot], (i / kStages - 1) & 1);
      const int c0 = (t_first + i) * kTile;
      unsigned char* st = ring + slot * G::kQStage;
      wg::mbar_expect_tx(&full[slot], 2 * G::kStepBytes);
      wg::tma_tile<kTile, D>(st, &maps.k, c0, hk, b, &full[slot]);
      wg::tma_tile<kTile, D>(st + G::kStepBytes, &maps.v, c0, hk, b,
                             &full[slot]);
    }
    return;
  }
  wg::setmaxnreg_inc<G::kConsumerRegs>();
  const float rcap = kCap ? 1.0f / cap : 0.0f;
  const int c = (threadIdx.x >> 7) - 1;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rw0 = q0 + kTile * c;          // this warpgroup's rows
  const int row0 = rw0 + 16 * warp + g;    // this thread's: +0, +8
  const long long lrow = static_cast<long long>(blockIdx.x) * S;
  float lg[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lg[r] = row < S ? lse[lrow + row] * kLog2e : 0.0f;
    dl[r] = row < S ? delta[lrow + row] : 0.0f;
  }
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.0f;
  wg::mbar_wait(&own_full, 0);
  for (int i = 0; i < n; ++i) {
    const int slot = i % kStages;
    const int c0 = (t_first + i) * kTile;
    const unsigned char* st = ring + slot * G::kQStage;
    wg::mbar_wait(&full[slot], (i / kStages) & 1);
    // (the products are issued and waited for within one branch: ptxas
    // serializes wgmma whose wait lies on another path)
    if (!(kExt ? tile_dead_at(rw0, c0, S, Sk, causal, window, qo)
               : tile_dead(rw0, c0, S, Sk, causal, window))) {
      uint32_t mlo = ~0u, mhi = ~0u;       // the key mask of keys c0 ..
      bool edge;
      if constexpr (kExt) {
        if (kvm != nullptr) {
          const unsigned char* mb = kvm + static_cast<long long>(b) * Sk;
          mlo = key_bits(mb, c0, Sk, lane);
          mhi = key_bits(mb, c0 + 32, Sk, lane);
        }
        edge = !tile_interior_at(rw0, c0, S, Sk, causal, window, qo) ||
               (mlo & mhi) != ~0u;
      } else {
        edge = !tile_interior(rw0, c0, S, Sk, causal, window);
      }
      float s[32], dp[32];
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wg::mma_ss_n64(s, wg::sw128_kmajor<G::kOwn>(Qs, kTile * c, kk),
                       wg::sw128_kmajor<kTile>(st, 0, kk), kk > 0);
      wg::commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wg::mma_ss_n64(dp, wg::sw128_kmajor<G::kOwn>(Os, kTile * c, kk),
                       wg::sw128_kmajor<kTile>(st + G::kStepBytes, 0, kk),
                       kk > 0);
      wg::commit();
      // P and dS in place
      if constexpr (kCap) {
        wg::wait<0>();
        wg::fence_regs(s);
        wg::fence_regs(dp);
      } else {
        wg::wait<1>();                     // S (dP still running)
        wg::fence_regs(s);
      }
      if constexpr (kExt) {
        if (edge)
          q_elements<true, kCap, true>(s, dp, lg, dl, row0, c0, t4, S, Sk,
                                       causal, window, rsd, cap, rcap, qo,
                                       mlo, mhi);
        else
          q_elements<false, kCap, true>(s, dp, lg, dl, row0, c0, t4, S, Sk,
                                        causal, window, rsd, cap, rcap, qo,
                                        mlo, mhi);
      } else {
        if (edge)
          q_elements<true, kCap>(s, dp, lg, dl, row0, c0, t4, S, Sk, causal,
                                 window, rsd, cap, rcap);
        else
          q_elements<false, kCap>(s, dp, lg, dl, row0, c0, t4, S, Sk, causal,
                                  window, rsd, cap, rcap);
      }
      if constexpr (!kCap) {
        wg::wait<0>();
        wg::fence_regs(dp);
#pragma unroll
        for (int e = 0; e < 32; ++e)
          dp[e] = s[e] * (dp[e] - dl[(e >> 1) & 1]) * rsd;
      }
      uint32_t da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wg::acc_to_a(dp, kk, da[kk]);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::mma_rs<D>(acc, da[kk], wg::sw128_mnmajor<kTile>(st, kk), 1);
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(acc);
    }
    warp_arrive(&empty[slot]);
  }
  if (dq_part != nullptr) {
    float* out = dq_part + (static_cast<long long>(blockIdx.z) * gridDim.x
                            + blockIdx.x) * S * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < S)
          *reinterpret_cast<float2*>(out + static_cast<long long>(row) * D
                                     + 8 * j + 2 * t4) =
              make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    return;
  }
  bf16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      *reinterpret_cast<__nv_bfloat162*>(dqb + row * sdq.s + col) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// delta for bf16: each row's 16-byte pieces over D / 8 lanes (2 rows a
// warp at D = 128, 4 at 64), float32 products, a fixed shuffle tree
template <int D>
__global__ void __launch_bounds__(256)
fa_bwd_delta_bf16(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                  float* __restrict__ delta, int Hq, int S,
                  long long n_rows, Strides so, Strides sdo) {
  constexpr int kLanesRow = D / 8;
  const int lane = threadIdx.x & 31;
  const long long row =
      (static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5))
          * (32 / kLanesRow) + lane / kLanesRow;
  const int piece = lane % kLanesRow;
  float acc = 0.0f;
  if (row < n_rows) {
    const int i = static_cast<int>(row % S);
    const long long bh = row / S;
    const int h = static_cast<int>(bh % Hq);
    const long long b = bh / Hq;
    const uint4 a = *reinterpret_cast<const uint4*>(
        o + b * so.b + h * so.h + i * so.s + 8 * piece);
    const uint4 c = *reinterpret_cast<const uint4*>(
        dout + b * sdo.b + h * sdo.h + i * sdo.s + 8 * piece);
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pc = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(pa[e]);
      const float2 y = __bfloat1622float2(pc[e]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
#pragma unroll
  for (int off = kLanesRow / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < n_rows && piece == 0) delta[row] = acc;
}

// dq = the parts' float32 partials added in part order, stored in dq's
// type (rounded to bf16, or float32 as summed); a thread a pair of columns
__device__ __forceinline__ void store_pair(bf16* at, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store_pair(float* at, float x, float y) {
  at[0] = x;                               // float32 rows may sit at any
  at[1] = y;                               // offset: no 8-byte store
}

template <typename T>
__global__ void dq_fold(const float* __restrict__ part, T* __restrict__ dq,
                        int parts, int Hq, int S, int D, Strides sdq,
                        long long n_pairs) {
  const long long m = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (m >= n_pairs) return;
  const long long plane = 2 * n_pairs;
  const long long e = 2 * m;
  const int d = static_cast<int>(e % D);
  const long long row = e / D;
  const int i = static_cast<int>(row % S);
  const long long bh = row / S;
  const int h = static_cast<int>(bh % Hq);
  const long long b = bh / Hq;
  float2 s = *reinterpret_cast<const float2*>(part + e);
  for (int p = 1; p < parts; ++p) {
    const float2 x = *reinterpret_cast<const float2*>(part + p * plane + e);
    s.x = __fadd_rn(s.x, x.x);
    s.y = __fadd_rn(s.y, x.y);
  }
  store_pair(dq + b * sdq.b + h * sdq.h + i * sdq.s + d, s.x, s.y);
}

// dq_fold over (B, Hq, S, D) on `stream`
template <typename T>
cudaError_t launch_fold(const float* dq_part, T* dq, int parts, int B,
                        int Hq, int S, int D, Strides sdq,
                        cudaStream_t stream) {
  const long long n_pairs = static_cast<long long>(B) * Hq * S * D / 2;
  dq_fold<T><<<static_cast<unsigned>((n_pairs + 255) / 256), 256, 0,
               stream>>>(dq_part, dq, parts, Hq, S, D, sdq, n_pairs);
  return cudaGetLastError();
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

// The extra arguments of an offset or masked call (kExt instances)
struct Ext {
  int q_offset;
  const unsigned char* kvm;
  float* vsum;
  bool on() const {
    return q_offset != 0 || kvm != nullptr || vsum != nullptr;
  }
};

// the empty-row pass (vsum given: kernel.py may_lack_keys) on `stream`
template <typename T, int D>
cudaError_t launch_empty(const void* dout, const float* lse, const Ext& x,
                         int B, int Hq, int Hkv, int S, int Sk,
                         const long long* st, cudaStream_t stream) {
  if (x.vsum == nullptr) return cudaSuccess;
  fa_bwd_empty_kernel<T, D><<<B * Hkv, 32 * kEmptyWarps, 0, stream>>>(
      static_cast<const T*>(dout), lse, x.vsum, Hq, Hkv, S, Sk,
      strides_of(st, 4));
  return cudaGetLastError();
}

template <int D, bool kExt>
int launch_bwd_f32_as(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, float* delta,
                      void* dq, void* dk, void* dv, int B, int Hq, int Hkv,
                      int S, int Sk, const long long* st, int causal,
                      int window, float cap, float* dq_part, int parts,
                      int part_keys, const Ext& x, cudaStream_t stream) {
  static bool opted_kv[kMaxDevices] = {}, opted_q[kMaxDevices] = {};
  cudaError_t err = opt_in(fa_bwd_dkdv_tf32<D, kExt>,
                           f32_dkdv_smem_bytes<D>(), opted_kv);
  if (err == cudaSuccess)
    err = opt_in(fa_bwd_dq_tf32<D, kExt>, f32_dq_smem_bytes<D>(), opted_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sq = strides_of(st, 0), sk = strides_of(st, 1),
                sv = strides_of(st, 2), sdo = strides_of(st, 4);
  const int vec = f32_rows_aligned(q, sq, B, Hq, S) &&
                  f32_rows_aligned(k, sk, B, Hkv, Sk) &&
                  f32_rows_aligned(v, sv, B, Hkv, Sk) &&
                  f32_rows_aligned(dout, sdo, B, Hq, S);
  const float rsd = 1.0f / sqrtf(static_cast<float>(D));
  const float rcap = cap > 0.0f ? 1.0f / cap : 0.0f;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* df = static_cast<const float*>(dout);
  fa_bwd_dkdv_tf32<D, kExt><<<dim3(B * Hkv, (Sk + kOwn - 1) / kOwn),
                              kF32BwdThreads, f32_dkdv_smem_bytes<D>(),
                              stream>>>(
      qf, kf, vf, df, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), Hq, Hkv, S, Sk, sq, sk, sv, sdo,
      strides_of(st, 6), strides_of(st, 7), causal, window, rsd, cap, rcap,
      vec, x.q_offset, x.kvm, x.vsum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fa_bwd_dq_tf32<D, kExt><<<dim3(B * Hq, (S + kOwn - 1) / kOwn, parts),
                            kF32BwdThreads, f32_dq_smem_bytes<D>(),
                            stream>>>(
      qf, kf, vf, df, lse, delta, static_cast<float*>(dq),
      parts > 1 ? dq_part : nullptr, Hq, Hkv, S, Sk, sq, sk, sv, sdo,
      strides_of(st, 5), causal, window, rsd, cap, rcap,
      parts > 1 ? part_keys : 0, vec, x.q_offset, x.kvm);
  err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return static_cast<int>(err);
  return static_cast<int>(launch_fold(dq_part, static_cast<float*>(dq),
                                      parts, B, Hq, S, D, strides_of(st, 5),
                                      stream));
}

template <int D>
int launch_bwd_f32(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int Hq,
                   int Hkv, int S, int Sk, const long long* st, int causal,
                   int window, float cap, float* dq_part, int part_keys,
                   const Ext& x, void* stream_ptr) {
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const int parts = part_keys > 0 ? (Sk + part_keys - 1) / part_keys : 1;
  if (part_keys < 0 || part_keys % kF32Tile ||
      (parts > 1 && (causal || dq_part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = launch_delta<float>(o, dout, delta, B, Hq, S, D, st, stream);
  if (rc) return rc;
  const cudaError_t err =
      launch_empty<float, D>(dout, lse, x, B, Hq, Hkv, S, Sk, st, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return x.on() ? launch_bwd_f32_as<D, true>(q, k, v, dout, lse, delta, dq,
                                             dk, dv, B, Hq, Hkv, S, Sk, st,
                                             causal, window, cap, dq_part,
                                             parts, part_keys, x, stream)
                : launch_bwd_f32_as<D, false>(q, k, v, dout, lse, delta, dq,
                                              dk, dv, B, Hq, Hkv, S, Sk, st,
                                              causal, window, cap, dq_part,
                                              parts, part_keys, x, stream);
}

constexpr int kSms = 132;            // an H100's SMs: a grid below
                                     // this takes one warpgroup a block

template <int D, int NWG, bool kCap, bool kExt>
cudaError_t launch_dkdv(const Maps& maps, const float* lse,
                        const float* delta, bf16* dk, bf16* dv, int B,
                        int Hq, int Hkv, int S, int Sk, const long long* st,
                        int causal, int window, float rsd, float cap,
                        const Ext& x, cudaStream_t stream) {
  using G = WgGeom<D, NWG>;
  static bool opted[kMaxDevices] = {};
  cudaError_t err =
      opt_in(fa_bwd_dkdv_wg<D, NWG, kCap, kExt>, G::kKvSmem, opted);
  if (err != cudaSuccess) return err;
  fa_bwd_dkdv_wg<D, NWG, kCap, kExt>
      <<<dim3(B * Hkv, (Sk + G::kOwn - 1) / G::kOwn), G::kThreads,
         G::kKvSmem, stream>>>(maps, lse, delta, dk, dv, Hq, Hkv, S, Sk,
                               strides_of(st, 6), strides_of(st, 7), causal,
                               window, rsd, cap, x.q_offset, x.kvm, x.vsum);
  return cudaGetLastError();
}

template <int D, int NWG, bool kCap, bool kExt>
cudaError_t launch_dq(const Maps& maps, const float* lse, const float* delta,
                      bf16* dq, float* dq_part, int parts, int part_keys,
                      int B, int Hq, int Hkv, int S, int Sk,
                      const long long* st, int causal, int window, float rsd,
                      float cap, const Ext& x, cudaStream_t stream) {
  using G = WgGeom<D, NWG>;
  static bool opted[kMaxDevices] = {};
  cudaError_t err =
      opt_in(fa_bwd_dq_wg<D, NWG, kCap, kExt>, G::kQSmem, opted);
  if (err != cudaSuccess) return err;
  fa_bwd_dq_wg<D, NWG, kCap, kExt>
      <<<dim3(B * Hq, (S + G::kOwn - 1) / G::kOwn, parts), G::kThreads,
         G::kQSmem, stream>>>(maps, lse, delta, dq,
                              parts > 1 ? dq_part : nullptr, Hq, Hkv, S, Sk,
                              strides_of(st, 5), causal, window, rsd, cap,
                              parts > 1 ? part_keys : 0, x.q_offset, x.kvm);
  return cudaGetLastError();
}

// the two kernels with one warpgroup or two a block, with the cap or not
template <int D, bool kCap, bool kExt>
cudaError_t launch_wg(const Maps& maps, const float* lse, const float* delta,
                      bf16* dq, bf16* dk, bf16* dv, float* dq_part,
                      int parts, int part_keys, int B, int Hq, int Hkv,
                      int S, int Sk, const long long* st, int causal,
                      int window, float rsd, float cap, const Ext& x,
                      cudaStream_t stream) {
  // two consumer warpgroups a block where that leaves a block for every
  // SM, else one (a row's arithmetic is the same either way)
  const bool kv2 = static_cast<long long>(B) * Hkv * ((Sk + 127) / 128)
                   >= kSms;
  cudaError_t err =
      kv2 ? launch_dkdv<D, 2, kCap, kExt>(maps, lse, delta, dk, dv, B, Hq,
                                          Hkv, S, Sk, st, causal, window,
                                          rsd, cap, x, stream)
          : launch_dkdv<D, 1, kCap, kExt>(maps, lse, delta, dk, dv, B, Hq,
                                          Hkv, S, Sk, st, causal, window,
                                          rsd, cap, x, stream);
  if (err != cudaSuccess) return err;
  const bool q2 = static_cast<long long>(B) * Hq * ((S + 127) / 128) * parts
                  >= kSms;
  return q2 ? launch_dq<D, 2, kCap, kExt>(maps, lse, delta, dq, dq_part,
                                          parts, part_keys, B, Hq, Hkv, S,
                                          Sk, st, causal, window, rsd, cap,
                                          x, stream)
            : launch_dq<D, 1, kCap, kExt>(maps, lse, delta, dq, dq_part,
                                          parts, part_keys, B, Hq, Hkv, S,
                                          Sk, st, causal, window, rsd, cap,
                                          x, stream);
}

template <int D>
int launch_bwd_bf16(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const float* lse,
                    float* delta, void* dq, void* dk, void* dv, int B,
                    int Hq, int Hkv, int S, int Sk, const long long* st,
                    int causal, int window, float cap, float* dq_part,
                    int part_keys, const Ext& x, void* stream_ptr) {
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const int parts = part_keys > 0 ? (Sk + part_keys - 1) / part_keys : 1;
  if (part_keys < 0 || part_keys % kTile ||
      (parts > 1 && (causal || dq_part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  // libcuda's encoder makes the tensor maps, and needs the tensors'
  // context current on this thread: autograd runs a backward on a thread
  // of its own, where no runtime call may have made it so yet
  cudaPointerAttributes where;
  cudaError_t err = cudaPointerGetAttributes(&where, q);
  if (err == cudaSuccess) err = cudaSetDevice(where.device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Maps maps;
  const Strides sq = strides_of(st, 0), sk = strides_of(st, 1),
                sv = strides_of(st, 2), sdo = strides_of(st, 4);
  if (!wg::bf16_map(&maps.q, q, B, Hq, S, D, sq.b, sq.h, sq.s) ||
      !wg::bf16_map(&maps.k, k, B, Hkv, Sk, D, sk.b, sk.h, sk.s) ||
      !wg::bf16_map(&maps.v, v, B, Hkv, Sk, D, sv.b, sv.h, sv.s) ||
      !wg::bf16_map(&maps.dout, dout, B, Hq, S, D, sdo.b, sdo.h, sdo.s))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_rows = static_cast<long long>(B) * Hq * S;
  const long long n_warps = (n_rows + 32 / (D / 8) - 1) / (32 / (D / 8));
  fa_bwd_delta_bf16<D><<<static_cast<unsigned>((n_warps + 7) / 8), 256, 0,
                         stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta,
      Hq, S, n_rows, strides_of(st, 3), strides_of(st, 4));
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_empty<bf16, D>(dout, lse, x, B, Hq, Hkv, S, Sk, st, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float rsd = 1.0f / sqrtf(static_cast<float>(D));
  auto* dqb = static_cast<bf16*>(dq);
  auto launch = cap > 0.0f ? (x.on() ? launch_wg<D, true, true>
                                     : launch_wg<D, true, false>)
                           : (x.on() ? launch_wg<D, false, true>
                                     : launch_wg<D, false, false>);
  err = launch(maps, lse, delta, dqb, static_cast<bf16*>(dk),
               static_cast<bf16*>(dv), dq_part, parts, part_keys, B, Hq, Hkv,
               S, Sk, st, causal, window, rsd, cap, x, stream);
  if (err != cudaSuccess || parts == 1) return static_cast<int>(err);
  return static_cast<int>(launch_fold(dq_part, dqb, parts, B, Hq, S, D,
                                      strides_of(st, 5), stream));
}

}  // namespace

// S: query rows, Sk: keys; lse: the forward's (B, Hq, S) float32 (+inf
// for a row with no key); delta: (B, Hq, S) float32 scratch; strides: 24
// int64 (see launch_delta); window: 0 for none; dq_part, part_keys: the
// dQ key split (kernel.py dq_key_parts): part_keys > 0 (a multiple of
// 64, non-causal only) splits the keys into parts of that many, whose
// float32 partials go to dq_part (ceil(Sk / part_keys), B, Hq, S, D)
// and are folded in order; 0: no split (dq_part unused).  q_offset,
// kv_mask: the forward's; vsum: null, or (B, Hkv, D) float32 scratch
// for the rows with no key (fa_bwd_empty_kernel; kernel.py
// may_lack_keys says when one can occur: then it must be given).  dq,
// dk, dv are written whole.
#define FA_BWD_ENTRY(NAME, LAUNCH)                                           \
  extern "C" int NAME(const void* q, const void* k, const void* v,           \
                      const void* o, const void* dout, const float* lse,     \
                      float* delta, void* dq, void* dk, void* dv, int B,     \
                      int Hq, int Hkv, int S, int Sk,                        \
                      const long long* strides, int causal, int window,      \
                      float cap, float* dq_part, int part_keys,              \
                      int q_offset, const unsigned char* kv_mask,            \
                      float* vsum, void* stream) {                           \
    if (B <= 0 || S <= 0 || Hq <= 0) return 0;                               \
    if (Sk <= 0 || Hkv <= 0 || Hq % Hkv || q_offset < 0 ||                   \
        (window > 0 && !causal))                                             \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    return LAUNCH(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S,   \
                  Sk, strides, causal, window, cap, dq_part, part_keys,      \
                  Ext{q_offset, kv_mask, vsum}, stream);                     \
  }

FA_BWD_ENTRY(fa_bwd_launch_f32_d64, launch_bwd_f32<64>)
FA_BWD_ENTRY(fa_bwd_launch_f32_d128, launch_bwd_f32<128>)
FA_BWD_ENTRY(fa_bwd_launch_bf16_d64, launch_bwd_bf16<64>)
FA_BWD_ENTRY(fa_bwd_launch_bf16_d128, launch_bwd_bf16<128>)
