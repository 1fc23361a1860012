// flash_attention: causal, sliding-window or full GQA attention with an
// online softmax and an optional tanh soft-cap.
//
// Replaces the TPU kernel flash_attention_kernel (_fa_kernel) in
// src/repro/kernels/flash_attention/kernel.py.
//
//   s[i,j] = q_i . k_j / sqrt(D);  s = cap * tanh(s / cap) if cap > 0;
//   s[i,j] = -1e30 where causal and j > p_i, where a window w > 0 is
//   given and p_i - j >= w, or where the key mask masks key j of the
//   batch row (p_i = q_offset + i: the reference's _attend);
//   o_i = softmax_j(s) v
// for q (B, Hq, Sq, D) and k/v (B, Hkv, Sk, D), query head h reading kv
// head h / (Hq / Hkv) (jnp.repeat's order in the reference), float32
// accumulation, the output in q's type.  Sk is any length, causal or not
// (whisper's cross-attention: the prompt, or one position, against 1500
// encoder frames; a chunk of queries after a prefix, against the cache);
// a window needs causality (gemma2's local layers).  Strides are
// arguments (the head dimension must be contiguous), so the model's
// (B, S, H, D) activations go in as they are, without a transpose, and
// the output keeps q's layout.  Both
// kernels take one block per (batch * query head, 64-row query tile; in
// float32 also key part), mask keys past Sk and rows past Sq (any Sq,
// Sk >= 1), stop the causal loop at the diagonal tile and start a
// windowed one at the tile that holds the first row's first key (q0 - w
// + 1): tiles wholly left of the window are never loaded.  A row whose
// keys in a tile are all masked takes p = 1 there with m = -1e30; its
// first tile with a valid key rescales that away (exp(-1e30 - m) = 0).
//
// Offset and key mask (kExt instances; the kernels without them carry
// neither, so the serving and training calls run the code they ran
// before): the causal and window bounds take each row at its position
// q_offset + i, and the key mask (one byte a key, (B, Sk)) is read a tile
// at a time into a warp-uniform bit word (__ballot_sync over the tile's
// keys); a tile whose word is not all ones takes the masked loop.  A row
// may then have no valid key (every key of a left-padded prompt's pad
// rows is masked, or a window lies past the keys).  The reference scores
// all its Sk keys -1e30, so its softmax is uniform over them and its
// output the mean of v over all Sk keys: such a row ends with m = -1e30
// exactly (no valid score comes near it), and the kernels write the mean
// of v instead of acc / l (fa_vmean_kernel, a fixed-order pre-pass a
// (batch, kv head) that the group's query heads share, run when kernel.py
// may_lack_keys says such a row can occur) and +inf as its lse, which
// the backward reads as "no key".
//
// Bound on the H100: at the serve path's shapes (S ~ 1000, D = 128) the
// work, 2*S*S*D operations a head causal, sits far above the bytes (q, k,
// v and o once), so the bound is the bf16 tensor-core rate (989 TFLOP/s
// dense): 0.0062 ms at llama's (1, 24/8, 1000, 128).
//
// bfloat16 -> fa_mma_kernel, on the tensor cores (mma.sync.m16n8k16,
// bf16 in, float32 accumulate; the FlashAttention-2 layout).  Chosen over
// wgmma because its fragment layouts are fixed by the PTX ISA and need no
// shared-memory descriptors or swizzle modes that only the card could
// check; wgmma (64-row warpgroup tiles fed by TMA) is the next step.
//   - 4 warps, each owning 16 query rows of the 64-row tile; k/v tiles of
//     64 keys.  Q's A fragments are loaded once (ldmatrix) and stay in
//     registers; S = Q K^T runs on K fragments from ldmatrix, O += P V on
//     V fragments from ldmatrix.trans.  P goes from the S accumulators
//     straight into the A fragments of the PV product (rounded to bf16;
//     the row sums l stay float32), never through shared memory.
//   - K/V tiles are double-buffered with cp.async: tile t+1's copy is in
//     flight while tile t's products run.  Rows past S are zero-filled
//     (cp.async with a source size of 0), so padded V rows add nothing.
//   - 1/sqrt(D) and log2(e) are one multiply of the scores (exp2f then
//     gives e^x); with a cap, one multiply before tanhf and one after.
//     The online softmax (m, l) lives in registers; a row's 64 scores are
//     spread over the 4 threads of a quad and folded with 2 shuffles.
//   - Causal query tiles launch heaviest first (the diagonal-most tiles
//     do the most key tiles), heads fastest in the grid.
//   - Shared memory: Q + 2 x (K, V) tiles of 64 rows at a pitch of D + 8
//     bf16 (272 bytes at D = 128: the 8 row addresses of an ldmatrix fall
//     in distinct bank groups) = 87,040 bytes at D = 128 (2 blocks an SM),
//     46,080 at D = 64.  Registers: the 16 x D output and 16 x 64 score
//     accumulators and Q's fragments (D/16 x 4 words) make 251 a thread
//     at D = 128 and 167 at D = 64, no spills (-Xptxas=-v, which
//     chip_smoke.py prints with the build).
//   - What bounds it: 16 rows a warp means each K/V fragment read from
//     shared memory (ldmatrix) feeds one mma: a block moves 128 KB of
//     fragments per 64-key tile (64 ldmatrix.x4 a warp), 1,024 clocks at
//     128 bytes a clock an SM, for its 512 mma.sync.  Shared-memory
//     bandwidth and mma.sync's rate bound it, not device memory; wgmma,
//     which reads B from shared memory itself, would lift the first.
//   - P rounded to bf16 moves the float32 output by at most 0.31 bf16
//     ulp at the output's largest magnitude over the card tests' edge
//     cases (scripts/fa_bf16_rounding.py), so the bf16 output differs
//     from the plain version's by one rounding flip at most, as a kernel
//     that keeps P in float32 does.  A bf16 residual of P in a second PV
//     product cost 18% and left that unchanged (scripts/kernel_ab.py),
//     so it was not kept.
//   The wrapper refuses bf16 pointers or strides that are not 16-byte
//   aligned (cp.async copies 16 bytes).
//
// float32 -> fa_tf32_kernel, 3xTF32 on the tensor cores (mma.sync
// m16n8k8 .tf32, float32 accumulation): TF32 alone keeps about 3 digits
// and would break the 1e-5 gates of the float32 path, so each operand
// is split as it is loaded into registers, hi = tf32(v) (cvt.rna's) and
// lo = tf32(v - hi), and each k-step of 8 runs lo*hi, hi*lo, then hi*hi
// into the float32 accumulator (lo*lo, ~2^-22 of a product, dropped):
// ~2^-22 of each product's size against float32's 2^-24 rounding.  The
// bound of this design is 3 x 4 D operations a scored pair at the TF32
// rate (495 TFLOP/s): 0.0372 ms at llama's shape, against 0.0917 at the
// fp32 FMA rate (67 TFLOP/s).
//   - 64 query rows a block, 64-key tiles, as the bf16 kernel, but 8
//     warps: 4 pairs of 16 rows, the two warps of a pair taking the two
//     32-key halves of every tile, each with an online softmax (m, l,
//     acc) of its own, folded in a fixed order at the end.  mma.sync on
//     TF32 needs ~5 independent products in flight on an SM
//     sub-partition to reach its rate (scripts/mma_tf32_rate.py: 319
//     TFLOP/s, 64% of the dense TF32 peak, with 4 chains a warp at 2 warps
//     a sub-partition); two warps of a block there, with no exchange
//     between them a tile, keep it fed.  The tiles are float32 in shared
//     memory at a pitch of D + 4 floats (no bank conflicts for any
//     fragment load; flash_attention.cuh).  The Q tile stays in shared
//     memory (Q's split fragments in registers would take 128 of them at
//     D = 128), and the A fragments of Q and B fragments of K and V are
//     scalar loads split in registers: no hi/lo copies in shared memory
//     (Q split once a block into a hi/lo copy was measured slower: more
//     loads and spills, PERF.md section 6).
//     P goes from the S accumulators straight into the A fragments of P V
//     (split, not rounded), with V's rows read in the matching order
//     (flash_attention.cuh acc_as_a).
//   - Every product runs on the tensor cores two k-steps at a time from
//     zero, added to its float32 sum with IEEE adds (mma.sync's own
//     accumulation drifts toward zero: flash_attention.cuh
//     mma_3xtf32_x2): S over D, and O over the keys of a tile and across
//     tiles, with P's rescaling, in float32 adds.
//   - K and V double-buffered by cp.async: tile t + 1 copies while tile t
//     is multiplied, rows past Sk zero-filled, one barrier a tile.  Q + 2
//     x (K + V) are 169 KB at D = 128 (one block, 8 warps, an SM), 87 KB
//     at D = 64 (two).  16-byte copies where the operands' rows are
//     16-byte aligned, else 4-byte ones (float32 views may have any
//     offset and stride).
//   - Scores times 1/sqrt(D) (a multiply; the cap's tanhf of x / cap by a
//     multiply with 1/cap), expf and tanhf IEEE; a warp whose rows all lie
//     past S, or whose half of a tile scores nothing, skips its products
//     (one query row: 1 pair in 4 works).
//   - Non-causal calls with few query rows and many keys (kernel.py
//     fwd_key_parts: at most 128 rows, more than 512 keys: whisper's
//     cross-attention) split the keys into parts of whole 64-key tiles,
//     cut where dQ's key split cuts them (a function of the lengths
//     alone, never of the batch or heads), one block a part: each part's
//     (m, l, acc) goes to a float32 scratch and fa_tf32_fold combines the
//     parts in part order.  No atomics: a row's output depends on its own
//     q, k and v and the two lengths, not on what else the call computes.
#include "flash_attention.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile

// ------------------------------------ float32: 3xTF32 on the tensor cores

constexpr int kF32Threads = 256;       // 4 warp pairs x 16 query rows
constexpr int kHalfKeys = kBK / 2;     // a warp's keys of a tile

template <int D>
constexpr int f32_smem_bytes() {       // Q, 2 x (K, V)
  return 5 * kBQ * f32_pitch<D>() * static_cast<int>(sizeof(float));
}

// Block (b * Hq + head, query tile, key part), 8 warps: warp w owns query
// rows q0 + 16 (w % 4) .. and takes half w / 4 of every 64-key tile, with
// an online softmax (m, l, acc) of its own; the pair's two states are
// folded in a fixed order at the end (half 0's, then half 1's).  The key
// range is the part's [z part_keys, (z + 1) part_keys) when part_keys > 0
// (then the block writes its unnormalized rows with their (m, l) to
// `part`: (parts, B, Hq, S, D + 2)), else all keys (o and lse written
// here).  kExt: the query offset and the key mask (module comment,
// "Offset and key mask"); the instance without them carries neither.
template <int D, bool kExt>
__global__ void __launch_bounds__(kF32Threads, D == 64 ? 2 : 1)
fa_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, float* __restrict__ part, int Hq,
               int group, int S, int Sk, Strides sq, Strides sk, Strides sv,
               Strides so, int causal, int window, float rsd, float cap,
               float rcap, int part_keys, int vec, int q_offset,
               const unsigned char* __restrict__ kvm,
               const float* __restrict__ vmean) {
  constexpr int P = f32_pitch<D>();
  constexpr int ND = D / 8;            // n-tiles of the output
  constexpr int NK = kHalfKeys / 8;    // n-tiles of a warp's scores
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                     // [kBQ][P]
  float* Ks = Qs + kBQ * P;            // [2][kBK][P]
  float* Vs = Ks + 2 * kBK * P;        // [2][kBK][P]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int w4 = warp & 3, half = warp >> 2;
  const int h = blockIdx.x % Hq;
  const int b = blockIdx.x / Hq;
  const int hk = h / group;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kBQ;
  const int qo = kExt ? q_offset : 0;  // row i is position qo + i
  const int key_lo = part_keys > 0 ? blockIdx.z * part_keys : 0;
  const int key_hi = part_keys > 0 ? min(Sk, key_lo + part_keys) : Sk;
  // (the kernel without kExt keeps the expressions it had before the
  // offset, so that it compiles to the code it had)
  int n_keys, t_first;
  if constexpr (kExt)
    n_keys = causal ? min(Sk, qo + q0 + kBQ) : key_hi;
  else
    n_keys = causal ? min(Sk, q0 + kBQ) : key_hi;
  const int n_tiles = (n_keys + kBK - 1) / kBK;
  if constexpr (kExt)
    t_first =
        max(window > 0 ? max(qo + q0 - window + 1, 0) / kBK : 0, key_lo / kBK);
  else
    t_first =
        max(window > 0 ? max(q0 - window + 1, 0) / kBK : 0, key_lo / kBK);
  const unsigned char* mb =
      kExt && kvm != nullptr ? kvm + static_cast<long long>(b) * Sk : nullptr;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;

  auto load_kv = [&](int t, int buf) {
    f32_tile_async<D, kBK, kF32Threads>(Ks + buf * kBK * P, kb, sk.s,
                                        t * kBK, Sk, vec, tid);
    f32_tile_async<D, kBK, kF32Threads>(Vs + buf * kBK * P, vb, sv.s,
                                        t * kBK, Sk, vec, tid);
  };
  f32_tile_async<D, kBQ, kF32Threads>(Qs, qb, sq.s, q0, S, vec, tid);
  load_kv(t_first, 0);
  cp_async_commit();

  const int rw = q0 + 16 * w4;         // this warp's rows
  const int row0 = rw + g;             // this thread's rows: +0, +8
  const float* qa = Qs + (16 * w4 + g) * P + t4;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};           // this thread's share of the sums
  const unsigned full = 0xffffffffu;

  for (int t = t_first; t < n_tiles; ++t) {
    const int buf = (t - t_first) & 1;
    cp_async_wait<0>();                // tile t has landed, and every warp
    __syncthreads();                   // is done with tile t - 1
    if (t + 1 < n_tiles) {             // its buffer takes tile t + 1
      load_kv(t + 1, buf ^ 1);
      cp_async_commit();
    }
    const int kc = t * kBK + kHalfKeys * half;   // this warp's keys
    if constexpr (kExt) {
      if (rw >= S || kc >= Sk || (causal && kc > qo + rw + 15) ||
          (window > 0 && qo + rw - (kc + kHalfKeys - 1) >= window))
        continue;                      // it scores none of them
    } else {
      if (rw >= S || kc >= Sk || (causal && kc > rw + 15) ||
          (window > 0 && rw - (kc + kHalfKeys - 1) >= window))
        continue;                      // it scores none of them
    }
    uint32_t bits = ~0u;               // the key mask of keys kc ..
    if constexpr (kExt)
      if (mb != nullptr) bits = key_bits(mb, kc, Sk, lane);
    const float* Kt = Ks + (buf * kBK + kHalfKeys * half) * P;
    const float* Vt = Vs + (buf * kBK + kHalfKeys * half) * P;
    float s[NK][4];                    // 16 rows x 32 keys
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    products_nk<D, NK>(s, qa, Kt, g, t4);    // S = Q K^T
    // scale (and cap), mask, online softmax (natural-log domain)
    bool masked;
    if constexpr (kExt)
      masked = kc + kHalfKeys > Sk ||
               (causal && kc + kHalfKeys - 1 > qo + rw) ||
               (window > 0 && qo + rw + 15 - kc >= window) || bits != ~0u;
    else
      masked = kc + kHalfKeys > Sk ||
               (causal && kc + kHalfKeys - 1 > rw) ||
               (window > 0 && rw + 15 - kc >= window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * rsd;
        if (cap > 0.0f) x = cap * tanhf(x * rcap);
        if (masked) {
          const int key = kc + 8 * n + 2 * t4 + (e & 1);
          if constexpr (kExt) {
            const int row = qo + row0 + 8 * (e >> 1);   // its position
            if (key >= Sk || (causal && key > row) ||
                (window > 0 && row - key >= window) ||
                !((bits >> (8 * n + 2 * t4 + (e & 1))) & 1u))
              x = kNegInf;
          } else {
            const int row = row0 + 8 * (e >> 1);
            if (key >= Sk || (causal && key > row) ||
                (window > 0 && row - key >= window))
              x = kNegInf;
          }
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(full, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(full, mx[r], 2));
      corr[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // O += P V: P's accumulators of keys 8n.. are the A fragment (k slot
    // t <- key 2t, t+4 <- key 2t+1), so V's rows 2t and 2t+1
    products_kn<D, NK>(acc, s, Vt, g, t4);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(full, l[r], 1);
    l[r] += __shfl_xor_sync(full, l[r], 2);
  }
  // the pair's fold: half 1 leaves (m, l, acc) in the K buffers, half 0
  // adds them to its own with the weights exp(m_half - M)
  cp_async_wait<0>();
  __syncthreads();                     // the K/V buffers are free
  float* red = Ks;                     // [kBQ][D + 2]: acc, m, l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* row = red + (16 * w4 + g + 8 * r) * (D + 2);
    if (half == 1) {
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        row[8 * n + 2 * t4] = acc[n][2 * r];
        row[8 * n + 2 * t4 + 1] = acc[n][2 * r + 1];
      }
      if (t4 == 0) {
        row[D] = m[r];
        row[D + 1] = l[r];
      }
    }
  }
  __syncthreads();
  if (half == 1 || rw >= S) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* row = red + (16 * w4 + g + 8 * r) * (D + 2);
    const float m1 = row[D];
    const float mm = fmaxf(m[r], m1);
    const float w0 = expf(m[r] - mm), w1 = expf(m1 - mm);
    m[r] = mm;
    l[r] = __fadd_rn(__fmul_rn(l[r], w0), __fmul_rn(row[D + 1], w1));
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& a = acc[n][2 * r + e];
        a = __fadd_rn(__fmul_rn(a, w0),
                      __fmul_rn(row[8 * n + 2 * t4 + e], w1));
      }
  }
  if (part_keys > 0) {                 // this part's rows, unnormalized
    float* pb = part + (static_cast<long long>(blockIdx.z) * gridDim.x
                        + blockIdx.x) * S * (D + 2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      float* pr = pb + static_cast<long long>(row) * (D + 2);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        pr[8 * n + 2 * t4] = acc[n][2 * r];
        pr[8 * n + 2 * t4 + 1] = acc[n][2 * r + 1];
      }
      if (t4 == 0) {
        pr[D] = m[r];
        pr[D + 1] = l[r];
      }
    }
    return;
  }
  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    if constexpr (kExt) {
      if (vmean != nullptr && m[r] == kNegInf) {   // no key: the mean of v
        const float* vm =
            vmean + (static_cast<long long>(b) * (Hq / group) + hk) * D;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          ob[row * so.s + 8 * n + 2 * t4] = vm[8 * n + 2 * t4];
          ob[row * so.s + 8 * n + 2 * t4 + 1] = vm[8 * n + 2 * t4 + 1];
        }
        if (lse != nullptr && t4 == 0)
          lse[static_cast<long long>(blockIdx.x) * S + row] = no_key_lse();
        continue;
      }
    }
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      ob[row * so.s + 8 * n + 2 * t4] = __fdiv_rn(acc[n][2 * r], den);
      ob[row * so.s + 8 * n + 2 * t4 + 1] =
          __fdiv_rn(acc[n][2 * r + 1], den);
    }
    if (lse != nullptr && t4 == 0)
      lse[static_cast<long long>(blockIdx.x) * S + row] = m[r] + logf(den);
  }
}

// The key parts' rows folded in part order: M = max m_p, w_p = exp(m_p -
// M), L = sum w_p l_p, o = (sum w_p acc_p) / L, lse = M + log L; a thread
// an output element (b * Hq + head, row, column).  kExt: a row no part
// found a key for (M = -1e30) takes the mean of v and the sentinel lse.
template <bool kExt>
__global__ void fa_tf32_fold(const float* __restrict__ part,
                             float* __restrict__ o, float* __restrict__ lse,
                             int parts, int Hq, int S, int D, Strides so,
                             long long n_rows,
                             const float* __restrict__ vmean, int group) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (e >= n_rows * D) return;
  const int d = static_cast<int>(e % D);
  const long long row = e / D;
  const long long plane = n_rows * (D + 2);
  const float* pr = part + row * (D + 2);
  float mx = pr[D];
  for (int p = 1; p < parts; ++p) mx = fmaxf(mx, pr[p * plane + D]);
  float sum_l = 0.0f, sum_a = 0.0f;
  for (int p = 0; p < parts; ++p) {
    const float w = expf(pr[p * plane + D] - mx);
    sum_l = __fadd_rn(sum_l, __fmul_rn(pr[p * plane + D + 1], w));
    sum_a = __fadd_rn(sum_a, __fmul_rn(pr[p * plane + d], w));
  }
  const float den = fmaxf(sum_l, 1e-30f);
  const int i = static_cast<int>(row % S);
  const long long bh = row / S;
  const int h = static_cast<int>(bh % Hq);
  const long long b = bh / Hq;
  if constexpr (kExt) {
    if (vmean != nullptr && mx == kNegInf) {
      o[b * so.b + h * so.h + i * so.s + d] =
          vmean[(b * (Hq / group) + h / group) * D + d];
      if (lse != nullptr && d == 0) lse[row] = no_key_lse();
      return;
    }
  }
  o[b * so.b + h * so.h + i * so.s + d] = __fdiv_rn(sum_a, den);
  if (lse != nullptr && d == 0) lse[row] = mx + logf(den);
}

// ------------------------------------- bfloat16: tensor cores (mma.sync)

constexpr int kMmaThreads = 128;       // 4 warps x 16 query rows

template <int D>
__host__ __device__ constexpr int mma_pitch() { return D + 8; }  // a smem row

template <int D>
constexpr int mma_smem_bytes() {              // Q, then 2 x K, 2 x V
  return 5 * kBQ * mma_pitch<D>() * static_cast<int>(sizeof(bf16));
}

// kWin: a window is given.  The kernel without one carries none of the
// window's bounds and masks: they cost registers at D = 128, where the
// accumulators already take 251 of 255.  kExt: the query offset and the
// key mask (module comment, "Offset and key mask"), likewise only in the
// instances that take them.
template <int D, bool kWin, bool kExt>
__global__ void __launch_bounds__(kMmaThreads, 2)
fa_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o,
              float* __restrict__ lse, int Hq, int group, int S, int Sk,
              Strides sq, Strides sk, Strides sv, Strides so, int causal,
              int window, float score_mul, float cap_mul, int q_offset,
              const unsigned char* __restrict__ kvm,
              const float* __restrict__ vmean) {
  constexpr int P = mma_pitch<D>();
  constexpr int KD = D / 16;           // k-steps of Q K^T
  constexpr int ND = D / 8;            // n-tiles of the output
  constexpr int CH = D / 8;            // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [kBQ][P]
  bf16* Ks = Qs + kBQ * P;                        // [2][kBK][P]
  bf16* Vs = Ks + 2 * kBK * P;                    // [2][kBK][P]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int h = blockIdx.x % Hq;
  const int b = blockIdx.x / Hq;
  const int hk = h / group;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kBQ;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + hk * sk.h;
  const bf16* vb = v + b * sv.b + hk * sv.h;
  bf16* ob = o + b * so.b + h * so.h;

  // a 64-row tile of rows r0.. into shared memory, zeros past n
  auto load_tile = [&](bf16* dst, const bf16* src, long long stride,
                       int r0, int n) {
#pragma unroll
    for (int i = 0; i < kBQ * CH / kMmaThreads; ++i) {
      const int chunk = tid + i * kMmaThreads;
      const int r = chunk / CH, cc = chunk % CH;
      const bool ok = r0 + r < n;
      const bf16* from = ok ? src + (r0 + r) * stride + cc * 8 : src;
      cp_async16(smem_u32(dst + r * P + cc * 8), from, ok);
    }
  };

  const int qo = kExt ? q_offset : 0;  // row i is position qo + i
  int n_keys, t_first;                 // (without kExt: as before it)
  if constexpr (kExt) {
    n_keys = causal ? min(Sk, qo + q0 + kBQ) : Sk;
    t_first = kWin ? max(qo + q0 - window + 1, 0) / kBK : 0;
  } else {
    n_keys = causal ? min(Sk, q0 + kBQ) : Sk;
    t_first = kWin ? max(q0 - window + 1, 0) / kBK : 0;
  }
  const int n_tiles = (n_keys + kBK - 1) / kBK;
  const unsigned char* mb =
      kExt && kvm != nullptr ? kvm + static_cast<long long>(b) * Sk : nullptr;
  load_tile(Qs, qb, sq.s, q0, S);
  cp_async_commit();
  load_tile(Ks, kb, sk.s, t_first * kBK, Sk);
  load_tile(Vs, vb, sv.s, t_first * kBK, Sk);
  cp_async_commit();
  cp_async_wait<1>();                  // Q has landed
  __syncthreads();

  uint32_t qf[KD][4];                  // this warp's 16 rows of Q
  {
    const int r = warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
    const int col = 8 * (lane >> 4);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldsm_x4(smem_u32(Qs + r * P + kk * 16 + col), qf[kk]);
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};     // rows g and g+8, log2 domain
  float l[2] = {0.0f, 0.0f};           // this thread's share of the sums
  const int row0 = q0 + warp * 16 + g;
  const unsigned full = 0xffffffffu;

  for (int t = t_first; t < n_tiles; ++t) {
    const int buf = (t - t_first) & 1;
    if (t + 1 < n_tiles) {             // the next tile's copy overlaps
      load_tile(Ks + (buf ^ 1) * kBK * P, kb, sk.s, (t + 1) * kBK, Sk);
      load_tile(Vs + (buf ^ 1) * kBK * P, vb, sv.s, (t + 1) * kBK, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                   // tile t is in shared memory
    const bf16* Kt = Ks + buf * kBK * P;
    const bf16* Vt = Vs + buf * kBK * P;

    float s[8][4];                     // 16 rows x 64 keys
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // keys 16np .. 16np+15
        uint32_t kf[4];
        const int key = np * 16 + (lane & 7) + 8 * (lane >> 4);
        const int col = kk * 16 + 8 * ((lane >> 3) & 1);
        ldsm_x4(smem_u32(Kt + key * P + col), kf);
        mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale (and cap) into the log2 domain, mask, online softmax
    const int k0 = t * kBK;
    uint32_t mlo = ~0u, mhi = ~0u;     // the key mask: keys k0 .., k0 + 32 ..
    bool masked;
    if constexpr (kExt) {
      if (mb != nullptr) {
        mlo = key_bits(mb, k0, Sk, lane);
        mhi = key_bits(mb, k0 + 32, Sk, lane);
      }
      masked = k0 + kBK > Sk || (causal && k0 + kBK - 1 > qo + q0) ||
               (kWin && qo + q0 + kBQ - 1 - k0 >= window) ||
               (mlo & mhi) != ~0u;
    } else {
      masked = k0 + kBK > Sk || (causal && k0 + kBK - 1 > q0) ||
               (kWin && q0 + kBQ - 1 - k0 >= window);
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * score_mul;
        if (cap_mul > 0.0f) x = cap_mul * tanhf(x);
        if (masked) {
          const int key = k0 + 8 * n + 2 * c4 + (e & 1);
          if constexpr (kExt) {
            const int row = qo + row0 + 8 * (e >> 1);   // its position
            if (key >= Sk || (causal && key > row) ||
                (kWin && row - key >= window) ||
                !(((n < 4 ? mlo : mhi) >> (8 * (n & 3) + 2 * c4 + (e & 1)))
                  & 1u))
              x = kNegInf;
          } else {
            const int row = row0 + 8 * (e >> 1);
            if (key >= Sk || (causal && key > row) ||
                (kWin && row - key >= window))
              x = kNegInf;
          }
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(full, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(full, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V: the S accumulators of keys 16kk.. are P's A fragment
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int key = kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {  // columns 16dp .. 16dp+15
        uint32_t vf[4];
        ldsm_x4_t(smem_u32(Vt + key * P + dp * 16 + 8 * (lane >> 4)), vf);
        mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();                   // buffer buf is free for tile t+2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(full, l[r], 1);
    l[r] += __shfl_xor_sync(full, l[r], 2);
  }
  const float inv0 = 1.0f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.0f / fmaxf(l[1], 1e-30f);
  const int row1 = row0 + 8;
  if constexpr (kExt) {
    // (a window past the keys leaves a block no tile: the copy of tile
    // t_first, all zeros, may still be in flight)
    cp_async_wait<0>();
    const float* vm =
        vmean + (static_cast<long long>(b) * (Hq / group) + hk) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      // a row with no key: the mean of v, the sentinel lse
      const bool none = vmean != nullptr && m[r] == kNegInf;
      const float inv = r ? inv1 : inv0;
      if (lse != nullptr && c4 == 0)
        lse[static_cast<long long>(blockIdx.x) * S + row] =
            none ? no_key_lse()
                 : (m[r] + log2f(fmaxf(l[r], 1e-30f))) * kLn2;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int col = 8 * n + 2 * c4;
        __nv_bfloat162 y;
        if (none)
          y = __floats2bfloat162_rn(vm[col], vm[col + 1]);
        else
          y = __floats2bfloat162_rn(acc[n][2 * r] * inv,
                                    acc[n][2 * r + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(ob + row * so.s + col) = y;
      }
    }
    return;
  }
  if (lse != nullptr && c4 == 0) {     // m is in the log2 domain
    float* lb = lse + static_cast<long long>(blockIdx.x) * S;
    if (row0 < S) lb[row0] = (m[0] + log2f(fmaxf(l[0], 1e-30f))) * kLn2;
    if (row1 < S) lb[row1] = (m[1] + log2f(fmaxf(l[1], 1e-30f))) * kLn2;
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = 8 * n + 2 * c4;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * so.s + col) =
          __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * so.s + col) =
          __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

// ------------------------------------------- the mean of v (no-key rows)

constexpr int kMeanThreads = 512;

// vmean (B, Hkv, D) float32: v's mean over its Sk keys, a block a (batch,
// kv head), shared by the group's query heads.  Thread (lane r, column d)
// adds keys r, r + R, ... in order (R = 512 / D lanes), then lane 0 adds
// the lanes' sums in lane order and divides by Sk: a fixed order, a
// function of Sk and D alone.
template <typename T, int D>
__global__ void __launch_bounds__(kMeanThreads)
fa_vmean_kernel(const T* __restrict__ v, float* __restrict__ vmean, int Hkv,
                int Sk, Strides sv) {
  constexpr int R = kMeanThreads / D;
  __shared__ float lanes[kMeanThreads];
  const int d = threadIdx.x % D, r = threadIdx.x / D;
  const long long b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const T* col = v + b * sv.b + hk * sv.h + d;
  float sum = 0.0f;
#pragma unroll 8
  for (int j = r; j < Sk; j += R)
    sum = __fadd_rn(sum, to_f(col[static_cast<long long>(j) * sv.s]));
  lanes[threadIdx.x] = sum;
  __syncthreads();
  if (r != 0) return;
  for (int i = 1; i < R; ++i) sum = __fadd_rn(sum, lanes[i * D + d]);
  vmean[static_cast<long long>(blockIdx.x) * D + d] =
      __fdiv_rn(sum, static_cast<float>(Sk));
}

template <typename T, int D>
cudaError_t launch_vmean(const void* v, float* vmean, int B, int Hkv,
                         int Sk, Strides sv, cudaStream_t stream) {
  fa_vmean_kernel<T, D><<<B * Hkv, kMeanThreads, 0, stream>>>(
      static_cast<const T*>(v), vmean, Hkv, Sk, sv);
  return cudaGetLastError();
}

// ------------------------------------------------------------ launchers

template <int D, bool kExt>
int launch_f32_as(const void* q, const void* k, const void* v, void* o,
                  int B, int Hq, int Hkv, int S, int Sk, const long long* st,
                  int causal, int window, float cap, float* lse, float* part,
                  int parts, int part_keys, int q_offset,
                  const unsigned char* kvm, const float* vmean,
                  cudaStream_t stream) {
  const int smem = f32_smem_bytes<D>();
  static bool opted[kMaxDevices] = {};
  cudaError_t err = opt_in(fa_tf32_kernel<D, kExt>, smem, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sq = strides_of(st, 0), sk = strides_of(st, 1),
                sv = strides_of(st, 2), so = strides_of(st, 3);
  const int vec = f32_rows_aligned(q, sq, B, Hq, S) &&
                  f32_rows_aligned(k, sk, B, Hkv, Sk) &&
                  f32_rows_aligned(v, sv, B, Hkv, Sk);
  const float rsd = 1.0f / sqrtf(static_cast<float>(D));
  const dim3 grid(B * Hq, (S + kBQ - 1) / kBQ, parts);
  fa_tf32_kernel<D, kExt><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, part, Hq,
      Hq / Hkv, S, Sk, sq, sk, sv, so, causal, window, rsd, cap,
      cap > 0.0f ? 1.0f / cap : 0.0f, parts > 1 ? part_keys : 0, vec,
      q_offset, kvm, vmean);
  err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return static_cast<int>(err);
  const long long n_rows = static_cast<long long>(B) * Hq * S;
  fa_tf32_fold<kExt><<<static_cast<unsigned>((n_rows * D + 255) / 256), 256,
                       0, stream>>>(part, static_cast<float*>(o), lse, parts,
                                    Hq, S, D, so, n_rows, vmean, Hq / Hkv);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Hq, int Hkv, int S, int Sk, const long long* st,
               int causal, int window, float cap, float* lse, float* part,
               int part_keys, int q_offset, const unsigned char* kvm,
               float* vmean, void* stream_ptr) {
  const int parts = part_keys > 0 ? (Sk + part_keys - 1) / part_keys : 1;
  if (part_keys < 0 || part_keys % kBK ||
      (parts > 1 && (causal || part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  if (vmean != nullptr) {
    const cudaError_t err = launch_vmean<float, D>(
        v, vmean, B, Hkv, Sk, strides_of(st, 2), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return q_offset != 0 || kvm != nullptr || vmean != nullptr
             ? launch_f32_as<D, true>(q, k, v, o, B, Hq, Hkv, S, Sk, st,
                                      causal, window, cap, lse, part, parts,
                                      part_keys, q_offset, kvm, vmean,
                                      stream)
             : launch_f32_as<D, false>(q, k, v, o, B, Hq, Hkv, S, Sk, st,
                                       causal, window, cap, lse, part, parts,
                                       part_keys, 0, nullptr, nullptr,
                                       stream);
}

template <int D, bool kWin, bool kExt>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int Hq, int Hkv, int S, int Sk, const long long* st,
               int causal, int window, float score_mul, float cap_mul,
               float* lse, int q_offset, const unsigned char* kvm,
               const float* vmean, cudaStream_t stream) {
  const int smem = mma_smem_bytes<D>();
  static bool opted[kMaxDevices] = {};
  const cudaError_t err = opt_in(fa_mma_kernel<D, kWin, kExt>, smem, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * Hq, (S + kBQ - 1) / kBQ);
  fa_mma_kernel<D, kWin, kExt><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, Hq,
      Hq / Hkv, S, Sk, strides_of(st, 0), strides_of(st, 1),
      strides_of(st, 2), strides_of(st, 3), causal, window, score_mul,
      cap_mul, q_offset, kvm, vmean);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int Hq, int Hkv, int S, int Sk, const long long* st,
                int causal, int window, float cap, float* lse,
                float* /*part*/, int part_keys, int q_offset,
                const unsigned char* kvm, float* vmean, void* stream_ptr) {
  if (part_keys != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  if (vmean != nullptr) {
    const cudaError_t err = launch_vmean<bf16, D>(
        v, vmean, B, Hkv, Sk, strides_of(st, 2), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // scores -> log2 domain: x * log2(e) / sqrt(D), or with the cap
  // cap * log2(e) * tanh(x / (sqrt(D) * cap))
  const float rsd = 1.0f / sqrtf(static_cast<float>(D));
  const float score_mul = cap > 0.0f ? rsd / cap : rsd * kLog2e;
  const float cap_mul = cap > 0.0f ? cap * kLog2e : 0.0f;
  const bool ext = q_offset != 0 || kvm != nullptr || vmean != nullptr;
  auto launch = window > 0
      ? (ext ? launch_mma<D, true, true> : launch_mma<D, true, false>)
      : (ext ? launch_mma<D, false, true> : launch_mma<D, false, false>);
  return launch(q, k, v, o, B, Hq, Hkv, S, Sk, st, causal, window,
                score_mul, cap_mul, lse, q_offset, kvm, vmean, stream);
}

}  // namespace

// S: query rows, Sk: keys; strides: 12 int64, (batch, head, seq) for q,
// k, v and o in turn; window: 0 for none; lse: null, or (B, Hq, S)
// float32 that takes each row's log-sum-exp of its scaled (and capped)
// scores, m + log(l), for the backward (flash_attention_bwd.cu), +inf
// for a row with no key; part, part_keys: float32 only, the key split
// (kernel.py fwd_key_parts): part_keys > 0 (a multiple of 64,
// non-causal only) splits the keys into parts of that many, whose rows
// go to part (ceil(Sk / part_keys), B, Hq, S, D + 2) float32 and are
// folded in order; 0: no split (part unused).  q_offset >= 0: row i is
// position q_offset + i for the causal and window masks; kv_mask: null,
// or (B, Sk) bytes, 0 masking the key; vmean: null, or (B, Hkv, D)
// float32 scratch that takes v's mean, the output of a row with no key
// (kernel.py may_lack_keys says when one can occur: then it must be
// given).
#define FA_ENTRY(NAME, LAUNCH)                                               \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o,  \
                      int B, int Hq, int Hkv, int S, int Sk,                 \
                      const long long* strides, int causal, int window,      \
                      float cap, float* lse, float* part, int part_keys,     \
                      int q_offset, const unsigned char* kv_mask,            \
                      float* vmean, void* stream) {                          \
    if (B <= 0 || S <= 0 || Hq <= 0) return 0;                               \
    if (Sk <= 0 || q_offset < 0 || (window > 0 && !causal))                  \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    return LAUNCH(q, k, v, o, B, Hq, Hkv, S, Sk, strides, causal, window,    \
                  cap, lse, part, part_keys, q_offset, kv_mask, vmean,       \
                  stream);                                                   \
  }

FA_ENTRY(fa_launch_f32_d64, launch_f32<64>)
FA_ENTRY(fa_launch_f32_d128, launch_f32<128>)
FA_ENTRY(fa_launch_bf16_d64, launch_bf16<64>)
FA_ENTRY(fa_launch_bf16_d128, launch_bf16<128>)
