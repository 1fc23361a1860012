// Helpers shared by flash_attention.cu (B9's forward) and
// flash_attention_bwd.cu (its gradient): strides, cp.async, ldmatrix,
// mma.sync.m16n8k16 on bf16, the float32 kernels' 3xTF32 products on
// mma.sync.m16n8k8 and their tiles, and the shared-memory opt-in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {                 // in elements; the D axis is contiguous
  long long b, h, s;
};

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 x) {
  return __bfloat162float(x);
}

// The sentinel lse of a row with no valid key (flash_attention.cu): the
// backward's P = exp(s - lse) is 0 there, and its empty-row pass finds
// the row by it
__device__ __forceinline__ float no_key_lse() {
  return __int_as_float(0x7f800000);   // +inf
}

// The key mask of keys k0 .. k0 + 31 of batch row `mb` (one byte a key,
// keys past Sk masked) as a warp-uniform word: bit j for key k0 + j
__device__ __forceinline__ uint32_t key_bits(const unsigned char* mb,
                                             int k0, int Sk, int lane) {
  const int key = k0 + lane;
  return __ballot_sync(0xffffffffu, key < Sk && mb[key] != 0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lanes 8j..8j+7 give matrix j's row addresses,
// register j holds matrix j's (row lane/4, columns 2*(lane%4) .. +1)
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// the same, transposed: register j holds matrix j's (rows 2*(lane%4) .. +1,
// column lane/4)
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment layouts (PTX ISA, mma.m16n8k16), g = lane / 4, c = lane % 4:
//   A regs 0..3: (row g, k 2c..2c+1), (g+8, 2c..), (g, 2c+8..), (g+8, 2c+8..)
//   B regs 0..1: (k 2c..2c+1, n g), (k 2c+8.., n g)
//   C 0..3:      (row g, n 2c), (g, 2c+1), (g+8, 2c), (g+8, 2c+1)
// Three ways to fill them from a bf16 tile in shared memory at a pitch
// of p elements (the kernels use all three):
//   A of rows r0.. (16 rows x 16 columns at col0), row-major [row][k]
__device__ __forceinline__ void ld_a(const bf16* tile, int p, int r0,
                                     int col0, int lane, uint32_t (&a)[4]) {
  const int r = r0 + (lane & 7) + 8 * ((lane >> 3) & 1);
  ldsm_x4(smem_u32(tile + r * p + col0 + 8 * (lane >> 4)), a);
}
//   B of two n-tiles (n0.. n0+15) from a row-major [n][k] tile:
//   b[0], b[1] for n0..n0+7, b[2], b[3] for n0+8..n0+15
__device__ __forceinline__ void ld_b_nk(const bf16* tile, int p, int n0,
                                        int k0, int lane, uint32_t (&b)[4]) {
  const int n = n0 + (lane & 7) + 8 * (lane >> 4);
  ldsm_x4(smem_u32(tile + n * p + k0 + 8 * ((lane >> 3) & 1)), b);
}
//   B of two n-tiles (columns n0..n0+15) from a row-major [k][n] tile
//   (rows k0..k0+15), transposed by ldmatrix
__device__ __forceinline__ void ld_b_kn(const bf16* tile, int p, int k0,
                                        int n0, int lane, uint32_t (&b)[4]) {
  const int k = k0 + (lane & 7) + 8 * ((lane >> 3) & 1);
  ldsm_x4_t(smem_u32(tile + k * p + n0 + 8 * (lane >> 4)), b);
}

// ----------------------------------- float32: 3xTF32 on mma.sync (both files)

// 4 bytes global -> shared, asynchronously; zero-filled when !ok
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  const int n = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(src), "r"(n));
}

// A float32 tile in shared memory: rows at a pitch of D + 4 floats, so
// that the fragment loads below are free of bank conflicts (a row starts
// 4 banks after the one before: lanes (g, t) read banks 4g + t for A/B
// fragments of [n][k] tiles, 8t + g and 8t + 4 + g for [k][n] tiles)
template <int D>
__host__ __device__ constexpr int f32_pitch() { return D + 4; }

// rows r0 .. r0 + kRows - 1 of a float32 (n x D) matrix at row stride
// `stride` into a tile of pitch D + 4 by cp.async, zeros past row n; by
// 16-byte copies where `vec` (pointer and strides 16-byte aligned), else
// 4-byte ones (float32 views may sit at any offset and stride)
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void f32_tile_async(float* dst, const float* src,
                                               long long stride, int r0,
                                               int n, bool vec, int tid) {
  constexpr int P = f32_pitch<D>();
  if (vec) {
    constexpr int CH = D / 4;
#pragma unroll 4
    for (int i = tid; i < kRows * CH; i += kThreads) {
      const int r = i / CH, c = i % CH;
      const bool ok = r0 + r < n;
      cp_async16(smem_u32(dst + r * P + 4 * c),
                 ok ? src + (r0 + r) * stride + 4 * c : src, ok);
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < kRows * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool ok = r0 + r < n;
      cp_async4(smem_u32(dst + r * P + c),
                ok ? src + (r0 + r) * stride + c : src, ok);
    }
  }
}

// v = hi + lo up to ~2^-22 of v, hi = tf32(v) and lo = tf32(v - hi), where
// tf32(x) rounds x to 10 mantissa bits, to nearest with ties away from zero
// (cvt.rna.tf32.f32's rounding): adding 0x1000 to the bit pattern rounds
// the magnitude, and the tensor cores read only the top 19 bits of a
// .tf32 operand, so the sum is the operand as it stands (ptxas compiles
// cvt.rna the same way, behind a test for non-finite values that these
// kernels' finite operands never need: 4 instructions a split instead of
// 6).  The mask gives hi's value for v - hi, which is exact.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(v) + 0x1000u;
  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi & 0xffffe000u)))
       + 0x1000u;
}

// c (16x8 f32) += a (16x8 tf32, row) * b (8x8 tf32, col).  Fragments
// (PTX ISA, mma.m16n8k8 .tf32), g = lane / 4, t = lane % 4:
//   A 0..3: (row g, k t), (g+8, t), (g, t+4), (g+8, t+4)
//   B 0..1: (k t, n g), (k t+4, n g)
//   C 0..3: (row g, n 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment of float32 values split into tf32 hi and lo
struct TfA {
  uint32_t hi[4], lo[4];
};
__device__ __forceinline__ TfA tf_a(float a0, float a1, float a2, float a3) {
  TfA f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}

// t += a b in 3xTF32 (a k-step of 8): lo*hi, hi*lo, then hi*hi, each
// accumulated in float32; lo*lo (~2^-22 of the product) is dropped
__device__ __forceinline__ void mma_3xtf32(float (&t)[4], const TfA& a,
                                           float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(t, a.lo, bh0, bh1);
  mma_tf32(t, a.hi, bl0, bl1);
  mma_tf32(t, a.hi, bh0, bh1);
}

// c += a0 b0 + a1 b1 over two k-steps: the six products summed from zero
// on the tensor cores, then added to c with IEEE adds.  mma.sync's float32
// accumulation does not round to nearest: a running sum kept in its
// accumulator drifts toward zero with every product (a truncating model
// of it reads 1.06e-5 at llama's forward shape, the card 1.1e-5), so no
// chain on the tensor cores is longer than two k-steps and every longer
// sum is float32 adds (2.4e-6 in the same model).
__device__ __forceinline__ void mma_3xtf32_x2(float (&c)[4], const TfA& a0,
                                              float b00, float b01,
                                              const TfA& a1, float b10,
                                              float b11) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_3xtf32(t, a0, b00, b01);
  mma_3xtf32(t, a1, b10, b11);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(c[e], t[e]);
}

// The S-accumulator -> A-fragment handoff (P V, P^T dO, dS^T Q, dS K): the
// accumulator of n-tile kk holds (row g, key 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1); read as the A fragment of the k-step over those 8 keys with
// k slot t <- key 2t and t+4 <- key 2t+1, it needs no shuffle, provided the
// B operand's rows are read in the same order (k slot t from key row 2t,
// t+4 from 2t+1: see mma_3xtf32's callers)
__device__ __forceinline__ TfA acc_as_a(const float (&c)[4]) {
  return tf_a(c[0], c[2], c[1], c[3]);
}

// c (16 rows x N columns) += A B^T over D: A's rows at `a` (a warp's 16
// rows of a [row][d] tile, offset by lane: + g P + t4), B's N rows from
// `b` ([n][d] tile): S = Q K^T and dP = dO V^T, or S^T and dP^T.  Two
// k-steps at a time from zero, then IEEE adds (mma_3xtf32_x2).
template <int D, int NT>
__device__ __forceinline__ void products_nk(float (&c)[NT][4],
                                            const float* a, const float* b,
                                            int g, int t4) {
  constexpr int P = f32_pitch<D>();
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {     // k-steps 2kc, 2kc + 1
    const float* x = a + 16 * kc;
    const TfA a0 = tf_a(x[0], x[8 * P], x[4], x[8 * P + 4]);
    const TfA a1 = tf_a(x[8], x[8 * P + 8], x[12], x[8 * P + 12]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* y = b + (8 * j + g) * P + 16 * kc + t4;
      mma_3xtf32_x2(c[j], a0, y[0], y[4], a1, y[8], y[12]);
    }
  }
}

// acc (16 rows x D) += X B over 8 NT inner indices: X the accumulators
// x[NT][4] of an earlier product (the S-accumulator handoff), B's rows
// from `b` ([k][d] tile, row 0 the first inner index): O += P V, dV +=
// P^T dO, dK += dS^T Q, dQ += dS K.  Two k-steps at a time from zero.
template <int D, int NT>
__device__ __forceinline__ void products_kn(float (&acc)[D / 8][4],
                                            const float (&x)[NT][4],
                                            const float* b, int g, int t4) {
  constexpr int P = f32_pitch<D>();
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
    const TfA a0 = acc_as_a(x[2 * kc]);
    const TfA a1 = acc_as_a(x[2 * kc + 1]);
    const float* y0 = b + (16 * kc + 2 * t4) * P + g;
    const float* y1 = y0 + 8 * P;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      mma_3xtf32_x2(acc[j], a0, y0[8 * j], y0[P + 8 * j], a1, y1[8 * j],
                    y1[P + 8 * j]);
  }
}

constexpr int kMaxDevices = 64;

// a kernel's opt-in to more than 48 KB of dynamic shared memory, once
// per device (the CUDA runtime keeps it; a launch needs no further call)
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, bool (&opted)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && opted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) opted[dev] = true;
  return err;
}

inline Strides strides_of(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

// Does every row of a float32 (B, H, S, D) operand start 16-byte aligned
// (its pointer, and the strides of its axes longer than 1)?
inline bool f32_rows_aligned(const void* p, Strides s, int B, int H, int S) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (B == 1 || s.b % 4 == 0) && (H == 1 || s.h % 4 == 0) &&
         (S == 1 || s.s % 4 == 0);
}

}  // namespace
