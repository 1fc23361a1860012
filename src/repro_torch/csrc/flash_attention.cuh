// Helpers shared by flash_attention.cu (B9's forward) and
// flash_attention_bwd.cu (its gradient): strides, cp.async, ldmatrix,
// mma.sync.m16n8k16 on bf16 and the shared-memory opt-in.
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

}  // namespace
