// Helpers for hand-written Hopper kernels on bf16 tiles: wgmma (bf16 in,
// float32 accumulate; A from shared memory or from registers, B from
// shared memory K-major or MN-major), the 128-byte-swizzled tile layout
// and its descriptors, TMA copies of a tile into it (the tensor map
// built on the host through libcuda's cuTensorMapEncodeTiled, found
// with dlsym), cp.async for small pieces, mbarriers and setmaxnreg.
// Used by flash_attention_bwd.cu (B9's backward); xcorr_align.cu (B4,
// TF32) keeps its own copies.
//
// The tile layout (what wgmma and TMA call the 128-byte swizzle): a
// (R x C) bf16 tile, C a multiple of 64, is C / 64 panels of R rows of
// 128 bytes, each panel 1 KB aligned; the 16-byte piece c (0..7) of row r
// sits at piece c ^ (r & 7) of its row, so 8 consecutive rows form a 1
// KB atom.
// wgmma reads one such tile two ways:
//   - K-major (rows = M or N, columns = K): a k16 step is 32 bytes into
//     the row (sw128_kmajor), 8-row groups 1 KB apart (SBO);
//   - MN-major (rows = K, columns = N): a k16 step is 16 rows (2 KB)
//     down the panel, 8-row groups 1 KB apart (SBO), the 64-column panels
//     R * 128 bytes apart (LBO); the instruction's transpose flag is set.
// The swizzle is a function of the shared address's bits, so every panel
// starts on a 1 KB boundary.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {
namespace wg {

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- TMA

// libcuda's cuTensorMapEncodeTiled, found in the copy the CUDA runtime
// has loaded (the library links against nothing else)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? EncodeTiled{nullptr}
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A (B, H, S, D) bf16 tensor (strides in elements, D contiguous, the
// others 16-byte multiples where their extent exceeds 1) as a tensor map
// of 64-column x 64-row boxes in the 128-byte swizzle: one box is one
// 8 KB panel block of a swizzled tile.  Rows past S read as zeros.
inline bool bf16_map(CUtensorMap* map, const void* base, int B, int H,
                     int S, int D, long long sb, long long sh,
                     long long ss) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  // an extent of 1 never steps: give it a stride the encoder accepts
  if (S == 1) ss = D;
  if (H == 1) sh = S * ss;
  if (B == 1) sb = H * sh;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the box at (column c0, row r0, head h, batch b) into dst (8 KB, 1 KB
// aligned), its bytes completing on bar
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int c0, int r0, int h, int b,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(saddr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
        "r"(r0), "r"(h), "r"(b), "r"(saddr(bar))
      : "memory");
}

// rows r0 .. r0 + R - 1 (R a multiple of 64) of head h, batch b into the
// swizzled (R x C) tile at dst: C / 64 x R / 64 boxes
template <int R, int C>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map, int r0,
                                         int h, int b, uint64_t* bar) {
#pragma unroll
  for (int pn = 0; pn < C / 64; ++pn)
#pragma unroll
    for (int rb = 0; rb < R / 64; ++rb)
      tma_box(dst + pn * (R * 128) + rb * (64 * 128), map, 64 * pn,
              r0 + 64 * rb, h, b, bar);
}

// ------------------------------------------------------------ cp.async

// n floats (n <= 64) from src to dst by 4-byte cp.async, zeros past
// `valid`, by the caller's threads p in [0, n)
__device__ __forceinline__ void load_floats(float* dst, const float* src,
                                            int valid, int n, int p) {
  if (p >= 0 && p < n)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(saddr(dst + p)), "l"(p < valid ? src + p : src),
                   "r"(p < valid ? 4 : 0));
}

// the barrier's arrival of this thread, made when every cp.async the
// thread has issued so far has landed (the barrier counts it among the
// arrivals it was initialised with)
__device__ __forceinline__ void cp_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(saddr(bar)) : "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// --------------------------------------------------------- descriptors

// a descriptor of a swizzled operand at p (1 KB atoms); lbo and sbo in
// bytes
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint64_t addr = saddr(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t{(lbo >> 4) & 0x3FFF} << 16) |
         (uint64_t{(sbo >> 4) & 0x3FFF} << 32) | (uint64_t{1} << 62);
}

// K-major: rows row0 .. row0 + 63 (or the B operand's N rows) of a
// swizzled (R x C) tile, k16 step kk of its C columns
template <int R>
__device__ __forceinline__ uint64_t sw128_kmajor(const unsigned char* tile,
                                                 int row0, int kk) {
  return sw128_desc(tile + (kk >> 2) * (R * 128) + row0 * 128 + (kk & 3) * 32,
                    16, 1024);
}

// MN-major: k16 step kk of a swizzled (R x C) tile's R rows, all C
// columns as N
template <int R>
__device__ __forceinline__ uint64_t sw128_mnmajor(const unsigned char* tile,
                                                  int kk) {
  return sw128_desc(tile + kk * 16 * 128, R * 128, 1024);
}

// ------------------------------------------------------------- wgmma

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator
// across the asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(v[i])::"memory");
}

// d (64 x 64 f32, 32 a thread) (+)= A * B, A (64 x 16) and B (16 x 64)
// K-major in shared memory (descriptors); d starts from 0 where
// !accumulate
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 f32, 32 a thread) (+)= A * B: A (64 x 16 bf16) in registers
// in mma.sync's A layout (acc_to_a), B (16 x 64) MN-major in shared
// memory (its rows of 64 contiguous: the transpose flag is set)
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d (64 x 128 f32, 64 a thread) (+)= A * B: A (64 x 16 bf16) in registers
// in mma.sync's A layout (acc_to_a), B (16 x 128) MN-major in shared
// memory (its rows of 128 contiguous: the transpose flag is set)
__device__ __forceinline__ void mma_rs_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d (64 x N) (+)= A (registers) * B (MN-major), N = 64 or 128
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b,
                                       int accumulate) {
  if constexpr (N == 64) {
    mma_rs_n64(d, a, b, accumulate);
  } else {
    static_assert(N == 128, "n64 or n128");
    mma_rs_n128(d, a, b, accumulate);
  }
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the A fragment of k16 step kk from a 64 x N accumulator (a thread's
// element 4j + r is row 16 warp + lane/4 + 8 (r/2), column 8j + 2 (lane%4)
// + r%2), rounded to bf16: mma.sync's and wgmma's register-A layout
template <int R>
__device__ __forceinline__ void acc_to_a(const float (&x)[R], int kk,
                                         uint32_t (&a)[4]) {
  a[0] = pack(x[8 * kk + 0], x[8 * kk + 1]);
  a[1] = pack(x[8 * kk + 2], x[8 * kk + 3]);
  a[2] = pack(x[8 * kk + 4], x[8 * kk + 5]);
  a[3] = pack(x[8 * kk + 6], x[8 * kk + 7]);
}

// --------------------------------------------------- barriers, proxies

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(saddr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(saddr(bar)) : "memory");
}
// this thread's arrival, and `bytes` more for the phase to wait for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(saddr(bar)), "r"(bytes) : "memory");
}
// until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(saddr(bar)), "r"(parity) : "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

}  // namespace wg
}  // namespace
