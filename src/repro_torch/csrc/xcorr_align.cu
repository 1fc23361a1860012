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
// only (129 of 256 lags on the windowed path, 1025 of 1152 on the batch
// path).  Nothing is assumed of the bank's rows (they are shifted copies
// of one reference on every path, but the op does not say so).
//
// Bound on the H100: the product's 2*F*L_real*G operations, against ~8*F*G
// bytes.  Launches, on the current stream:
//   stats    blocks [0, F): a stream row's masked mean and ||xc|| (the
//            centred values formed exactly as the product forms them),
//            and the zero scores of the padded lags; blocks
//            [F, F + L_real): ||bank_l||.  Only (F,) + (F,) + (L,) floats
//            are written: xc never goes to device memory.
//   product  128 streams x 128 lags a block, 32 grid points a stage,
//            three warpgroups.  The producer (warpgroup 0) copies x, m
//            and the bank into a ring of 3 stages in shared memory by
//            cp.async, centres the pieces of x it copied, (x - mean) * m,
//            in place as they land (and splits them, below), and marks
//            the slot full on an mbarrier; the two consumers (64 streams
//            each) multiply a full slot and mark it empty, which the
//            producer waits for before it refills it.  So a stage's
//            copies, its centring and the products of the stage before
//            overlap.  A stage's rows are 128 bytes, their eight 16-byte
//            pieces XOR-swizzled by the row's low 3 bits: the layout
//            wgmma reads as K-major with the 128-byte swizzle, and free of
//            bank conflicts for the copies.  Partial sums leave as 8-byte
//            pairs into rows padded to 8 lags.
//            The arithmetic is 3xTF32 on the tensor cores: the producer
//            splits each value of both operands into hi = tf32(v) and
//            lo = tf32(v - hi) (four operand tiles a stage); a consumer
//            issues, per 8 grid points, wgmma m64n128k8 on lo*hi, hi*lo,
//            hi*hi (lo*lo, ~2^-22 of the product, dropped), reading both
//            operands from shared memory.  wgmma's dense TF32 rate (495
//            TFLOP/s, which mma.sync does not reach) makes the three
//            products ~165 TFLOP/s of float32 work; at the batch shape the
//            copies from L2 (49 KB a block a stage) and shared memory's
//            bandwidth bound it first.
//            Lags go in tiles of 128; a remainder of at most 8 (the 129th
//            and the 1025th lag on the paths) joins the last tile, 136
//            wide (wgmma n128 + n8), instead of a tile of its own that
//            would cost a whole block for one lag.
//   fold     where G is split (below): the chunks' partial sums added in
//            chunk order, then the division.
// Summation order, the invariant the reference pins with ROW_ALIGN: an
// output (f, l) is summed by one thread over its chunk's stages in order;
// each stage's 32 products are summed from 0 on their own (4 x 3 wgmma
// in a fixed order) and then added
// to the running sum with __fadd_rn, so rounding grows with 32 + G/32
// terms instead of G (a single running sum over the batch path's ~16k
// grid points drifted 1.14e-5 from the plain version).  G is split into
// chunks of whole stages (the wrapper's plan: a function of G alone),
// whose sums the fold adds in chunk order 0..S-1.  No atomics.  So a
// row's scores depend on G and on nothing of F, the row's offset, the
// tile layout or the grid: the same row scored alone or among others
// gives the same bits (a wgmma's output element depends on its own row
// and column alone, which the card tests check at odd row offsets).
// sqrt and the divide are IEEE.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kProducers = 128;         // product: a warpgroup that copies,
constexpr int kConsumers = 256;         // two that multiply
constexpr int kThreads = kProducers + kConsumers;
constexpr int kBM = 128, kBN = 128;     // block tile: streams x lags
constexpr int kBNMax = kBN + 8;         // a last tile may take 8 more
constexpr int kBK = 32;                 // grid points a stage
constexpr int kRing = 3;                // stages in flight
constexpr int kPieces = kBK / 4;        // 16-byte pieces a row a stage
constexpr int kTile = kBM * kBK;        // floats of one operand a stage
constexpr int kPerThread = kTile / 4 / kProducers;  // pieces a producer copies
static_assert(kBM == kBN, "one loader map for both operands");
static_assert(kBNMax * kBK * 4 % 1024 == 0, "1 KB-aligned operand tiles");
static_assert(kPieces == 8 && kBK * 4 == 128, "128-byte swizzled rows");
static_assert(kConsumers == 128 * (kBM / 64), "a warpgroup 64 streams");
static_assert(kTile % (4 * kProducers) == 0, "whole pieces a thread");
static_assert((kBNMax - kBN) * kPieces <= kProducers, "one extra round");

// shared floats a stage: x (centred in place, then its hi part), m (then
// x's lo part), the bank's hi part (kBNMax rows), the bank's lo part
constexpr int kStageFloats = 2 * kTile + 2 * kBNMax * kBK;
// where a stage's tile of the bank's lo parts starts
constexpr int kBankLo = 2 * kTile + kBNMax * kBK;
// + 1 KB to align the ring to 1 KB
constexpr int kSmemBytes =
    kRing * kStageFloats * static_cast<int>(sizeof(float)) + 1024;

// the float offset of 16-byte piece c of stage row r: the 128-byte
// swizzle (piece c ^ (r & 7)) of a ring aligned to 1 KB
__device__ __forceinline__ int piece_offset(int r, int c) {
  return r * kBK + 4 * (c ^ (r & 7));
}

// stats: a stream row or a bank row a block
__global__ void stats_kernel(const float* __restrict__ x,
                             const float* __restrict__ m,
                             const float* __restrict__ bank,
                             float* __restrict__ mean_out,
                             float* __restrict__ den_x,
                             float* __restrict__ den_r,
                             float* __restrict__ out, int F, int G,
                             int L_out, int L_real) {
  __shared__ float scratch[33];
  const int step = blockDim.x;
  if (blockIdx.x >= F) {                      // a bank row's norm
    const int l = blockIdx.x - F;
    const size_t base = static_cast<size_t>(l) * G;
    float s = 0.0f;
    for (int g = threadIdx.x; g < G; g += step) {
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
  for (int g = threadIdx.x; g < G; g += step) {
    const float mv = m[base + g];
    s_m = __fadd_rn(s_m, mv);
    s_xm = __fadd_rn(s_xm, __fmul_rn(x[base + g], mv));
  }
  const float cnt = pmax(block_sum(s_m, scratch), 1.0f);
  const float mean = __fdiv_rn(block_sum(s_xm, scratch), cnt);
  float s_sq = 0.0f;
  for (int g = threadIdx.x; g < G; g += step) {
    const float c = __fmul_rn(__fsub_rn(x[base + g], mean), m[base + g]);
    s_sq = __fadd_rn(s_sq, __fmul_rn(c, c));
  }
  const float total = block_sum(s_sq, scratch);
  if (threadIdx.x == 0) {
    mean_out[f] = mean;
    den_x[f] = __fsqrt_rn(total);
  }
  for (int l = L_real + threadIdx.x; l < L_out; l += step)
    out[static_cast<size_t>(f) * L_out + l] = 0.0f;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// global -> shared, asynchronously; zero-filled when !ok (src is then
// not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// the thread's own copies of all but the newest group have landed; the
// "memory" clobber keeps the compiler from reading them earlier
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

struct Args {
  const float* x;
  const float* m;
  const float* bank;
  const float* mean;
  const float* den_x;
  const float* den_r;
  float* part;           // (chunks, F, ld_part) partial sums, or null
  float* out;            // (F, L_out)
  int F, G, L_out, L_real, ld_part, stages, stages_per_chunk;
};

// 16 bytes of rows (src, n_rows valid, row length G) at row r, point g
// into dst, zero-filled past them
template <bool kVec>
__device__ __forceinline__ void copy_piece(float* dst, const float* src,
                                           int r, int n_rows, int g, int G) {
  const size_t i = static_cast<size_t>(r) * G + g;
  if (kVec) {                            // G % 4 == 0: a piece is all in
    const bool ok = r < n_rows && g < G;
    cp_async16(dst, ok ? src + i : src, ok);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool ok = r < n_rows && g + u < G;
      cp_async4(dst + u, ok ? src + i + u : src, ok);
    }
  }
}

// Copy stage k0 of the block's x, m (rows f0..) and kNB bank rows (l0..)
// into ring slot st: producer tid copies the pieces tid + kProducers * q
// of each (bank rows past kBN: pieces kBN * kPieces + tid).
template <bool kVec, int kNB>
__device__ __forceinline__ void load_stage(float* st, const Args& a, int f0,
                                           int l0, int k0) {
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int e = threadIdx.x + kProducers * q;
    const int r = e / kPieces, c = e % kPieces;
    const int o = piece_offset(r, c);
    copy_piece<kVec>(st + o, a.x, f0 + r, a.F, k0 + 4 * c, a.G);
    copy_piece<kVec>(st + kTile + o, a.m, f0 + r, a.F, k0 + 4 * c, a.G);
    if (r < kNB)
      copy_piece<kVec>(st + 2 * kTile + o, a.bank, l0 + r, a.L_real,
                       k0 + 4 * c, a.G);
  }
  if (kNB > kBN && threadIdx.x < (kNB - kBN) * kPieces) {
    const int r = kBN + threadIdx.x / kPieces, c = threadIdx.x % kPieces;
    copy_piece<kVec>(st + 2 * kTile + piece_offset(r, c), a.bank, l0 + r,
                     a.L_real, k0 + 4 * c, a.G);
  }
}

// v -> (tf32(v), tf32(v - tf32(v))), element by element
__device__ __forceinline__ void split(const float4 v, float4& hi,
                                      float4& lo) {
  hi.x = to_tf32(v.x); lo.x = to_tf32(__fsub_rn(v.x, hi.x));
  hi.y = to_tf32(v.y); lo.y = to_tf32(__fsub_rn(v.y, hi.y));
  hi.z = to_tf32(v.z); lo.z = to_tf32(__fsub_rn(v.z, hi.z));
  hi.w = to_tf32(v.w); lo.w = to_tf32(__fsub_rn(v.w, hi.w));
}

// Centre the pieces of x this thread copied into slot st, in place:
// x becomes (x - mean) * m, then is split (hi in x's place, lo in m's),
// and so are the bank's pieces (hi in place, lo in the lo tile).
template <int kNB>
__device__ __forceinline__ void centre_stage(float* st,
                                             const float (&mean)[kPerThread]) {
  float* xs = st;
  float* ms = st + kTile;
  float* bs = st + 2 * kTile;
  float* bl = st + kBankLo;
  auto split_bank = [&](int o) {
    float4 hi, lo;
    split(*reinterpret_cast<const float4*>(bs + o), hi, lo);
    *reinterpret_cast<float4*>(bs + o) = hi;
    *reinterpret_cast<float4*>(bl + o) = lo;
  };
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int e = threadIdx.x + kProducers * q;
    const int o = piece_offset(e / kPieces, e % kPieces);
    float4 xv = *reinterpret_cast<float4*>(xs + o);
    const float4 mv = *reinterpret_cast<const float4*>(ms + o);
    xv.x = __fmul_rn(__fsub_rn(xv.x, mean[q]), mv.x);
    xv.y = __fmul_rn(__fsub_rn(xv.y, mean[q]), mv.y);
    xv.z = __fmul_rn(__fsub_rn(xv.z, mean[q]), mv.z);
    xv.w = __fmul_rn(__fsub_rn(xv.w, mean[q]), mv.w);
    float4 hi, lo;
    split(xv, hi, lo);
    *reinterpret_cast<float4*>(xs + o) = hi;
    *reinterpret_cast<float4*>(ms + o) = lo;
    if (e / kPieces < kNB) split_bank(o);
  }
  if (kNB > kBN && threadIdx.x < (kNB - kBN) * kPieces)
    split_bank(piece_offset(kBN + threadIdx.x / kPieces,
                            threadIdx.x % kPieces));
}

// one output's end: a chunk's partial sum, or (one chunk) the score
__device__ __forceinline__ void emit(const Args& a, int chunk, int f, int l,
                                     float v) {
  if (f >= a.F || l >= a.L_real) return;
  if (a.part != nullptr) {
    a.part[(static_cast<size_t>(chunk) * a.F + f) * a.ld_part + l] = v;
  } else {
    const float den = __fadd_rn(__fmul_rn(a.den_x[f], a.den_r[l]), 1e-12f);
    a.out[static_cast<size_t>(f) * a.L_out + l] = __fdiv_rn(v, den);
  }
}
// the ends of outputs (f, l) and (f, l + 1), l even: one 8-byte store of
// partial sums (ld_part is a multiple of 8), so a warp writes whole
// 32-byte sectors
__device__ __forceinline__ void emit2(const Args& a, int chunk, int f,
                                      int l, float v0, float v1) {
  if (a.part == nullptr || f >= a.F || l + 1 >= a.L_real) {
    emit(a, chunk, f, l, v0);
    emit(a, chunk, f, l + 1, v1);
    return;
  }
  *reinterpret_cast<float2*>(
      a.part + (static_cast<size_t>(chunk) * a.F + f) * a.ld_part + l) =
      make_float2(v0, v1);
}

// d (+)= a * b for a 64 x 128 tile, 8 grid points; a and b: descriptors of
// K-major tiles in shared memory; d starts from 0 where !accumulate
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
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
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= a * b for a 64 x 8 tile, 8 grid points; a and b: descriptors of
// K-major tiles in shared memory; d starts from 0 where !accumulate
__device__ __forceinline__ void wgmma_8(float (&d)[4], uint64_t a,
                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// a wgmma descriptor of a K-major operand at p (1 KB-aligned 8-row
// groups of 128-byte rows, the 128-byte swizzle): the stride between
// 8-row groups is 1 KB; the leading offset is unused by this layout
__device__ __forceinline__ uint64_t sw128_desc(const float* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// keeps the compiler from moving reads or writes of v across the
// asynchronous wgmma
__device__ __forceinline__ void fence_operand(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}

// 3xTF32 on wgmma: warpgroup w (threads 128w..) owns streams 64w..64w+63
// and the tile's kN lags: 128; 136 for a last tile of 129-136 real lags
// (129 and 1025 lags on the paths: no tile holds one lag alone).
// Accumulator element 4j + r of a thread (warp q of its warpgroup, lane
// (g, t) = (lane / 4, lane % 4)) is stream 16q + g + 8 (r / 2), lag
// 8j + 2t + r % 2.
template <int kN>
struct Tf32x3 {
  static constexpr int kR = kN / 2;
  static constexpr int kNB = kN;             // bank rows a stage
  float acc[kR];
  float part[kR];
  int w;

  __device__ __forceinline__ Tf32x3() : w((threadIdx.x - kProducers) >> 7) {
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[r] = 0.0f;
  }

  __device__ __forceinline__ void mma(uint64_t a, uint64_t b, int accumulate) {
    if constexpr (kN == kBNMax) {     // n136 as n128 + n8
      wgmma_128(*reinterpret_cast<float(*)[64]>(part), a, b, accumulate);
      wgmma_8(*reinterpret_cast<float(*)[4]>(part + 64), a,
              b + ((kBN * kBK * 4) >> 4), accumulate);
    } else {
      static_assert(kN == kBN, "n128 or n136");
      wgmma_128(part, a, b, accumulate);
    }
  }

  // the stage's 4 x 3 wgmma, in flight when this returns: the first
  // starts the stage's sum from 0
  __device__ __forceinline__ void issue(const float* st) {
    const float* ah = st + w * 64 * kBK;
    const float* al = ah + kTile;
    const float* bh = st + 2 * kTile;
    const float* bl = st + kBankLo;
#pragma unroll
    for (int r = 0; r < kR; ++r) fence_operand(part[r]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < kBK / 8; ++s) {       // 8 grid points = 32 bytes
      mma(sw128_desc(al + 8 * s), sw128_desc(bh + 8 * s), s > 0);
      mma(sw128_desc(ah + 8 * s), sw128_desc(bl + 8 * s), 1);
      mma(sw128_desc(ah + 8 * s), sw128_desc(bh + 8 * s), 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }

  // wait for the stage's products, add its sum to the running sum
  __device__ __forceinline__ void finish() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      fence_operand(part[r]);
      acc[r] = __fadd_rn(acc[r], part[r]);
    }
  }

  __device__ __forceinline__ void store(const Args& a, int chunk, int f0,
                                        int l0) {
    const int q = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int r = 0; r < kR; r += 2)
      emit2(a, chunk, f0 + 64 * w + 16 * q + g + 8 * ((r >> 1) & 1),
            l0 + 8 * (r >> 2) + 2 * t, acc[r], acc[r + 1]);
  }
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(smem_u32(bar)) : "memory");
}
// until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// One block's tile and chunk.  Warpgroup 0, the producer, copies each
// stage into the ring and centres (and splits) it, then arrives on the
// slot's `full` barrier; warpgroups 1-2, the consumers, wait on it,
// multiply, and arrive on the slot's `empty` barrier, which the producer
// waits on before it refills the slot.  So the copies, the centring and
// the products of consecutive stages overlap.
template <bool kVec, class Math>
__device__ __forceinline__ void run_tile(const Args& a, float* smem,
                                         uint64_t* full, uint64_t* empty,
                                         int f0, int l0, int chunk) {
  constexpr int kNB = Math::kNB;
  const int s0 = chunk * a.stages_per_chunk;
  const int n = max(0, min(a.stages_per_chunk, a.stages - s0));
  auto slot = [&](int i) {
    return smem + (i % kRing) * kStageFloats;
  };
  if (threadIdx.x < kProducers) {
    float mean[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int f = f0 + (threadIdx.x + kProducers * q) / kPieces;
      mean[q] = f < a.F ? a.mean[f] : 0.0f;
    }
    if (n > 0) load_stage<kVec, kNB>(slot(0), a, f0, l0, s0 * kBK);
    cp_async_commit();
    for (int i = 0; i < n; ++i) {
      const int j = i + 1;                       // the stage to copy next
      if (j < n) {
        if (j >= kRing) mbar_wait(&empty[j % kRing], (j / kRing - 1) & 1);
        load_stage<kVec, kNB>(slot(j), a, f0, l0, (s0 + j) * kBK);
      }
      cp_async_commit();
      cp_async_wait1();                          // stage i has landed
      centre_stage<kNB>(slot(i), mean);
      // for wgmma's reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&full[i % kRing]);
    }
    return;
  }
  Math math;
  for (int i = 0; i < n; ++i) {
    mbar_wait(&full[i % kRing], (i / kRing) & 1);
    math.issue(slot(i));
    math.finish();
    mbar_arrive(&empty[i % kRing]);
  }
  math.store(a, chunk, f0, l0);
}

// lag tiles of kBN; a remainder of at most 8 lags joins the last tile
// (kBNMax) instead of a tile of its own
__host__ __device__ inline int lag_tiles(int L_real) {
  const int full = L_real / kBN, rem = L_real % kBN;
  return rem <= kBNMax - kBN ? (full > 0 ? full : 1) : full + (rem > 0);
}

// grid (row tiles, chunks, lag tiles): the lag tiles slowest, the wider
// last one last
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
product_kernel(const Args a) {
  extern __shared__ float smem_raw[];
  __shared__ uint64_t full[kRing], empty[kRing];
  float* smem = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(&full[i], kProducers);
      mbar_init(&empty[i], kConsumers);
    }
  }
  __syncthreads();
  const int f0 = blockIdx.x * kBM;
  const int l0 = blockIdx.z * kBN;
  // real lags of the tile: kBN but in the last, which may hold up to
  // kBNMax (or fewer than kBN: emit skips the lags past L_real)
  const int real = blockIdx.z + 1 < gridDim.z ? kBN : a.L_real - l0;
  if (real > kBN)
    run_tile<kVec, Tf32x3<kBNMax>>(a, smem, full, empty, f0, l0, blockIdx.y);
  else
    run_tile<kVec, Tf32x3<kBN>>(a, smem, full, empty, f0, l0, blockIdx.y);
}

__global__ void fold_kernel(const Args a, int chunks) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (idx >= static_cast<size_t>(a.F) * a.L_real) return;
  const int f = static_cast<int>(idx / a.L_real);
  const int l = static_cast<int>(idx % a.L_real);
  const size_t n = static_cast<size_t>(a.F) * a.ld_part;
  const size_t i = static_cast<size_t>(f) * a.ld_part + l;
  float v = a.part[i];
  for (int c = 1; c < chunks; ++c) v = __fadd_rn(v, a.part[c * n + i]);
  const float den = __fadd_rn(__fmul_rn(a.den_x[f], a.den_r[l]), 1e-12f);
  a.out[static_cast<size_t>(f) * a.L_out + l] = __fdiv_rn(v, den);
}

constexpr int kMaxDevices = 64;

// a kernel's opt-in to more than 48 KB of dynamic shared memory, once
// per device (the driver keeps it; a launch needs no further call)
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

template <bool kVec>
cudaError_t launch_product(const Args& a, int chunks, cudaStream_t s) {
  static bool opted[kMaxDevices] = {};
  cudaError_t err = opt_in(product_kernel<kVec>, kSmemBytes, opted);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.F + kBM - 1) / kBM, chunks, lag_tiles(a.L_real));
  product_kernel<kVec><<<grid, kThreads, kSmemBytes, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x, m (F, G) and bank (L_out, G) float32, contiguous; mean, den_x (F,)
// and den_r (L_real,) scratch; part (chunks, F, L_real rounded up to a
// multiple of 8) scratch when chunks > 1 (else unused); out (F, L_out).
// G is split into `chunks` chunks of `stages_per_chunk` stages of kBK
// points (the last may be shorter).
extern "C" int xcorr_align_launch(const float* x, const float* m,
                                  const float* bank, float* mean,
                                  float* den_x, float* den_r, float* part,
                                  float* out, int F, int G, int L_out,
                                  int L_real, int stages_per_chunk,
                                  int chunks, void* stream) {
  if (F <= 0 || L_out <= 0) return 0;
  if (L_real > 0 && (chunks < 1 || stages_per_chunk < 1 ||
                     (chunks > 1 && part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // stats: a row a block of 256 threads up to G = 4096, else of 1024 (a
  // function of G alone), so a long row's second pass still finds it in L2
  stats_kernel<<<F + L_real, G <= 4096 ? 256 : 1024, 0, s>>>(
      x, m, bank, mean, den_x, den_r, out, F, G, L_out, L_real);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || L_real <= 0) return static_cast<int>(err);
  Args a{x, m, bank, mean, den_x, den_r, chunks > 1 ? part : nullptr, out,
         F, G, L_out, L_real, (L_real + 7) / 8 * 8, (G + kBK - 1) / kBK,
         stages_per_chunk};
  const bool vec = G % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(m) |
        reinterpret_cast<uintptr_t>(bank)) & 15) == 0;
  err = vec ? launch_product<true>(a, chunks, s)
            : launch_product<false>(a, chunks, s);
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(F) * L_real;
  fold_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(a,
                                                                    chunks);
  return static_cast<int>(cudaGetLastError());
}
