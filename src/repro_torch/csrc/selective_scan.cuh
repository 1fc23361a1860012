// Helpers shared by selective_scan.cu (B10's forward) and
// selective_scan_bwd.cu (its gradient): the state step, the raw loads and
// the forward's checkpoint spacing.  The backward recomputes each chunk's
// states from the forward's checkpoints with the same step, so its h_t is
// the forward's bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 4;        // threads sharing a channel's states
// steps between the states the forward keeps for the backward (h_chunk):
// the state entering steps 0, kChunk, 2 kChunk, ...; a multiple of the
// forward's tile, so it writes them at a tile's start
constexpr int kChunk = 32;

// loads move raw bits (a bf16 as its 16-bit pattern: no conversion code in
// the predicated loads); widened to float when staged
template <typename T> struct Raw { using type = float; };
template <> struct Raw<__nv_bfloat16> { using type = unsigned short; };
__device__ __forceinline__ float raw_f32(float v) { return v; }
__device__ __forceinline__ float raw_f32(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// dt * x, the input's weight on B_t
__device__ __forceinline__ float ss_dx(float dt, float x) {
  return __fmul_rn(dt, x);
}

// exp(dt * a), the state's decay over one step
__device__ __forceinline__ float ss_abar(float dt, float a) {
  return expf(__fmul_rn(dt, a));
}

// one state's step given its decay ab = ss_abar(dt, a): uncontracted
// multiplies and add, as the plain version steps it
__device__ __forceinline__ float ss_step_abar(float h, float ab, float dx,
                                              float b) {
  return __fadd_rn(__fmul_rn(ab, h), __fmul_rn(dx, b));
}

// one state's step, h_t = exp(dt a) h_{t-1} + (dt x) B_t: the IEEE expf
// (the build has no fast math) and uncontracted multiplies and add, as
// the plain version steps it, so every caller gets the same bits (the
// backward, which keeps each decay for its walk, takes ss_abar and
// ss_step_abar apart)
__device__ __forceinline__ float ss_step(float h, float dt, float dx,
                                         float a, float b) {
  return ss_step_abar(h, ss_abar(dt, a), dx, b);
}

}  // namespace
