// empty: a kernel that does nothing, so that a timing of it shows what a
// launch alone costs the card (the floor under the short kernels B1, B3
// and B7, whose bytes would take the H100 a few microseconds or less).
// Not a port of a TPU kernel.
#include "common.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
