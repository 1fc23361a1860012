"""The H100's rate of ``mma.sync.m16n8k8`` on TF32 (float32 accumulate),
the tensor-core instruction of B9's float32 kernels, against the same
kernel on bf16 (``m16n8k16``), measured with CUDA events.

    python3 scripts/mma_tf32_rate.py [--blocks 528] [--warps 4] [--chains 8]

Builds a probe kernel with nvcc (into ``build/kernels/``): each warp runs
``--chains`` independent accumulator chains of 4096 mma.sync each, on
operands in registers (no memory traffic); prints the card's name and
power limit, then one JSON line: TFLOP/s for each type and each chain
count up to ``--chains``, against the dense peaks (TF32 495, bf16 989
TFLOP/s).  Needs a CUDA card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int C>
__global__ void tf32_chains(float* out, int iters, uint32_t seed) {
  float c[C][4];
  for (int i = 0; i < C; ++i)
    for (int e = 0; e < 4; ++e) c[i][e] = 0.0f;
  uint32_t a0 = seed ^ threadIdx.x, a1 = a0 * 3u, a2 = a0 * 5u, a3 = a0 * 7u;
  uint32_t b0 = a0 * 11u, b1 = a0 * 13u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < C; ++i)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float s = 0.0f;
  for (int i = 0; i < C; ++i)
    for (int e = 0; e < 4; ++e) s += c[i][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int C>
__global__ void bf16_chains(float* out, int iters, uint32_t seed) {
  float c[C][4];
  for (int i = 0; i < C; ++i)
    for (int e = 0; e < 4; ++e) c[i][e] = 0.0f;
  uint32_t a0 = seed ^ threadIdx.x, a1 = a0 * 3u, a2 = a0 * 5u, a3 = a0 * 7u;
  uint32_t b0 = a0 * 11u, b1 = a0 * 13u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < C; ++i)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float s = 0.0f;
  for (int i = 0; i < C; ++i)
    for (int e = 0; e < 4; ++e) s += c[i][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
#define ENTRY(T, C)                                                       \
  extern "C" int T##_##C(float* out, int blocks, int threads, int iters,  \
                         void* stream) {                                  \
    T##_chains<C><<<blocks, threads, 0, (cudaStream_t)stream>>>(          \
        out, iters, 12345u);                                              \
    return (int)cudaGetLastError();                                       \
  }
ENTRY(tf32, 1) ENTRY(tf32, 2) ENTRY(tf32, 4) ENTRY(tf32, 8)
ENTRY(bf16, 1) ENTRY(bf16, 2) ENTRY(bf16, 4) ENTRY(bf16, 8)
"""
PEAK = {"tf32": 495e12, "bf16": 989e12}
FLOPS = {"tf32": 2 * 16 * 8 * 8, "bf16": 2 * 16 * 8 * 16}   # a warp's mma


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=528)
    ap.add_argument("--warps", type=int, default=4)
    ap.add_argument("--chains", type=int, default=8, choices=(1, 2, 4, 8))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("mma_tf32_rate: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "mma_rate_probe.cu"
    lib = build.BUILD_DIR / "libmma_rate_probe.so"
    src.write_text(SOURCE)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                    str(lib), str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    dev = torch.device("cuda")
    threads = 32 * args.warps
    out = torch.empty(args.blocks * threads, device=dev)
    iters = 4096
    result = {}
    for kind in ("tf32", "bf16"):
        for chains in (1, 2, 4, 8):
            if chains > args.chains:
                continue
            fn = getattr(so, f"{kind}_{chains}")
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            stream = torch.cuda.current_stream(dev).cuda_stream
            launch = lambda: fn(out.data_ptr(), args.blocks, threads,  # noqa
                                iters, stream)
            build.check_launch(launch(), "mma probe")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                launch()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 5
            flops = (FLOPS[kind] * iters * chains * args.warps
                     * args.blocks)
            rate = flops / (ms * 1e-3)
            result[f"{kind}_chains{chains}"] = dict(
                ms=ms, tflops=rate / 1e12, of_peak=rate / PEAK[kind])
            print(f"{kind} mma.sync, {chains} chains a warp, "
                  f"{args.warps} warps x {args.blocks} blocks: {ms:.3f} ms, "
                  f"{rate / 1e12:.1f} TFLOP/s ({rate / PEAK[kind]:.1%} of "
                  f"the dense peak)", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
