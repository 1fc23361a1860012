"""Wrapper of the ``squarewave`` CUDA kernel (``csrc/squarewave.cu``;
replaces the TPU kernel ``squarewave_kernel`` of
``repro/kernels/squarewave/kernel.py``)."""
from __future__ import annotations

import torch

from repro_torch.device import refuse_detached
from repro_torch.kernels import build
from repro_torch.kernels.squarewave.ref import squarewave_ref

_ENTRY = {torch.float32: "sw_launch_f32", torch.bfloat16: "sw_launch_bf16",
          torch.float64: "sw_launch_f64"}
_ARGS = (build.PTR, build.PTR, build.I64, build.INT, build.PTR)


def squarewave_kernel(x: torch.Tensor, *, fma_chain: int) -> torch.Tensor:
    """x: (rows, width) float32, bfloat16 or float64 -> same shape and
    dtype: ``fma_chain`` dependent steps ``acc = acc * a + b`` per
    element (2 * fma_chain FLOPs each).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream.  The kernel reads 16-byte vectors, so
    ``x`` must be contiguous and 16-byte aligned.
    """
    dev = x.device
    if dev.type == "cpu":
        return squarewave_ref(x, fma_chain=fma_chain)
    if dev.type != "cuda":
        raise ValueError(f"squarewave: unsupported device {dev}")
    refuse_detached("squarewave", x, item="B8")
    if x.dtype not in _ENTRY:
        raise TypeError(f"squarewave: dtype {x.dtype}, expected one of "
                        f"{sorted(map(str, _ENTRY))}")
    build.check_tensor(x, "x", dtype=x.dtype, shape=x.shape, device=dev)
    if x.data_ptr() % 16:
        raise ValueError("squarewave: x must be 16-byte aligned")
    if fma_chain < 0:
        raise ValueError(f"squarewave: fma_chain {fma_chain} < 0")
    out = torch.empty_like(x)
    fn = build.c_function(_ENTRY[x.dtype], _ARGS)
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), out.data_ptr(), x.numel(), int(fma_chain),
                build.stream_ptr(dev))
    build.check_launch(rc, "squarewave")
    squarewave_kernel.launches += 1
    return out


squarewave_kernel.launches = 0
