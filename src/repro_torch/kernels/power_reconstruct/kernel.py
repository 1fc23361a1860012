"""Wrapper of the ``power_reconstruct_rows`` CUDA kernel
(``csrc/power_reconstruct_rows.cu``; replaces the TPU kernel
``power_reconstruct_rows_kernel`` of
``repro/kernels/power_reconstruct/kernel.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.power_reconstruct.ref import (
    reconstruct_power_rows_ref)

_ARGS = (build.PTR,) * 4 + (build.INT,) * 2 + (build.PTR,)


def power_reconstruct_rows_kernel(energy: torch.Tensor, times: torch.Tensor,
                                  wrap_row: torch.Tensor) -> torch.Tensor:
    """energy/times: (F, S) float32; wrap_row: (F, 1) float32 periods
    (0 disables) -> power (F, S) float32; column 0 is 0.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream.
    """
    dev = energy.device
    if dev.type == "cpu":
        return reconstruct_power_rows_ref(energy, times, wrap_row)
    if dev.type != "cuda":
        raise ValueError(f"power_reconstruct_rows: unsupported device {dev}")
    f, s = energy.shape
    for x, what, shape in ((energy, "energy", (f, s)),
                           (times, "times", (f, s)),
                           (wrap_row, "wrap_row", (f, 1))):
        build.check_tensor(x, what, dtype=torch.float32, shape=shape,
                           device=dev)
    out = torch.empty_like(energy)
    fn = build.c_function("pr_rows_launch", _ARGS)
    with torch.cuda.device(dev):
        rc = fn(energy.data_ptr(), times.data_ptr(), wrap_row.data_ptr(),
                out.data_ptr(), f, s, build.stream_ptr(dev))
    build.check_launch(rc, "power_reconstruct_rows")
    power_reconstruct_rows_kernel.launches += 1
    return out


power_reconstruct_rows_kernel.launches = 0
