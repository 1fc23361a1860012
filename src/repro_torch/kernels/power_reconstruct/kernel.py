"""Wrappers of the three dE/dt CUDA kernels, each replacing the TPU kernel
of the same name in ``repro/kernels/power_reconstruct/kernel.py``:

  power_reconstruct_rows_kernel   csrc/power_reconstruct_rows.cu
  power_reconstruct_fleet_kernel  csrc/power_reconstruct_fleet.cu
  power_reconstruct_kernel        csrc/power_reconstruct.cu

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel on the current stream; any other device raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import refuse_detached
from repro_torch.kernels import build
from repro_torch.kernels.power_reconstruct.ref import (
    reconstruct_power_fleet_ref, reconstruct_power_ref,
    reconstruct_power_rows_ref)

_ARGS = (build.PTR,) * 4 + (build.INT,) * 2 + (build.PTR,)
_FLEET_ARGS = (build.PTR,) * 7 + (build.INT,) * 2 + (build.PTR,)
_SCALAR_ARGS = (build.PTR,) * 3 + (build.INT,) * 2 + (ctypes.c_float,
                                                      build.PTR)


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
    refuse_detached("power_reconstruct_rows", energy, times, wrap_row,
                    item="B1")
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


def power_reconstruct_fleet_kernel(energy: torch.Tensor, times: torch.Tensor,
                                   wrap_row: torch.Tensor,
                                   n_row: torch.Tensor):
    """energy/times: (F, S) float32 raw padded reads; wrap_row: (F, 1)
    float32 periods (0 disables); n_row: (F, 1) int32 raw sample counts
    -> (power (F, S) float32, valid (F, S) bool, reordered (F, 1) bool).
    """
    dev = energy.device
    if dev.type == "cpu":
        return reconstruct_power_fleet_ref(energy, times, wrap_row, n_row)
    if dev.type != "cuda":
        raise ValueError(f"power_reconstruct_fleet: unsupported device "
                         f"{dev}")
    refuse_detached("power_reconstruct_fleet", energy, times, wrap_row, n_row,
                    item="B2")
    f, s = energy.shape
    for x, what, dtype, shape in ((energy, "energy", torch.float32, (f, s)),
                                  (times, "times", torch.float32, (f, s)),
                                  (wrap_row, "wrap_row", torch.float32,
                                   (f, 1)),
                                  (n_row, "n_row", torch.int32, (f, 1))):
        build.check_tensor(x, what, dtype=dtype, shape=shape, device=dev)
    power = torch.empty_like(energy)
    valid = torch.empty((f, s), dtype=torch.bool, device=dev)
    reordered = torch.empty((f, 1), dtype=torch.bool, device=dev)
    fn = build.c_function("pr_fleet_launch", _FLEET_ARGS)
    with torch.cuda.device(dev):
        rc = fn(energy.data_ptr(), times.data_ptr(), wrap_row.data_ptr(),
                n_row.data_ptr(), power.data_ptr(), valid.data_ptr(),
                reordered.data_ptr(), f, s, build.stream_ptr(dev))
    build.check_launch(rc, "power_reconstruct_fleet")
    power_reconstruct_fleet_kernel.launches += 1
    return power, valid, reordered


power_reconstruct_fleet_kernel.launches = 0


def power_reconstruct_kernel(energy: torch.Tensor, times: torch.Tensor, *,
                             wrap_period: float = 0.0) -> torch.Tensor:
    """energy/times: (F, S) float32; one wrap period for every row
    (0 disables; applied as ``de + wrap``) -> power (F, S) float32;
    column 0 is 0."""
    dev = energy.device
    if dev.type == "cpu":
        return reconstruct_power_ref(energy, times, wrap_period=wrap_period)
    if dev.type != "cuda":
        raise ValueError(f"power_reconstruct: unsupported device {dev}")
    refuse_detached("power_reconstruct", energy, times, item="B3")
    f, s = energy.shape
    for x, what in ((energy, "energy"), (times, "times")):
        build.check_tensor(x, what, dtype=torch.float32, shape=(f, s),
                           device=dev)
    out = torch.empty_like(energy)
    fn = build.c_function("pr_launch", _SCALAR_ARGS)
    with torch.cuda.device(dev):
        rc = fn(energy.data_ptr(), times.data_ptr(), out.data_ptr(), f, s,
                float(wrap_period), build.stream_ptr(dev))
    build.check_launch(rc, "power_reconstruct")
    power_reconstruct_kernel.launches += 1
    return out


power_reconstruct_kernel.launches = 0
