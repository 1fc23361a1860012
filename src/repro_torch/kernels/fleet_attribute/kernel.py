"""Wrapper of the ``fleet_attribute`` CUDA kernel
(``csrc/fleet_attribute.cu``; replaces the TPU kernel
``fleet_attribute_kernel`` of ``repro/kernels/fleet_attribute/kernel.py``).
"""
from __future__ import annotations

import torch

from repro_torch.device import refuse_detached
from repro_torch.kernels import build
from repro_torch.kernels.fleet_attribute.ref import fleet_attribute_ref

_ARGS = (build.PTR,) * 5 + (build.INT,) * 3 + (build.PTR,)


def fleet_attribute_kernel(times: torch.Tensor, energy: torch.Tensor,
                           wrap_row: torch.Tensor,
                           phases: torch.Tensor) -> torch.Tensor:
    """times/energy: (R, S) float32 raw counter reads; wrap_row: (R, 1)
    float32 periods (0 disables); phases: (P, 2) float32 -> (R, P)
    float32 joules.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream (one block per row: a row's energy does
    not depend on R).
    """
    dev = times.device
    if dev.type == "cpu":
        return fleet_attribute_ref(times, energy, wrap_row, phases)
    if dev.type != "cuda":
        raise ValueError(f"fleet_attribute: unsupported device {dev}")
    refuse_detached("fleet_attribute", times, energy, wrap_row, phases,
                    item="B7")
    r, s = times.shape
    p = phases.shape[0]
    for x, what, shape in ((times, "times", (r, s)),
                           (energy, "energy", (r, s)),
                           (wrap_row, "wrap_row", (r, 1)),
                           (phases, "phases", (p, 2))):
        build.check_tensor(x, what, dtype=torch.float32, shape=shape,
                           device=dev)
    out = torch.empty((r, p), dtype=torch.float32, device=dev)
    fn = build.c_function("fa_launch", _ARGS)
    with torch.cuda.device(dev):
        rc = fn(times.data_ptr(), energy.data_ptr(), wrap_row.data_ptr(),
                phases.data_ptr(), out.data_ptr(), r, s, p,
                build.stream_ptr(dev))
    build.check_launch(rc, "fleet_attribute")
    fleet_attribute_kernel.launches += 1
    return out


fleet_attribute_kernel.launches = 0
