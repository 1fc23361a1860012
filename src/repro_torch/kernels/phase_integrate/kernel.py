"""Wrapper of the ``phase_integrate`` CUDA kernel
(``csrc/phase_integrate.cu``; replaces the TPU kernel
``phase_integrate_kernel`` of ``repro/kernels/phase_integrate/kernel.py``).
"""
from __future__ import annotations

import torch

from repro_torch.device import refuse_detached
from repro_torch.kernels import build
from repro_torch.kernels.phase_integrate.ref import phase_energies_ref

_ARGS = (build.PTR,) * 4 + (build.INT,) * 3 + (build.PTR,)


def phase_integrate_kernel(times: torch.Tensor, watts: torch.Tensor,
                           phases: torch.Tensor) -> torch.Tensor:
    """times/watts: (R, S) float32; phases: (P, 2) float32 -> (R, P)
    float32 joules.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream (one block per row: a row's energy does
    not depend on R).
    """
    dev = times.device
    if dev.type == "cpu":
        return phase_energies_ref(times, watts, phases)
    if dev.type != "cuda":
        raise ValueError(f"phase_integrate: unsupported device {dev}")
    refuse_detached("phase_integrate", times, watts, phases, item="B6")
    r, s = times.shape
    p = phases.shape[0]
    for x, what, shape in ((times, "times", (r, s)),
                           (watts, "watts", (r, s)),
                           (phases, "phases", (p, 2))):
        build.check_tensor(x, what, dtype=torch.float32, shape=shape,
                           device=dev)
    out = torch.empty((r, p), dtype=torch.float32, device=dev)
    fn = build.c_function("pi_launch", _ARGS)
    with torch.cuda.device(dev):
        rc = fn(times.data_ptr(), watts.data_ptr(), phases.data_ptr(),
                out.data_ptr(), r, s, p, build.stream_ptr(dev))
    build.check_launch(rc, "phase_integrate")
    phase_integrate_kernel.launches += 1
    return out


phase_integrate_kernel.launches = 0
