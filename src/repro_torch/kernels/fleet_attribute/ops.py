"""Public op: raw counter chunks -> per-phase energies in one fused pass
(port of ``repro/kernels/fleet_attribute/ops.py``)."""
from __future__ import annotations

from repro_torch.kernels.fleet_attribute.kernel import fleet_attribute_kernel


def fleet_attribute(times, energy, wrap_row, phases):
    """times/energy: (R, S) raw reads; wrap_row: (R, 1); phases: (P, 2)
    -> (R, P) joules, through the ``fleet_attribute`` kernel on a CUDA
    tensor and its plain version on a CPU tensor."""
    return fleet_attribute_kernel(times.contiguous(), energy.contiguous(),
                                  wrap_row.contiguous(),
                                  phases.contiguous())
