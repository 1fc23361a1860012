"""Plain PyTorch version of the fused streaming attribution (port of
``repro/kernels/fleet_attribute/ref.py``)."""
from __future__ import annotations

from repro_torch.kernels.phase_integrate.ref import phase_energies_ref
from repro_torch.kernels.power_reconstruct.ref import (
    reconstruct_power_rows_ref)


def fleet_attribute_ref(times, energy, wrap_row, phases):
    """Composition of the two stage versions the fused kernel replaces:
    wrapped dE/dt, then per-phase integration."""
    power = reconstruct_power_rows_ref(energy, times, wrap_row)
    return phase_energies_ref(times, power, phases)
