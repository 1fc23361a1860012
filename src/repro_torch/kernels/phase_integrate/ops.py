"""Public op: per-phase energies of batched power streams (port of
``repro/kernels/phase_integrate/ops.py``)."""
from __future__ import annotations

from repro_torch.kernels.phase_integrate.kernel import phase_integrate_kernel


def phase_energies(times, watts, phases):
    """times/watts: (R, S); phases: (P, 2) [a, b) windows -> (R, P)
    joules, through the ``phase_integrate`` kernel on a CUDA tensor and
    its plain version on a CPU tensor."""
    return phase_integrate_kernel(times.contiguous(), watts.contiguous(),
                                  phases.contiguous())
