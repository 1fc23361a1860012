"""Segmented per-phase integration of sample-and-hold power rows."""
from repro_torch.kernels.phase_integrate.kernel import (  # noqa: F401
    phase_integrate_kernel)
from repro_torch.kernels.phase_integrate.ops import phase_energies  # noqa
from repro_torch.kernels.phase_integrate.ref import (  # noqa: F401
    phase_energies_ref)
