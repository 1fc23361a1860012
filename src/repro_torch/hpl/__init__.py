"""The §V-B mixed-precision case study on the device (port of
``repro.hpl``): HPL (blocked LU with partial pivoting, in the matrix's
dtype: float64 is the paper's rocHPL baseline), HPL-MxP (bf16-GEMM LU +
fp32 iterative refinement), HPG-MxP (CG on a Poisson stencil, fp32 or
bf16 matvec), each traced by phase, and the fleet energy accounting of
those phases."""
from repro_torch.hpl.hpl import hpl_solve, make_system  # noqa: F401
from repro_torch.hpl.hpl_mxp import hpl_mxp_solve, make_dd_system  # noqa
from repro_torch.hpl.hpg_mxp import hpg_solve, make_poisson  # noqa: F401
from repro_torch.hpl.energy import (energize, fleet_energize,  # noqa: F401
                                    fused_fleet_energize,
                                    mxp_energy_report)
