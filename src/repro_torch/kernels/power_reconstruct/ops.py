"""Public op: batched traces -> instantaneous power with one wrap period
(port of ``repro/kernels/power_reconstruct/ops.py``)."""
from __future__ import annotations

from repro_torch.kernels.power_reconstruct.kernel import (
    power_reconstruct_kernel)


def reconstruct_power(energy, times, *, wrap_period: float = 0.0):
    """energy/times: (F, S) float32 -> power (F, S); column 0 is 0.

    ``wrap_period`` (value units, 0 = none) is added to every interval
    whose dE falls below -wrap_period/2.  A CPU tensor takes the plain
    version, a CUDA tensor the ``power_reconstruct`` kernel.
    """
    return power_reconstruct_kernel(energy.contiguous(), times.contiguous(),
                                    wrap_period=float(wrap_period))
