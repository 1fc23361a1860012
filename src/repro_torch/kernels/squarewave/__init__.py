"""Calibrated square-wave load generation (paper §IV-B)."""
from repro_torch.kernels.squarewave.kernel import squarewave_kernel  # noqa
from repro_torch.kernels.squarewave.ops import (  # noqa: F401
    calibrated_fma_count, squarewave_load)
from repro_torch.kernels.squarewave.ref import (  # noqa: F401
    squarewave_fused_ref, squarewave_ref)
