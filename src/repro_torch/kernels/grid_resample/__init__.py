"""Batched masked lower bound + hold/linear regridding onto one grid."""
from repro_torch.kernels.grid_resample.kernel import (  # noqa: F401
    grid_resample_kernel)
from repro_torch.kernels.grid_resample.ops import (GRID_ALIGN,  # noqa: F401
                                                   grid_resample)
from repro_torch.kernels.grid_resample.ref import (  # noqa: F401
    grid_resample_ref, searchsorted_rows, searchsorted_rows_sorted)
