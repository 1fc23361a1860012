"""Selective scan: the Mamba-1 recurrence (B10)."""
from repro_torch.kernels.ssm_scan.kernel import (  # noqa: F401
    selective_scan_kernel)
from repro_torch.kernels.ssm_scan.ops import selective_scan  # noqa: F401
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref  # noqa
