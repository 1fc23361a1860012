"""Selective scan: the Mamba-1 recurrence (B10), with its gradient."""
from repro_torch.kernels.ssm_scan.kernel import (  # noqa: F401
    CHUNK, SelectiveScan, selective_scan_bwd_kernel, selective_scan_kernel)
from repro_torch.kernels.ssm_scan.ops import selective_scan  # noqa: F401
from repro_torch.kernels.ssm_scan.ref import (  # noqa: F401
    selective_scan_bwd_ref, selective_scan_ref)
