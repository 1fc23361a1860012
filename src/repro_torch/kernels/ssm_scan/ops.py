"""Public API: the selective scan, Mamba's inner recurrence (port of
``repro/kernels/ssm_scan/ops.py``), with its gradient."""
from __future__ import annotations

import torch

from repro_torch.device import refuse_unported
from repro_torch.kernels.ssm_scan.kernel import (SelectiveScan,
                                                 selective_scan_kernel)


def selective_scan(dt, x, b_mat, c_mat, a, h0, *, interpret=False,
                   use_kernel=True):
    """dt/x: (B, L, D); b_mat/c_mat: (B, L, N); a: (D, N); h0: (B, D, N)
    -> (y (B, L, D) in x's dtype, h_last (B, D, N) float32): the
    ``selective_scan`` kernel on CUDA tensors, its plain version on CPU
    tensors (whose gradient is autograd through it).  On CUDA tensors
    that need a gradient (grad enabled, one of them requiring it) the
    call goes through ``SelectiveScan``: the forward kernel keeping a
    checkpoint every ``CHUNK`` steps, and the backward kernel.  B, C, A
    and h0 are read in float32 (exact from bfloat16), as the reference's
    kernel reads them.  ``interpret=True`` and ``use_kernel=False`` are
    not ported."""
    refuse_unported("selective_scan", interpret=interpret,
                    use_kernel=use_kernel)
    args = (dt.contiguous(), x.contiguous(), b_mat.float().contiguous(),
            c_mat.float().contiguous(), a.float().contiguous(),
            h0.float().contiguous())
    if x.is_cuda and torch.is_grad_enabled() and any(
            t.requires_grad for t in args):
        return SelectiveScan.apply(*args)
    return selective_scan_kernel(*args)
