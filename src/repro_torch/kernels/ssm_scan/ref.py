"""Plain PyTorch version of the selective scan (the recurrence of
``repro/kernels/ssm_scan/ref.py``, stepped in time order).

The reference's oracle runs an associative scan over the materialized
(B, L, D, N) terms; PyTorch has no such primitive, so this version steps
the same recurrence one time step at a time, in the kernel's order, with
O(B*D*N) memory.  The two agree up to float32 rounding."""
from __future__ import annotations

import torch


def selective_scan_ref(dt, x, b_mat, c_mat, a, h0):
    """dt/x: (B, L, D); b_mat/c_mat: (B, L, N); a: (D, N); h0: (B, D, N)
    -> (y (B, L, D) in x's dtype, h_last (B, D, N) float32)."""
    dtf = dt.float()
    dxf = dtf * x.float()
    bf = b_mat.float()
    cf = c_mat.float()
    af = a.float()
    h = h0.float()
    ys = []
    for t in range(dt.shape[1]):
        abar = torch.exp(dtf[:, t, :, None] * af[None])
        h = abar * h + dxf[:, t, :, None] * bf[:, t, None, :]
        ys.append((h * cf[:, t, None, :]).sum(dim=-1))
    y = (torch.stack(ys, dim=1) if ys
         else dtf.new_zeros(dt.shape))
    return y.to(x.dtype), h
