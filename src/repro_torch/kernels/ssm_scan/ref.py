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


def selective_scan_bwd_ref(dt, x, b_mat, c_mat, a, h0, dy, dh_last, *,
                           chunk):
    """The gradient of ``selective_scan_ref`` by the backward kernel's
    algorithm (``csrc/selective_scan_bwd.cu``): the forward steps ``h``
    and keeps the state entering every ``chunk``-th step; then, from the
    last chunk, each chunk's states are recomputed from its checkpoint,
    taking each decay exp(dt A) once and keeping it for the walk; dC of
    the chunk is summed over the channels from those states; the chunk is
    walked backwards with ``g``, the gradient of the state (``dh_last``,
    or zero, at the start), keeping each step's g; and dB of the chunk is
    summed over the channels from them.  ``dy``: (B, L, D), the gradient
    of y (None: zero).  -> (ddt in dt's dtype, dx in x's, dB, dC (B, L,
    N), dA (D, N), dh0 (B, D, N) float32); dA summed over the steps of
    each batch row, then over the rows in order.  Never divides by
    exp(dt A), which underflows."""
    dtf = dt.float()
    xf = x.float()
    dxf = dtf * xf
    bf = b_mat.float()
    cf = c_mat.float()
    af = a.float()
    dyf = torch.zeros_like(dtf) if dy is None else dy.float()
    bsz, seq, d = dtf.shape
    h = h0.float()
    ckpt = []
    for t in range(seq):
        if t % chunk == 0:
            ckpt.append(h)
        h = (torch.exp(dtf[:, t, :, None] * af[None]) * h
             + dxf[:, t, :, None] * bf[:, t, None, :])
    g = (torch.zeros_like(h) if dh_last is None
         else dh_last.float().clone())
    ddt, dx = torch.zeros_like(dtf), torch.zeros_like(dtf)
    db, dc = torch.zeros_like(bf), torch.zeros_like(cf)
    da_rows = torch.zeros_like(h)
    for k in reversed(range(len(ckpt))):
        t0, t1 = k * chunk, min(seq, (k + 1) * chunk)
        # recompute: the states and the decays, each exponential once
        hs, abars = [ckpt[k]], []
        for t in range(t0, t1):
            abars.append(torch.exp(dtf[:, t, :, None] * af[None]))
            hs.append(abars[-1] * hs[-1]
                      + dxf[:, t, :, None] * bf[:, t, None, :])
        for t in range(t0, t1):                 # dC from the states
            dc[:, t] = (dyf[:, t, :, None] * hs[t - t0 + 1]).sum(dim=1)
        gs = [None] * (t1 - t0)
        for t in reversed(range(t0, t1)):       # the walk back
            h_prev, abar = hs[t - t0], abars[t - t0]
            g = g + dyf[:, t, :, None] * cf[:, t, None, :]
            gs[t - t0] = g
            s = (g * bf[:, t, None, :]).sum(dim=-1)
            dx[:, t] = s * dtf[:, t]
            gh = g * h_prev * abar
            ddt[:, t] = s * xf[:, t] + (gh * af[None]).sum(dim=-1)
            da_rows = da_rows + gh * dtf[:, t, :, None]
            g = abar * g
        for t in range(t0, t1):                 # dB from the walk's g
            db[:, t] = (gs[t - t0] * dxf[:, t, :, None]).sum(dim=1)
    da = da_rows[0].clone() if bsz else torch.zeros_like(af)
    for i in range(1, bsz):
        da = da + da_rows[i]
    return ddt.to(dt.dtype), dx.to(x.dtype), db, dc, da, g
