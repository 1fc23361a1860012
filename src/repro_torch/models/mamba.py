"""Mamba-1 selective SSM block (arXiv:2312.00752; port of
``repro/models/mamba.py``).

The multi-token scan is one call of the ``selective_scan`` kernel (B10)
over the whole sequence, carrying ``h0`` in: on a CUDA tensor the
hand-written kernel, on a CPU tensor its plain version.  In training
(autograd recording, the parameters behind dt, B, C and A requiring a
gradient) the call goes through ``SelectiveScan``: the forward kernel
keeps the state every 32 steps and B10's backward kernel walks the
sequence back from them; the CPU's gradient is autograd through the
plain version.  The reference chunks the scan into ``chunk``-step
associative scans to bound its memory on a TPU; a sequential scan needs
no chunks, so ``chunk`` is accepted and changes nothing (the results
agree up to rounding).  The single-token decode step stays PyTorch ops,
as it is jnp in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import selective_scan
from repro_torch.models.layers import ParamSpec, torch_dtype


def mamba_specs(cfg):
    d = cfg.d_model
    d_in = cfg.mamba_expand * d
    n = cfg.mamba_d_state
    dt_rank = max(1, d // 16)
    return {
        "in_proj": ParamSpec((d, 2 * d_in), ("embed", "mamba_inner")),
        "conv_w": ParamSpec((cfg.mamba_d_conv, d_in), (None, "mamba_inner")),
        "conv_b": ParamSpec((d_in,), ("mamba_inner",), init="zeros"),
        "x_proj": ParamSpec((d_in, dt_rank + 2 * n), ("mamba_inner", None)),
        "dt_proj": ParamSpec((dt_rank, d_in), (None, "mamba_inner")),
        "dt_bias": ParamSpec((d_in,), ("mamba_inner",), init="zeros"),
        "A_log": ParamSpec((d_in, n), ("mamba_inner", None), init="zeros"),
        "D": ParamSpec((d_in,), ("mamba_inner",), init="ones"),
        "out_proj": ParamSpec((d_in, d), ("mamba_inner", "embed")),
    }


def scan_inputs(proj, dt_proj, dt_bias, a_log, n: int):
    """x_proj's output (B, L, dt_rank + 2N) and the channels' dt_proj
    (dt_rank, C), dt_bias (C,), A_log (C, N) -> dt (B,L,C), B/C (B,L,N),
    A (C,N), float32; the three weights are read in float32."""
    dt_rank = dt_proj.shape[0]
    dt_in, b_mat, c_mat = torch.split(proj, [dt_rank, n, n], dim=-1)
    pre = dt_in.float() @ dt_proj.float() + dt_bias.float()
    dt = torch.logaddexp(pre, torch.zeros_like(pre))    # softplus
    a_mat = -torch.exp(a_log.float())                    # (C, N) < 0
    return dt, b_mat.float(), c_mat.float(), a_mat


def _ssm_params(p, x, cfg):
    """x: (B, L, d_in) -> dt (B,L,d_in), B/C (B,L,N), A (d_in,N), the
    last three float32; dt_proj, dt_bias and A_log are read in float32."""
    proj = x @ p["x_proj"].to(x.dtype)
    return scan_inputs(proj, p["dt_proj"], p["dt_bias"], p["A_log"],
                       cfg.mamba_d_state)


def causal_conv(window, conv_w, conv_b, s: int):
    """The depthwise causal conv of ``window`` (B, S + d_conv - 1, C:
    the padded channels) by ``conv_w`` (d_conv, C) and ``conv_b`` (C,),
    in ``window``'s dtype -> (B, S, C)."""
    dt = window.dtype
    stacked = torch.stack([window[:, i:i + s] for i in range(len(conv_w))],
                          dim=0)                       # (dc, B, S, C)
    conv = torch.einsum("kbsc,kc->bsc", stacked, conv_w.to(dt))
    return conv + conv_b.to(dt)


def ssm_out(y, xs, z, d_skip, out_proj):
    """The block's tail on its channels: the scan's ``y`` plus the
    ``D`` skip of ``xs``, gated by silu(``z``), times ``out_proj``'s
    rows, in ``xs``'s dtype -> (B, S, d)."""
    dt = xs.dtype
    y = y + xs * d_skip.to(dt)
    y = y * F.silu(z)
    return y @ out_proj.to(dt)


def mamba_apply(p, cfg, x, *, ssm_state=None, conv_state=None, chunk=512):
    """x: (B, S, d) -> (y, new_states).

    Prefill when S > 1 (states None or initial); decode when S == 1
    with states given.  States: ssm (B, d_in, N) float32, conv
    (B, d_conv-1, d_in).  ``chunk``: see the module docstring.
    """
    b, s, d = x.shape
    dt_model = x.dtype
    d_in = cfg.mamba_expand * d
    dc = cfg.mamba_d_conv

    xz = x @ p["in_proj"].to(dt_model)
    xs, z = torch.chunk(xz, 2, dim=-1)                 # (B, S, d_in)

    # --- depthwise causal conv over time ---------------------------------
    if s == 1 and conv_state is not None:
        window = torch.cat([conv_state.to(dt_model), xs], dim=1)
        new_conv = window[:, 1:]
        conv = torch.einsum("bkc,kc->bc", window, p["conv_w"].to(dt_model))
        conv = conv[:, None, :] + p["conv_b"].to(dt_model)
    else:
        if conv_state is None:
            pad = torch.zeros((b, dc - 1, d_in), dtype=dt_model,
                              device=x.device)
        else:
            pad = conv_state.to(dt_model)
        window = torch.cat([pad, xs], dim=1)           # (B, S+dc-1, d_in)
        conv = causal_conv(window, p["conv_w"], p["conv_b"], s)
        new_conv = window[:, -(dc - 1):]
    xs = F.silu(conv)

    dt, b_mat, c_mat, a_mat = _ssm_params(p, xs, cfg)
    h0 = (torch.zeros((b, d_in, cfg.mamba_d_state), dtype=torch.float32,
                      device=x.device)
          if ssm_state is None else ssm_state.float())

    if s == 1:
        abar = torch.exp(dt[:, 0, :, None] * a_mat[None])
        bx = (dt[:, 0] * xs[:, 0].float())[..., None] \
            * b_mat[:, 0, None, :]
        h = abar * h0 + bx
        y = torch.einsum("bdn,bn->bd", h, c_mat[:, 0])[:, None].to(dt_model)
        h_last = h
    else:
        y, h_last = selective_scan(dt, xs, b_mat, c_mat, a_mat, h0)

    out = ssm_out(y, xs, z, p["D"], p["out_proj"])
    states = {"ssm": h_last.float(), "conv": new_conv}
    return out, states


def mamba_state_specs(cfg, batch):
    """{name: (shape, dtype)} of one Mamba layer's decode state."""
    d_in = cfg.mamba_expand * cfg.d_model
    return {
        "ssm": ((batch, d_in, cfg.mamba_d_state), torch.float32),
        "conv": ((batch, cfg.mamba_d_conv - 1, d_in),
                 torch_dtype(cfg.compute_dtype)),
    }
