"""xLSTM blocks: mLSTM (matrix memory, parallel form) and sLSTM (scalar
memory, sequential) — arXiv:2405.04517 (port of ``repro/models/xlstm.py``).

mLSTM: pre-up-projection (factor cfg.xlstm_proj_factor), exponential
input gates with a max-stabilizer.  Prefill uses the parallel
(quadratic, query-chunked) form and hands its final (C, n, m) state to
decode, which runs the recurrent form one token at a time.

sLSTM: block-diagonal (per-head) recurrent weights, a true sequential
scan: a Python loop of PyTorch ops, one token at a time (the reference's
``lax.scan``).  Neither block reaches a Pallas kernel in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_specs(cfg):
    d = cfg.d_model
    d_in = int(cfg.xlstm_proj_factor * d)
    h = cfg.num_heads
    dh = d_in // h
    return {
        "up": ParamSpec((d, 2 * d_in), ("embed", "mlp")),
        # block-diagonal per-head projections (arXiv:2405.04517 §mLSTM)
        "wq": ParamSpec((h, dh, dh), (None, "fsdp", None)),
        "wk": ParamSpec((h, dh, dh), (None, "fsdp", None)),
        "wv": ParamSpec((h, dh, dh), (None, "fsdp", None)),
        "w_igate": ParamSpec((d_in, h), (None, None), init="small_normal"),
        "w_fgate": ParamSpec((d_in, h), (None, None), init="small_normal"),
        "b_igate": ParamSpec((h,), (None,), init="zeros"),
        "b_fgate": ParamSpec((h,), (None,), init="ones"),
        "down": ParamSpec((d_in, d), ("mlp", "embed")),
    }


def _inv_sqrt(n: int, device) -> torch.Tensor:
    """1 / sqrt(n) rounded as the reference rounds it (float32 sqrt,
    then a float32 division)."""
    return 1.0 / torch.sqrt(torch.tensor(float(n), device=device))


def mlstm_apply(p, cfg, x, *, state=None, q_chunk=1024):
    """x: (B, S, d) -> (y, new_state).

    state: dict(C=(B,H,dk,dv), n=(B,H,dk), m=(B,H)) float32 or None.  A
    single token with a state takes the recurrent step; anything else
    the parallel form, which starts from zero (the given state is not
    read, as in the reference).  A prompt longer than ``q_chunk`` must
    be a multiple of it (``ValueError``, as the reference asserts).
    """
    b, s, d = x.shape
    dt = x.dtype
    nh = cfg.num_heads
    d_in = int(cfg.xlstm_proj_factor * d)
    f32 = torch.float32

    xz = x @ p["up"].to(dt)
    xi, z = torch.chunk(xz, 2, dim=-1)                  # (B, S, d_in)
    dh = d_in // nh
    xh = xi.reshape(b, s, nh, dh)                       # per-head view
    # block-diagonal projections -> (B, H, S, dh)
    q = torch.einsum("bshd,hde->bhse", xh, p["wq"].to(dt)).to(f32)
    k = torch.einsum("bshd,hde->bhse", xh, p["wk"].to(dt)).to(f32)
    v = torch.einsum("bshd,hde->bhse", xh, p["wv"].to(dt)).to(f32)
    scale = _inv_sqrt(dh, x.device)

    ig = (xi.to(f32) @ p["w_igate"].to(f32)
          + p["b_igate"].to(f32)).transpose(1, 2)        # (B, H, S)
    fg = (xi.to(f32) @ p["w_fgate"].to(f32)
          + p["b_fgate"].to(f32)).transpose(1, 2)

    if s == 1 and state is not None:
        # --- recurrent decode step -----------------------------------------
        c0, n0, m0 = state["C"], state["n"], state["m"]
        it, ft = ig[..., 0], fg[..., 0]                 # (B, H)
        logf = F.logsigmoid(ft)
        m1 = torch.maximum(logf + m0, it)
        i_s = torch.exp(it - m1)
        f_s = torch.exp(logf + m0 - m1)
        kt, vt, qt = k[:, :, 0], v[:, :, 0], q[:, :, 0]  # (B, H, dh)
        c1 = f_s[..., None, None] * c0 \
            + i_s[..., None, None] * (kt[..., :, None] * vt[..., None, :])
        n1 = f_s[..., None] * n0 + i_s[..., None] * kt
        num = torch.einsum("bhk,bhkv->bhv", qt * scale, c1)
        den = torch.maximum(
            torch.abs(torch.einsum("bhk,bhk->bh", qt * scale, n1)),
            torch.exp(-m1))
        y = (num / den[..., None])[:, :, None]          # (B, H, 1, dh)
        new_state = {"C": c1, "n": n1, "m": m1}
    else:
        # --- parallel (chunked-query quadratic) form ------------------------
        y, fcum = mlstm_parallel(q, k, v, ig, fg, scale, q_chunk)
        # final state for the prefill -> decode handoff
        last_f = fcum[..., -1]
        dlast = last_f[..., None] - fcum + ig            # (B, H, S)
        m_last = dlast.amax(dim=-1)
        wlast = torch.exp(dlast - m_last[..., None])
        c_last = torch.einsum("bhsk,bhsv->bhkv", wlast[..., None] * k, v)
        n_last = torch.einsum("bhs,bhsk->bhk", wlast, k)
        new_state = {"C": c_last, "n": n_last, "m": m_last}

    return mlstm_out(y, z, p["down"]), new_state


def mlstm_out(y, z, down):
    """The block's tail on its heads: ``y`` (B, H, S, dh) float32 laid
    out as ``z``'s (B, S, H dh) channels in ``z``'s dtype, gated by
    silu(``z``), times ``down``'s rows -> (B, S, d)."""
    dt = z.dtype
    y = y.transpose(1, 2).reshape(z.shape).to(dt)
    y = y * F.silu(z)
    return y @ down.to(dt)


def mlstm_parallel(q, k, v, ig, fg, scale, q_chunk: int = 1024):
    """The parallel (chunked-query quadratic) form over the heads of
    ``q``/``k``/``v`` (B, H, S, dh) float32, with the gates'
    pre-activations ``ig``/``fg`` (B, H, S), from a zero state -> (y
    (B, H, S, dh), the forget gates' cumulative log F (B, H, S)).  A
    sequence longer than ``q_chunk`` must be a multiple of it."""
    s = q.shape[2]
    logf = F.logsigmoid(fg)                             # (B, H, S)
    fcum = torch.cumsum(logf, dim=-1)                   # F_t
    kpos = torch.arange(s, device=q.device)

    def q_block(t0, qc):
        qt = q[:, :, t0:t0 + qc]
        ft_q = fcum[..., t0:t0 + qc]
        # D_ts = F_t - F_s + i_s for s <= t
        dmat = ft_q[..., :, None] - fcum[..., None, :] + ig[..., None, :]
        tpos = t0 + torch.arange(qc, device=q.device)
        mask = tpos[:, None] >= kpos[None, :]
        dmat = torch.where(mask[None, None], dmat, -torch.inf)
        mrow = dmat.amax(dim=-1)                        # (B, H, Qc)
        w = torch.exp(dmat - mrow[..., None])
        sc = torch.einsum("bhqd,bhkd->bhqk", qt * scale, k) * w
        num = torch.einsum("bhqk,bhkv->bhqv", sc, v)
        den = torch.maximum(torch.abs(sc.sum(dim=-1)), torch.exp(-mrow))
        return num / den[..., None]

    q_chunk = min(q_chunk, s)
    if s % q_chunk:
        raise ValueError(f"mlstm_apply: a {s}-token sequence is not a "
                         f"multiple of the {q_chunk}-token query chunk "
                         f"(the reference asserts the same)")
    y = torch.cat([q_block(t0, q_chunk) for t0 in range(0, s, q_chunk)],
                  dim=2)
    return y, fcum


def mlstm_state_specs(cfg, batch):
    """{name: (shape, dtype)} of one mLSTM layer's decode state."""
    d_in = int(cfg.xlstm_proj_factor * cfg.d_model)
    h = cfg.num_heads
    dh = d_in // h
    f32 = torch.float32
    return {"C": ((batch, h, dh, dh), f32), "n": ((batch, h, dh), f32),
            "m": ((batch, h), f32)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_specs(cfg):
    d = cfg.d_model
    h = cfg.num_heads
    dh = d // h
    d_in = int(cfg.xlstm_proj_factor * d)
    return {
        # input projections for gates (z, i, f, o)
        "w_in": ParamSpec((d, 4 * d), ("embed", None)),
        "b_in": ParamSpec((4 * d,), (None,), init="zeros"),
        # block-diagonal recurrent weights per head, per gate
        "r_z": ParamSpec((h, dh, dh), (None, None, None), init="small_normal"),
        "r_i": ParamSpec((h, dh, dh), (None, None, None), init="small_normal"),
        "r_f": ParamSpec((h, dh, dh), (None, None, None), init="small_normal"),
        "r_o": ParamSpec((h, dh, dh), (None, None, None), init="small_normal"),
        # gated FFN after the core (post-up-projection block)
        "up_gate": ParamSpec((d, d_in), ("embed", "mlp")),
        "up": ParamSpec((d, d_in), ("embed", "mlp")),
        "down": ParamSpec((d_in, d), ("mlp", "embed")),
    }


def slstm_core(p, cfg, x, *, state=None):
    """The sLSTM's recurrence (``w_in``, ``b_in``, ``r_*``), a token at
    a time: x (B, S, d) -> (its hidden states (B, S, d) in x's dtype,
    the new state)."""
    b, s, d = x.shape
    dt = x.dtype
    h = cfg.num_heads
    dh = d // h
    f32 = torch.float32

    gates_in = (x @ p["w_in"].to(dt)).to(f32) + p["b_in"].to(f32)  # (B,S,4d)
    if state is None:
        state = slstm_init_state(cfg, b, device=x.device)
    hp, cp, np_, mp = (state[key].to(f32) for key in ("h", "c", "n", "m"))
    # the four gates' per-head recurrent weights side by side: one
    # product a step, (B, H, dh) x (H, dh, 4 dh)
    r_all = torch.cat([p[name].to(f32)
                       for name in ("r_z", "r_i", "r_f", "r_o")], dim=2)

    hs = []
    for t in range(s):
        g_t = gates_in[:, t]
        rec = torch.einsum("bhk,hkj->bhj", hp.reshape(b, h, dh),
                           r_all).reshape(b, h, 4, dh)
        rz, ri, rf, ro = (rec[:, :, j].reshape(b, d) for j in range(4))
        zt = torch.tanh(g_t[:, :d] + rz)
        it = g_t[:, d:2 * d] + ri
        ft = g_t[:, 2 * d:3 * d] + rf
        ot = torch.sigmoid(g_t[:, 3 * d:] + ro)
        logf = F.logsigmoid(ft)
        mt = torch.maximum(logf + mp, it)
        i_s = torch.exp(it - mt)
        f_s = torch.exp(logf + mp - mt)
        cp = f_s * cp + i_s * zt
        np_ = f_s * np_ + i_s
        hp = ot * cp / torch.clamp_min(np_, 1e-6)
        mp = mt
        hs.append(hp)
    y = torch.stack(hs, dim=1).to(dt)                   # (B, S, d)
    return y, {"h": hp, "c": cp, "n": np_, "m": mp}


def slstm_apply(p, cfg, x, *, state=None):
    """x: (B, S, d) -> (y, new_state); state: h, c, n, m each (B, d)
    float32, or None (``slstm_init_state``: n starts at 1e-6)."""
    dt = x.dtype
    y, new_state = slstm_core(p, cfg, x, state=state)
    g = F.silu(y @ p["up_gate"].to(dt)) * (y @ p["up"].to(dt))
    out = g @ p["down"].to(dt)
    return out, new_state


def slstm_init_state(cfg, batch, device=None):
    d = cfg.d_model
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return {"h": z, "c": z, "n": z + 1e-6, "m": z}


def slstm_state_specs(cfg, batch):
    """{name: (shape, dtype)} of one sLSTM layer's decode state."""
    sd = ((batch, cfg.d_model), torch.float32)
    return {"h": sd, "c": sd, "n": sd, "m": sd}
