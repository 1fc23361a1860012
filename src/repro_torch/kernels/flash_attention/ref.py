"""Plain PyTorch version of causal, sliding-window or full GQA attention
with an optional soft-cap (port of
``repro/kernels/flash_attention/ref.py``, with the key length and the
window of the reference's ``models.layers._attend``), and the backward
kernel's algorithm in plain PyTorch (``flash_attention_bwd_ref``)."""
from __future__ import annotations

import torch


def flash_attention_ref(q, k, v, *, causal=True, logit_cap=0.0, window=0):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D) in q's
    dtype.  ``causal`` masks keys after the query (Sk == Sq); ``window``
    (with ``causal``) masks keys ``window`` or more positions behind it.
    Materializes the (B, Hq, Sq, Sk) float32 scores."""
    b, hq, s, d = q.shape
    sk = k.shape[2]
    g = hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s_mat = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / (d ** 0.5)
    if logit_cap:
        s_mat = logit_cap * torch.tanh(s_mat / logit_cap)
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        mask = qpos >= kpos
        if window:
            mask &= qpos - kpos < window
        s_mat = torch.where(mask, s_mat, -1e30)
    p = torch.exp(s_mat - s_mat.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention_bwd_ref(q, k, v, out, dout, lse, *, causal=True,
                            logit_cap=0.0, window=0):
    """The gradient of ``flash_attention_ref`` by the backward kernel's
    algorithm (``csrc/flash_attention_bwd.cu``) -> (dq, dk, dv) in q's
    dtype.  ``out`` and ``lse`` (B, Hq, Sq) are the forward's; P is
    recomputed from the lse, delta = rowsum(dout * out) (from ``out`` as
    given: in bf16, the rounded output), dS = P (dP - delta) (1 - t^2
    with a cap, t = tanh(s / cap)) / sqrt(D), the scores and dS
    multiplied by 1 / sqrt(D) as both dtypes' kernels multiply.  In
    bfloat16 P and dS are rounded to bf16 as the kernel rounds them (the
    A operands of dV += P^T dO, dK += dS^T Q and dQ += dS K); everything
    else, and all of float32 (3xTF32 products: float32 to ~2^-22 of each
    product), is float32.  dQ is summed over the wrapper's
    ``kernel.dq_key_parts`` one part at a time and the parts added in
    order; dK and dV over the group's query heads in order."""
    # the wrapper's plan (kernel.py imports this module: imported here)
    from repro_torch.kernels.flash_attention.kernel import dq_key_parts
    b, hq, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    bf16 = q.dtype == torch.bfloat16
    rnd = ((lambda x: x.to(torch.bfloat16).float()) if bf16
           else (lambda x: x))
    qf, kf, vf = (x.float() for x in (q, k, v))
    kf, vf = (x.repeat_interleave(g, dim=1) for x in (kf, vf))
    of, dof = out.float(), dout.float()
    rsd = 1.0 / d ** 0.5
    x = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * rsd
    dc = torch.ones_like(x)
    if logit_cap:
        t = torch.tanh(x / logit_cap)
        x = logit_cap * t
        dc = 1.0 - t * t
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((s, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = i >= j
        if window:
            mask &= i - j < window
    p = torch.where(mask, torch.exp(x - lse.float()[..., None]), 0.0)
    delta = (dof * of).sum(dim=-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * dc * rsd
    pr, dsr = rnd(p), rnd(ds)
    dv = torch.einsum("bhqk,bhqd->bhkd", pr, dof)
    dk = torch.einsum("bhqk,bhqd->bhkd", dsr, qf)
    dq = None
    for lo, hi in dq_key_parts(sk, causal):
        part = torch.einsum("bhqk,bhkd->bhqd", dsr[..., lo:hi],
                            kf[:, :, lo:hi])
        dq = part if dq is None else dq + part
    dk, dv = (x.reshape(b, hkv, g, sk, d).sum(dim=2) for x in (dk, dv))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
