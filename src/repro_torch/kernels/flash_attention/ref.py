"""Plain PyTorch version of causal, sliding-window or full GQA attention
with an optional soft-cap (port of
``repro/kernels/flash_attention/ref.py``, with the key length, the
window, the query offset and the key mask of the reference's
``models.layers._attend``), each row's log-sum-exp as the forward kernel
writes it (``flash_attention_lse_ref``), and the backward kernel's
algorithm in plain PyTorch (``flash_attention_bwd_ref``)."""
from __future__ import annotations

import torch


def score_mask(q, sk, *, causal, window=0, q_offset=0, kv_len_mask=None):
    """The (query, key) pairs the function scores: (Sq, Sk) bool, or (B,
    1, Sq, Sk) with a key mask.  Row i sits at position ``q_offset + i``:
    ``causal`` drops keys after it, ``window`` (with ``causal``) keys
    ``window`` or more positions behind it; ``kv_len_mask`` (B, Sk) drops
    the keys it is False for.  None where every pair is scored."""
    s = q.shape[2]
    mask = None
    if causal:
        i = q_offset + torch.arange(s, device=q.device)[:, None]
        j = torch.arange(sk, device=q.device)[None, :]
        mask = i >= j
        if window:
            mask &= i - j < window
    if kv_len_mask is not None:
        keys = kv_len_mask[:, None, None, :]
        mask = keys if mask is None else mask & keys
    return mask


def _scores(q, k, logit_cap):
    """The scaled (and capped) float32 scores, (B, Hq, Sq, Sk)."""
    g = q.shape[1] // k.shape[1]
    s_mat = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                         k.float().repeat_interleave(g, dim=1)) \
        / (q.shape[-1] ** 0.5)
    if logit_cap:
        s_mat = logit_cap * torch.tanh(s_mat / logit_cap)
    return s_mat


def flash_attention_ref(q, k, v, *, causal=True, logit_cap=0.0, window=0,
                        q_offset=0, kv_len_mask=None):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D) in q's
    dtype.  The pairs ``score_mask`` drops score -1e30, as in the
    reference: a row with no valid key has a softmax uniform over all Sk
    keys (the mean of v).  Materializes the (B, Hq, Sq, Sk) float32
    scores."""
    g = q.shape[1] // k.shape[1]
    s_mat = _scores(q, k, logit_cap)
    mask = score_mask(q, k.shape[2], causal=causal, window=window,
                      q_offset=q_offset, kv_len_mask=kv_len_mask)
    if mask is not None:
        s_mat = torch.where(mask, s_mat, -1e30)
    p = torch.exp(s_mat - s_mat.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.float().repeat_interleave(g, dim=1)).to(q.dtype)


def flash_attention_lse_ref(q, k, *, causal=True, logit_cap=0.0, window=0,
                            q_offset=0, kv_len_mask=None):
    """Each row's log-sum-exp of its scored pairs, (B, Hq, Sq) float32, as
    the forward kernel writes it for the backward: +inf for a row with no
    valid key (the kernels' sentinel: the backward's P is 0 there)."""
    s_mat = _scores(q, k, logit_cap)
    mask = score_mask(q, k.shape[2], causal=causal, window=window,
                      q_offset=q_offset, kv_len_mask=kv_len_mask)
    if mask is None:
        return torch.logsumexp(s_mat, dim=-1)
    mask = mask.expand_as(s_mat)
    lse = torch.logsumexp(torch.where(mask, s_mat, -torch.inf), dim=-1)
    return torch.where(mask.any(dim=-1), lse, torch.inf)


def flash_attention_bwd_ref(q, k, v, out, dout, lse, *, causal=True,
                            logit_cap=0.0, window=0, q_offset=0,
                            kv_len_mask=None):
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
    order; dK and dV over the group's query heads in order.  A row with no
    valid key (lse +inf, ``flash_attention_lse_ref``) has P = 0 and adds
    dout / Sk to every key's dv: the sum of the group's such rows' dout
    over Sk, added to dv before its rounding."""
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
    mask = score_mask(q, sk, causal=causal, window=window,
                      q_offset=q_offset, kv_len_mask=kv_len_mask)
    p = torch.exp(x - lse.float()[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
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
    none = torch.isinf(lse)                          # rows with no key
    if bool(none.any()):
        u = (dof * none[..., None]).reshape(b, hkv, g * s, d).sum(dim=2)
        dv = dv + (u / sk)[:, :, None, :]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
