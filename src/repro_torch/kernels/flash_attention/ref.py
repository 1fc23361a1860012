"""Plain PyTorch version of causal, sliding-window or full GQA attention
with an optional soft-cap (port of
``repro/kernels/flash_attention/ref.py``, with the key length and the
window of the reference's ``models.layers._attend``)."""
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
