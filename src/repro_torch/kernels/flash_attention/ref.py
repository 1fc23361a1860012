"""Plain PyTorch version of causal GQA attention with an optional
soft-cap (port of ``repro/kernels/flash_attention/ref.py``)."""
from __future__ import annotations

import torch


def flash_attention_ref(q, k, v, *, causal=True, logit_cap=0.0):
    """q: (B, Hq, S, D); k/v: (B, Hkv, S, D) -> (B, Hq, S, D) in q's
    dtype.  Materializes the (B, Hq, S, S) float32 scores."""
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s_mat = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / (d ** 0.5)
    if logit_cap:
        s_mat = logit_cap * torch.tanh(s_mat / logit_cap)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        s_mat = torch.where(mask, s_mat, -1e30)
    p = torch.exp(s_mat - s_mat.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
