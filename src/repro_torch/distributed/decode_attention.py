"""Flash-decode: single-token attention over a KV cache (port of the
single-card form of ``repro/distributed/decode_attention.py``).

The reference splits the cache's sequence across a mesh axis and
combines per-shard online-softmax partials; on one card the whole cache
is one shard.  This is not a TPU kernel in the reference (XLA ran it),
so the port runs it as PyTorch ops.  A ``mesh`` is not ported.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import refuse_unported


def _scores(q3, k, logit_cap):
    """q3: (B, Hq, D); k: (B, S, Hkv, D) -> (B, Hkv, g, S) float32."""
    b, hq, d = q3.shape
    hkv = k.shape[2]
    qf = q3.reshape(b, hkv, hq // hkv, d).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k.float()) / math.sqrt(d)
    if logit_cap:
        scores = logit_cap * torch.tanh(scores / logit_cap)
    return scores


def decode_attention(q, ck, cv, pos, mesh=None, *, window=0, logit_cap=0.0):
    """q: (B, 1, Hq, D); ck/cv: (B, Smax, Hkv, D) in their storage dtype;
    pos: an int (entries <= pos are valid) or a (B,) tensor of per-row
    positions (continuous-batching slots) -> (B, 1, Hq, D) in q's dtype.

    The soft-cap applies per score before the max and the sum, as in the
    reference (tanh is monotonic).
    """
    refuse_unported("decode_attention", mesh=mesh, item="A9")
    k = ck.to(q.dtype)          # the storage-dtype cast happens here
    v = cv.to(q.dtype)
    b, s_loc = k.shape[0], k.shape[1]
    slots = torch.arange(s_loc, device=k.device)
    if torch.is_tensor(pos) and pos.dim() == 1:     # (B,) x (S,)
        pos = pos.to(k.device)
        valid = slots[None, :] <= pos[:, None]
        if window:
            valid &= slots[None, :] > (pos - window)[:, None]
    else:
        pos = int(pos)
        valid = slots <= pos
        if window:
            valid &= slots > pos - window
    valid = torch.broadcast_to(valid, (b, s_loc))[:, None, None, :]
    q3 = q[:, 0]
    scores = torch.where(valid, _scores(q3, k, logit_cap), -1e30)
    m = scores.amax(dim=-1)                              # (B, Hkv, g)
    p = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
    lsum = p.sum(dim=-1)
    num = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    bq, hq, d = q3.shape
    num, lsum = num.reshape(bq, hq, d), lsum.reshape(bq, hq)
    out = num / torch.clamp_min(lsum[..., None], 1e-30)
    return out[:, None].to(q.dtype)
