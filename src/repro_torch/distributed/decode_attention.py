"""Flash-decode: single-token attention over a KV cache, optionally
sequence-sharded over a mesh (port of
``repro/distributed/decode_attention.py``).

Decode caches split their sequence over the mesh's ``seq_axis``: each
shard computes its online-softmax partials ``(num, m, lsum)`` over its
slice of the cache, and the partials are combined on the mesh's first
device (the max of the ``m``, then each partial rescaled and folded in
axis-index order, ``core.reduce.fold_sum``), so only (B, Hq, D)-sized
tensors leave a shard.  The batch is split over the data axes when they
divide it.  Without a mesh (or when the cache does not split) the whole
cache is one shard.  A cache placed by ``ShardingPlan.cache_shardings``
(``sharding.Placed``) is read where it lives: each shard computes on its
own block, and no slice of the cache moves between devices; a whole
cache sends each shard its slice.  This is not a TPU kernel in the
reference (XLA ran it), so the port runs it as PyTorch ops.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.reduce import fold_sum
from repro_torch.distributed.sharding import Placed, check_mesh, shard_coords


def _scores(q3, k, logit_cap):
    """q3: (B, Hq, D); k: (B, S, Hkv, D) -> (B, Hkv, g, S) float32."""
    b, hq, d = q3.shape
    hkv = k.shape[2]
    qf = q3.reshape(b, hkv, hq // hkv, d).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k.float()) / math.sqrt(d)
    if logit_cap:
        scores = logit_cap * torch.tanh(scores / logit_cap)
    return scores


def _valid(pos, b, s_loc, base, window, device):
    """(B, S_loc) bool: the shard's slots ``base .. base + S_loc`` at or
    before ``pos`` (and inside the window).  A (B,) ``pos`` must match the
    shard's batch, as the reference's broadcast requires."""
    slots = base + torch.arange(s_loc, device=device)
    if torch.is_tensor(pos) and pos.dim() == 1:     # (B,) x (S,)
        if pos.shape[0] != b:
            raise ValueError(
                f"per-row positions of {pos.shape[0]} rows cannot "
                f"broadcast to a shard batch of {b}: a (B,) pos needs a "
                f"batch that is not split over the data axes")
        pos = pos.to(device)
        valid = slots[None, :] <= pos[:, None]
        if window:
            valid &= slots[None, :] > (pos - window)[:, None]
    else:
        pos = int(pos)
        valid = slots <= pos
        if window:
            valid &= slots > pos - window
    return torch.broadcast_to(valid, (b, s_loc))


def _partial(q3, k, v, valid, logit_cap):
    """One shard's online-softmax partials: (num (B, Hq, D), m (B, Hq),
    lsum (B, Hq)), float32."""
    valid = valid[:, None, None, :]
    scores = torch.where(valid, _scores(q3, k, logit_cap), -1e30)
    m = scores.amax(dim=-1)                              # (B, Hkv, g)
    p = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
    lsum = p.sum(dim=-1)
    num = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    bq, hq, d = q3.shape
    return (num.reshape(bq, hq, d), m.reshape(bq, hq),
            lsum.reshape(bq, hq))


def _shard_block(cache, coords, dev, rows, cols):
    """A shard's (rows, cols) of the cache on ``dev``: a placed cache's
    block held there (it must be placed for this split), a whole
    cache's slice sent there."""
    if not isinstance(cache, Placed):
        return cache[rows, cols].to(dev)
    idx = cache.block_of(coords)
    want = ((rows.start, rows.stop), (cols.start, cols.stop))
    if cache.bounds(idx)[:2] != want or dev not in cache.copies[idx]:
        raise ValueError(f"the cache is placed as {cache.spec}, not for "
                         f"this shard's rows {want[0]} and slots {want[1]}")
    return cache.copies[idx][dev]


def decode_attention(q, ck, cv, pos, mesh=None, *, window=0, logit_cap=0.0,
                     seq_axis="model", dp_axes=("pod", "data")):
    """q: (B, 1, Hq, D); ck/cv: (B, Smax, Hkv, D) in their storage dtype;
    pos: an int (entries <= pos are valid) or a (B,) tensor of per-row
    positions (continuous-batching slots) -> (B, 1, Hq, D) in q's dtype,
    on q's device.

    ``mesh``: a ``distributed.sharding.Mesh`` splitting the cache's
    sequence over ``seq_axis`` when it divides Smax (and the axis has
    more than one shard; else one shard runs it all, as in the
    reference) and the batch over the ``dp_axes`` it has when they
    divide B.  A (B,) ``pos`` with the batch split raises, as the
    reference's does.  The soft-cap applies per score before the max
    and the sum, as in the reference (tanh is monotonic).
    """
    check_mesh(mesh)
    b, smax = ck.shape[0], ck.shape[1]
    n_shards = mesh.shape[seq_axis] if mesh is not None else 1
    seq_ok = mesh is not None and smax % n_shards == 0 and n_shards > 1
    dt = q.dtype

    if not seq_ok:
        if isinstance(ck, Placed):
            ck, cv = ck.full(q.device), cv.full(q.device)
        # the casts from the storage dtype happen here, on the one shard
        num, _, lsum = _partial(q[:, 0], ck.to(dt), cv.to(dt),
                                _valid(pos, b, smax, 0, window, ck.device),
                                logit_cap)
        out = num / torch.clamp_min(lsum[..., None], 1e-30)
        return out[:, None].to(dt)

    s_loc = smax // n_shards
    dp, dp_n = mesh.data_split(dp_axes, b)
    b_loc = b // dp_n
    parts = {}          # batch block -> [(num, m, lsum) per seq shard]
    for c in shard_coords(mesh, dp + (seq_axis,)):
        dev = mesh.device_at(**c)
        blk = mesh.block_index(c, dp)
        j = c[seq_axis]
        rows = slice(blk * b_loc, (blk + 1) * b_loc)
        cols = slice(j * s_loc, (j + 1) * s_loc)
        # dequantize inside the shard: only its slice takes q's dtype
        k = _shard_block(ck, c, dev, rows, cols).to(dt)
        v = _shard_block(cv, c, dev, rows, cols).to(dt)
        parts.setdefault(blk, []).append(_partial(
            q[rows, 0].to(dev), k, v,
            _valid(pos, b_loc, s_loc, j * s_loc, window, dev), logit_cap))
    first = mesh.device
    outs = []
    for blk in sorted(parts):
        got = [tuple(x.to(first) for x in part) for part in parts[blk]]
        m_g = torch.stack([m for _, m, _ in got]).amax(dim=0)
        scale = [torch.exp(m - m_g) for _, m, _ in got]
        num = fold_sum(torch.stack([n * s[..., None]
                                    for (n, _, _), s in zip(got, scale)]),
                       dim=0)
        lsum = fold_sum(torch.stack([ls * s for (_, _, ls), s
                                     in zip(got, scale)]), dim=0)
        outs.append(num / torch.clamp_min(lsum[..., None], 1e-30))
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    return out[:, None].to(dt).to(q.device)
