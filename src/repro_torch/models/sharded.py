"""Training on a mesh: each data block's loss, tensor-parallel over the
mesh's ``"model"`` axis (the reference's ``forward_train`` under its
``ShardingPlan``, ``repro/models/transformer.py`` with ``Model.mesh``).

The batch splits over the mesh's data axes when they divide it
(``Mesh.data_split``; else one block takes it whole).  A data block's
shards are the coordinates along ``"model"`` at its data indices; the
shard at model 0 holds the residual stream, the norms and every combine.
Each shard reads the weights it computes with through
``sharding.take`` (FSDP's gather of the ``embed`` dim included) inside
the pattern group's recomputed region, so with remat the gathered copies
are not kept for the backward:

  * attention by whole heads: shard m computes q heads ``m*Hq/M ..`` and
    the kv heads they read by the GQA map ``h // (Hq/Hkv)`` (the plan
    splits features, not heads, so a shard may gather kv columns another
    shard stores), on B9 per shard, then its rows of ``wo``;
  * the MLP's hidden dim: ``w_gate``/``w_up`` columns, ``w_down`` rows;
  * MoE: each shard's experts and slice of the shared experts
    (``moe._moe_local``, split as the expert-parallel ``moe_apply``
    splits them), the capacity that of the block's tokens, the router
    rounded to the activations' dtype; the aux loss is the model-0
    shard's;
  * the vocabulary: the embedding a masked lookup of each shard's rows,
    each cross-entropy chunk each shard's logits, their logsumexp and
    gold logit combined.

Partial sums fold in shard order on the first device
(``sharding.fold_list``).  A split the shards do not divide (heads, d_ff,
vocabulary) runs whole on the first shard.  ``loss_and_grads``
takes each block's gradients from detached per-block pieces and folds
the blocks in block order on each piece's owner; the loss is the blocks'
cross-entropy folded plus the first block's aux (the reference's
replicated value), and the aux's gradient the blocks' mean (its
``shard_map`` transpose).  Mamba, mLSTM and sLSTM blocks, whisper's
encoder-decoder and qwen2-vl are not covered: ``refuse`` names ROADMAP
A14b.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ATTN, ATTN_LOCAL, MAMBA, MLSTM, SLSTM
from repro_torch.distributed.sharding import (Placed, block_view, broadcast,
                                              fold_list, shard_coords, take)
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.transformer import (CE_CHUNK, _is_moe_layer,
                                            _recompute, gather_dtype,
                                            recompute_group)

DP_AXES = ("pod", "data")


def refuse(model) -> None:
    """Raise for the families training on a mesh does not cover
    (ROADMAP A14b)."""
    cfg = model.cfg
    what = None
    if any(k in (MAMBA, MLSTM, SLSTM) for k in model.pattern):
        what = "Mamba / mLSTM / sLSTM blocks"
    elif cfg.encoder_layers:
        what = "whisper's encoder-decoder"
    elif cfg.family == "vlm":
        what = "qwen2-vl's vision rows"
    if what is not None:
        raise NotImplementedError(
            f"training on a mesh does not cover {what} ({cfg.name}) yet "
            f"(ROADMAP A14b)")
    if cfg.moe is not None and "model" not in model.mesh.axis_names:
        raise ValueError("MoE training on a mesh needs a 'model' axis for "
                         "its experts")


class Shards:
    """One data block's shards: its mesh coordinates along ``"model"``
    (one without a model axis), their devices, the first's."""

    def __init__(self, mesh, block: dict):
        n = mesh.shape["model"] if "model" in mesh.axis_names else 1
        self.n = n
        self.coords = [tuple(block.get(a, m if a == "model" else 0)
                             for a in mesh.axis_names) for m in range(n)]
        self.devices = [mesh.devices[c] for c in self.coords]
        self.first = self.devices[0]

    def split(self, size: int) -> int:
        """How many shards split a dim of ``size``: all, or one."""
        return self.n if size % self.n == 0 else 1


def data_blocks(model, batch) -> list:
    """``[(block, rows)]``: each data block's indices over the data axes
    and its slice of the batch's rows, in row-major order."""
    mesh = model.mesh
    b = batch["tokens"].shape[0]
    axes, n = mesh.data_split(DP_AXES, b)
    w = b // n
    return [(c, slice(i * w, (i + 1) * w))
            for i, c in enumerate(shard_coords(mesh, axes))]


def block_batch(batch, rows: slice, device) -> dict:
    """A data block's rows of ``batch`` on ``device`` (the second dim of
    (3, B, S) M-RoPE positions)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        t = t[:, rows] if k == "positions" and t.dim() == 3 \
            and t.shape[0] == 3 else t[rows]
        out[k] = t.to(device)
    return out


def block_views(model, params, block: dict, *, trainable=False) -> dict:
    """``params`` (Placed leaves or tensors) as data block ``block``
    reads them (``sharding.block_view``); a stacked leaf that
    ``transformer.gather_dtype`` casts (``REPRO_GATHER_BF16=1``) is read
    in the compute dtype, each piece cast as it is sent."""
    def view(path, leaf):
        stacked = path[0] == "layers"
        v = block_view(leaf, model.mesh, block, trainable=trainable,
                       stacked=stacked)
        to = gather_dtype(len(v.shape), model.compute_dtype) \
            if stacked else None
        return v if to is None else v.cast(to)
    return tree_map(view, params, path=())


def _one(view, shards) -> torch.Tensor:
    """A replicated read: the whole leaf on the first shard."""
    return take(view, [(shards.coords[0], None)])[0]


# ---------------------------------------------------------------------------
# The tensor-parallel layers
# ---------------------------------------------------------------------------

def head_split(nq: int, nkv: int, n: int) -> int:
    """Shards that split attention by whole heads: ``n`` when they
    divide the q heads and each shard's heads read whole kv heads by
    the GQA map, else 1."""
    if n > 1 and nq % n == 0:
        hq, grp = nq // n, nq // nkv
        if hq % grp == 0 or grp % hq == 0:
            return n
    return 1


def attention(cfg, pv, h, positions, window, shards):
    """Causal self-attention of ``h`` (B, S, d) on the first shard ->
    the folded output there: each shard's ``layers.attention_apply`` on
    its heads' slices of the projections."""
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    n = head_split(nq, nkv, shards.n)
    hq, grp = nq // n, nq // nkv
    kv = [(m * hq // grp, ((m + 1) * hq - 1) // grp + 1) for m in range(n)]
    cs, devs = shards.coords[:n], shards.devices[:n]
    q_cols = [(m * hq * hd, (m + 1) * hq * hd) for m in range(n)]
    kv_cols = [(a * hd, e * hd) for a, e in kv]

    def cols(name, ranges):
        return take(pv[name], [(c, (None, r)) for c, r in zip(cs, ranges)])

    def vec(name, ranges):
        return take(pv[name], [(c, (r,)) for c, r in zip(cs, ranges)])
    got = {"wq": cols("wq", q_cols), "wk": cols("wk", kv_cols),
           "wv": cols("wv", kv_cols),
           "wo": take(pv["wo"], [(c, (r, None)) for c, r in zip(cs, q_cols)])}
    if cfg.qkv_bias:
        got.update(bq=vec("bq", q_cols), bk=vec("bk", kv_cols),
                   bv=vec("bv", kv_cols))
    hs = broadcast(h, devs)
    parts = []
    for m, dev in enumerate(devs):
        sub = dataclasses.replace(cfg, num_heads=hq, head_dim=hd,
                                  num_kv_heads=kv[m][1] - kv[m][0])
        out, _ = L.attention_apply({k: v[m] for k, v in got.items()}, sub,
                                   hs[m], positions.to(dev),
                                   layer_window=window)
        parts.append(out)
    return fold_list(parts, shards.first)


def mlp(pv, h, shards):
    """SwiGLU over the hidden dim's shards (each shard's
    ``layers.mlp_apply``) -> the folded output."""
    f = pv["w_gate"].shape[1]
    n = shards.split(f)
    fw = f // n
    cs, r = shards.coords[:n], [(m * fw, (m + 1) * fw) for m in range(n)]
    w = {k: take(pv[k], [(c, (None, x) if k != "w_down" else (x, None))
                         for c, x in zip(cs, r)])
         for k in ("w_gate", "w_up", "w_down")}
    hs = broadcast(h, shards.devices[:n])
    return fold_list([L.mlp_apply({k: v[m] for k, v in w.items()}, hs[m])
                      for m in range(n)], shards.first)


def moe(cfg, pv, h, shards):
    """The MoE FFN, experts over the shards -> (output, the model-0
    shard's aux loss) on the first shard."""
    mo = cfg.moe
    n = shards.n
    if mo.num_experts % n:
        raise ValueError(f"{mo.num_experts} experts not divisible by "
                         f"EP={n}")
    el = mo.num_experts // n
    b, s, d = h.shape
    dt = h.dtype
    cs = shards.coords
    er = [(m * el, (m + 1) * el) for m in range(n)]
    router = take(pv["router"], [(c, None) for c in cs])
    w = {k: take(pv[k], [(c, (r, None, None)) for c, r in zip(cs, er)])
         for k in ("w_gate", "w_up", "w_down")}
    if "shared" in pv:
        sp = pv["shared"]
        fs = sp["w_down"].shape[0]
        if fs % n:
            raise ValueError(f"the shared experts' d_ff {fs} does not "
                             f"split over EP={n}")
        sr = [(m * (fs // n), (m + 1) * (fs // n)) for m in range(n)]
        sg = take(sp["w_gate"], [(c, (None, r)) for c, r in zip(cs, sr)])
        su = take(sp["w_up"], [(c, (None, r)) for c, r in zip(cs, sr)])
        sd = take(sp["w_down"], [(c, (r, None)) for c, r in zip(cs, sr)])
    xs = broadcast(h.reshape(b * s, d), shards.devices)
    capacity = MOE._capacity(b * s, mo)
    parts, aux = [], None
    for m in range(n):
        p = {"router": router[m].to(dt), "w_gate": w["w_gate"][m],
             "w_up": w["w_up"][m], "w_down": w["w_down"][m]}
        if "shared" in pv:
            p["shared"] = {"w_gate": sg[m], "w_up": su[m], "w_down": sd[m]}
        y, a = MOE._moe_local(p, xs[m], moe=mo, expert_offset=m * el,
                              e_local=el, capacity=capacity,
                              with_aux=m == 0)
        parts.append(y)
        if m == 0:
            aux = a
    return (fold_list(parts, shards.first).reshape(b, s, d),
            aux.to(shards.first))


def lookup(tables, tokens, shards) -> torch.Tensor:
    """The embedding rows of ``tokens`` from each shard's slice of the
    vocabulary (zeros outside it), folded on the first shard."""
    if len(tables) == 1:
        return tables[0][tokens.long()]
    vw = tables[0].shape[0]
    parts = []
    for m, tab in enumerate(tables):
        t = tokens.to(tab.device).long() - m * vw
        inside = (t >= 0) & (t < vw)
        rows = tab[t.clamp(0, vw - 1)]
        parts.append(torch.where(inside[..., None], rows,
                                 torch.zeros((), dtype=rows.dtype,
                                             device=rows.device)))
    return fold_list(parts, shards.first)


def chunk_ce(model, shards, xc, lc, *heads) -> torch.Tensor:
    """One cross-entropy chunk over the vocabulary's shards: ``heads``
    are the shards' (d, V/M) slices of the head.  One shard runs the
    unsharded chunk; more combine each shard's logsumexp (the max
    across shards first) and its gold logit (a token's label in another
    shard's range adds 0 there), folded in shard order."""
    cd = model.compute_dtype
    if len(heads) == 1:
        return model._chunk_ce(xc, lc, heads[0].to(cd))
    cap = model.cfg.final_softcap
    n, first = len(heads), shards.first
    xs = broadcast(xc, shards.devices[:n])
    logits = [L.softcap((xs[m] @ heads[m].to(cd)).float(), cap)
              for m in range(n)]
    vw = heads[0].shape[1]
    mx = torch.stack([lg.detach().amax(dim=-1).to(first)
                      for lg in logits]).amax(dim=0)
    sums, golds = [], []
    for m, lg in enumerate(logits):
        sums.append(torch.exp(lg - mx.to(lg.device)[..., None]).sum(dim=-1))
        loc = lc.to(lg.device) - m * vw
        inside = (loc >= 0) & (loc < vw)
        g = torch.gather(lg, -1, loc.clamp(0, vw - 1)[..., None])[..., 0]
        golds.append(torch.where(inside, g, 0.0))
    logz = mx + torch.log(fold_list(sums, first))
    return torch.sum(logz - fold_list(golds, first))


# ---------------------------------------------------------------------------
# One data block's loss
# ---------------------------------------------------------------------------

class _RecomputeHere(torch.autograd.Function):
    """The identity on a recomputed region's outputs, whose backward
    unpacks a tensor the region saved, so the region is recomputed
    there.  Autograd runs each device's nodes on that device's thread,
    and ``torch.utils.checkpoint`` recomputes a region at its first
    unpack without a lock: two shards' threads reaching one region at
    once would recompute it twice, interleaved.  The outputs are on the
    block's first device, so the recomputation runs on its thread
    before any of the region's gradients reaches another device."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.save_for_backward(xs[0])
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.saved_tensors   # noqa: B018 (the unpack recomputes)
        return grads


def _chunk_here(*args):
    """``chunk_ce`` as a recomputed region (:class:`_RecomputeHere`)."""
    return _RecomputeHere.apply(chunk_ce(*args))[0]


def _block(model, kind, pv, x, positions, layer_pos, shards):
    """One attention block (and its MLP or MoE FFN) of a data block."""
    if kind not in (ATTN, ATTN_LOCAL):
        raise ValueError(kind)
    cfg = model.cfg
    h = L.rms_norm(x, _one(pv["norm1"], shards), cfg.rms_eps)
    window = cfg.sliding_window if kind == ATTN_LOCAL else 0
    x = x + attention(cfg, pv["core"], h, positions, window, shards)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ffn" in pv:
        hf = L.rms_norm(x, _one(pv["norm2"], shards), cfg.rms_eps)
        if _is_moe_layer(cfg, layer_pos):
            out, aux = moe(cfg, pv["ffn"], hf, shards)
        else:
            out = mlp(pv["ffn"], hf, shards)
        x = x + out
    return x, aux


def block_loss(model, views, batch, block: dict, n_tokens: int):
    """One data block's (cross-entropy summed over its tokens and
    divided by the whole batch's ``n_tokens``, aux loss summed over its
    MoE layers), float32 scalars on its first shard."""
    cfg = model.cfg
    shards = Shards(model.mesh, block)
    first = shards.first
    tokens = batch["tokens"]
    labels = batch.get("labels", tokens).long()
    b, s = tokens.shape
    chunk = min(CE_CHUNK, s)
    if s % chunk:
        raise ValueError(f"{s} tokens do not split into chunks of {chunk}")
    n_chunks = s // chunk
    nv = shards.split(cfg.vocab_size)
    vw = cfg.vocab_size // nv
    vr = [(m * vw, (m + 1) * vw) for m in range(nv)]
    cs = shards.coords[:nv]
    # the vocabulary's reads, each piece broadcast once to all of them
    if cfg.tie_embeddings:
        got = take(views["embed"], [(c, (r, None)) for c, r in zip(cs, vr)]
                   * (1 + n_chunks))
        tables = got[:nv]
        heads = [[t.T for t in got[nv * (i + 1):nv * (i + 2)]]
                 for i in range(n_chunks)]
    else:
        tables = take(views["embed"], [(c, (r, None))
                                       for c, r in zip(cs, vr)])
        got = take(views["lm_head"], [(c, (None, r)) for c, r in
                                      zip(cs, vr)] * n_chunks)
        heads = [got[nv * i:nv * (i + 1)] for i in range(n_chunks)]
    x = lookup(tables, tokens, shards).to(model.compute_dtype)
    positions = model._positions(batch, s, device=first)
    remat = cfg.remat and torch.is_grad_enabled()

    def group(gi, x, aux_sum):
        for p_idx, kind in enumerate(model.pattern):
            pv = tree_map(lambda v: v.group(gi),
                          views["layers"][f"pos{p_idx}"])
            x, aux = _block(model, kind, pv, x, positions, p_idx, shards)
            aux_sum = aux_sum + aux
        return _RecomputeHere.apply(x, aux_sum)

    aux = torch.zeros((), dtype=torch.float32, device=first)
    for gi in range(model.n_groups):
        x, aux = (recompute_group(group, gi, x, aux) if remat
                  else group(gi, x, aux))
    x = L.rms_norm(x, _one(views["final_norm"], shards), cfg.rms_eps)
    total = torch.zeros((), dtype=torch.float32, device=first)
    for i in range(n_chunks):
        args = (model, shards, x[:, i * chunk:(i + 1) * chunk],
                labels[:, i * chunk:(i + 1) * chunk], *heads[i])
        total = total + (_recompute(_chunk_here, *args)
                         if torch.is_grad_enabled() else chunk_ce(*args))
    return total / n_tokens, aux


def _blocks_run(model, params, batch, trainable):
    """Each data block's (views, ce part, aux) in block order."""
    refuse(model)
    n_tokens = batch["tokens"].shape[0] * batch["tokens"].shape[1]
    for blk, rows in data_blocks(model, batch):
        views = block_views(model, params, blk, trainable=trainable)
        dev = Shards(model.mesh, blk).first
        ce, aux = block_loss(model, views, block_batch(batch, rows, dev),
                             blk, n_tokens)
        yield views, ce, aux


def forward_train(model, params, batch):
    """``Model.forward_train`` on ``model.mesh`` -> (loss, {"ce",
    "aux"}) on the mesh's first device: the blocks' cross-entropy folded
    in block order plus the first block's aux loss.  Train through
    ``train.loop.loss_and_grads``: differentiated here, a piece several
    blocks read sums their gradients in autograd's order."""
    first = model.mesh.device
    ces, aux0 = [], None
    for _, ce, aux in _blocks_run(model, params, batch, False):
        ces.append(ce)
        aux0 = aux if aux0 is None else aux0
    ce = fold_list(ces, first)
    aux0 = aux0.to(first)
    return ce + aux0, {"ce": ce, "aux": aux0}


def loss_and_grads(model, params, batch):
    """``train.loop.loss_and_grads`` on ``model.mesh`` -> (loss, metrics,
    grads): each data block's backward on its own graph, from detached
    pieces of the blocks it reads; a piece's gradients move to its
    owner's device and fold in block order there.  A :class:`Placed`
    leaf's gradient is a Placed of its owners' blocks, a tensor leaf's
    a tensor where it is."""
    first = model.mesh.device
    acc = {}
    ces, aux0 = [], None
    n_blocks = len(data_blocks(model, batch))
    for views, ce, aux in _blocks_run(model, params, batch, True):
        loss_b = ce + aux / n_blocks
        keys, leaves = [], []
        for path, v in _view_items(views):
            for idx in sorted(v.pieces):
                p = v.pieces[idx]
                group = p if isinstance(p, list) else [p]
                keys.append((path, idx, isinstance(p, list), len(group)))
                leaves.extend(group)
        grads = list(torch.autograd.grad(loss_b, leaves, allow_unused=True))
        for (path, idx, stacked, n), got in _chunks(keys, leaves, grads):
            gs = [torch.zeros_like(t) if g is None else g
                  for t, g in got]
            g = torch.stack(gs) if stacked else gs[0]
            key = (path, idx)
            if key in acc:
                acc[key] = acc[key] + g.to(acc[key].device)
            else:
                acc[key] = g.to(_owner_device(params, path, idx))
        del grads, leaves
        ces.append(ce.detach())
        aux0 = aux.detach() if aux0 is None else aux0
    ce = fold_list(ces, first)
    aux0 = aux0.to(first)

    def grad(path, leaf):
        if isinstance(leaf, Placed):
            return leaf.with_owners([acc[path, idx]
                                     for idx in leaf.indices()])
        return acc[path, (0,) * leaf.dim()]
    return (ce + aux0, {"ce": ce, "aux": aux0},
            tree_map(grad, params, path=()))


def _view_items(views):
    out = []
    tree_map(lambda path, v: out.append((path, v)), views, path=())
    return out


def _chunks(keys, leaves, grads):
    at = 0
    for key in keys:
        n = key[3]
        yield key, list(zip(leaves[at:at + n], grads[at:at + n]))
        at += n


def _owner_device(params, path, idx):
    leaf = params
    for k in path:
        leaf = leaf[k]
    return leaf.owner(idx).device if isinstance(leaf, Placed) \
        else leaf.device


def param_count(model) -> int:
    """The model's parameter count, from its specs."""
    import math
    return sum(math.prod(s.shape) for s in tree_leaves(model.specs()))
