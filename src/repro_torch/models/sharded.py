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
    shard stores), on B9 per shard, then its rows of ``wo``; causal, or
    not (whisper's encoder), or whisper's cross-attention on the
    encoder's output; M-RoPE positions (qwen2-vl) reach each shard;
  * the MLP's hidden dim: ``w_gate``/``w_up`` columns, ``w_down`` rows
    (the sLSTM's ``up_gate``/``up``/``down`` the same);
  * Mamba's ``d_in`` channels, B10 per shard on its channels (``x_proj``'s
    row products folded and sent back, so B and C are one tensor);
  * mLSTM by whole heads (its gates' row products folded); the sLSTM's
    recurrence on the first shard (the plan replicates its weights);
  * MoE: each shard's experts and slice of the shared experts
    (``moe._moe_local``, split as the expert-parallel ``moe_apply``
    splits them), the capacity that of the block's tokens, the router
    rounded to the activations' dtype; the aux loss is the model-0
    shard's;
  * the vocabulary: the embedding a masked lookup of each shard's rows
    (qwen2-vl's first positions then take the vision rows), each
    cross-entropy chunk each shard's logits, their logsumexp and gold
    logit combined.

In a projection whose columns are ``[a | b]`` side by side (Mamba's
``in_proj``, the mLSTM's ``up``) the plan's column blocks are storage,
not compute: shard m takes its ``a`` columns ``c`` and its ``b`` columns
``d_in + c`` from whichever blocks hold them.  Partial sums fold in
shard order on the first device (``sharding.fold_list``); a tensor
several shards read goes to them through one ``sharding.broadcast``
(whisper's encoder output once a data block, for every decoder layer),
whose backward folds in shard order.  A split the shards do not divide
(heads, d_ff, channels, vocabulary) runs whole on the first shard.
``loss_and_grads`` takes each block's gradients from detached per-block
pieces and folds the blocks in block order on each piece's owner; the
loss is the blocks' cross-entropy folded plus the first block's aux
(the reference's replicated value), and the aux's gradient the blocks'
mean (its ``shard_map`` transpose).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ATTN, ATTN_LOCAL, MAMBA, MLSTM, SLSTM
from repro_torch.distributed.sharding import (Placed, block_view, broadcast,
                                              fold_list, shard_coords, take)
from repro_torch.kernels.ssm_scan import selective_scan
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import xlstm as X
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.transformer import (CE_CHUNK, _is_moe_layer,
                                            _recompute, gather_dtype,
                                            recompute_group)

DP_AXES = ("pod", "data")


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
    reads them (``sharding.block_view``; the decoder's and the encoder's
    layers stacked by group); a decoder leaf that
    ``transformer.gather_dtype`` casts (``REPRO_GATHER_BF16=1``) is read
    in the compute dtype, each piece cast as it is sent (the encoder's
    are read as stored, as ``Model._encode`` reads them)."""
    def view(path, leaf):
        stacked = path[0] == "layers" or path[:2] == ("encoder", "layers")
        v = block_view(leaf, model.mesh, block, trainable=trainable,
                       stacked=stacked)
        to = gather_dtype(len(v.shape), model.compute_dtype) \
            if path[0] == "layers" else None
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


def attention(cfg, pv, h, positions, window, shards, *, causal=True,
              enc=None):
    """Self-attention of ``h`` (B, S, d) on the first shard (causal, or
    not: whisper's encoder), or with ``enc`` (each shard's copy of the
    encoder's output, :func:`broadcast` once a data block) whisper's
    cross-attention, its keys and values from ``enc`` -> the folded
    output there: each shard's ``layers.attention_apply`` on its heads'
    slices of the projections."""
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
        nkv_m = kv[m][1] - kv[m][0]
        sub = dataclasses.replace(cfg, num_heads=hq, head_dim=hd,
                                  num_kv_heads=nkv_m)
        p = {k: v[m] for k, v in got.items()}
        cross = None
        if enc is not None:
            e, dt = enc[m], hs[m].dtype
            b, f, _ = e.shape
            cross = tuple((e @ p[w].to(dt)).reshape(b, f, nkv_m, hd)
                          for w in ("wk", "wv"))
        out, _ = L.attention_apply(p, sub, hs[m], positions.to(dev),
                                   layer_window=window, causal=causal,
                                   cross_kv=cross)
        parts.append(out)
    return fold_list(parts, shards.first)


def mlp(pv, h, shards, names=("w_gate", "w_up", "w_down")):
    """SwiGLU over the hidden dim's shards (each shard's
    ``layers.mlp_apply``) -> the folded output; ``names`` are the
    leaves' (the sLSTM's FFN: ``up_gate``, ``up``, ``down``)."""
    f = pv[names[0]].shape[1]
    n = shards.split(f)
    fw = f // n
    cs, r = shards.coords[:n], [(m * fw, (m + 1) * fw) for m in range(n)]
    w = [take(pv[k], [(c, (None, x) if k != names[2] else (x, None))
                      for c, x in zip(cs, r)]) for k in names]
    hs = broadcast(h, shards.devices[:n])
    return fold_list([L.mlp_apply({"w_gate": w[0][m], "w_up": w[1][m],
                                   "w_down": w[2][m]}, hs[m])
                      for m in range(n)], shards.first)


def cut(view, cs, ranges, dim):
    """Each consumer's ``ranges[i]`` of ``view`` along ``dim`` (the
    other dims whole) at mesh coordinate ``cs[i]``, in one :func:`take`
    (a shard may appear twice: ``[xs | z]``'s two column ranges)."""
    nd = len(view.shape)
    return take(view, [(c, tuple(r if d == dim else None
                                 for d in range(nd)))
                       for c, r in zip(cs, ranges)])


def mamba(cfg, pv, h, shards):
    """The Mamba block over the ``d_in`` channels' shards: shard m owns
    channels ``[m d_in/M, (m+1) d_in/M)``, its ``xs`` and ``z`` columns
    of ``in_proj`` (``c`` and ``d_in + c``, from whichever blocks hold
    them), its conv, ``dt_proj`` columns and rows of ``dt_bias``,
    ``A_log``, ``D``, ``x_proj`` and ``out_proj``.  ``x_proj``'s row
    products fold in shard order on the first shard and go back through
    one :func:`broadcast` (dt's low-rank input, B and C the same tensor
    on every shard); B10 runs once a shard on its channels; ``out_proj``'s
    row products fold -> the output on the first shard."""
    d_in = cfg.mamba_expand * cfg.d_model
    n_st = cfg.mamba_d_state
    n = shards.split(d_in)
    w = d_in // n
    cr = [(m * w, (m + 1) * w) for m in range(n)]
    cs, devs = shards.coords[:n], shards.devices[:n]
    win = cut(pv["in_proj"], cs * 2,
              cr + [(d_in + a, d_in + e) for a, e in cr], 1)
    cw, dtp = (cut(pv[k], cs, cr, 1) for k in ("conv_w", "dt_proj"))
    cb, dtb, dd, xp, alog, wo = (
        cut(pv[k], cs, cr, 0)
        for k in ("conv_b", "dt_bias", "D", "x_proj", "A_log", "out_proj"))
    hs = broadcast(h, devs)
    dt = h.dtype
    b, s, _ = h.shape
    xs, z, parts = [], [], []
    for m in range(n):
        x_m = hs[m] @ win[m].to(dt)
        z.append(hs[m] @ win[n + m].to(dt))
        pad = torch.zeros((b, cfg.mamba_d_conv - 1, w), dtype=dt,
                          device=x_m.device)
        x_m = F.silu(M.causal_conv(torch.cat([pad, x_m], dim=1), cw[m],
                                   cb[m], s))
        xs.append(x_m)
        parts.append(x_m @ xp[m].to(dt))
    projs = broadcast(fold_list(parts, shards.first), devs)
    outs = []
    for m in range(n):
        dt_m, b_mat, c_mat, a_m = M.scan_inputs(projs[m], dtp[m], dtb[m],
                                                alog[m], n_st)
        h0 = torch.zeros((b, w, n_st), dtype=torch.float32,
                         device=xs[m].device)
        y, _ = selective_scan(dt_m, xs[m], b_mat, c_mat, a_m, h0)
        outs.append(M.ssm_out(y, xs[m], z[m], dd[m], wo[m]))
    return fold_list(outs, shards.first)


def mlstm(cfg, pv, h, shards):
    """The mLSTM block by whole heads: shard m owns heads ``m H/M ..``
    (channels ``h dh .. (h+1) dh`` of ``xi``), its ``xi`` and ``z``
    columns of ``up``, its heads' ``wq``/``wk``/``wv`` and its rows of
    ``down``.  The gates contract over every channel: each shard's
    row products of ``w_igate``/``w_fgate`` fold in shard order on the
    first shard, the biases are added there and the sums go back
    through one :func:`broadcast`; each shard runs the parallel form on
    its heads; ``down``'s row products fold -> the output on the first
    shard.  Shards that do not divide H: the block whole on the first."""
    d = cfg.d_model
    nh = cfg.num_heads
    d_in = int(cfg.xlstm_proj_factor * d)
    dh = d_in // nh
    n = shards.split(nh)
    hl, w = nh // n, d_in // n
    cr = [(m * w, (m + 1) * w) for m in range(n)]
    hr = [(m * hl, (m + 1) * hl) for m in range(n)]
    cs, devs = shards.coords[:n], shards.devices[:n]
    f32 = torch.float32
    up = cut(pv["up"], cs * 2, cr + [(d_in + a, d_in + e) for a, e in cr],
             1)
    wq, wk, wv = (cut(pv[k], cs, hr, 0) for k in ("wq", "wk", "wv"))
    wi, wf, down = (cut(pv[k], cs, cr, 0)
                    for k in ("w_igate", "w_fgate", "down"))
    hs = broadcast(h, devs)
    dt = h.dtype
    b, s, _ = h.shape
    xi, z, parts = [], [], []
    for m in range(n):
        x_m = hs[m] @ up[m].to(dt)
        z.append(hs[m] @ up[n + m].to(dt))
        xi.append(x_m)
        xf = x_m.to(f32)
        parts.append(torch.cat([xf @ wi[m].to(f32), xf @ wf[m].to(f32)],
                               dim=-1))
    bias = torch.cat([_one(pv["b_igate"], shards),
                      _one(pv["b_fgate"], shards)]).to(f32)
    gates = broadcast(fold_list(parts, shards.first) + bias, devs)
    scale = X._inv_sqrt(dh, h.device)
    outs = []
    for m in range(n):
        xh = xi[m].reshape(b, s, hl, dh)
        q, k, v = (torch.einsum("bshd,hde->bhse", xh, t[m].to(dt)).to(f32)
                   for t in (wq, wk, wv))
        g = gates[m].transpose(1, 2)                    # (B, 2H, S)
        ig, fg = g[:, hr[m][0]:hr[m][1]], g[:, nh + hr[m][0]:nh + hr[m][1]]
        y, _ = X.mlstm_parallel(q, k, v, ig, fg, scale.to(xh.device))
        outs.append(X.mlstm_out(y, z[m], down[m]))
    return fold_list(outs, shards.first)


def slstm(cfg, pv, h, shards):
    """The sLSTM block: its recurrence (``w_in``, ``b_in`` and ``r_*``,
    replicated by the plan) on the first shard, a token at a time; its
    gated FFN over the shards as :func:`mlp`."""
    p = {k: _one(pv[k], shards) for k in ("w_in", "b_in", "r_z", "r_i",
                                          "r_f", "r_o")}
    y, _ = X.slstm_core(p, cfg, h)
    return mlp(pv, y, shards, names=("up_gate", "up", "down"))


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


def _block(model, kind, pv, x, positions, layer_pos, shards, *,
           causal=True, enc=None):
    """One block of a data block: its core (attention, Mamba, mLSTM or
    sLSTM), whisper's cross-attention on ``enc`` where the block has
    one, then its MLP or MoE FFN -> (x, aux)."""
    cfg = model.cfg
    h = L.rms_norm(x, _one(pv["norm1"], shards), cfg.rms_eps)
    if kind in (ATTN, ATTN_LOCAL):
        window = cfg.sliding_window if kind == ATTN_LOCAL else 0
        out = attention(cfg, pv["core"], h, positions, window, shards,
                        causal=causal)
    elif kind == MAMBA:
        out = mamba(cfg, pv["core"], h, shards)
    elif kind == MLSTM:
        out = mlstm(cfg, pv["core"], h, shards)
    elif kind == SLSTM:
        out = slstm(cfg, pv["core"], h, shards)
    else:
        raise ValueError(kind)
    x = x + out
    if enc is not None and "cross" in pv:
        hc = L.rms_norm(x, _one(pv["cross_norm"], shards), cfg.rms_eps)
        x = x + attention(cfg, pv["cross"], hc, positions, 0, shards,
                          enc=enc)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ffn" in pv:
        hf = L.rms_norm(x, _one(pv["norm2"], shards), cfg.rms_eps)
        if _is_moe_layer(cfg, layer_pos):
            out, aux = moe(cfg, pv["ffn"], hf, shards)
        else:
            out = mlp(pv["ffn"], hf, shards)
        x = x + out
    return x, aux


def encode(model, views, batch, shards) -> torch.Tensor:
    """Whisper's encoder on a data block (``Model._encode``): the audio
    frames plus ``pos_embed`` (gathered whole on the first shard), each
    encoder layer's non-causal attention and MLP over the shards, the
    final norm -> (B, F, d) on the first shard."""
    cfg = model.cfg
    enc = views["encoder"]
    cd = model.compute_dtype
    x = batch["audio_frames"].to(cd) + _one(enc["pos_embed"],
                                            shards).to(cd)[None]
    b, f, _ = x.shape
    pos = torch.arange(f, dtype=torch.int32,
                       device=x.device)[None].expand(b, f)
    for gi in range(cfg.encoder_layers):
        pv = tree_map(lambda v: v.group(gi), enc["layers"]["pos0"])
        x, _ = _block(model, ATTN, pv, x, pos, 0, shards, causal=False)
    return L.rms_norm(x, _one(enc["final_norm"], shards), cfg.rms_eps)


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
    if cfg.family == "vlm" and "vision_embeds" in batch:
        # the first n_vis positions take the vision rows (Model._embed)
        ve = batch["vision_embeds"].to(model.compute_dtype)
        x = torch.cat([ve, x[:, ve.shape[1]:]], dim=1)
    positions = model._positions(batch, s, device=first)
    # the encoder's output, sent to the shards once for every decoder
    # layer's cross-attention: its gradients fold in shard order
    enc = (broadcast(encode(model, views, batch, shards), shards.devices)
           if cfg.encoder_layers else None)
    remat = cfg.remat and torch.is_grad_enabled()

    def group(gi, x, aux_sum):
        for p_idx, kind in enumerate(model.pattern):
            pv = tree_map(lambda v: v.group(gi),
                          views["layers"][f"pos{p_idx}"])
            x, aux = _block(model, kind, pv, x, positions, p_idx, shards,
                            enc=enc)
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
    if model.cfg.moe is not None and "model" not in model.mesh.axis_names:
        raise ValueError("MoE training on a mesh needs a 'model' axis for "
                         "its experts")
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
