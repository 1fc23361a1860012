"""Config-driven model: dense / MoE / hybrid (Mamba) / xLSTM / enc-dec
(whisper) / VLM (qwen2-vl) — port of ``repro/models/transformer.py``.

One :class:`Model` covers all ten configurations of
``repro_torch.configs``.  Layers are stacked per *pattern position*, as
in the reference: every parameter of pattern position ``p`` carries a
leading group dimension, so weights carry across 1:1.  The reference's
``lax.scan`` over pattern groups is a Python loop over that dimension
here.

Entry points:
  * ``forward_train(params, batch) -> (loss, {"ce", "aux"})``
  * ``prefill(params, batch, cache) -> (logits, cache)``
  * ``decode_step(params, batch, cache, pos) -> (logits, cache)``
The last two write ``cache`` in place (the reference returns a new one)
and return it.  ``batch`` may carry ``audio_frames`` (whisper: the
encoder runs in prefill and its cross-attention keys/values go into the
cache) and ``vision_embeds`` (qwen2-vl: they replace the first
positions' token embeddings).  ``forward_train`` is differentiable with
autograd: with ``cfg.remat`` each pattern group is recomputed in the
backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` of its scan body), and each 512-token chunk of the
cross-entropy too.  On the card attention is B9 and a Mamba block's
scan is B10, each with its backward kernel.

``Model.mesh`` (None, or a ``distributed.sharding.Mesh`` set by the
caller, as the reference's distribution layer sets it) reaches every
attention layer (decode sequence-sharded over ``"model"``) and every
MoE layer (experts over ``"model"``, tokens over the data axes); the
rest runs on the parameters' device.  ``init_cache`` places the cache
by the plan's ``cache_shardings`` on a mesh with a ``"model"`` axis.
``forward_train`` with a mesh is ``models.sharded``'s: data-parallel,
tensor-parallel over ``"model"``, FSDP when the plan says, on
parameters placed by ``ShardingPlan.param_shardings`` (or whole).

Two environment knobs, read at each call as the reference reads them:
``REPRO_GATHER_BF16=1`` casts every stacked leaf of 3 or more dims to
the compute dtype before the stack runs (training, prefill and decode),
and ``REPRO_REMAT_POLICY=dots`` keeps the plain matrix products of each
recomputed group for the backward (any other value recomputes them).
"""
from __future__ import annotations

import functools
import os

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import (ArchConfig, ATTN, ATTN_LOCAL, MAMBA,
                                      MLSTM, SLSTM)
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Placed, make_plan, placed_zeros
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import xlstm as X
from repro_torch.models.layers import ParamSpec, torch_dtype, tree_map

# Weights that every use casts to the compute dtype: ``Model.init`` may
# store these cast once (the experts' and shared experts' w_gate / w_up /
# w_down among them).  Norm weights (``rms_norm`` reads them in float32)
# and the leaves the reference reads in float32 stay in the parameter
# dtype: dt_proj / dt_bias / A_log (Mamba), the MoE router, the mLSTM
# gates (w_igate, w_fgate, b_igate, b_fgate) and the sLSTM's b_in and
# recurrent r_z / r_i / r_f / r_o.
COMPUTE_CAST = frozenset({"embed", "lm_head", "wq", "wk", "wv", "wo", "bq",
                          "bk", "bv", "w_gate", "w_up", "w_down", "in_proj",
                          "conv_w", "conv_b", "x_proj", "D", "out_proj",
                          "up", "down", "up_gate", "w_in", "pos_embed"})


CE_CHUNK = 512              # tokens of the cross-entropy's logits at once


def _recompute(fn, *args):
    """``fn(*args)``, recomputed in the backward instead of saved."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The reference's ``dots_with_no_batch_dims_saveable``: keep plain
    matrix products, recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def recompute_group(fn, *args):
    """A pattern group's remat: everything recomputed in the backward,
    or with ``REPRO_REMAT_POLICY=dots`` all but the plain matrix
    products (``torch.utils.checkpoint``'s selective contexts)."""
    if os.environ.get("REPRO_REMAT_POLICY", "nothing") != "dots":
        return _recompute(fn, *args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts, _save_dots))


def gather_dtype(ndim: int, dtype):
    """``REPRO_GATHER_BF16=1``: the dtype a stacked leaf of ``ndim``
    dims is read in (``dtype`` for 3 or more dims), else None (as
    stored)."""
    if ndim >= 3 and os.environ.get("REPRO_GATHER_BF16") == "1":
        return dtype
    return None


def gather_cast(stacked, dtype):
    """Every stacked leaf that :func:`gather_dtype` casts, in ``dtype``
    (a list of per-group views counts its group dim)."""
    def cast(w):
        grouped = isinstance(w, list)
        to = gather_dtype(w[0].dim() + 1 if grouped else w.dim(), dtype)
        if to is None:
            return w
        return [g.to(to) for g in w] if grouped else w.to(to)
    return tree_map(cast, stacked)


def _block_specs(cfg: ArchConfig, kind: str, layer_pos: int, *,
                 cross: bool = False):
    d = cfg.d_model
    specs = {"norm1": ParamSpec((d,), ("embed",), init="zeros")}
    if kind in (ATTN, ATTN_LOCAL):
        specs["core"] = L.attention_specs(cfg)
    elif kind == MAMBA:
        specs["core"] = M.mamba_specs(cfg)
    elif kind == MLSTM:
        specs["core"] = X.mlstm_specs(cfg)
    elif kind == SLSTM:
        specs["core"] = X.slstm_specs(cfg)
    else:
        raise ValueError(kind)
    if cross:
        specs["cross_norm"] = ParamSpec((d,), ("embed",), init="zeros")
        specs["cross"] = L.attention_specs(cfg)
    if _has_ffn(cfg, kind):
        specs["norm2"] = ParamSpec((d,), ("embed",), init="zeros")
        if _is_moe_layer(cfg, layer_pos):
            specs["ffn"] = MOE.moe_specs(cfg)
        else:
            specs["ffn"] = L.mlp_specs(cfg)
    return specs


def _has_ffn(cfg, kind):
    return cfg.d_ff > 0 and kind in (ATTN, ATTN_LOCAL, MAMBA)


def _is_moe_layer(cfg, layer_pos):
    return cfg.moe is not None and layer_pos % cfg.moe_every == 0


def _stack_specs(specs, n):
    """Prefix every ParamSpec shape with the group dimension n."""
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init),
        specs)


def _group(tree, gi):
    """Views of group ``gi`` of a stacked tree (parameters or caches)."""
    return tree_map(lambda t: t[gi], tree)


def _write_back(cache, new):
    """Copy a block's new states into its cache views (in place, a
    placed leaf block by block); the attention cache is already written
    and comes back as itself."""
    for key, val in new.items():
        if isinstance(val, dict):
            _write_back(cache[key], val)
        elif val is not cache[key]:
            cache[key].copy_(val)


def _read_view(cache, device):
    """A group's cache as a block reads it: a placed attention cache
    stays placed (written and read block by block); any other placed
    leaf (recurrent states, whisper's cross keys) gathered on
    ``device``."""
    if cache is None:
        return None
    out = {}
    for key, val in cache.items():
        if key == "kv":
            out[key] = val
        elif isinstance(val, dict):
            out[key] = _read_view(val, device)
        else:
            out[key] = val.full(device) if isinstance(val, Placed) else val
    return out


class Model:
    mesh = None     # set by the caller (None: every layer on one device)

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.pattern = tuple(cfg.block_pattern)
        if cfg.num_layers % len(self.pattern):
            raise ValueError(f"{cfg.num_layers} layers not divisible by "
                             f"pattern {self.pattern}")
        self.n_groups = cfg.num_layers // len(self.pattern)
        if cfg.moe is not None and len(self.pattern) % cfg.moe_every \
                and cfg.moe_every != 1:
            raise ValueError(f"moe_every {cfg.moe_every} does not divide "
                             f"the pattern {self.pattern}")
        self.compute_dtype = torch_dtype(cfg.compute_dtype)

    # ------------------------------------------------------------------
    # Parameter specs / init
    # ------------------------------------------------------------------
    def specs(self):
        cfg = self.cfg
        d = cfg.d_model
        specs = {
            "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "embed")),
            "final_norm": ParamSpec((d,), ("embed",), init="zeros"),
            "layers": {},
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = ParamSpec((d, cfg.vocab_size),
                                         ("embed", "vocab"))
        cross = cfg.encoder_layers > 0
        for p_idx, kind in enumerate(self.pattern):
            specs["layers"][f"pos{p_idx}"] = _stack_specs(
                _block_specs(cfg, kind, p_idx, cross=cross), self.n_groups)
        if cfg.encoder_layers:
            specs["encoder"] = {
                "pos_embed": ParamSpec((cfg.num_audio_frames, d),
                                       (None, "embed")),
                "final_norm": ParamSpec((d,), ("embed",), init="zeros"),
                "layers": {"pos0": _stack_specs(
                    _block_specs(cfg, ATTN, 0), cfg.encoder_layers)},
            }
        return specs

    def param_structs(self):
        """Each parameter's shape and dtype (``meta`` tensors)."""
        return L.param_structs(self.specs(), self.cfg.param_dtype)

    def param_logical_axes(self):
        """Each parameter's logical axes, for ``ShardingPlan``."""
        return L.param_axes(self.specs())

    def init(self, seed: int = 0, *, device=None, cast_weights=False):
        """Parameters in ``param_dtype`` with the reference's shapes,
        init kinds and scales, drawn from a ``torch.Generator`` seeded
        with ``seed`` on ``device`` (None means CUDA).

        ``cast_weights=True`` stores each weight of ``COMPUTE_CAST`` in
        the compute dtype, cast as it is drawn (every use casts it so),
        so a full-size model never holds the float32 tree and its cast
        copy at once (a leaf too large to draw whole in float32 beside
        the rest is drawn a slice of its leading dimension at a time);
        the others keep ``param_dtype``.
        """
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        store_dtype = None
        if cast_weights:
            cd = self.compute_dtype

            def store_dtype(path):
                return cd if path[-1] in COMPUTE_CAST else None
        return L.init_params(self.specs(), gen, self.cfg.param_dtype,
                             store_dtype=store_dtype)

    # ------------------------------------------------------------------
    # Block application
    # ------------------------------------------------------------------
    def _apply_block(self, kind, p, x, positions, *, layer_pos, cache=None,
                     cache_index=None, enc_out=None, causal=True,
                     with_aux=False):
        """One block -> (x, new_cache, aux): ``aux`` is the MoE aux loss
        (a float32 scalar; zero without experts, None unless
        ``with_aux``)."""
        cfg = self.cfg
        aux = (torch.zeros((), dtype=torch.float32, device=x.device)
               if with_aux else None)
        new_cache = {}
        h = L.rms_norm(x, p["norm1"], cfg.rms_eps)
        if kind in (ATTN, ATTN_LOCAL):
            window = cfg.sliding_window if kind == ATTN_LOCAL else 0
            kvc = cache.get("kv") if cache else None
            out, nkv = L.attention_apply(
                p["core"], cfg, h, positions, layer_window=window,
                kv_cache=kvc, cache_index=cache_index, causal=causal,
                mesh=self.mesh)
            if nkv is not None:
                new_cache["kv"] = nkv
        elif kind == MAMBA:
            out, st = M.mamba_apply(
                p["core"], cfg, h,
                ssm_state=cache.get("ssm") if cache else None,
                conv_state=cache.get("conv") if cache else None)
            if cache is not None:
                new_cache.update(st)
        elif kind == MLSTM:
            out, st = X.mlstm_apply(
                p["core"], cfg, h,
                state=cache.get("mlstm") if cache else None)
            if cache is not None:
                new_cache["mlstm"] = st
        elif kind == SLSTM:
            out, st = X.slstm_apply(
                p["core"], cfg, h,
                state=cache.get("slstm") if cache else None)
            if cache is not None:
                new_cache["slstm"] = st
        else:
            raise ValueError(kind)
        x = x + out

        has_cached_cross = cache is not None and "cross_k" in cache
        if "cross" in p and (enc_out is not None or has_cached_cross):
            hc = L.rms_norm(x, p["cross_norm"], cfg.rms_eps)
            dt = hc.dtype
            if has_cached_cross and enc_out is None:
                ck, cv = cache["cross_k"], cache["cross_v"]
            else:
                b, f, _ = enc_out.shape
                ck = (enc_out @ p["cross"]["wk"].to(dt)).reshape(
                    b, f, cfg.num_kv_heads, cfg.resolved_head_dim)
                cv = (enc_out @ p["cross"]["wv"].to(dt)).reshape(
                    b, f, cfg.num_kv_heads, cfg.resolved_head_dim)
            out, _ = L.attention_apply(p["cross"], cfg, hc, positions,
                                       cross_kv=(ck.to(dt), cv.to(dt)))
            if cache is not None:
                new_cache["cross_k"], new_cache["cross_v"] = ck, cv
            x = x + out

        if "ffn" in p:
            hf = L.rms_norm(x, p["norm2"], cfg.rms_eps)
            if _is_moe_layer(cfg, layer_pos):
                out, a = MOE.moe_apply(p["ffn"], cfg, hf, mesh=self.mesh,
                                       with_aux=with_aux)
                if with_aux:
                    aux = aux + a
            else:
                out = L.mlp_apply(p["ffn"], hf)
            x = x + out
        return x, new_cache, aux

    # ------------------------------------------------------------------
    # Stack runner
    # ------------------------------------------------------------------
    def _run_stack(self, stacked_params, x, positions, *, caches=None,
                   cache_index=None, enc_out=None, with_aux=False):
        """-> (x, aux, caches): ``aux`` summed over the blocks in the
        reference's order (None unless ``with_aux``).  With ``cfg.remat``
        each pattern group is recomputed in the backward when autograd
        records and no cache is written."""
        remat = (self.cfg.remat and caches is None
                 and torch.is_grad_enabled())
        aux_sum = (torch.zeros((), dtype=torch.float32, device=x.device)
                   if with_aux else None)
        stacked_params = gather_cast(stacked_params, self.compute_dtype)

        def group(gi, x, aux_sum):
            for p_idx, kind in enumerate(self.pattern):
                key = f"pos{p_idx}"
                cg = (_group(caches[key], gi) if caches is not None
                      else None)
                x, nc, aux = self._apply_block(
                    kind, _group(stacked_params[key], gi), x, positions,
                    layer_pos=p_idx, cache=_read_view(cg, x.device),
                    cache_index=cache_index, enc_out=enc_out,
                    with_aux=with_aux)
                if cg is not None:
                    _write_back(cg, nc)
                if with_aux:
                    aux_sum = aux_sum + aux
            return x, aux_sum

        for gi in range(self.n_groups):
            if remat:
                x, aux_sum = recompute_group(group, gi, x, aux_sum)
            else:
                x, aux_sum = group(gi, x, aux_sum)
        return x, aux_sum, caches

    # ------------------------------------------------------------------
    # Embedding / unembedding
    # ------------------------------------------------------------------
    def _embed(self, params, batch):
        table = params["embed"]
        tokens = torch.as_tensor(batch["tokens"], device=table.device)
        # gather, then cast: the same values as casting the whole table
        x = table[tokens.long()].to(self.compute_dtype)
        if self.cfg.family == "vlm" and "vision_embeds" in batch:
            # the first n_vis positions take the vision rows
            ve = torch.as_tensor(batch["vision_embeds"],
                                 device=table.device).to(self.compute_dtype)
            n_vis = ve.shape[1]
            x = torch.cat([ve, x[:, n_vis:]], dim=1)
        return x

    def _positions(self, batch, seq, offset=0, device=None):
        cfg = self.cfg
        b = batch["tokens"].shape[0]
        if "positions" in batch:
            return torch.as_tensor(batch["positions"], device=device)
        pos = offset + torch.arange(seq, dtype=torch.int32,
                                    device=device)[None, :]
        pos = pos.expand(b, seq)
        if cfg.mrope_sections is not None:
            pos = pos[None].expand(3, b, seq)
        return pos

    def _head(self, params):
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"]).to(self.compute_dtype)

    def _logits(self, params, x):
        return L.softcap((x @ self._head(params)).float(),
                         self.cfg.final_softcap)

    def _chunk_ce(self, xc, lc, head):
        """Sum over a chunk's tokens of logsumexp - gold logit."""
        logits = L.softcap((xc @ head).float(), self.cfg.final_softcap)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None])[..., 0]
        return torch.sum(logz - gold)

    def _ce_loss(self, params, x, labels):
        """The reference's chunked cross-entropy (``_logits`` with
        ``chunked_labels``): chunks of ``min(512, S)`` tokens, each
        chunk's logits recomputed in the backward, the sums added in
        chunk order and divided by B * S.  The gold logit is a gather
        (the reference's masked sum over the vocabulary: the same
        value)."""
        head = self._head(params)
        b, s, _ = x.shape
        chunk = min(CE_CHUNK, s)
        assert s % chunk == 0
        labels = torch.as_tensor(labels, device=x.device).long()
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, s, chunk):
            args = (x[:, i:i + chunk], labels[:, i:i + chunk], head)
            total = total + (_recompute(self._chunk_ce, *args)
                             if torch.is_grad_enabled()
                             else self._chunk_ce(*args))
        return total / (b * s)

    # ------------------------------------------------------------------
    # Encoder (whisper)
    # ------------------------------------------------------------------
    def _encode(self, params, batch):
        """The audio frames plus ``pos_embed`` through the encoder's
        layers (non-causal self-attention), then its final norm."""
        cfg = self.cfg
        enc = params["encoder"]
        cd = self.compute_dtype
        frames = torch.as_tensor(batch["audio_frames"],
                                 device=enc["pos_embed"].device).to(cd)
        x = frames + enc["pos_embed"].to(cd)[None]
        b, f, _ = x.shape
        pos = torch.arange(f, dtype=torch.int32,
                           device=x.device)[None].expand(b, f)
        for gi in range(cfg.encoder_layers):
            x, _, _ = self._apply_block(
                ATTN, _group(enc["layers"]["pos0"], gi), x, pos,
                layer_pos=0, causal=False)
        return L.rms_norm(x, enc["final_norm"], cfg.rms_eps)

    # ------------------------------------------------------------------
    # Public entry points
    # ------------------------------------------------------------------
    def forward_train(self, params, batch):
        """-> (loss, {"ce", "aux"}): the chunked cross-entropy of
        ``batch["labels"]`` (the tokens where there are none) plus the
        MoE aux loss (zero without experts), float32 scalars.  With
        ``mesh`` set, ``models.sharded.forward_train`` (every family:
        attention, MLP, MoE, Mamba, mLSTM, sLSTM, whisper's
        encoder-decoder, qwen2-vl's vision rows)."""
        if self.mesh is not None:
            from repro_torch.models import sharded
            return sharded.forward_train(self, params, batch)
        cfg = self.cfg
        x = self._embed(params, batch)
        positions = self._positions(batch, x.shape[1], device=x.device)
        enc_out = self._encode(params, batch) if cfg.encoder_layers else None
        x, aux, _ = self._run_stack(params["layers"], x, positions,
                                    enc_out=enc_out, with_aux=True)
        x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
        labels = batch.get("labels", batch["tokens"])
        ce = self._ce_loss(params, x, labels)
        loss = ce + aux
        return loss, {"ce": ce, "aux": aux}

    def cache_specs(self, batch_size, max_len):
        """{pos: {name: (shape, dtype)}} of the decode cache."""
        cfg = self.cfg
        h, nkv = cfg.resolved_head_dim, cfg.num_kv_heads
        cd = self.compute_dtype
        g = self.n_groups
        caches = {}
        for p_idx, kind in enumerate(self.pattern):
            c = {}
            if kind in (ATTN, ATTN_LOCAL):
                # sliding-window layers use a ring cache bounded by the
                # window (position p -> slot p % W)
                eff = max_len
                if kind == ATTN_LOCAL and cfg.sliding_window:
                    eff = min(max_len, cfg.sliding_window)
                c["kv"] = {"k": ((g, batch_size, eff, nkv, h), cd),
                           "v": ((g, batch_size, eff, nkv, h), cd)}
            elif kind == MAMBA:
                c.update({k: ((g,) + shape, dt) for k, (shape, dt)
                          in M.mamba_state_specs(cfg, batch_size).items()})
            elif kind == MLSTM:
                c["mlstm"] = {k: ((g,) + shape, dt) for k, (shape, dt)
                              in X.mlstm_state_specs(cfg,
                                                     batch_size).items()}
            elif kind == SLSTM:
                c["slstm"] = {k: ((g,) + shape, dt) for k, (shape, dt)
                              in X.slstm_state_specs(cfg,
                                                     batch_size).items()}
            if cfg.encoder_layers:
                f = cfg.num_audio_frames
                c["cross_k"] = ((g, batch_size, f, nkv, h), cd)
                c["cross_v"] = ((g, batch_size, f, nkv, h), cd)
            caches[f"pos{p_idx}"] = c
        return caches

    def init_cache(self, batch_size, max_len, *, device=None):
        """A zero cache on ``device`` (None means CUDA); with ``mesh``
        set and a ``"model"`` axis in it, each leaf placed by the plan's
        ``cache_shardings`` (``distributed.sharding.Placed``), so each
        decode shard reads the block on its own device."""
        dev = resolve_device(device)
        specs = self.cache_specs(batch_size, max_len)
        if self.mesh is None or "model" not in self.mesh.axis_names:
            return tree_map(
                lambda sd: torch.zeros(sd[0], dtype=sd[1], device=dev),
                specs)
        from repro_torch.models.sharded import param_count
        plan = make_plan(self.mesh, param_count(self))
        return tree_map(lambda sd, sh: placed_zeros(sh, sd[0], sd[1]),
                        specs, plan.cache_shardings(specs, batch_size))

    def prefill(self, params, batch, cache):
        """Full-sequence forward writing ``cache``; returns the last
        position's logits (B, 1, V) float32 and the cache."""
        cfg = self.cfg
        x = self._embed(params, batch)
        positions = self._positions(batch, x.shape[1], device=x.device)
        enc_out = self._encode(params, batch) if cfg.encoder_layers else None
        x, _, cache = self._run_stack(params["layers"], x, positions,
                                      caches=cache, cache_index=0,
                                      enc_out=enc_out)
        x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.rms_eps)
        return self._logits(params, x), cache

    def decode_step(self, params, batch, cache, pos):
        """batch["tokens"]: (B, 1); pos: an int (the current length) or a
        (B,) tensor of per-row positions."""
        cfg = self.cfg
        x = self._embed(params, batch)
        positions = self._positions(batch, 1, offset=pos, device=x.device)
        # the cross-attention keys/values come from the cache
        x, _, cache = self._run_stack(params["layers"], x, positions,
                                      caches=cache, cache_index=pos)
        x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
        return self._logits(params, x), cache
