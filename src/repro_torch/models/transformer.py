"""Config-driven model: the dense and the attention+Mamba families (port
of ``repro/models/transformer.py``).

Layers are stacked per *pattern position*, as in the reference: every
parameter of pattern position ``p`` carries a leading group dimension,
so weights carry across 1:1.  The reference's ``lax.scan`` over pattern
groups is a Python loop over that dimension here.

Entry points:
  * ``prefill(params, batch, cache) -> (logits, cache)``
  * ``decode_step(params, batch, cache, pos) -> (logits, cache)``
Both write ``cache`` in place (the reference returns a new one) and
return it.  Not ported yet (each raises ``NotImplementedError`` naming
ROADMAP A4b): MoE layers, xLSTM blocks, the encoder (whisper), vision
embeddings (qwen2-vl) and ``forward_train``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import (ArchConfig, ATTN, ATTN_LOCAL, MAMBA,
                                      MLSTM, SLSTM)
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models.layers import ParamSpec, map_tree, torch_dtype

# Weights that every use casts to the compute dtype: ``Model.init`` may
# store these cast once.  Norm weights (``rms_norm`` reads them in
# float32) and dt_proj / dt_bias / A_log (read in float32) stay in the
# parameter dtype.
COMPUTE_CAST = frozenset({"embed", "lm_head", "wq", "wk", "wv", "wo", "bq",
                          "bk", "bv", "w_gate", "w_up", "w_down", "in_proj",
                          "conv_w", "conv_b", "x_proj", "D", "out_proj"})


def _unported(what: str):
    raise NotImplementedError(f"repro_torch's Model does not run {what} "
                              f"yet (ROADMAP A4b)")


def _block_specs(cfg: ArchConfig, kind: str):
    d = cfg.d_model
    specs = {"norm1": ParamSpec((d,), ("embed",), init="zeros")}
    if kind in (ATTN, ATTN_LOCAL):
        specs["core"] = L.attention_specs(cfg)
    elif kind == MAMBA:
        specs["core"] = M.mamba_specs(cfg)
    else:
        _unported(f"{kind} blocks")
    if _has_ffn(cfg, kind):
        specs["norm2"] = ParamSpec((d,), ("embed",), init="zeros")
        specs["ffn"] = L.mlp_specs(cfg)
    return specs


def _has_ffn(cfg, kind):
    return cfg.d_ff > 0 and kind in (ATTN, ATTN_LOCAL, MAMBA)


def _stack_specs(specs, n):
    """Prefix every ParamSpec shape with the group dimension n."""
    return map_tree(
        lambda _, s: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init),
        specs)


def _group(tree, gi):
    """Views of group ``gi`` of a stacked tree (parameters or caches)."""
    return map_tree(lambda _, t: t[gi], tree)


def _write_back(cache, new):
    """Copy a block's new states into its cache views (in place); the
    attention cache is already written and comes back as itself."""
    for key, val in new.items():
        if isinstance(val, dict):
            _write_back(cache[key], val)
        elif val is not cache[key]:
            cache[key].copy_(val)


class Model:
    def __init__(self, cfg: ArchConfig):
        if cfg.moe is not None:
            _unported("MoE layers")
        if any(k in (MLSTM, SLSTM) for k in cfg.block_pattern):
            _unported("xLSTM blocks")
        if cfg.encoder_layers:
            _unported("the encoder and cross-attention")
        self.cfg = cfg
        self.pattern = tuple(cfg.block_pattern)
        if cfg.num_layers % len(self.pattern):
            raise ValueError(f"{cfg.num_layers} layers not divisible by "
                             f"pattern {self.pattern}")
        self.n_groups = cfg.num_layers // len(self.pattern)
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
        for p_idx, kind in enumerate(self.pattern):
            specs["layers"][f"pos{p_idx}"] = _stack_specs(
                _block_specs(cfg, kind), self.n_groups)
        return specs

    def init(self, seed: int = 0, *, device=None, cast_weights=False):
        """Parameters in ``param_dtype`` with the reference's shapes,
        init kinds and scales, drawn from a ``torch.Generator`` seeded
        with ``seed`` on ``device`` (None means CUDA).

        ``cast_weights=True`` stores each weight of ``COMPUTE_CAST`` in
        the compute dtype, cast as it is drawn (every use casts it so),
        so a full-size model never holds the float32 tree and its cast
        copy at once; the others keep ``param_dtype``.
        """
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        store = None
        if cast_weights:
            cd = self.compute_dtype

            def store(path, t):
                return t.to(cd) if path[-1] in COMPUTE_CAST else t
        return L.init_params(self.specs(), gen, self.cfg.param_dtype,
                             store=store)

    # ------------------------------------------------------------------
    # Block application
    # ------------------------------------------------------------------
    def _apply_block(self, kind, p, x, positions, *, cache=None,
                     cache_index=None):
        cfg = self.cfg
        new_cache = {}
        h = L.rms_norm(x, p["norm1"], cfg.rms_eps)
        if kind in (ATTN, ATTN_LOCAL):
            window = cfg.sliding_window if kind == ATTN_LOCAL else 0
            kvc = cache.get("kv") if cache else None
            out, nkv = L.attention_apply(
                p["core"], cfg, h, positions, layer_window=window,
                kv_cache=kvc, cache_index=cache_index)
            if nkv is not None:
                new_cache["kv"] = nkv
        elif kind == MAMBA:
            out, st = M.mamba_apply(
                p["core"], cfg, h,
                ssm_state=cache.get("ssm") if cache else None,
                conv_state=cache.get("conv") if cache else None)
            if cache is not None:
                new_cache.update(st)
        else:
            _unported(f"{kind} blocks")
        x = x + out
        if "ffn" in p:
            hf = L.rms_norm(x, p["norm2"], cfg.rms_eps)
            x = x + L.mlp_apply(p["ffn"], hf)
        return x, new_cache

    # ------------------------------------------------------------------
    # Stack runner
    # ------------------------------------------------------------------
    def _run_stack(self, stacked_params, x, positions, *, caches=None,
                   cache_index=None):
        for gi in range(self.n_groups):
            for p_idx, kind in enumerate(self.pattern):
                key = f"pos{p_idx}"
                cg = (_group(caches[key], gi) if caches is not None
                      else None)
                x, nc = self._apply_block(
                    kind, _group(stacked_params[key], gi), x, positions,
                    cache=cg, cache_index=cache_index)
                if cg is not None:
                    _write_back(cg, nc)
        return x, caches

    # ------------------------------------------------------------------
    # Embedding / unembedding
    # ------------------------------------------------------------------
    def _embed(self, params, batch):
        if "vision_embeds" in batch:
            _unported("vision embeddings")
        table = params["embed"]
        tokens = torch.as_tensor(batch["tokens"], device=table.device)
        # gather, then cast: the same values as casting the whole table
        return table[tokens.long()].to(self.compute_dtype)

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

    def _logits(self, params, x):
        cfg = self.cfg
        head = (params["embed"].T if cfg.tie_embeddings
                else params["lm_head"]).to(self.compute_dtype)
        logits = x @ head
        return L.softcap(logits.float(), cfg.final_softcap)

    # ------------------------------------------------------------------
    # Public entry points
    # ------------------------------------------------------------------
    def forward_train(self, params, batch):
        _unported("forward_train (training)")

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
            caches[f"pos{p_idx}"] = c
        return caches

    def init_cache(self, batch_size, max_len, *, device=None):
        """A zero cache on ``device`` (None means CUDA)."""
        dev = resolve_device(device)
        return map_tree(
            lambda _, sd: torch.zeros(sd[0], dtype=sd[1], device=dev),
            self.cache_specs(batch_size, max_len))

    def prefill(self, params, batch, cache):
        """Full-sequence forward writing ``cache``; returns the last
        position's logits (B, 1, V) float32 and the cache."""
        cfg = self.cfg
        x = self._embed(params, batch)
        positions = self._positions(batch, x.shape[1], device=x.device)
        x, cache = self._run_stack(params["layers"], x, positions,
                                   caches=cache, cache_index=0)
        x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.rms_eps)
        return self._logits(params, x), cache

    def decode_step(self, params, batch, cache, pos):
        """batch["tokens"]: (B, 1); pos: an int (the current length) or a
        (B,) tensor of per-row positions."""
        cfg = self.cfg
        x = self._embed(params, batch)
        positions = self._positions(batch, 1, offset=pos, device=x.device)
        x, cache = self._run_stack(params["layers"], x, positions,
                                   caches=cache, cache_index=pos)
        x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
        return self._logits(params, x), cache
