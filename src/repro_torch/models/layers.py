"""Shared model layers: norms, RoPE/M-RoPE, attention, SwiGLU MLP (port
of ``repro/models/layers.py``).

Plain PyTorch, shape-polymorphic over batch/seq and dtype-polymorphic,
with the reference's parameter layout.  On a CUDA tensor, attention is
the hand-written ``flash_attention`` kernel (B9): causal with or without
a sliding window, or non-causal, any key length (whisper's encoder and
cross-attention), with a query offset and a (B, Sk) key mask (a chunk of
queries after a prefix, a padded batch); while autograd records
(training) it goes through ``FlashAttention``, whose backward is B9's
backward kernel.  On a CPU tensor the plain form runs in full, query
chunks and all, as the reference's jnp form, and autograd
differentiates it.

KV caches are updated in place (the reference returns new ones): the
returned cache is the given one, written.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import Placed, check_mesh
from repro_torch.kernels.flash_attention import flash_attention

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# leaves with more elements than this are drawn a slice at a time when
# they are stored cast (moonshot's stacked experts: 8.9e9 each)
SLICED_DRAW = 1 << 31


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else DTYPES[str(name)]


# ---------------------------------------------------------------------------
# Param spec machinery (shapes + logical axes declared once, init derived).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple              # logical axis names, len == len(shape)
    init: str = "normal"     # normal | zeros | ones | small_normal

    def initializer(self, generator: torch.Generator, param_dtype,
                    store_dtype=None):
        """The reference's init kinds and scales; the numbers come from
        ``generator`` (on the target device), not ``jax.random``.
        ``store_dtype``: the draw in ``param_dtype``, then cast to it; a
        leaf of more than ``SLICED_DRAW`` elements is then drawn a slice
        of its leading dimension at a time, so its full float32 draw
        never exists."""
        dtype = torch_dtype(param_dtype)
        out = dtype if store_dtype is None else torch_dtype(store_dtype)
        dev = generator.device
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=dev).to(out)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=dev).to(out)
        scale = 0.02 if self.init == "normal" else 0.006
        fan_in = self.shape[0] if len(self.shape) > 1 else 1
        scale = min(scale, (1.0 / max(fan_in, 1)) ** 0.5)
        if store_dtype is not None and math.prod(self.shape) > SLICED_DRAW:
            w = torch.empty(self.shape, dtype=out, device=dev)
            for i in range(self.shape[0]):
                w[i] = torch.randn(self.shape[1:], generator=generator,
                                   device=dev).mul_(scale).to(dtype)
            return w
        w = torch.randn(self.shape, generator=generator, device=dev)
        return w.mul_(scale).to(dtype).to(out)


def tree_map(fn, tree, *rest, path=None):
    """``fn(leaf, *leaves of rest)`` over a nested dict's leaves (``rest``
    shaped like ``tree`` down to its leaves), keeping its structure.
    Given a ``path`` (``()`` at the root), ``fn`` takes the leaf's key
    path first: ``fn(path, leaf, *leaves of rest)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest),
                            path=None if path is None else path + (k,))
                for k, v in tree.items()}
    return fn(tree, *rest) if path is None else fn(path, tree, *rest)


def tree_leaves(tree) -> list:
    """A nested dict's leaves in the reference's flattening order (keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def init_params(specs, generator: torch.Generator, param_dtype="float32",
                store_dtype=None):
    """Parameters of ``specs`` in ``param_dtype``, one draw per leaf in
    the tree's order.  ``store_dtype(path)`` may name another dtype to
    keep a leaf in (None keeps ``param_dtype``); it is applied leaf by
    leaf, so the full-precision copy of the whole tree never exists at
    once."""
    return tree_map(
        lambda path, s: s.initializer(
            generator, param_dtype,
            None if store_dtype is None else store_dtype(path)),
        specs, path=())


def param_structs(specs, param_dtype="float32"):
    """Each leaf's shape and dtype as a tensor on the ``meta`` device
    (the reference's ``ShapeDtypeStruct``: no storage)."""
    dtype = torch_dtype(param_dtype)
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"), specs)


def param_axes(specs):
    """Each leaf's logical axes (a tuple of names or None a dim)."""
    return tree_map(lambda s: s.axes, specs)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps=1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def softcap(x, cap):
    """Gemma2-style logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# RoPE (standard + qwen2-vl M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim, theta, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta=10_000.0, mrope_sections=None):
    """Rotate pairs of features (split halves).

    x: (..., S, H, D); positions: (B, S) int for standard RoPE, or
    (3, B, S) for M-RoPE (temporal, height, width position streams).
    """
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)       # (D/2,)
    positions = torch.as_tensor(positions, device=x.device)
    if mrope_sections is not None:
        # M-RoPE: the D/2 frequency slots are split into (t, h, w)
        # sections; each takes its angle from its own position stream
        if positions.dim() != 3:
            raise ValueError("M-RoPE needs (3, B, S) positions")
        sec = torch.cat([torch.full((n,), i, dtype=torch.long,
                                    device=x.device)
                         for i, n in enumerate(mrope_sections)])
        pos_sel = positions.float()[sec].permute(1, 2, 0)  # (B, S, D/2)
        ang = pos_sel * inv[None, None, :]
    else:
        if positions.dim() == 3:      # tolerate (3,B,S) given to standard rope
            positions = positions[0]
        ang = positions.float()[..., None] * inv      # (B, S, D/2)
    cos = torch.cos(ang)[..., None, :]                # (B, S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, causal / sliding-window / cross, chunked queries)
# ---------------------------------------------------------------------------

def _attend(q, k, v, *, causal, q_offset, window=0, logit_cap=0.0,
            kv_len_mask=None):
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D).  Chunk-free core."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qf = q.reshape(b, sq, hkv, group, d).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) \
        / math.sqrt(d)
    scores = softcap(scores, logit_cap)
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        kpos = torch.arange(sk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        if window:
            mask &= qpos[:, None] - kpos[None, :] < window
        scores = torch.where(mask[None, None, None], scores, -1e30)
    if kv_len_mask is not None:                       # (B, Sk) valid-kv mask
        scores = torch.where(kv_len_mask[:, None, None, None, :], scores,
                             -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def attention(q, k, v, *, causal=True, q_offset=0, window=0, logit_cap=0.0,
              kv_len_mask=None, q_chunk=1024):
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D).

    On the card: the ``flash_attention`` kernel over the whole sequence
    (no query chunks: it holds no score matrix), causal (with the
    window, if any) or non-causal, any key length, with the query offset
    and the (B, Sk) bool key mask.  On the CPU: the plain form, in query
    chunks that bound the score memory to (B, H, q_chunk, Sk), as the
    reference computes it.  The window and the offset bind only with
    ``causal``, as in the reference; a row with no valid key attends to
    all Sk keys alike (the reference's -1e30 scores).
    """
    if q.is_cuda:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              logit_cap=logit_cap,
                              window=window if causal else 0,
                              q_offset=q_offset if causal else 0,
                              kv_len_mask=kv_len_mask)
        return out.transpose(1, 2)
    sq = q.shape[1]
    if sq % q_chunk:          # largest divisor of sq that is <= q_chunk
        q_chunk = next((c for c in range(q_chunk, 0, -1) if sq % c == 0), sq)
    if sq <= q_chunk:
        return _attend(q, k, v, causal=causal, q_offset=q_offset,
                       window=window, logit_cap=logit_cap,
                       kv_len_mask=kv_len_mask)
    outs = [_attend(q[:, i:i + q_chunk], k, v, causal=causal,
                    q_offset=q_offset + i, window=window,
                    logit_cap=logit_cap, kv_len_mask=kv_len_mask)
            for i in range(0, sq, q_chunk)]
    return torch.cat(outs, dim=1)


def attention_specs(cfg):
    """ParamSpecs for one attention block (self- or cross-attention: the
    same leaves)."""
    d, h = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    specs = {
        "wq": ParamSpec((d, nq * h), ("embed", "q_features")),
        "wk": ParamSpec((d, nkv * h), ("embed", "kv_features")),
        "wv": ParamSpec((d, nkv * h), ("embed", "kv_features")),
        "wo": ParamSpec((nq * h, d), ("q_features", "embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((nq * h,), ("q_features",), init="zeros")
        specs["bk"] = ParamSpec((nkv * h,), ("kv_features",), init="zeros")
        specs["bv"] = ParamSpec((nkv * h,), ("kv_features",), init="zeros")
    return specs


def _is_rows(index) -> bool:
    return torch.is_tensor(index) and index.dim() == 1


def attention_apply(p, cfg, x, positions, *, layer_window=0, kv_cache=None,
                    cache_index=None, cross_kv=None, causal=True,
                    mesh=None):
    """Returns (out, kv_cache).

    kv_cache: dict(k=(B, W, Hkv, D), v=...) or None, written in place.
    For sliding-window layers W = min(max_len, window) and the cache is
    a RING indexed by position % W; otherwise W = max_len with direct
    indexing.  cache_index: an int (or 0-d tensor) write offset — 0 in
    prefill — or a (B,) tensor of per-row offsets during single-token
    decode (continuous batching: each slot advances at its own
    position).  A cache placed on a mesh (``sharding.Placed``, from
    ``Model.init_cache`` with a mesh) is written block by block where
    its blocks live.  ``cross_kv``: precomputed (k, v), each (B, F, Hkv, D),
    for cross-attention (whisper's decoder): q's projection and bias, no
    RoPE, non-causal attention over the F keys.  ``mesh``: a
    ``distributed.sharding.Mesh`` whose ``"model"`` axis splits the
    cache's sequence in decode (``decode_attention``); prefill and the
    projections run on x's device, where the reference's mesh changes
    no number.
    """
    check_mesh(mesh)
    b, s, _ = x.shape
    h = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    dt = x.dtype

    q = (x @ p["wq"].to(dt)).reshape(b, s, nq, h)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt).reshape(nq, h)
    if cross_kv is not None:
        k, v = cross_kv
        out = attention(q, k, v, causal=False)
        return out.reshape(b, s, nq * h) @ p["wo"].to(dt), kv_cache

    k = (x @ p["wk"].to(dt)).reshape(b, s, nkv, h)
    v = (x @ p["wv"].to(dt)).reshape(b, s, nkv, h)
    if cfg.qkv_bias:
        k = k + p["bk"].to(dt).reshape(nkv, h)
        v = v + p["bv"].to(dt).reshape(nkv, h)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)

    if kv_cache is None:
        out = attention(q, k, v, causal=causal, window=layer_window,
                        logit_cap=cfg.logit_softcap)
        return out.reshape(b, s, nq * h) @ p["wo"].to(dt), None

    ck, cv = kv_cache["k"], kv_cache["v"]
    w_len = ck.shape[1]
    ring = bool(layer_window) and w_len <= layer_window
    if s > 1:
        # prefill: attend over the fresh k/v, then write the cache
        out = attention(q, k, v, causal=True, window=layer_window,
                        logit_cap=cfg.logit_softcap)
        if ring:
            if s >= w_len:
                # position p lives at slot p % W -> rolled last-W block
                r = (s - w_len) % w_len
                kw = torch.roll(k[:, s - w_len:], r, dims=1)
                vw = torch.roll(v[:, s - w_len:], r, dims=1)
            else:
                kw, vw = k, v
            ck[:, :kw.shape[1]] = kw
            cv[:, :vw.shape[1]] = vw
        else:
            i0 = int(cache_index)
            ck[:, i0:i0 + s] = k
            cv[:, i0:i0 + s] = v
        return out.reshape(b, s, nq * h) @ p["wo"].to(dt), kv_cache

    # decode: ring slot or direct slot, then flash-decode, sequence-
    # sharded over ``mesh`` (caches stay in their storage dtype; the cast
    # happens inside each shard)
    if _is_rows(cache_index):
        # per-row write offsets: scatter each batch row at its own slot
        slot = torch.remainder(cache_index, w_len) if ring else cache_index
        if isinstance(ck, Placed):
            ck.write_rows(slot, k[:, 0])
            cv.write_rows(slot, v[:, 0])
        else:
            rows = torch.arange(b, device=ck.device)
            ck[rows, slot.long()] = k[:, 0].to(ck.dtype)
            cv[rows, slot.long()] = v[:, 0].to(cv.dtype)
    else:
        i0 = int(cache_index)
        slot = i0 % w_len if ring else i0
        ck[:, slot:slot + 1] = k
        cv[:, slot:slot + 1] = v
    from repro_torch.distributed.decode_attention import decode_attention
    out = decode_attention(
        q, ck, cv, cache_index, mesh,
        window=0 if ring else layer_window,     # ring bounds the window
        logit_cap=cfg.logit_softcap)
    out = out.to(dt)
    return out.reshape(b, s, nq * h) @ p["wo"].to(dt), kv_cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_specs(cfg, d_ff=None):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "w_gate": ParamSpec((d, f), ("embed", "mlp")),
        "w_up": ParamSpec((d, f), ("embed", "mlp")),
        "w_down": ParamSpec((f, d), ("mlp", "embed")),
    }


def mlp_apply(p, x):
    dt = x.dtype
    g = F.silu(x @ p["w_gate"].to(dt))
    u = x @ p["w_up"].to(dt)
    return (g * u) @ p["w_down"].to(dt)
