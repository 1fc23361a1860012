"""PyTorch port, models: the layers, the Mamba block, flash-decode and the
whole ``Model`` — every configuration of ``repro_torch.configs``, the MoE,
xLSTM, whisper (encoder and cross-attention) and qwen2-vl (vision rows)
families included — against the JAX reference on the same seeded weights
and inputs (numpy on both sides, the weights carried over through
``interop.model_params_from_arrays``).  Float32 cases agree within 1e-5
of the reference output's largest magnitude; bfloat16 cases at the
reference's own bf16 bounds (atol 5e-2, rtol 1e-2)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_arch as jax_get_arch, reduced as jax_reduced
from repro.distributed.decode_attention import (decode_attention as
                                                jax_decode_attention)
from repro.models import Model as JaxModel
from repro.models import layers as JL
from repro.models import mamba as JM
from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.distributed.decode_attention import decode_attention
from repro_torch.interop import (model_cache_from_arrays,
                                 model_params_from_arrays)
from repro_torch.models import Model
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models.transformer import COMPUTE_CAST

torch.use_deterministic_algorithms(True)
# the test workers share the machine's cores: keep torch from taking them all
torch.set_num_threads(2)

TOL = 1e-5
CPU = "cpu"


def _close(got, want, tol=TOL):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float32) - want).max()) / scale
    assert err <= tol, err


def _bf16_close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=5e-2, rtol=1e-2)


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    return np.asarray(t)


def _cfgs(arch, dtype="float32", **kw):
    """The reduced config of ``arch`` in both packages, MoE dropped."""
    out = []
    for get, red in ((jax_get_arch, jax_reduced), (get_arch, reduced)):
        cfg = dataclasses.replace(red(get(arch)), compute_dtype=dtype,
                                  moe=None, **kw)
        out.append(cfg)
    return out


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------- layers

def test_rms_norm_matches_reference():
    rng = _rng(0)
    x = rng.normal(0, 3.0, (2, 7, 64)).astype(np.float32)
    w = rng.normal(0, 0.1, (64,)).astype(np.float32)
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("mrope", [None, (2, 3, 3)])
def test_apply_rope_matches_reference(mrope):
    rng = _rng(1)
    x = rng.normal(0, 1.0, (2, 9, 4, 16)).astype(np.float32)
    if mrope is None:
        pos = rng.integers(0, 3000, (2, 9)).astype(np.int32)
    else:
        pos = rng.integers(0, 3000, (3, 2, 9)).astype(np.int32)
    _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        500_000.0, mrope),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0,
                         mrope))


def _qkv(seed, b=2, sq=24, sk=24, hq=4, hkv=2, d=16):
    rng = _rng(seed)
    q = rng.normal(0, 1.5, (b, sq, hq, d)).astype(np.float32)
    k = rng.normal(0, 1.5, (b, sk, hkv, d)).astype(np.float32)
    v = rng.normal(0, 1.0, (b, sk, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, window=5),
    dict(causal=True, logit_cap=2.0),
    dict(causal=True, q_chunk=8),
    dict(causal=True, q_chunk=8, window=6, logit_cap=3.0),
], ids=["causal", "full", "window", "cap", "chunked", "chunked-window-cap"])
def test_attention_matches_reference(kw):
    q, k, v = _qkv(2)
    _close(L.attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw),
           JL.attention(*(jnp.asarray(a) for a in (q, k, v)), **kw))


def test_attention_kv_len_mask_and_offset_match_reference():
    q, k, v = _qkv(3, sq=6, sk=20)
    mask = np.ones((2, 20), bool)
    mask[0, 15:] = False
    mask[1, :3] = False
    for kw in (dict(causal=False, kv_len_mask=mask),
               dict(causal=True, q_offset=14, kv_len_mask=mask)):
        tkw = dict(kw, kv_len_mask=torch.from_numpy(mask))
        jkw = dict(kw, kv_len_mask=jnp.asarray(mask))
        _close(L.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                           **tkw),
               JL.attention(*(jnp.asarray(a) for a in (q, k, v)), **jkw))


def _attn_params(cfg_j, seed):
    specs = JL.attention_specs(cfg_j)
    p = JL.init_params(specs, jax.random.key(seed))
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma2-27b",
                                  "qwen2-vl-2b"])
def test_attention_apply_prefill_and_decode_match_reference(arch):
    """Prefill (no cache; then into a direct or ring cache), a scalar
    decode step and a per-row decode step, cache contents included."""
    cj, ct = _cfgs(arch)
    jp, tp = _attn_params(cj, 4)
    window = cj.sliding_window            # gemma2: ring of 8 slots
    b, s, max_len = 2, 12, 16
    x = _rng(5).normal(0, 1.0, (b, s, cj.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    if cj.mrope_sections:
        pos = np.broadcast_to(pos[None], (3, b, s))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos.copy())
    out_j, _ = JL.attention_apply(jp, cj, jx, jpos, layer_window=window)
    out_t, none = L.attention_apply(tp, ct, tx, tpos, layer_window=window)
    assert none is None
    _close(out_t, out_j)
    w_len = min(max_len, window) if window else max_len
    hk = (cj.num_kv_heads, cj.resolved_head_dim)
    zeros = np.zeros((b, w_len) + hk, np.float32)
    jc = {"k": jnp.asarray(zeros), "v": jnp.asarray(zeros)}
    tc = {"k": torch.from_numpy(zeros.copy()),
          "v": torch.from_numpy(zeros.copy())}
    out_j, jc = JL.attention_apply(jp, cj, jx, jpos, layer_window=window,
                                   kv_cache=jc, cache_index=0)
    out_t, tc = L.attention_apply(tp, ct, tx, tpos, layer_window=window,
                                  kv_cache=tc, cache_index=0)
    _close(out_t, out_j)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    # one scalar step, then one per-row step (rows at their own offsets)
    for idx in (np.int32(s), np.array([s + 1, s - 3], np.int32)):
        x1 = _rng(6).normal(0, 1.0, (b, 1, cj.d_model)).astype(np.float32)
        p1 = (np.broadcast_to(idx, (b,))[:, None]).astype(np.int32)
        if cj.mrope_sections:
            p1 = np.broadcast_to(p1[None], (3, b, 1))
        out_j, jc = JL.attention_apply(
            jp, cj, jnp.asarray(x1), jnp.asarray(p1), layer_window=window,
            kv_cache=jc, cache_index=jnp.asarray(idx))
        t_idx = (int(idx) if np.ndim(idx) == 0
                 else torch.from_numpy(idx.astype(np.int64)))
        out_t, tc = L.attention_apply(
            tp, ct, torch.from_numpy(x1), torch.from_numpy(p1.copy()),
            layer_window=window, kv_cache=tc, cache_index=t_idx)
        _close(out_t, out_j)
        _close(tc["k"], jc["k"])


@pytest.mark.parametrize("kw", [dict(), dict(window=5), dict(logit_cap=2.0),
                                dict(window=7, logit_cap=3.0)],
                         ids=["plain", "window", "cap", "window-cap"])
@pytest.mark.parametrize("vector", [False, True])
def test_decode_attention_matches_reference(vector, kw):
    rng = _rng(7)
    q = rng.normal(0, 1.5, (3, 1, 4, 16)).astype(np.float32)
    ck = rng.normal(0, 1.5, (3, 20, 2, 16)).astype(np.float32)
    cv = rng.normal(0, 1.0, (3, 20, 2, 16)).astype(np.float32)
    pos = np.array([4, 19, 11], np.int32) if vector else np.int32(13)
    want = jax_decode_attention(jnp.asarray(q), jnp.asarray(ck),
                                jnp.asarray(cv), jnp.asarray(pos), None,
                                **kw)
    tpos = torch.from_numpy(pos.astype(np.int64)) if vector else int(pos)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(ck),
                           torch.from_numpy(cv), tpos, None, **kw)
    _close(got, want)


def test_decode_attention_casts_storage_dtype_inside():
    """A bfloat16 cache with float32 queries: the cast happens inside,
    as the reference does it."""
    rng = _rng(8)
    q = rng.normal(0, 1.0, (2, 1, 4, 16)).astype(np.float32)
    ck = rng.normal(0, 1.0, (2, 9, 2, 16)).astype(np.float32)
    want = jax_decode_attention(
        jnp.asarray(q), jnp.asarray(ck, jnp.bfloat16),
        jnp.asarray(ck, jnp.bfloat16), jnp.asarray(6), None)
    got = decode_attention(torch.from_numpy(q),
                           torch.from_numpy(ck).to(torch.bfloat16),
                           torch.from_numpy(ck).to(torch.bfloat16), 6)
    assert got.dtype == torch.float32
    _close(got, want)


def test_mlp_apply_matches_reference():
    cj, ct = _cfgs("llama3.2-3b")
    p = JL.init_params(JL.mlp_specs(cj), jax.random.key(9))
    x = _rng(9).normal(0, 1.0, (2, 5, cj.d_model)).astype(np.float32)
    _close(L.mlp_apply({k: torch.from_numpy(np.array(v))
                        for k, v in p.items()}, torch.from_numpy(x)),
           JL.mlp_apply(p, jnp.asarray(x)))


# ----------------------------------------------------------------- mamba

def _mamba_case(seed, s):
    cj, ct = _cfgs("jamba-1.5-large-398b")
    p = JL.init_params(JM.mamba_specs(cj), jax.random.key(seed))
    # non-trivial dt_bias, A_log and conv bias (their init is zeros)
    rng = _rng(seed)
    p = dict(p, dt_bias=jnp.asarray(rng.normal(0, 0.5, p["dt_bias"].shape),
                                    jnp.float32),
             A_log=jnp.asarray(rng.normal(0, 0.5, p["A_log"].shape),
                               jnp.float32),
             conv_b=jnp.asarray(rng.normal(0, 0.1, p["conv_b"].shape),
                                jnp.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    x = rng.normal(0, 1.0, (2, s, cj.d_model)).astype(np.float32)
    return cj, ct, p, tp, x


def test_mamba_prefill_over_several_chunks_matches_reference():
    """48 steps with the reference's chunk set to 16 on both sides: the
    reference carries h across three chunks, the port scans once."""
    cj, ct, p, tp, x = _mamba_case(10, 48)
    out_j, st_j = JM.mamba_apply(p, cj, jnp.asarray(x), chunk=16)
    out_t, st_t = M.mamba_apply(tp, ct, torch.from_numpy(x), chunk=16)
    _close(out_t, out_j)
    _close(st_t["ssm"], st_j["ssm"])
    _close(st_t["conv"], st_j["conv"])


def test_mamba_prefill_from_given_states_and_decode_match_reference():
    """A prefill continuing from a conv state and an SSM state, then a
    single-token step on its states."""
    cj, ct, p, tp, x = _mamba_case(11, 32)
    rng = _rng(12)
    d_in = cj.mamba_expand * cj.d_model
    ssm = rng.normal(0, 1.0, (2, d_in, cj.mamba_d_state)).astype(np.float32)
    conv = rng.normal(0, 1.0, (2, cj.mamba_d_conv - 1, d_in)) \
        .astype(np.float32)
    out_j, st_j = JM.mamba_apply(p, cj, jnp.asarray(x),
                                 ssm_state=jnp.asarray(ssm),
                                 conv_state=jnp.asarray(conv), chunk=16)
    out_t, st_t = M.mamba_apply(tp, ct, torch.from_numpy(x),
                                ssm_state=torch.from_numpy(ssm),
                                conv_state=torch.from_numpy(conv))
    _close(out_t, out_j)
    _close(st_t["ssm"], st_j["ssm"])
    x1 = rng.normal(0, 1.0, (2, 1, cj.d_model)).astype(np.float32)
    out_j, st_j = JM.mamba_apply(p, cj, jnp.asarray(x1),
                                 ssm_state=st_j["ssm"],
                                 conv_state=st_j["conv"])
    out_t, st_t = M.mamba_apply(tp, ct, torch.from_numpy(x1),
                                ssm_state=st_t["ssm"],
                                conv_state=st_t["conv"])
    _close(out_t, out_j)
    _close(st_t["ssm"], st_j["ssm"])
    _close(st_t["conv"], st_j["conv"])


# ----------------------------------------------------------------- Model

_MODELS = {}


def _model_pair(arch, dtype="float32", seed=1):
    key = (arch, dtype, seed)
    if key not in _MODELS:
        cj, ct = _cfgs(arch, dtype)
        jm, tm = JaxModel(cj), Model(ct)
        params = jm.init(jax.random.key(seed))
        tp = model_params_from_arrays(_np_tree(params), ct, device=CPU)
        _MODELS[key] = (jm, tm, params, tp)
    return _MODELS[key]


def _cmp_tree(got, want, close):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _cmp_tree(got[k], want[k], close)
    else:
        close(got, np.asarray(want, np.float32))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma2-27b",
                                  "jamba-1.5-large-398b", "qwen1.5-32b"])
def test_model_prefill_and_decode_match_reference(arch):
    """Prefill of 20 tokens (logits and every cache leaf), then three
    decode steps at per-row positions (the serve engine's form); qwen1.5
    covers the untied head and the QKV bias."""
    jm, tm, params, tp = _model_pair(arch)
    toks = _rng(13).integers(0, jm.cfg.vocab_size, (2, 20)).astype(np.int32)
    lj, cj = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)},
                                 jm.init_cache(2, 32))
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        tm.init_cache(2, 32, device=CPU))
    _close(lt, lj)
    _cmp_tree(ct, _np_tree(cj), _close)
    step = jax.jit(jm.decode_step)
    for i in range(3):
        tok = np.array([[3 + i], [11 + i]], np.int32)
        pos = np.array([20 + i, 20 + i], np.int32)
        lj, cj = step(params, {"tokens": jnp.asarray(tok),
                               "positions": jnp.asarray(pos[:, None])},
                      cj, jnp.asarray(pos))
        tpos = torch.from_numpy(pos.astype(np.int64))
        lt, ct = tm.decode_step(tp, {"tokens": torch.from_numpy(tok),
                                     "positions": tpos[:, None]}, ct, tpos)
        _close(lt, lj)
    _cmp_tree(ct, _np_tree(cj), _close)


def test_model_decode_from_carried_cache_matches_reference():
    """A cache the reference prefilled, carried over with
    ``model_cache_from_arrays``: the port's scalar-position decode step
    on it matches the reference's."""
    jm, tm, params, tp = _model_pair("jamba-1.5-large-398b")
    toks = _rng(14).integers(0, jm.cfg.vocab_size, (1, 9)).astype(np.int32)
    _, cj = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)},
                                jm.init_cache(1, 16))
    ct = model_cache_from_arrays(_np_tree(cj), tm.cfg, 1, 16, device=CPU)
    tok = np.array([[7]], np.int32)
    lj, _ = jm.decode_step(params, {"tokens": jnp.asarray(tok)}, cj,
                           jnp.asarray(9, jnp.int32))
    lt, _ = tm.decode_step(tp, {"tokens": torch.from_numpy(tok)}, ct, 9)
    _close(lt, lj)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "jamba-1.5-large-398b"])
def test_model_bf16_matches_reference_at_bf16_bounds(arch):
    """The compute dtype the serve path runs in: bf16 activations and
    caches, float32 weights, at the reference's own prefill/decode
    bounds."""
    jm, tm, params, tp = _model_pair(arch, "bfloat16")
    toks = _rng(15).integers(0, jm.cfg.vocab_size, (1, 12)).astype(np.int32)
    lj, cj = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)},
                                 jm.init_cache(1, 16))
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        tm.init_cache(1, 16, device=CPU))
    _bf16_close(lt, lj)
    lj, _ = jm.decode_step(params, {"tokens": jnp.asarray([[5]])}, cj,
                           jnp.asarray(12, jnp.int32))
    lt, _ = tm.decode_step(tp, {"tokens": torch.tensor([[5]])}, ct, 12)
    _bf16_close(lt, lj)


def test_prefill_matches_stepwise_decode():
    """The reference's own consistency check, on the port alone: the
    last prefill logits equal those of decoding the prompt step by step
    (same bounds as ``tests/test_models_decode.py``)."""
    _, tm, _, tp = _model_pair("jamba-1.5-large-398b", "bfloat16")
    toks = torch.from_numpy(
        _rng(16).integers(0, tm.cfg.vocab_size, (1, 10)).astype(np.int64))
    lp, _ = tm.prefill(tp, {"tokens": toks}, tm.init_cache(1, 32,
                                                           device=CPU))
    cache = tm.init_cache(1, 32, device=CPU)
    for i in range(10):
        lg, cache = tm.decode_step(tp, {"tokens": toks[:, i:i + 1]}, cache,
                                   i)
    np.testing.assert_allclose(lp[0, -1].numpy(), lg[0, 0].numpy(),
                               atol=5e-2, rtol=1e-2)


# ----------------------------------------------- the rest of the zoo

# the families this slice added: MoE (qwen3-moe: no shared expert;
# moonshot: shared experts), Jamba with its MoE layers, xLSTM (mLSTM and
# sLSTM blocks), whisper (encoder and cross-attention), qwen2-vl (vision
# rows and M-RoPE)
ZOO = ["qwen3-moe-235b-a22b", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b",
       "xlstm-1.3b", "whisper-base", "qwen2-vl-2b"]
_ZOO = {}


def _zoo_cfgs(arch, dtype="float32"):
    """The reduced config of ``arch`` in both packages, experts kept."""
    return [dataclasses.replace(red(get(arch)), compute_dtype=dtype)
            for get, red in ((jax_get_arch, jax_reduced),
                             (get_arch, reduced))]


def _zoo_pair(arch, dtype="float32", seed=1):
    key = (arch, dtype, seed)
    if key not in _ZOO:
        cj, ct = _zoo_cfgs(arch, dtype)
        jm, tm = JaxModel(cj), Model(ct)
        params = jm.init(jax.random.key(seed))
        tp = model_params_from_arrays(_np_tree(params), ct, device=CPU)
        _ZOO[key] = (jm, tm, params, tp)
    return _ZOO[key]


def _zoo_batch(cfg, b, s, seed):
    """Tokens, and the family's extra inputs: whisper's audio frames,
    qwen2-vl's vision rows (a quarter of the prompt) and M-RoPE
    positions whose three streams differ."""
    rng = _rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))
             .astype(np.int32)}
    if cfg.family == "audio":
        batch["audio_frames"] = rng.normal(
            0, 1.0, (b, cfg.num_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.normal(
            0, 1.0, (b, s // 4, cfg.d_model)).astype(np.float32)
        ar = np.arange(s, dtype=np.int32)
        batch["positions"] = np.ascontiguousarray(np.broadcast_to(
            np.stack([ar, ar // 2, ar % 3])[:, None], (3, b, s)))
    return batch


def _dec_batch(cfg, tok, pos):
    """A decode step's batch at per-row positions (the engine's form)."""
    p = pos[:, None]
    if cfg.mrope_sections is not None:
        p = np.ascontiguousarray(np.broadcast_to(p[None], (3,) + p.shape))
    return {"tokens": tok, "positions": p}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_prefill_and_decode_match_reference(arch):
    """Float32: prefill of 16 tokens (logits and every cache leaf: KV,
    Mamba, mLSTM/sLSTM states, cross k/v), then three decode steps at
    per-row positions, each step's logits and the final cache, within
    1e-5 of the reference."""
    jm, tm, params, tp = _zoo_pair(arch)
    cfg = jm.cfg
    jb, tb = _both(_zoo_batch(cfg, 2, 16, 20))
    lj, cj = jax.jit(jm.prefill)(params, jb, jm.init_cache(2, 32))
    lt, ct = tm.prefill(tp, tb, tm.init_cache(2, 32, device=CPU))
    _close(lt, lj)
    _cmp_tree(ct, _np_tree(cj), _close)
    step = jax.jit(jm.decode_step)
    for i in range(3):
        tok = np.array([[3 + i], [11 + i]], np.int32)
        pos = np.array([16 + i, 16 + i], np.int32)
        jd, td = _both(_dec_batch(cfg, tok, pos))
        lj, cj = step(params, jd, cj, jnp.asarray(pos))
        lt, ct = tm.decode_step(tp, td, ct,
                                torch.from_numpy(pos.astype(np.int64)))
        _close(lt, lj)
    _cmp_tree(ct, _np_tree(cj), _close)


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_bf16_matches_reference_at_bf16_bounds(arch):
    """The serving dtype (bf16 activations and caches, float32 weights):
    prefill and one scalar-position decode step at the reference's
    bounds."""
    jm, tm, params, tp = _zoo_pair(arch, "bfloat16")
    cfg = jm.cfg
    jb, tb = _both(_zoo_batch(cfg, 1, 12, 21))
    lj, cj = jax.jit(jm.prefill)(params, jb, jm.init_cache(1, 16))
    lt, ct = tm.prefill(tp, tb, tm.init_cache(1, 16, device=CPU))
    _bf16_close(lt, lj)
    dec = {"tokens": np.array([[5]], np.int32)}
    if cfg.mrope_sections is not None:
        dec["positions"] = np.full((3, 1, 1), 12, np.int32)
    jd, td = _both(dec)
    lj, _ = jm.decode_step(params, jd, cj, jnp.asarray(12, jnp.int32))
    lt, _ = tm.decode_step(tp, td, ct, 12)
    _bf16_close(lt, lj)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "whisper-base"])
def test_zoo_prefill_matches_stepwise_decode(arch):
    """The reference's own consistency check (``tests/test_models_decode.py``)
    on the port alone, for the two families it adds: the last prefill
    logits equal those of decoding the prompt token by token; whisper
    prefills its first token to fill the cross k/v."""
    _, tm, _, tp = _zoo_pair(arch, "bfloat16")
    cfg = tm.cfg
    n = 10
    toks = torch.from_numpy(
        _rng(22).integers(0, cfg.vocab_size, (1, n)).astype(np.int64))
    extra = {}
    if cfg.family == "audio":
        extra["audio_frames"] = torch.ones(
            (1, cfg.num_audio_frames, cfg.d_model), dtype=torch.bfloat16)
    lp, _ = tm.prefill(tp, {"tokens": toks, **extra},
                       tm.init_cache(1, 32, device=CPU))
    cache = tm.init_cache(1, 32, device=CPU)
    start = 0
    if cfg.family == "audio":
        lg, cache = tm.prefill(tp, {"tokens": toks[:, :1], **extra}, cache)
        start = 1
    for i in range(start, n):
        lg, cache = tm.decode_step(tp, {"tokens": toks[:, i:i + 1]}, cache,
                                   i)
    np.testing.assert_allclose(lp[0, -1].float().numpy(),
                               lg[0, 0].float().numpy(),
                               atol=5e-2, rtol=1e-2)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "jamba-1.5-large-398b"])
def test_moe_aux_loss_summed_over_layers_matches_reference(arch):
    """The MoE aux loss of every MoE layer, summed over the stack in the
    reference's order (the term ``forward_train`` adds to the loss);
    prefill and decode leave it out."""
    jm, tm, params, tp = _zoo_pair(arch)
    cfg = jm.cfg
    toks = _zoo_batch(cfg, 2, 16, 26)["tokens"]
    x = np.asarray(jm._embed(params, {"tokens": jnp.asarray(toks)}))
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    _, want, _ = jm._run_stack(params["layers"], jnp.asarray(x),
                               jnp.asarray(pos), remat=False)
    got_x, got, _ = tm._run_stack(tp["layers"], torch.from_numpy(x),
                                  torch.from_numpy(pos.copy()),
                                  with_aux=True)
    assert float(want) > 0
    assert abs(float(got) / float(want) - 1.0) <= TOL
    _, none, _ = tm._run_stack(tp["layers"], torch.from_numpy(x),
                               torch.from_numpy(pos.copy()))
    assert none is None


def test_vision_rows_replace_the_first_embeddings():
    """qwen2-vl: the first n_vis positions take the vision rows cast to
    the compute dtype, the rest the token embeddings."""
    _, tm, _, tp = _zoo_pair("qwen2-vl-2b", "bfloat16")
    batch = _zoo_batch(tm.cfg, 2, 8, 23)
    x = tm._embed(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    ve = torch.from_numpy(batch["vision_embeds"]).to(torch.bfloat16)
    assert x.dtype == torch.bfloat16
    assert torch.equal(x[:, :2], ve)
    toks = torch.from_numpy(batch["tokens"]).long()
    assert torch.equal(x[:, 2:], tp["embed"][toks[:, 2:]].to(torch.bfloat16))


def test_whisper_decode_reads_cross_kv_from_the_cache():
    """After prefill the cross k/v in the cache are the encoder output's
    projections (the reference's); a decode step reads them there and
    never needs the audio frames again."""
    jm, tm, params, tp = _zoo_pair("whisper-base")
    jb, tb = _both(_zoo_batch(jm.cfg, 1, 4, 24))
    _, cj = jax.jit(jm.prefill)(params, jb, jm.init_cache(1, 8))
    _, ct = tm.prefill(tp, tb, tm.init_cache(1, 8, device=CPU))
    for key in ("cross_k", "cross_v"):
        _close(ct["pos0"][key], np.asarray(cj["pos0"][key]))
        assert ct["pos0"][key].abs().max() > 0
    tok = np.array([[9]], np.int32)
    lj, _ = jm.decode_step(params, {"tokens": jnp.asarray(tok)}, cj,
                           jnp.asarray(4, jnp.int32))
    lt, _ = tm.decode_step(tp, {"tokens": torch.from_numpy(tok)}, ct, 4)
    _close(lt, lj)


# ------------------------------------------------- init, interop, refusals

def test_init_matches_reference_shapes_dtypes_and_kinds():
    """Every configuration (reduced, experts kept): the reference's tree
    of shapes, float32, zeros and ones where its init puts them, and the
    same scale rule elsewhere (std within 10% of the reference's)."""
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for arch in sorted(ARCHS):
        cj, ct = _zoo_cfgs(arch)
        ref = _np_tree(JaxModel(cj).init(jax.random.key(0)))
        got = Model(ct).init(0, device=CPU)
        _check_init(got, ref, Model(ct).specs(), (arch,))


def _check_init(g, r, spec, path):
    if isinstance(r, dict):
        assert set(g) == set(r) == set(spec), path
        for k in r:
            _check_init(g[k], r[k], spec[k], path + (k,))
        return
    assert tuple(g.shape) == r.shape and g.dtype == torch.float32, path
    if spec.init == "zeros":
        assert not g.any() and not r.any(), path
    elif spec.init == "ones":
        assert torch.equal(g, torch.ones_like(g)) and (r == 1).all(), path
    else:
        assert abs(float(g.std()) / float(r.std()) - 1.0) < 0.1, path


# leaves the reference reads in float32 (``.astype(f32)``) wherever they
# occur: the compute-dtype cast must leave them alone
_READ_F32 = {"norm1", "norm2", "final_norm", "cross_norm", "dt_proj",
             "dt_bias", "A_log", "router", "w_igate", "w_fgate", "b_igate",
             "b_fgate", "b_in", "r_z", "r_i", "r_f", "r_o"}


def test_init_cast_weights_keeps_float32_where_the_reference_reads_it():
    # every configuration: a leaf is stored in bf16 exactly where every
    # use casts it (COMPUTE_CAST), never where the reference reads it
    # in float32
    assert not COMPUTE_CAST & _READ_F32
    for arch in sorted(ARCHS):
        _, zt = _zoo_cfgs(arch, "bfloat16")
        cast = Model(zt).init(0, device=CPU, cast_weights=True)

        def walk(t, path):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, path + (k,))
                return
            want = (torch.bfloat16 if path[-1] in COMPUTE_CAST
                    else torch.float32)
            assert t.dtype == want, (arch, path, t.dtype)
            assert path[-1] in COMPUTE_CAST | _READ_F32, (arch, path)
        walk(cast, ())
    _, ct = _cfgs("jamba-1.5-large-398b", "bfloat16")
    p = Model(ct).init(0, device=CPU, cast_weights=True)
    mamba = p["layers"]["pos1"]["core"]
    assert p["embed"].dtype == torch.bfloat16
    assert mamba["in_proj"].dtype == torch.bfloat16
    for name in ("dt_proj", "dt_bias", "A_log"):
        assert mamba[name].dtype == torch.float32, name
    assert p["layers"]["pos0"]["norm1"].dtype == torch.float32
    assert p["final_norm"].dtype == torch.float32
    # the cast values are the float32 draw's, rounded once
    full = Model(ct).init(0, device=CPU)
    assert torch.equal(p["layers"]["pos0"]["core"]["wq"],
                       full["layers"]["pos0"]["core"]["wq"]
                       .to(torch.bfloat16))


def test_interop_raises_on_dtype_shape_or_key_mismatch():
    cj, ct = _cfgs("llama3.2-3b")
    tree = _np_tree(JaxModel(cj).init(jax.random.key(0)))
    bad = dict(tree, embed=tree["embed"].astype(np.float64))
    with pytest.raises(TypeError, match="params.embed"):
        model_params_from_arrays(bad, ct, device=CPU)
    bad = dict(tree, final_norm=tree["final_norm"][:-1])
    with pytest.raises(ValueError, match="params.final_norm"):
        model_params_from_arrays(bad, ct, device=CPU)
    bad = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="keys"):
        model_params_from_arrays(bad, ct, device=CPU)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_interop_round_trips_every_family(arch):
    """Each configuration's reference trees — parameters (experts,
    router, shared experts, mLSTM/sLSTM weights, the encoder) and a
    prefilled decode cache (KV, Mamba, mLSTM/sLSTM states, cross k/v) —
    carried into the port leaf for leaf, and the port's own tree has the
    reference's keys, shapes and dtypes; the port then prefills and
    decodes on them."""
    cj, ct = _zoo_cfgs(arch, "bfloat16")
    jm, tm = JaxModel(cj), Model(ct)
    params = jm.init(jax.random.key(2))
    tp = model_params_from_arrays(_np_tree(params), ct, device=CPU)
    _cmp_tree(tp, _np_tree(params),
              lambda g, w: np.testing.assert_array_equal(g.numpy(), w))
    jb, tb = _both(_zoo_batch(cj, 1, 8, 25))
    _, cache = jax.jit(jm.prefill)(params, jb, jm.init_cache(1, 16))
    tc = model_cache_from_arrays(_np_tree(cache), ct, 1, 16, device=CPU)
    _cmp_tree(tc, _np_tree(cache), lambda g, w: np.testing.assert_array_equal(
        g.float().numpy(), np.asarray(w, np.float32)))
    own = tm.init_cache(1, 16, device=CPU)
    _cmp_tree(own, _np_tree(jm.init_cache(1, 16)),
              lambda g, w: (g.shape == w.shape) or pytest.fail(
                  f"{g.shape} vs {w.shape}"))
    lg, tc = tm.prefill(tp, tb, tm.init_cache(1, 16, device=CPU))
    assert lg.shape == (1, 1, cj.vocab_size)
    dec = _dec_batch(cj, np.array([[1]], np.int32), np.array([8], np.int32))
    lg, _ = tm.decode_step(tp, _both(dec)[1], tc, 8)
    assert lg.shape == (1, 1, cj.vocab_size) and torch.isfinite(lg).all()


def test_unported_model_options_raise_naming_the_roadmap():
    """A mesh runs attention and decode (tests/test_torch_mesh.py) and
    trains every family (tests/test_torch_mesh_train.py,
    tests/test_torch_mesh_train_families.py); a value that is not a
    ``Mesh`` raises, and xLSTM, once refused on a training mesh, trains
    there to the unsharded loss."""
    from repro_torch.launch.mesh import make_local_mesh
    _, tm, _, tp = _model_pair("llama3.2-3b")
    q = torch.zeros((1, 4, 4, 16))
    with pytest.raises(TypeError, match="Mesh"):
        L.attention_apply(tp["layers"]["pos0"]["core"], tm.cfg,
                          torch.zeros((1, 4, 64)), torch.zeros((1, 4)),
                          mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        decode_attention(q[:, :1], q, q, 2, object())
    meshed = Model(tm.cfg)
    meshed.mesh = make_local_mesh((1, 2), devices=[CPU])
    loss, _ = meshed.forward_train(tp, {"tokens": torch.zeros(
        (1, 4), dtype=torch.int32)})
    assert torch.isfinite(loss)
    xl = Model(dataclasses.replace(reduced(get_arch("xlstm-1.3b")),
                                   compute_dtype="float32"))
    xp = xl.init(0, device=CPU)
    tokens = {"tokens": torch.arange(4, dtype=torch.int32)[None]}
    want, _ = xl.forward_train(xp, tokens)
    xl.mesh = meshed.mesh
    got, _ = xl.forward_train(xp, tokens)
    assert abs(float(got) / float(want) - 1) <= 1e-5
