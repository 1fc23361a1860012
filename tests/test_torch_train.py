"""PyTorch port, training: the data pipeline, the schedules and
optimizers, ``Model.forward_train`` and its gradients, the train step
(microbatches, gradient hooks), fault tolerance, instrumented training
with its attribution, training checkpoints across the two packages and
the training launcher — each against the JAX reference on the same
seeded weights and inputs (numpy on both sides; the weights carried over
through ``interop.model_params_from_arrays``, optimizer state through
``interop.optimizer_state_from_arrays``).

Bounds: losses within 1e-5 of the reference's (relative); each gradient
leaf within 1e-4 of that leaf's largest magnitude (float32 sums taken in
another order: XLA's fused reductions against PyTorch's; the worst leaf
measured ~1e-6, so 1e-4 is the stated bound with room for the MoE
router's and the sLSTM's longer chains); optimizer updates within 1e-6
on identical gradients (XLA's pow/rsqrt against PyTorch's, an ulp or
two); the data, the schedules and the compression round trips exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_arch as jax_get_arch, reduced as jax_reduced
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.distributed import compression as JC
from repro.distributed import fault_tolerance as JFT
from repro.models import Model as JaxModel
from repro.train import checkpoint as JCK
from repro.train import instrumented as JI
from repro.train import loop as JL
from repro.train import optimizer as JO
from repro_torch.configs import get_arch, reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.distributed import compression as TC
from repro_torch.distributed import fault_tolerance as TFT
from repro_torch.interop import (model_params_from_arrays,
                                 optimizer_state_from_arrays)
from repro_torch.models import Model
from repro_torch.train import checkpoint as TCK
from repro_torch.train import instrumented as TI
from repro_torch.train import loop as TL
from repro_torch.train import optimizer as TO

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

CPU = "cpu"
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
OPT_TOL = 1e-6


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if torch.is_tensor(t):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _both_cfgs(arch, dtype="float32", **kw):
    return [dataclasses.replace(red(get(arch)), compute_dtype=dtype, **kw)
            for get, red in ((jax_get_arch, jax_reduced),
                             (get_arch, reduced))]


_PAIRS = {}


def _pair(arch, seed=1):
    if (arch, seed) not in _PAIRS:
        cj, ct = _both_cfgs(arch)
        jm, tm = JaxModel(cj), Model(ct)
        params = jm.init(jax.random.key(seed))
        tp = model_params_from_arrays(_np_tree(params), ct, device=CPU)
        _PAIRS[arch, seed] = (jm, tm, params, tp)
    return _PAIRS[arch, seed]


def _batch(cfg, b, s, seed):
    """Tokens and labels, and the family's extra inputs (whisper's audio
    frames, qwen2-vl's vision rows on M-RoPE positions)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))
             .astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s))
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


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaf_errors(got, want):
    """{path: error relative to the reference leaf's largest magnitude},
    over the port's tree ``got`` and the reference's ``want`` (the same
    leaves)."""
    errs = dict(TO.tree_leaves(TO.tree_map(
        lambda path, g, w: ("/".join(path), _rel(_np_tree(g),
                                                 np.asarray(w, np.float32))),
        got, want, path=())))
    assert len(errs) == len(TO.tree_leaves(want))
    return errs


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("seed,step,shard,n_shards",
                         [(0, 0, 0, 1), (0, 7, 0, 1), (3, 2, 1, 2),
                          (5, 11, 3, 4)])
def test_synthetic_lm_batches_equal_reference(seed, step, shard, n_shards):
    jd = JaxSyntheticLM(JaxDataConfig(500, 48, 8, seed=seed))
    td = SyntheticLM(DataConfig(500, 48, 8, seed=seed))
    want = jd.batch(step, shard=shard, n_shards=n_shards)
    got = td.batch(step, shard=shard, n_shards=n_shards)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------- schedules

@pytest.mark.parametrize("name", ["llama3.2-3b", "minicpm-2b"])
@pytest.mark.parametrize("total", [1000, 40])
def test_schedules_equal_reference(name, total):
    """``schedule_for`` (cosine, or WSD for minicpm) at 20 steps: the same
    float32 values (the reference's ops run one by one, as the port's)."""
    want = JO.schedule_for(name, base_lr=3e-3, total=total)
    got = TO.schedule_for(name, base_lr=3e-3, total=total)
    for step in range(20):
        w = np.asarray(want(step))
        g = got(step)
        assert g.dtype == torch.float32 and w.dtype == np.float32
        assert g.item() == float(w), (step, g.item(), float(w))


# --------------------------------------------------------- optimizers

def _opt_case(seed):
    """A tree with a stacked 3-D leaf, a matrix and a vector, and three
    rounds of gradients."""
    rng = np.random.default_rng(seed)
    shapes = {"layers": {"w": (2, 6, 5), "b": (5,)}, "embed": (7, 6)}

    def draw(scale):
        return {"layers": {k: (rng.normal(0, scale, s)).astype(np.float32)
                           for k, s in shapes["layers"].items()},
                "embed": rng.normal(0, scale, shapes["embed"])
                .astype(np.float32)}
    params = draw(0.5)
    grads = [draw(2.0 if i == 1 else 0.3) for i in range(3)]
    return params, grads


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_updates_match_reference(kind):
    """Three updates on identical gradients (the same numpy arrays into
    both; the second large enough that AdamW clips): parameters, state
    and the returned gradient norm within 1e-6."""
    params, grads = _opt_case(3)
    jopt = getattr(JO, kind)()
    topt = getattr(TO, kind)()
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = _torch(params["layers"])
    tp = {"layers": tp, "embed": torch.from_numpy(params["embed"].copy())}
    ts = topt.init(tp)
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        jp, js, jn = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                                 jnp.float32(lr))
        tg = {"layers": _torch(g["layers"]),
              "embed": torch.from_numpy(g["embed"].copy())}
        tp, ts, tn = topt.update(tg, ts, tp, torch.tensor(lr,
                                                          dtype=torch.float32))
        for path, err in _leaf_errors(tp, _np_tree(jp)).items():
            assert err <= OPT_TOL, (i, path, err)
        state_err = _leaf_errors({k: v for k, v in ts.items()
                                  if k != "count"},
                                 {k: _np_tree(v) for k, v in js.items()
                                  if k != "count"})
        assert max(state_err.values()) <= OPT_TOL, state_err
        assert int(ts["count"]) == int(js["count"]) == i + 1
        assert ts["count"].dtype == torch.int32
        assert abs(float(tn) / float(jn) - 1.0) <= OPT_TOL


def test_adafactor_bf16_leaves_match_reference():
    """Adafactor on bfloat16 parameters and gradients (the hybrid's
    masters at full width): float32 arithmetic, the result rounded back
    to bfloat16, as the reference's ``.astype(p.dtype)``.  Three updates
    on the same bf16 arrays into both: every parameter within one bf16
    ulp of the reference's, the float32 state and the gradient norm
    within 1e-6."""
    params, grads = _opt_case(4)
    bf = jnp.bfloat16

    def jtree(t):
        return jax.tree.map(lambda v: jnp.asarray(v).astype(bf), t)

    def ttree(t):
        return TO.tree_map(lambda v: torch.from_numpy(np.array(v))
                           .to(torch.bfloat16), t)
    jopt, topt = JO.adafactor(), TO.adafactor()
    jp, tp = jtree(params), ttree(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        jp, js, jn = jopt.update(jtree(g), js, jp, jnp.float32(lr))
        tp, ts, tn = topt.update(ttree(g), ts, tp,
                                 torch.tensor(lr, dtype=torch.float32))
        for got, want in zip(TO.tree_leaves(tp), jax.tree.leaves(jp)):
            assert got.dtype == torch.bfloat16 and want.dtype == bf
            w = np.asarray(want.astype(jnp.float32), np.float64)
            d = np.abs(got.float().numpy().astype(np.float64) - w)
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w),
                                                      2.0 ** -126))) - 7)
            assert (d <= ulp).all(), (i, float((d / ulp).max()))
        state_err = _leaf_errors(ts["slots"], _np_tree(js["slots"]))
        assert max(state_err.values()) <= OPT_TOL, state_err
        assert abs(float(tn) / float(jn) - 1.0) <= OPT_TOL


def test_hybrid_bf16_masters_take_a_step():
    """The reduced hybrid with ``param_dtype="bfloat16"`` (the masters of
    the full-width run on the card) takes Adafactor steps through
    ``make_train_step`` on the CPU: a finite loss, every leaf's first
    gradient finite and not all zero (the Mamba leaves behind dt, B, C
    and A among them), every leaf still bfloat16 after the updates (the
    step refuses no bf16 master), and the zero-initialized ``A_log`` and
    ``dt_bias``, which only the scan reaches, moved."""
    cfg = dataclasses.replace(reduced(get_arch("jamba-1.5-large-398b")),
                              param_dtype="bfloat16", moe=None)
    model = Model(cfg)
    params = model.init(0, device=CPU)
    before = TO.tree_map(torch.clone, params)
    opt = TO.optimizer_for(cfg)
    first = []

    def hook(grads):
        if not first:
            first.append(TO.tree_map(torch.clone, grads))
        return grads
    step = TL.make_train_step(model, opt, TO.schedule_for(cfg.name, 3e-3,
                                                          1000),
                              grad_hook=hook)
    state = opt.init(params)
    batch = _torch(_batch(cfg, 2, 16, 38))
    for s in range(2):
        params, state, m = step(params, state, batch, s)
        assert torch.isfinite(m["loss"])
    for path, g in TO.tree_leaves(TO.tree_map(
            lambda p, g: ("/".join(p), g), first[0], path=())):
        assert torch.isfinite(g).all() and g.ne(0).any(), path
    assert all(t.dtype == torch.bfloat16 for t in TO.tree_leaves(params))
    for pos in range(1, len(cfg.block_pattern)):
        core, was = (t["layers"][f"pos{pos}"]["core"]
                     for t in (params, before))
        for leaf in ("A_log", "dt_bias"):
            assert not torch.equal(core[leaf], was[leaf]), (pos, leaf)


def test_optimizers_minimize_quadratic():
    """The reference's own check (``tests/test_system.py``) on the
    port."""
    for opt in (TO.adamw(weight_decay=0.0), TO.adafactor()):
        params = {"w": torch.full((4, 4), 5.0)}
        state = opt.init(params)
        for _ in range(200):
            grads = {"w": 2 * params["w"]}
            params, state, _ = opt.update(grads, state, params, 0.05)
        assert float(params["w"].abs().max()) < 1.0


# --------------------------------------------------------- forward_train

@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_forward_train_loss_matches_reference(arch):
    """Every configuration at ``reduced()``, float32, experts kept: the
    loss and its ``ce``/``aux`` terms within 1e-5 of the reference's."""
    jm, tm, params, tp = _pair(arch)
    batch = _batch(jm.cfg, 2, 16, 31)
    (lj, mj) = jax.jit(jm.forward_train)(params, _jnp(batch))
    with torch.no_grad():
        lt, mt = tm.forward_train(tp, _torch(batch))
    assert set(mt) == set(mj) == {"ce", "aux"}
    assert lt.dtype == torch.float32 and lt.dim() == 0
    assert abs(float(lt) - float(lj)) <= LOSS_TOL * abs(float(lj))
    for k in ("ce", "aux"):
        assert abs(float(mt[k]) - float(mj[k])) <= \
            LOSS_TOL * max(abs(float(mj[k])), 1e-30)


GRAD_ARCHS = ["llama3.2-3b", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b",
              "xlstm-1.3b", "whisper-base", "qwen2-vl-2b"]


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_reference(arch):
    """``jax.value_and_grad(model.forward_train)`` against the port's
    ``loss_and_grads`` (autograd over every leaf): dense, MoE (router and
    experts), the Mamba hybrid (the plain B10 on the CPU), xLSTM, whisper
    (encoder and cross-attention) and qwen2-vl (vision rows, M-RoPE):
    loss within 1e-5, each leaf within 1e-4 of its largest magnitude."""
    jm, tm, params, tp = _pair(arch)
    batch = _batch(jm.cfg, 2, 16, 32)
    (lj, _), gj = jax.jit(jax.value_and_grad(jm.forward_train,
                                             has_aux=True))(params,
                                                            _jnp(batch))
    lt, _, gt = TL.loss_and_grads(tm, tp, _torch(batch))
    assert abs(float(lt) - float(lj)) <= LOSS_TOL * abs(float(lj))
    errs = _leaf_errors(gt, _np_tree(gj))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    # every leaf the reference moves, the port moves
    for path, g in zip(sorted(errs), TO.tree_leaves(gt)):
        assert torch.isfinite(g).all(), path


def test_remat_recomputes_the_same_gradients():
    """``cfg.remat`` (each pattern group and each cross-entropy chunk
    recomputed in the backward) changes no bit of the loss or of any
    gradient."""
    _, tm, _, tp = _pair("jamba-1.5-large-398b")
    assert not tm.cfg.remat
    remat = Model(dataclasses.replace(tm.cfg, remat=True))
    batch = _torch(_batch(tm.cfg, 2, 16, 33))
    l0, _, g0 = TL.loss_and_grads(tm, tp, batch)
    l1, _, g1 = TL.loss_and_grads(remat, tp, batch)
    assert torch.equal(l0, l1)
    for a, b in zip(TO.tree_leaves(g0), TO.tree_leaves(g1)):
        assert torch.equal(a, b)


def test_chunked_cross_entropy_over_several_chunks():
    """At 1024 tokens the loss runs two 512-token chunks; a length that
    is not a multiple of the chunk asserts, as in the reference."""
    jm, tm, params, tp = _pair("llama3.2-3b")
    batch = _batch(jm.cfg, 1, 1024, 34)
    lj, _ = jax.jit(jm.forward_train)(params, _jnp(batch))
    lt, _, g = TL.loss_and_grads(tm, tp, _torch(batch))
    assert abs(float(lt) - float(lj)) <= LOSS_TOL * abs(float(lj))
    bad = _torch(_batch(jm.cfg, 1, 520, 35))
    with pytest.raises(AssertionError):
        tm.forward_train(tp, bad)


# ------------------------------------------------------------ the step

def _setup(arch="llama3.2-3b", batch=4, seq=64, lr_total=500,
           base_lr=3e-3, micro=1, grad_hook=None):
    cfg = reduced(get_arch(arch))
    model = Model(cfg)
    params = model.init(0, device=CPU)
    opt = TO.optimizer_for(cfg)
    lr = TO.schedule_for(cfg.name, base_lr, lr_total)
    step_fn = TL.make_train_step(model, opt, lr, micro=micro,
                                 grad_hook=grad_hook)
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq, batch, seed=0))
    return cfg, model, params, opt.init(params), step_fn, data


def test_train_step_matches_reference_step():
    """One step of the port's ``make_train_step`` against the
    reference's on the same weights and batch: loss 1e-5, the metrics'
    names and step equal, lr within an ulp (XLA fuses the schedule's
    float32 ops inside the jitted step; run op by op they are equal,
    ``test_schedules_equal_reference``), the gradient norm 1e-5 (the step's
    gradients are held leaf by leaf in ``test_gradients_match_reference``;
    the updated parameters are not compared: AdamW's first step moves a
    parameter whose gradient is near zero by a whole lr in the sign of
    that gradient, so an ulp in a gradient can flip it)."""
    jm, tm, params, tp = _pair("llama3.2-3b")
    batch = {k: v for k, v in _batch(jm.cfg, 2, 32, 36).items()}
    jopt, topt = JO.adamw(), TO.adamw()
    jlr = JO.schedule_for(jm.cfg.name, 3e-3, 1000)
    tlr = TO.schedule_for(tm.cfg.name, 3e-3, 1000)
    _, _, mj = jax.jit(JL.make_train_step(jm, jopt, jlr))(
        params, jopt.init(params), _jnp(batch), jnp.asarray(5, jnp.int32))
    tparams = TO.tree_map(torch.clone, tp)
    _, _, mt = TL.make_train_step(tm, topt, tlr)(
        tparams, topt.init(tparams), _torch(batch), 5)
    assert set(mt) == set(mj) == {"loss", "gnorm", "lr", "step"}
    assert abs(float(mt["loss"]) / float(mj["loss"]) - 1) <= LOSS_TOL
    assert abs(float(mt["gnorm"]) / float(mj["gnorm"]) - 1) <= LOSS_TOL
    assert abs(float(mt["lr"]) / float(mj["lr"]) - 1) <= 2.0 ** -23
    assert int(mt["step"]) == int(mj["step"]) == 6


def test_microbatched_step_matches_reference_step():
    """micro=2 of the port's ``make_train_step`` (float32 gradients
    accumulated over the microbatches in order, then divided by micro)
    against the reference's ``lax.scan`` on the same weights and batch:
    the loss and the gradient norm within 1e-5.  The norm is taken from
    the accumulated gradients, so a lost microbatch, a missing divide or
    a gradient cut off moves it."""
    jm, tm, params, tp = _pair("llama3.2-3b")
    batch = _batch(jm.cfg, 4, 32, 37)
    jopt, topt = JO.adamw(), TO.adamw()
    jlr = JO.schedule_for(jm.cfg.name, 3e-3, 1000)
    tlr = TO.schedule_for(tm.cfg.name, 3e-3, 1000)
    _, _, mj = jax.jit(JL.make_train_step(jm, jopt, jlr, micro=2))(
        params, jopt.init(params), _jnp(batch), jnp.asarray(5, jnp.int32))
    tparams = TO.tree_map(torch.clone, tp)
    _, _, mt = TL.make_train_step(tm, topt, tlr, micro=2)(
        tparams, topt.init(tparams), _torch(batch), 5)
    assert abs(float(mt["loss"]) / float(mj["loss"]) - 1) <= LOSS_TOL
    assert abs(float(mt["gnorm"]) / float(mj["gnorm"]) - 1) <= LOSS_TOL


def test_training_reduces_loss():
    """The reference's own check (``tests/test_system.py``): 25 steps of
    reduced llama lower the loss by more than 0.2."""
    _, _, p, o, step_fn, data = _setup()
    losses = []
    for s in range(25):
        p, o, m = step_fn(p, o, _torch(data.batch(s)), s)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses[::6]


def test_microbatched_step_matches_full_batch():
    """micro=2 against micro=1 on a dense model, at the reference's
    bounds (``tests/test_system.py``): MoE is left out, as there,
    because its capacity depends on the microbatch's token count (the
    accumulation itself is held to the reference by
    ``test_microbatched_step_matches_reference_step``)."""
    cfg, model, p, o, _, data = _setup(batch=4, seq=32)
    opt = TO.optimizer_for(cfg)
    lr = TO.schedule_for(cfg.name, 1e-3, 500)
    f1 = TL.make_train_step(model, opt, lr, micro=1)
    f2 = TL.make_train_step(model, opt, lr, micro=2)
    b = _torch(data.batch(0))
    p1, _, m1 = f1(TO.tree_map(torch.clone, p), opt.init(p), b, 0)
    p2, _, m2 = f2(TO.tree_map(torch.clone, p), opt.init(p), b, 0)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 2e-2
    for a, c in zip(TO.tree_leaves(p1), TO.tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=2e-2,
                                   atol=2e-3)


def test_split_micro_keeps_mrope_positions():
    """``_split_micro``'s (3, B, S) case, as the reference's."""
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 9, (4, 6)).astype(np.int32),
             "positions": rng.integers(0, 9, (3, 4, 6)).astype(np.int32)}
    want = JL._split_micro(_jnp(batch), 2)
    got = TL._split_micro(_torch(batch), 2)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_cast_weights_are_refused():
    """A tree stored cast (bf16 weights) would train bf16 masters: the
    step refuses it."""
    cfg = dataclasses.replace(reduced(get_arch("llama3.2-3b")),
                              compute_dtype="bfloat16")
    model = Model(cfg)
    params = model.init(0, device=CPU, cast_weights=True)
    opt = TO.adamw()
    step = TL.make_train_step(model, opt, TO.schedule_for(cfg.name))
    batch = _torch(_batch(cfg, 1, 8, 37))
    with pytest.raises(ValueError, match="cast_weights=False"):
        step(params, opt.init(params), batch, 0)


def test_eval_step_matches_reference():
    jm, tm, params, tp = _pair("moonshot-v1-16b-a3b")
    batch = _batch(jm.cfg, 2, 16, 38)
    want = JL.make_eval_step(jm)(params, _jnp(batch))
    got = TL.make_eval_step(tm)(tp, _torch(batch))
    assert set(got) == set(want) == {"loss", "ce", "aux"}
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= \
            LOSS_TOL * abs(float(want[k]))


# ------------------------------------------------------ gradient hooks

def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(0, 1e-3, (37, 11)).astype(np.float32),
            "b": {"c": rng.normal(0, 5.0, (300,)).astype(np.float32),
                  "d": (rng.normal(0, 1, (4, 64)) *
                        np.logspace(-8, 2, 64)).astype(np.float32)}}


@pytest.mark.parametrize("scheme", ["bf16", "int8"])
def test_grad_hooks_equal_reference_round_trip(scheme):
    """``make_grad_hook`` and ``ef_roundtrip`` (two steps, the residual
    carried) against the reference's on the same gradients: equal."""
    g = _grad_tree(4)
    want = JC.make_grad_hook(scheme)(jax.tree.map(jnp.asarray, g))
    got = TC.make_grad_hook(scheme)(_torch_tree(g))
    for path, err in _leaf_errors(got, _np_tree(want)).items():
        assert err == 0.0, (path, err)
    jres = tres = None
    for seed in (5, 6):
        g = _grad_tree(seed)
        jrt, jres = JC.ef_roundtrip(jax.tree.map(jnp.asarray, g), jres,
                                    scheme=scheme)
        trt, tres = TC.ef_roundtrip(_torch_tree(g), tres, scheme=scheme)
        for a, b in ((trt, jrt), (tres, jres)):
            for path, err in _leaf_errors(a, _np_tree(b)).items():
                assert err == 0.0, (path, err)
    assert TC.make_grad_hook("none") is None
    with pytest.raises(ValueError):
        TC.make_grad_hook("fp4")(_torch_tree(g))


def _torch_tree(t):
    if isinstance(t, dict):
        return {k: _torch_tree(v) for k, v in t.items()}
    return torch.from_numpy(np.array(t))


def test_int8_compress_blocks_equal_reference():
    x = np.random.default_rng(7).normal(0, 3, (5, 77)).astype(np.float32)
    qj, sj, shj, pj = JC.int8_compress(jnp.asarray(x))
    qt, st, sht, pt = TC.int8_compress(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert (tuple(sht), pt) == (tuple(shj), pj)


def test_grad_compression_hook_trains():
    """The reference's own check (``tests/test_system.py``): with the
    bf16 hook the loss still falls."""
    _, _, p, o, step_fn, data = _setup(grad_hook=TC.make_grad_hook("bf16"))
    losses = []
    for s in range(15):
        p, o, m = step_fn(p, o, _torch(data.batch(s)), s)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.1


# ----------------------------------------------------- fault tolerance

def _restart_case(ft):
    state0 = {"x": 0.0}
    saved = {}

    def save_fn(state, step):
        saved["state"], saved["step"] = dict(state), step

    def restore_fn():
        if not saved:
            return None
        return dict(saved["state"]), saved["step"]

    fails = {7: "node_failure", 13: "nan_loss"}
    seen = set()

    def train_one(state, step):
        if step in fails and step not in seen:
            seen.add(step)
            raise ft.TrainingFault(fails[step])
        return {"x": state["x"] + 1.0}, {"loss": 1.0 / (step + 1)}

    state, step, events = ft.run_with_restarts(
        lambda: (dict(state0), 0), train_one, n_steps=20, save_fn=save_fn,
        restore_fn=restore_fn, policy=ft.RestartPolicy(max_restarts=5),
        ckpt_every=5)
    return state, step, [{k: v for k, v in e.items() if k != "t"}
                         for e in events]


def _decay_case(ft, reset_after):
    fail_at = {3, 10, 17}
    seen = set()

    def train_one(state, step):
        if step in fail_at and step not in seen:
            seen.add(step)
            raise ft.TrainingFault("node_failure")
        return state, {"loss": 0.5}

    try:
        _, step, events = ft.run_with_restarts(
            lambda: ({}, 0), train_one, n_steps=25,
            save_fn=lambda *a: None, restore_fn=lambda: None,
            policy=ft.RestartPolicy(max_restarts=2,
                                    reset_after_steps=reset_after),
            ckpt_every=100)
    except ft.TrainingFault as e:
        return "raised", e.kind
    return step, [e["kind"] for e in events]


def _straggler_case(ft, n, times_fn, **kw):
    mon = ft.StragglerMonitor(n, **kw)
    out = []
    for s in range(8):
        v = mon.observe(times_fn(s))
        out.append([(x.host, x.is_straggler, round(x.deviation_mads, 9))
                    for x in v])
    return sorted(mon.flagged), out


def _noisy_times(s):
    rng = np.random.default_rng(s)
    t = list(0.1 + rng.normal(0, 0.002, 8))
    if s >= 3:
        t[5] += 0.05
    return t


@pytest.mark.parametrize("case", ["restarts", "budget", "decay",
                                  "no_decay", "backoff", "straggler",
                                  "median"])
def test_fault_tolerance_matches_reference(case):
    """The reference's own cases (``tests/test_checkpoint_ft.py``) run
    through both packages: the same final state, steps, events (less
    their wall times), verdicts and flags."""
    def run(ft):
        if case == "restarts":
            return _restart_case(ft)
        if case == "budget":
            def always(state, step):
                raise ft.TrainingFault("node_failure")
            try:
                ft.run_with_restarts(
                    lambda: ({}, 0), always, n_steps=5,
                    save_fn=lambda *a: None, restore_fn=lambda: None,
                    policy=ft.RestartPolicy(max_restarts=2))
            except ft.TrainingFault as e:
                return "raised", e.kind, str(e)
            return "finished"
        if case == "decay":
            return _decay_case(ft, 5)
        if case == "no_decay":
            return _decay_case(ft, 0)
        if case == "backoff":
            p = ft.RestartPolicy(backoff_s=1.0, backoff_factor=2.0,
                                 backoff_max_s=60.0)
            return [p.backoff(a) for a in (0, 5, 6, 50)]
        if case == "straggler":
            return _straggler_case(ft, 8, _noisy_times, threshold=4.0,
                                   patience=2)
        return ([ft._median(v) for v in ([1.0, 2.0, 3.0, 4.0], [3.0, 1.0],
                                        [5.0, 1.0, 3.0])],
                _straggler_case(ft, 4, lambda s: [1.0, 1.0, 1.1, 1.1],
                                threshold=5.0, patience=1))
    got, want = run(TFT), run(JFT)
    assert got == want
    if case == "restarts":
        kinds = [e["kind"] for e in got[2]]
        assert got[1] == 20 and kinds.count("fault") == 2
        assert "skip_batch" in kinds


# -------------------------------------------------- instrumented training

def test_instrumented_training_matches_reference_structure():
    """``run_instrumented_training`` + ``attribution_report`` on reduced
    llama, 8 steps in both packages: the same phase names in the same
    order and count, a PhaseEnergy record per phase, the step dominating
    the energy at a power between idle and TDP (the reference's own
    checks), and the metrics' keys; the port's loss falls over the run."""
    def run(pkg):
        cfg = (jax_reduced(JAX_ARCHS["llama3.2-3b"]) if pkg == "jax"
               else reduced(get_arch("llama3.2-3b")))
        data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 2, seed=0))
        if pkg == "jax":
            model = JaxModel(cfg)
            p = model.init(jax.random.key(0))
            opt = JO.optimizer_for(cfg)
            o = opt.init(p)
            step_fn = jax.jit(JL.make_train_step(
                model, opt, JO.schedule_for(cfg.name, 3e-3, 500)))

            def next_batch(step):
                return _jnp(data.batch(step))

            def as_step(s):
                return jnp.asarray(s, jnp.int32)
            mod = JI
        else:
            model = Model(cfg)
            p = model.init(0, device=CPU)
            opt = TO.optimizer_for(cfg)
            o = opt.init(p)
            step_fn = TL.make_train_step(
                model, opt, TO.schedule_for(cfg.name, 3e-3, 500))

            def next_batch(step):
                return _torch(data.batch(step))

            def as_step(s):
                return s
            mod = TI

        def train_one(st, batch, step):
            pp, oo = st if st is not None else (p, o)
            pp, oo, m = step_fn(pp, oo, batch, as_step(step))
            return (pp, oo), m
        run, _ = mod.run_instrumented_training(train_one, 8, next_batch)
        by_name, per_phase = mod.attribution_report(run)
        return run, by_name, per_phase

    jrun, jby, jper = run("jax")
    trun, tby, tper = run("torch")
    assert [n for n, _, _ in trun.phases] == [n for n, _, _ in jrun.phases]
    assert sorted(tby) == sorted(jby)
    assert {k: v["n"] for k, v in tby.items()} == \
        {k: v["n"] for k, v in jby.items()}
    assert len(tper) == len(trun.phases) == len(jper)
    assert set(trun.traces) == set(jrun.traces)
    assert [sorted(m) for m in trun.metrics_log] == \
        [sorted(m) for m in jrun.metrics_log]
    total = sum(v["energy_j"] for v in tby.values())
    assert tby["train_step"]["energy_j"] > 0.5 * total
    assert 55.0 - 5 < tby["train_step"]["mean_power_w"] < 215.0 + 5
    losses = [m["loss"] for m in trun.metrics_log]
    assert losses[-1] < losses[0]


# ------------------------------------------------ training checkpoints

@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma2-27b"])
def test_training_checkpoint_crosses_packages(arch, tmp_path):
    """A ``(params, opt_state)`` checkpoint (AdamW for llama, Adafactor
    for gemma2) after one step, written by each package, restores in the
    other bit for bit: the reference's tree into the port through
    ``interop``, the port's into the reference's ``restore_checkpoint``
    with its own tree as the template."""
    jm, tm, params, tp = _pair(arch)
    batch = _batch(jm.cfg, 2, 16, 39)
    jopt, topt = JO.optimizer_for(jm.cfg), TO.optimizer_for(tm.cfg)
    kind = "adafactor" if jm.cfg.optimizer == "adafactor" else "adamw"
    lr_j = JO.schedule_for(jm.cfg.name, 3e-3, 1000)
    lr_t = TO.schedule_for(tm.cfg.name, 3e-3, 1000)
    jstate = jax.jit(JL.make_train_step(jm, jopt, lr_j))(
        params, jopt.init(params), _jnp(batch), jnp.asarray(0, jnp.int32))[:2]
    tparams = TO.tree_map(torch.clone, tp)
    tstate = TL.make_train_step(tm, topt, lr_t)(
        tparams, topt.init(tparams), _torch(batch), 0)[:2]

    def equal(got, want):
        gl, wl = TCK._flatten(got)[0], TCK._flatten(want)[0]
        assert len(gl) == len(wl)
        for g, w in zip(gl, wl):
            g, w = TCK._host(g), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)

    # reference -> port
    JCK.save_checkpoint(tmp_path / "ref", 1, jstate)
    (p_np, o_np), step, _ = TCK.restore_checkpoint(tmp_path / "ref", tstate)
    assert step == 1
    port = (model_params_from_arrays(p_np, tm.cfg, device=CPU),
            optimizer_state_from_arrays(o_np, tstate[0], kind, device=CPU))
    equal(port, jax.tree.map(np.asarray, jstate))
    # port -> reference
    TCK.save_checkpoint(tmp_path / "port", 1, tstate)
    back, step, _ = JCK.restore_checkpoint(tmp_path / "port", jstate)
    assert step == 1
    equal(tstate, back)


def test_optimizer_state_interop_raises_on_mismatch():
    _, tm, _, tp = _pair("llama3.2-3b")
    state = _np_tree(TO.adamw().init(tp))
    bad = dict(state, count=np.zeros((), np.int64))
    with pytest.raises(TypeError):
        optimizer_state_from_arrays(bad, tp, "adamw", device=CPU)
    with pytest.raises(ValueError):
        optimizer_state_from_arrays(state, tp, "adafactor", device=CPU)
    with pytest.raises(ValueError):
        optimizer_state_from_arrays(state, tp, "sgd", device=CPU)


# ---------------------------------------------------------- the launcher

def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    """``launch.train.main`` (the reference's flags) for 3 steps with a
    checkpoint every step, then again: the second run resumes from step
    3; both print the attribution table."""
    from repro_torch.launch.train import main
    args = ["--steps", "3", "--seq-len", "16", "--batch", "2",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "1",
            "--out", str(tmp_path / "run.npz")]
    assert main(args, device=CPU) == 0
    out = capsys.readouterr().out
    assert "arch=llama3.2-3b" in out and "train_step" in out
    assert "loss:" in out and (tmp_path / "run.npz").exists()
    assert TCK.latest_step(tmp_path) == 3
    assert main(args, device=CPU) == 0
    out = capsys.readouterr().out
    assert "resumed from step 3" in out
    assert TCK.latest_step(tmp_path) == 6
