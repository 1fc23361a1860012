"""What the MoE capacity does to prefill against step-by-step decode, and
to the two serving engines, in either package (CPU, float32).

The capacity of an MoE layer is a function of the call's token count
(``_capacity(b * s)``): a prefill of S tokens drops the assignments past
an expert's capacity, while a single-token decode step (capacity 8, one
assignment per expert at most) never drops.  So a prompt's last prefill
logits and the same prompt decoded token by token differ once the
prefill drops, in the reference as in the port; a prompt of at most 8
tokens cannot drop.  For a moonshot-v1-16b-a3b layout at a small width
(64 experts top-6, 2 shared experts; d_model 512, 4 layers, expert d_ff
128, vocab 4096) the script prints, for prompts of 8, 32 and 128 tokens,
the largest logit difference, whether it is within the reference's
bounds (atol 5e-2, rtol 1e-2) and, with ``--package repro_torch``, how
many of layer 0's assignments the prefill drops (the CPU tests hold the
port's routing equal to the reference's).  Then, for each MoE
configuration at ``reduced()``, whether ``ServeEngine`` and
``FixedBatchEngine`` give the same greedy tokens for four 24-token
prompts (the reference's ``test_continuous_matches_fixed_batch``, which
it runs on llama only), and the same for an untied layout
(``engine_layout``: 64 experts top-6 at d_model 256, 2 layers, its own
output head, so the greedy token is not the last prompt token repeated,
as tied random embeddings make it) with 8-token prompts (no capacity
drops) and 64-token ones (the batch-1 and the 2-slot prefills drop
different assignments).

    PYTHONPATH=src python scripts/moe_capacity_drops.py --package repro
    PYTHONPATH=src python scripts/moe_capacity_drops.py --package repro_torch
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib

import numpy as np

MOE_ARCHS = ("moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b",
             "jamba-1.5-large-398b")


def layout(configs):
    base = configs.get_arch("moonshot-v1-16b-a3b")
    return dataclasses.replace(
        base, num_layers=4, d_model=512, num_heads=4, num_kv_heads=4,
        vocab_size=4096, compute_dtype="float32",
        moe=dataclasses.replace(base.moe, expert_d_ff=128))


def engine_layout(configs):
    base = configs.get_arch("moonshot-v1-16b-a3b")
    return dataclasses.replace(
        base, num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
        vocab_size=1024, compute_dtype="float32", tie_embeddings=False,
        moe=dataclasses.replace(base.moe, expert_d_ff=64))


def layer0_drops(cfg, tokens, seed) -> int:
    """Layer 0's dropped assignments in a prefill of ``tokens`` (the
    port's router on the port's weights drawn from ``seed``)."""
    import torch
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    model = Model(cfg)
    p = model.init(seed, device="cpu")
    x = p["embed"][torch.as_tensor(tokens).long()]
    blk = L.tree_map(lambda t: t[0], p["layers"]["pos0"])
    # layer 0's MoE input is its norm of x plus its attention output:
    # run the block's attention as the model does
    h = L.rms_norm(x, blk["norm1"], cfg.rms_eps)
    pos = torch.arange(x.shape[1])[None]
    att, _ = L.attention_apply(blk["core"], cfg, h, pos)
    x = x + att
    hf = L.rms_norm(x, blk["norm2"], cfg.rms_eps)
    _, kept = MOE.moe_assignments(blk["ffn"], cfg, hf)
    return int((~kept).sum())


def prefill_vs_decode(pkg, cfg, n, seed):
    rng = np.random.default_rng(seed + 1)
    tokens = rng.integers(1, cfg.vocab_size, (1, n)).astype(np.int32)
    if pkg == "repro":
        import jax
        import jax.numpy as jnp
        from repro.models import Model
        m = Model(cfg)
        p = m.init(jax.random.key(seed))
        toks = jnp.asarray(tokens)
        lp, _ = jax.jit(m.prefill)(p, {"tokens": toks}, m.init_cache(1, 256))
        cache, step = m.init_cache(1, 256), jax.jit(m.decode_step)
        for i in range(n):
            lg, cache = step(p, {"tokens": toks[:, i:i + 1]}, cache,
                             jnp.asarray(i, jnp.int32))
    else:
        import torch
        from repro_torch.models import Model
        m = Model(cfg)
        p = m.init(seed, device="cpu")
        toks = torch.as_tensor(tokens)
        lp, _ = m.prefill(p, {"tokens": toks}, m.init_cache(1, 256,
                                                            device="cpu"))
        cache = m.init_cache(1, 256, device="cpu")
        for i in range(n):
            lg, cache = m.decode_step(p, {"tokens": toks[:, i:i + 1]},
                                      cache, i)
    a, b = np.asarray(lp[0, -1]), np.asarray(lg[0, 0])
    return (float(np.abs(a - b).max()),
            bool(np.allclose(a, b, atol=5e-2, rtol=1e-2)), tokens)


def engines_agree(pkg, cfg, seed, plen=24) -> bool:
    serve = importlib.import_module(f"{pkg}.serve")
    models = importlib.import_module(f"{pkg}.models")
    model = models.Model(cfg)
    kw = {}
    if pkg == "repro":
        import jax
        params = model.init(jax.random.key(seed))
    else:
        params = model.init(seed, device="cpu")
        kw = dict(device="cpu")

    def reqs():
        rng = np.random.default_rng(seed)
        return [serve.Request(rid=i, prompt=rng.integers(
            1, cfg.vocab_size, plen).astype(np.int32), max_new_tokens=mn)
            for i, mn in enumerate((7, 3, 5, 2))]
    max_len = 2 * plen + 16
    fixed = serve.FixedBatchEngine(model, params, batch_slots=2,
                                   max_len=max_len, **kw).run(reqs())
    cont = serve.ServeEngine(model, params, batch_slots=2, max_len=max_len,
                             flush_interval=2, **kw).run(reqs())
    return fixed == cont


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("repro", "repro_torch"),
                    default="repro_torch")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    configs = importlib.import_module(f"{args.package}.configs")
    cfg = layout(configs)
    for n in (8, 32, 128):
        diff, ok, tokens = prefill_vs_decode(args.package, cfg, n,
                                             args.seed)
        drops = ""
        if args.package == "repro_torch":
            drops = (f"; layer 0's prefill drops "
                     f"{layer0_drops(cfg, tokens, args.seed)} of "
                     f"{n * cfg.moe.top_k} assignments")
        print(f"{args.package}: {n}-token prompt, prefill vs step-by-step "
              f"decode max |diff| {diff:.3e}, within the bounds {ok}"
              + drops)
    for arch in MOE_ARCHS:
        red = dataclasses.replace(configs.reduced(configs.get_arch(arch)),
                                  compute_dtype="float32")
        same = engines_agree(args.package, red, args.seed)
        print(f"{args.package}: {arch} reduced, continuous vs fixed-batch "
              f"greedy tokens equal: {same}")
    untied = engine_layout(configs)
    for plen in (8, 64):
        same = engines_agree(args.package, untied, args.seed, plen)
        print(f"{args.package}: the untied layout, {plen}-token prompts, "
              f"continuous vs fixed-batch greedy tokens equal: {same}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
