"""PyTorch port, MoE FFN: routing, dispatch, the expert SwiGLU and the
combine against the JAX reference (``repro/models/moe.py``) on the same
seeded weights and inputs, float32 within 1e-5 of the reference output's
largest magnitude (the aux loss within 1e-5 relative).  The routing is
exact: the same experts for every token, and the same assignments kept
and dropped, with drops (the default capacity) and without
(``capacity_factor=8.0``, as ``tests/test_moe_sharding.py`` runs it)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import get_arch as jax_get_arch, reduced as jax_reduced
from repro.models import layers as JL
from repro.models import moe as JMOE
from repro_torch.configs import get_arch, reduced
from repro_torch.models import moe as MOE

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

TOL = 1e-5


def _close(got, want, tol=TOL):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float32) - want).max()) / scale
    assert err <= tol, err


def _cfgs(arch, **moe_kw):
    """The reduced MoE config of ``arch`` in both packages, float32."""
    out = []
    for get, red in ((jax_get_arch, jax_reduced), (get_arch, reduced)):
        cfg = red(get(arch))
        cfg = dataclasses.replace(cfg, compute_dtype="float32",
                                  moe=dataclasses.replace(cfg.moe,
                                                          **moe_kw))
        out.append(cfg)
    return out


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _case(arch, seed, n_tok=96, skew=1.5, **moe_kw):
    """Both configs, the reference's MoE weights (and the port's copy)
    and a (2, n_tok/2, d) input whose tokens share a direction, so the
    router prefers some experts and the default capacity drops."""
    cj, ct = _cfgs(arch, **moe_kw)
    p = JL.init_params(JMOE.moe_specs(cj), jax.random.key(seed))
    # a router scale that separates the experts (its init is 0.006)
    rng = np.random.default_rng(seed)
    p = dict(p, router=jnp.asarray(
        rng.normal(0, 0.5, p["router"].shape), jnp.float32))
    x = rng.normal(0, 1.0, (2, n_tok // 2, cj.d_model))
    x = (x + skew * rng.normal(0, 1.0, (cj.d_model,))).astype(np.float32)
    return cj, ct, p, _torch_tree(p), x


def _ref_assignments(p, cfg, x):
    """The reference's routing and drops, in its own jnp lines
    (``repro/models/moe.py`` ``_moe_local``): (ids (N, k), kept (N, k))."""
    moe = cfg.moe
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    n, k = xf.shape[0], moe.top_k
    logits = xf.astype(jnp.float32) @ p["router"].astype(jnp.float32)
    _, idx = lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    e_local = moe.num_experts
    sort_key = idx.reshape(-1)
    order = jnp.argsort(sort_key, stable=True)
    se = sort_key[order]
    counts = jnp.bincount(se, length=e_local + 1)
    starts = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                              jnp.cumsum(counts)[:-1]])
    pos = jnp.arange(n * k) - starts[se]
    dropped = (pos >= JMOE._capacity(n, moe)) | (se == e_local)
    kept = np.zeros(n * k, bool)
    kept[np.asarray(order)] = ~np.asarray(dropped)
    return np.asarray(idx), kept.reshape(n, k)


@pytest.mark.parametrize("cf", [1.25, 8.0], ids=["drops", "no-drops"])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "moonshot-v1-16b-a3b"])
def test_moe_apply_matches_reference(arch, cf):
    """``moe_apply`` (output and aux loss) and the routing: the same
    experts, the same kept and dropped assignments; moonshot adds the
    shared expert."""
    cj, ct, p, tp, x = _case(arch, 0, capacity_factor=cf)
    want_y, want_aux = JMOE.moe_apply(p, cj, jnp.asarray(x))
    got_y, got_aux = MOE.moe_apply(tp, ct, torch.from_numpy(x))
    _close(got_y, want_y)
    assert abs(float(got_aux) / float(want_aux) - 1.0) <= TOL
    ids, kept = MOE.moe_assignments(tp, ct, torch.from_numpy(x))
    want_ids, want_kept = _ref_assignments(p, cj, x)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(kept.numpy(), want_kept)
    if cf == 8.0:
        assert kept.all()
    else:
        assert not kept.all()          # the case drops some


@pytest.mark.parametrize("capacity", [8, 13, 48])
def test_moe_local_matches_reference_at_any_capacity(capacity):
    """``_moe_local`` itself at capacities that drop most, some or none
    of the assignments."""
    cj, ct, p, tp, x = _case("moonshot-v1-16b-a3b", 1)
    xf = x.reshape(-1, x.shape[-1])
    kw = dict(moe=cj.moe, expert_offset=0, e_local=cj.moe.num_experts,
              capacity=capacity)
    want_y, want_aux = JMOE._moe_local(p, jnp.asarray(xf), **kw)
    got_y, got_aux = MOE._moe_local(tp, torch.from_numpy(xf), **kw)
    _close(got_y, want_y)
    assert abs(float(got_aux) / float(want_aux) - 1.0) <= TOL


def test_moe_local_keeps_only_its_experts():
    """An expert offset (a shard's slice of the experts, the reference's
    expert-parallel form run by hand): the same partial output."""
    cj, ct, p, tp, x = _case("qwen3-moe-235b-a22b", 2)
    xf = x.reshape(-1, x.shape[-1])
    half = {k: (v[2:] if k != "router" else v) for k, v in p.items()}
    kw = dict(moe=cj.moe, expert_offset=2, e_local=2, capacity=24)
    want_y, _ = JMOE._moe_local(half, jnp.asarray(xf), **kw)
    got_y, _ = MOE._moe_local(_torch_tree(half), torch.from_numpy(xf),
                              **kw)
    _close(got_y, want_y)


def test_moe_routing_breaks_ties_toward_the_lower_expert():
    """Equal router probabilities: ``lax.top_k`` picks the lower expert
    ids, and so does the port."""
    cj, ct, p, tp, x = _case("qwen3-moe-235b-a22b", 3)
    p = dict(p, router=jnp.zeros_like(p["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    ids, _ = MOE.moe_assignments(tp, ct, torch.from_numpy(x))
    want_ids, _ = _ref_assignments(p, cj, x)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    assert (ids.numpy() == np.arange(ct.moe.top_k)).all()


def test_moe_bf16_matches_reference_at_bf16_bounds():
    """The serving dtype: bf16 activations and expert weights."""
    cj, ct, p, tp, x = _case("moonshot-v1-16b-a3b", 4, capacity_factor=8.0)
    want, _ = JMOE.moe_apply(p, cj, jnp.asarray(x, jnp.bfloat16))
    got, _ = MOE.moe_apply(tp, ct, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=5e-2, rtol=1e-2)


def test_moe_apply_without_aux_gives_the_same_output():
    """Prefill and decode skip the aux loss; the output is the same."""
    _, ct, _, tp, x = _case("moonshot-v1-16b-a3b", 5)
    y, aux = MOE.moe_apply(tp, ct, torch.from_numpy(x))
    y2, none = MOE.moe_apply(tp, ct, torch.from_numpy(x), with_aux=False)
    assert none is None and aux.shape == ()
    assert torch.equal(y, y2)


def test_moe_apply_mesh_raises_naming_the_roadmap():
    """``mesh=`` runs expert parallelism (``tests/test_torch_mesh.py``
    holds it to the reference's sharded run); a value that is not a
    ``Mesh`` raises.  On a (data 1, model 2) mesh every expert shard sees
    all the tokens at the unsharded capacity, so it keeps the same
    assignments and the output is the unsharded one (1e-5)."""
    from repro_torch.launch.mesh import make_local_mesh
    _, ct, _, tp, x = _case("qwen3-moe-235b-a22b", 6)
    with pytest.raises(TypeError, match="Mesh"):
        MOE.moe_apply(tp, ct, torch.from_numpy(x), mesh=object())
    mesh = make_local_mesh((1, 2), devices=["cpu"])
    y, aux = MOE.moe_apply(tp, ct, torch.from_numpy(x), mesh=mesh)
    y_un, aux_un = MOE.moe_apply(tp, ct, torch.from_numpy(x))
    _close(y, y_un.numpy())
    assert torch.equal(aux, aux_un)
    _, kept = MOE.moe_assignments(tp, ct, torch.from_numpy(x))
    assert not kept.all()
