"""PyTorch port, training on a mesh for the Mamba hybrid, xLSTM, whisper's
encoder-decoder and qwen2-vl (``models/sharded.py``): the sharded step
against the reference's sharded step and against the port's own
unsharded step, each family's optimizer, determinism, elastic restore of
the hybrid, and the Mamba shard's ``[xs | z]`` columns.

Float32 compute copies of ``reduced()`` jamba-1.5-large-398b (its 4
reduced experts, capacity factor 8: no assignment dropped in any data
block), xlstm-1.3b, whisper-base (16 audio frames) and qwen2-vl-2b (4
vision rows, (3, B, S) M-RoPE positions), on CPU meshes that repeat the
CPU (``make_local_mesh(..., devices=["cpu"])``); a mesh of distinct CPU
device indices stands for distinct cards.  Inputs come from numpy with
a seed; the weights are the reference's init, carried across by
``interop``.  Bounds: losses within 1e-5 relative, each gradient leaf
within 1e-5 of the leaf's largest magnitude; updated leaves are held on
equal gradients (the unsharded step's, placed), as in
``tests/test_torch_mesh_train.py``.  The hybrid's aux loss on a mesh is
the reference's sharded one (the first data block's value, the blocks'
mean gradient), so against the unsharded step its aux weights are 0.
The reference's sharded runs go in one subprocess with
``--xla_force_host_platform_device_count=8`` set before JAX is
imported; the helpers (weights, bounds, comparisons) are
``tests/test_torch_mesh_train.py``'s."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_arch, reduced
from repro_torch.distributed.sharding import (Mesh, Placed, Sharding,
                                              ShardingPlan, block_view,
                                              place, place_tree)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import Model
from repro_torch.models import sharded
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.train import checkpoint as TCK
from repro_torch.train.loop import loss_and_grads, make_train_step
from repro_torch.train.optimizer import optimizer_for, schedule_for
from test_torch_mesh_train import (SRC, TOL, _cfg, _equal_trees, _flat,
                                   _full, _mesh, _params, _ref_tree, _rel,
                                   _tb, _worst)

CPU = "cpu"
HYBRID = "jamba-1.5-large-398b"
FAMILIES = (HYBRID, "xlstm-1.3b", "whisper-base", "qwen2-vl-2b")
SHAPES = ((2, 2), (1, 4), (4, 1))
N_VIS = 4


def _batch(arch, seed=3, b=8, s=16):
    """Tokens and labels, with whisper's audio frames and qwen2-vl's
    vision rows and (3, B, S) positions, from ``seed``."""
    cfg = reduced(get_arch(arch))
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.encoder_layers:
        out["audio_frames"] = rng.normal(
            size=(b, cfg.num_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.normal(
            size=(b, N_VIS, cfg.d_model)).astype(np.float32)
        out["positions"] = rng.integers(0, s, (3, b, s)).astype(np.int32)
    return out


def _setup(arch, shape=None, fsdp=True, aux=True, mesh=None):
    """(model, params): the port's model of ``arch``, unsharded or on a
    mesh (``shape`` repeating the CPU, or ``mesh``) with the params
    placed by a plan of ``fsdp``."""
    cfg = _cfg(get_arch, reduced, arch, aux=aux)
    model = Model(cfg)
    if shape is None and mesh is None:
        return model, interop.model_params_from_arrays(_params(arch), cfg,
                                                       device=CPU)
    model.mesh = mesh if mesh is not None else _mesh(shape)
    plan = ShardingPlan(model.mesh, fsdp, ("data",))
    return model, interop.model_params_from_arrays(_params(arch), cfg,
                                                   plan=plan)


# ------------------------------------------------- sharded vs unsharded

@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_gradients_match_unsharded(arch, shape, fsdp):
    """``loss_and_grads`` on the mesh against the unsharded one on the
    same weights and batch: the loss within 1e-5, every gradient leaf
    (B10's through each shard's channels, the encoder's, the vision
    rows' path) within 1e-5 of its largest magnitude; each gradient
    placed like its parameter, on the blocks' owners."""
    m0, p0 = _setup(arch, aux=False)
    m1, p1 = _setup(arch, shape, fsdp, aux=False)
    batch = _tb(_batch(arch))
    l0, _, g0 = loss_and_grads(m0, p0, batch)
    l1, met, g1 = loss_and_grads(m1, p1, batch)
    assert abs(float(l1) / float(l0) - 1) <= TOL
    assert set(met) == {"ce", "aux"}
    key, err = _worst(g1, g0)
    assert err <= TOL, (key, err)
    for g, p in zip(tree_leaves(g1), tree_leaves(p1)):
        assert isinstance(g, Placed) and g.spec == p.spec
        assert all(len(c) == 1 for c in g.copies.values())


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_train_on_a_mesh_matches_unsharded(arch):
    """``Model.forward_train`` with ``mesh`` set (no gradient) against
    the unsharded forward: loss and cross-entropy within 1e-5."""
    m0, p0 = _setup(arch, aux=False)
    m1, p1 = _setup(arch, (2, 2), aux=False)
    batch = _tb(_batch(arch))
    with torch.no_grad():
        l0, a = m0.forward_train(p0, batch)
        l1, b = m1.forward_train(p1, batch)
    assert abs(float(l1) / float(l0) - 1) <= TOL
    assert abs(float(b["ce"]) / float(a["ce"]) - 1) <= TOL


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_step_matches_unsharded_step(arch, shape):
    """``make_train_step`` with the configuration's own optimizer
    (Adafactor for the hybrid, AdamW for the others) on the mesh: loss
    and gradient norm within 1e-5 of the unsharded step's; given the
    unsharded step's gradients (placed), every updated leaf and every
    optimizer slot within 1e-5, each slot placed on the parameter's
    mesh (Adafactor's factored statistics of a Mamba leaf split on its
    channels, e.g. ``A_log`` (d_in, N), follow its rows)."""
    m0, p0 = _setup(arch, aux=False)
    m1, p1 = _setup(arch, shape, aux=False)
    opt = optimizer_for(m0.cfg)
    lr = schedule_for(m0.cfg.name, 1e-3, 100)
    batch = _tb(_batch(arch))
    seen = []

    def keep(g):
        seen.append(tree_map(lambda t: t.clone(), g))
        return g
    p0, o0, met0 = make_train_step(m0, opt, lr, grad_hook=keep)(
        p0, opt.init(p0), batch, 0)
    psh = tree_map(lambda p: Sharding(p.mesh, p.spec), p1)
    state = opt.init(p1)
    if m0.cfg.optimizer == "adafactor":
        a_log = state["slots"]["layers"]["pos1"]["core"]["A_log"]
        spec = p1["layers"]["pos1"]["core"]["A_log"].spec
        assert set(a_log) == {"vr", "vc"}
        assert a_log["vr"].spec == spec[:-1] and a_log["vr"].mesh is m1.mesh
    p1, o1, met1 = make_train_step(
        m1, opt, lr, grad_hook=lambda g: place_tree(seen[0], psh))(
            p1, state, batch, 0)
    assert abs(float(met1["loss"]) / float(met0["loss"]) - 1) <= TOL
    assert abs(float(met1["gnorm"]) / float(met0["gnorm"]) - 1) <= TOL
    key, err = _worst(p1, p0)
    assert err <= TOL, (key, err)
    key, err = _worst({k: v for k, v in o1.items() if k != "count"},
                      {k: v for k, v in o0.items() if k != "count"})
    assert err <= TOL, (key, err)
    for t in tree_leaves(p1):
        for c in t.copies.values():
            first = next(iter(c.values()))
            assert all(torch.equal(first, x) for x in c.values())


@pytest.mark.parametrize("arch", FAMILIES)
def test_two_sharded_runs_are_equal_and_distinct_devices_agree(arch):
    """Under deterministic algorithms two sharded steps are
    ``torch.equal``, and a (2, 2) mesh of distinct device indices gives
    the repeated device's bits (each combine an explicit fold: B10's
    dB/dC partials a shard, the encoder output's gradients from every
    decoder layer)."""
    devs = np.empty((2, 2), dtype=object)
    devs[:] = [[torch.device(CPU, 2 * i + j) for j in range(2)]
               for i in range(2)]
    outs = []
    for mesh in (_mesh((2, 2)), _mesh((2, 2)),
                 Mesh(devs, ("data", "model"))):
        model, params = _setup(arch, mesh=mesh)
        opt = optimizer_for(model.cfg)
        step = make_train_step(model, opt,
                               schedule_for(model.cfg.name, 1e-3, 100))
        state = opt.init(params)
        for i in range(2):
            params, state, met = step(params, state,
                                      _tb(_batch(arch, seed=i)), i)
        outs.append((met["loss"], params, state))
    for other in outs[1:]:
        assert torch.equal(outs[0][0], other[0])
        assert _equal_trees(outs[0][1], other[1])
        assert _equal_trees(outs[0][2], other[2])


def test_mamba_shard_reads_its_xs_and_z_columns():
    """On model 2 the plan stores ``in_proj``'s columns in two blocks,
    all of ``xs`` on shard 0 and all of ``z`` on shard 1; each shard
    computes its channels from its ``xs`` columns ``c`` and its ``z``
    columns ``d_in + c``.  With the two halves far apart (``z`` scaled
    and shifted), the sharded Mamba block's output is the unsharded
    one's within 1e-5; splitting by the storage blocks instead (shard m
    reading block m as ``[xs | z]``) is not."""
    from repro_torch.configs.base import MAMBA
    from repro_torch.models import mamba as M
    arch = HYBRID
    cfg = _cfg(get_arch, reduced, arch)
    p_idx = cfg.block_pattern.index(MAMBA)
    core = {k: torch.from_numpy(np.array(v[0])) for k, v in
            _params(arch)["layers"][f"pos{p_idx}"]["core"].items()}
    d_in = cfg.mamba_expand * cfg.d_model
    core["in_proj"][:, d_in:] = 3.0 * core["in_proj"][:, d_in:] + 0.5
    core["A_log"] = torch.from_numpy(np.random.default_rng(1).normal(
        0.0, 0.5, core["A_log"].shape).astype(np.float32))
    h = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32))
    want, _ = M.mamba_apply(core, cfg, h)
    mesh = make_local_mesh((1, 2), devices=[CPU])
    plan = ShardingPlan(mesh, False, ("data",))
    axes = M.mamba_specs(cfg)
    placed = {k: place(v, Sharding(mesh, plan.spec_for(
        axes[k].axes, tuple(v.shape)))) for k, v in core.items()}
    blocks = placed["in_proj"].owners()
    assert torch.equal(blocks[0], core["in_proj"][:, :d_in])
    assert torch.equal(blocks[1], core["in_proj"][:, d_in:])
    shards = sharded.Shards(mesh, {"data": 0})
    views = {k: block_view(v, mesh, {"data": 0}) for k, v in placed.items()}
    got = sharded.mamba(cfg, views, h, shards)
    assert _rel(got, want) <= TOL
    # the storage split: shard m's xs and z both halves of block m
    w = d_in // 2
    wrong = dict(core, in_proj=torch.cat([b[:, :w] for b in blocks]
                                         + [b[:, w:] for b in blocks], 1))
    bad, _ = M.mamba_apply(wrong, cfg, h)
    assert _rel(bad, want) > 1e-2


def test_moe_on_a_mesh_without_a_model_axis_raises():
    """The hybrid's MoE layers need a ``"model"`` axis for their
    experts: a data-only mesh raises from ``forward_train`` and
    ``loss_and_grads``; the other families train on it."""
    mesh = make_local_mesh((2,), ("data",), devices=[CPU])
    for arch in (HYBRID, "xlstm-1.3b"):
        model, params = _setup(arch)
        model.mesh = mesh
        batch = _tb(_batch(arch))
        if arch != HYBRID:
            loss, _, _ = loss_and_grads(model, params, batch)
            assert torch.isfinite(loss)
            continue
        with pytest.raises(ValueError, match="'model' axis"):
            model.forward_train(params, batch)
        with pytest.raises(ValueError, match="'model' axis"):
            loss_and_grads(model, params, batch)


# -------------------------------------------------------- elastic restore

def test_hybrid_elastic_restore_across_mesh_shapes(tmp_path):
    """The reduced hybrid, two Adafactor steps on (2, 2), saved; restored
    onto (4, 1) and (1, 4) with ``shardings=`` (each leaf, Adafactor's
    factored slots included, placed by the new mesh's plan), the third
    step's loss, gradient norm and gradients within 1e-5 of the
    unsharded third step from the same files (the aux weights 0, as
    against every unsharded step)."""
    arch = HYBRID
    m_a, params = _setup(arch, (2, 2), aux=False)
    cfg = m_a.cfg
    opt = optimizer_for(cfg)
    lr = schedule_for(cfg.name, 1e-3, 100)
    state = opt.init(params)
    step = make_train_step(m_a, opt, lr)
    for i in range(2):
        params, state, _ = step(params, state, _tb(_batch(arch, seed=i)), i)
    TCK.save_checkpoint(tmp_path / "a", 2, (params, state))
    batch = _tb(_batch(arch, seed=2))
    m0 = Model(cfg)
    like = m0.init(0, device=CPU)
    (p0, s0), at, _ = TCK.restore_checkpoint(tmp_path / "a",
                                             (like, opt.init(like)))
    p0, s0 = (tree_map(lambda a: torch.from_numpy(np.array(a)), t)
              for t in (p0, s0))
    grads = []

    def keep(g):
        grads.append(tree_map(lambda t: _full(t).clone(), g))
        return g
    _, _, want = make_train_step(m0, opt, lr, grad_hook=keep)(p0, s0,
                                                              batch, at)
    for shape in ((4, 1), (1, 4)):
        m_b = Model(cfg)
        m_b.mesh = _mesh(shape)
        plan = ShardingPlan(m_b.mesh, True, ("data",))
        psh = plan.param_shardings(m_b.param_logical_axes(),
                                   m_b.param_structs())
        osh = tree_map(lambda t: Sharding(t.mesh, t.spec)
                       if isinstance(t, Placed) else Sharding(m_b.mesh, ()),
                       opt.init(place_tree(like, psh)))
        (p_b, s_b), at_b, _ = TCK.restore_checkpoint(
            tmp_path / "a", (like, opt.init(like)), shardings=(psh, osh))
        assert at_b == 2 and int(s_b["count"]) == 2
        for p, sh in zip(tree_leaves(p_b), tree_leaves(psh)):
            assert isinstance(p, Placed) and p.spec == sh.spec \
                and p.mesh is m_b.mesh
        _, _, got = make_train_step(m_b, opt, lr, grad_hook=keep)(
            p_b, s_b, batch, at_b)
        assert abs(float(got["loss"]) / float(want["loss"]) - 1) <= TOL
        assert abs(float(got["gnorm"]) / float(want["gnorm"]) - 1) <= TOL
        key, err = _worst(grads[-1], grads[0])
        assert err <= TOL, (shape, key, err)


# ------------------------------------------------ against the reference

_REF_SCRIPT = """
import sys, dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_arch, reduced
from repro.models import Model
from repro.distributed.sharding import ShardingPlan

assert jax.device_count() == 8
inp = dict(np.load(sys.argv[1]))
out = {}


def unflat(prefix):
    tree = {}
    for k, v in inp.items():
        if not k.startswith(prefix):
            continue
        node = tree
        parts = k[len(prefix):].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(v)
    return tree


def flat(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(v, prefix + k + "/")
        else:
            out[prefix + k] = np.asarray(v, np.float32)


for case in [str(c) for c in inp["cases"]]:
    arch, shape = case.split("|")
    shape = tuple(int(x) for x in shape.split("x"))
    cfg = dataclasses.replace(reduced(get_arch(arch)),
                              compute_dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    mesh = Mesh(np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(
        shape), ("data", "model"))
    model = Model(cfg)
    model.mesh = mesh
    plan = ShardingPlan(mesh=mesh, fsdp=True, dp_axes=("data",))
    psh = plan.param_shardings(model.param_logical_axes(),
                               model.param_structs())
    batch = unflat("b/" + arch + "/")
    with mesh:
        ps = jax.device_put(unflat("p/" + arch + "/"), psh)
        (loss, _), g = jax.jit(jax.value_and_grad(
            model.forward_train, has_aux=True))(ps, batch)
    out[case + "/loss"] = np.asarray(loss)
    flat(g, case + "/g/")
np.savez(sys.argv[2], **out)
"""

REF_CASES = [f"{a}|2x4" for a in FAMILIES] + [f"{HYBRID}|4x2"]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's sharded loss and gradients (FSDP on) of each
    case, on 8 forced host devices in one subprocess."""
    d = tmp_path_factory.mktemp("mesh_train_families_ref")
    inp = dict(cases=np.asarray(REF_CASES))
    for arch in FAMILIES:
        _flat(_params(arch), f"p/{arch}/", inp)
        _flat(_batch(arch), f"b/{arch}/", inp)
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF_SCRIPT),
                        str(d / "in.npz"), str(d / "out.npz")],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("case", REF_CASES)
def test_sharded_gradients_match_reference_sharded(ref, case):
    """The port's sharded loss and gradients against the reference's on
    the same mesh shape, weights and batch (FSDP on): the loss within
    1e-5, every leaf within 1e-5 of its largest magnitude; the hybrid
    with its aux loss (the first block's value, the blocks' mean
    gradient)."""
    arch, shape = case.split("|")
    shape = tuple(int(x) for x in shape.split("x"))
    model, params = _setup(arch, shape, True)
    loss, _, grads = loss_and_grads(model, params, _tb(_batch(arch)))
    want = float(ref[case + "/loss"])
    assert abs(float(loss) / want - 1) <= TOL
    key, err = _worst(grads, _ref_tree(ref, case + "/g/"))
    assert err <= TOL, (key, err)
