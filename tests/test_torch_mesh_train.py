"""PyTorch port, training on a mesh: the sharded step (data parallel,
tensor parallel over ``"model"``, FSDP), its optimizers, elastic restore
across mesh shapes, the ``REPRO_GATHER_BF16`` and ``REPRO_REMAT_POLICY``
knobs, and decode caches placed by ``cache_shardings`` (the Mamba
hybrid, xLSTM, whisper and qwen2-vl on a mesh:
``tests/test_torch_mesh_train_families.py``).

CPU meshes repeat the CPU (``make_local_mesh(..., devices=["cpu"])``),
one device standing for every shard as one card does on the chip; a mesh
of distinct CPU device indices stands for distinct cards.  The
reference's sharded runs go in a subprocess with
``--xla_force_host_platform_device_count=8`` set before JAX is imported,
as ``tests/test_torch_mesh.py`` runs them.

Float32 compute copies of ``reduced()`` llama3.2-3b, gemma2-27b
(Adafactor, local layers, soft-caps) and moonshot-v1-16b-a3b (experts,
capacity factor 8: no assignment dropped in any data block).  Bounds:
losses and gradient norms within 1e-5 relative, each gradient leaf
within 1e-5 of the leaf's largest magnitude.  Updated leaves are held on
equal gradients (the unsharded step's, placed), within 1e-5: AdamW's
first update of a gradient at its eps scale (|g| ~ 1e-8) turns a
last-bit difference of the gradient into a visible move, so an update
from gradients folded in another order is not a bound on the step's
arithmetic.  Moonshot's aux loss is, as in the reference's sharded
step, the first data block's value with the blocks' mean as its
gradient, which is not the unsharded step's: against the unsharded
step its aux weights are 0, against the reference's sharded step they
are the configuration's.  The bf16 recipe is the reference's own
(``tests/test_multidevice.py:83``, its bounds)."""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_arch as jax_get_arch, reduced as jax_reduced
from repro.models import Model as JaxModel
from repro_torch import interop
from repro_torch.configs import get_arch, reduced
from repro_torch.distributed import decode_attention as DA
from repro_torch.distributed.sharding import (Mesh, Placed, Sharding,
                                              ShardingPlan, make_plan, place,
                                              place_tree)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import Model
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.train import checkpoint as TCK
from repro_torch.train.loop import loss_and_grads, make_train_step
from repro_torch.train.optimizer import optimizer_for, schedule_for

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = "cpu"
TOL = 1e-5
ARCHS = ("llama3.2-3b", "gemma2-27b", "moonshot-v1-16b-a3b")
SHAPES = ((2, 4), (4, 2), (1, 4), (8, 1))


def _cfg(get, red, arch, aux=True, dtype="float32"):
    cfg = dataclasses.replace(red(get(arch)), compute_dtype=dtype)
    if cfg.moe is not None:
        kw = {} if aux else dict(router_aux_weight=0.0, router_z_weight=0.0)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0, **kw))
    return cfg


def _np(t):
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    return np.asarray(t)


_PARAMS = {}


def _params(arch, seed=0):
    """The reference's init of ``arch``'s reduced configuration, as
    numpy (the same weights in both packages)."""
    if (arch, seed) not in _PARAMS:
        cfg = _cfg(jax_get_arch, jax_reduced, arch)
        _PARAMS[arch, seed] = _np(JaxModel(cfg).init(jax.random.key(seed)))
    return _PARAMS[arch, seed]


def _batch(vocab, seed=3, b=8, s=16):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _mesh(shape):
    return make_local_mesh(shape, devices=[CPU])


def _setup(arch, shape=None, fsdp=True, aux=True, dtype="float32"):
    """(model, params): the port's model of ``arch`` (on a mesh of
    ``shape`` with params placed by a plan of ``fsdp``, or unsharded)."""
    cfg = _cfg(get_arch, reduced, arch, aux=aux, dtype=dtype)
    model = Model(cfg)
    if shape is None:
        return model, interop.model_params_from_arrays(_params(arch), cfg,
                                                       device=CPU)
    model.mesh = _mesh(shape)
    plan = ShardingPlan(model.mesh, fsdp, ("data",))
    return model, interop.model_params_from_arrays(_params(arch), cfg,
                                                   plan=plan)


def _full(t):
    return t.full() if isinstance(t, Placed) else t


def _rel(got, want) -> float:
    got, want = _full(got).double(), _full(want).double()
    assert got.shape == want.shape
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def _worst(got, want):
    errs = dict(tree_leaves(tree_map(
        lambda path, g, w: ("/".join(path), _rel(g, w)), got, want,
        path=())))
    k = max(errs, key=errs.get)
    return k, errs[k]


def _equal_trees(a, b):
    return all(torch.equal(_full(x), _full(y))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


# ------------------------------------------------- sharded vs unsharded

@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_gradients_match_unsharded(arch, shape, fsdp):
    """``loss_and_grads`` on the mesh against the unsharded one on the
    same weights and batch: the loss within 1e-5, every gradient leaf
    within 1e-5 of its largest magnitude; each gradient placed like its
    parameter, on the blocks' owners."""
    m0, p0 = _setup(arch, aux=False)
    m1, p1 = _setup(arch, shape, fsdp, aux=False)
    batch = _tb(_batch(m0.cfg.vocab_size))
    l0, _, g0 = loss_and_grads(m0, p0, batch)
    l1, met, g1 = loss_and_grads(m1, p1, batch)
    assert abs(float(l1) / float(l0) - 1) <= TOL
    assert set(met) == {"ce", "aux"}
    key, err = _worst(g1, g0)
    assert err <= TOL, (key, err)
    for g, p in zip(tree_leaves(g1), tree_leaves(p1)):
        assert isinstance(g, Placed) and g.spec == p.spec
        assert all(len(c) == 1 for c in g.copies.values())


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_unsharded_step(arch, shape):
    """``make_train_step`` (the configuration's optimizer: AdamW, or
    Adafactor for gemma2) on the mesh: loss and gradient norm within
    1e-5 of the unsharded step's; given the unsharded step's gradients
    (placed), every updated leaf and every optimizer slot within 1e-5
    of the unsharded step's, each slot placed like its parameter."""
    m0, p0 = _setup(arch, aux=False)
    m1, p1 = _setup(arch, shape, aux=False)
    opt = optimizer_for(m0.cfg)
    lr = schedule_for(m0.cfg.name, 1e-3, 100)
    batch = _tb(_batch(m0.cfg.vocab_size))
    seen = []

    def keep(g):
        seen.append(tree_map(lambda t: t.clone(), g))
        return g
    p0, o0, met0 = make_train_step(m0, opt, lr, grad_hook=keep)(
        p0, opt.init(p0), batch, 0)
    psh = tree_map(lambda p: Sharding(p.mesh, p.spec), p1)

    def swap(g):
        return place_tree(seen[0], psh)
    state = opt.init(p1)
    for slot, p in zip(tree_leaves(state["m" if "m" in state
                                        else "slots"]),
                       tree_leaves(p1)):
        assert isinstance(slot, Placed) and slot.mesh is p.mesh
    p1, o1, met1 = make_train_step(m1, opt, lr, grad_hook=swap)(
        p1, state, batch, 0)
    assert abs(float(met1["loss"]) / float(met0["loss"]) - 1) <= TOL
    assert abs(float(met1["gnorm"]) / float(met0["gnorm"]) - 1) <= TOL
    key, err = _worst(p1, p0)
    assert err <= TOL, (key, err)
    key, err = _worst({k: v for k, v in o1.items() if k != "count"},
                      {k: v for k, v in o0.items() if k != "count"})
    assert err <= TOL, (key, err)
    assert int(o1["count"]) == int(o0["count"]) == 1
    # replicas of a block stay equal after the update
    for t in tree_leaves(p1):
        for c in t.copies.values():
            first = next(iter(c.values()))
            assert all(torch.equal(first, x) for x in c.values())


def test_microbatched_sharded_step_matches_unsharded():
    """micro=2 on a (2, 4) mesh: each microbatch split over the data
    blocks, float32 gradients accumulated in order: loss and gradient
    norm within 1e-5 of the unsharded micro=2 step."""
    m0, p0 = _setup("llama3.2-3b")
    m1, p1 = _setup("llama3.2-3b", (2, 4))
    opt = optimizer_for(m0.cfg)
    lr = schedule_for(m0.cfg.name, 1e-3, 100)
    batch = _tb(_batch(m0.cfg.vocab_size))
    _, _, a = make_train_step(m0, opt, lr, micro=2)(p0, opt.init(p0),
                                                    batch, 0)
    _, _, b = make_train_step(m1, opt, lr, micro=2)(p1, opt.init(p1),
                                                    batch, 0)
    assert abs(float(b["loss"]) / float(a["loss"]) - 1) <= TOL
    assert abs(float(b["gnorm"]) / float(a["gnorm"]) - 1) <= TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_two_sharded_runs_are_equal_and_distinct_devices_agree(arch):
    """Under deterministic algorithms two sharded steps are
    ``torch.equal``, and a (2, 2) mesh of distinct device indices gives
    the repeated device's result bit for bit (each combine is an
    explicit fold, never autograd's sum across devices)."""
    devs = np.empty((2, 2), dtype=object)
    devs[:] = [[torch.device(CPU, 2 * i + j) for j in range(2)]
               for i in range(2)]
    outs = []
    for mesh in (_mesh((2, 2)), _mesh((2, 2)), Mesh(devs, ("data",
                                                           "model"))):
        cfg = _cfg(get_arch, reduced, arch)
        model = Model(cfg)
        model.mesh = mesh
        params = interop.model_params_from_arrays(
            _params(arch), cfg, plan=ShardingPlan(mesh, True, ("data",)))
        opt = optimizer_for(cfg)
        step = make_train_step(model, opt, schedule_for(cfg.name, 1e-3, 100))
        state = opt.init(params)
        for i in range(2):
            params, state, met = step(params, state,
                                      _tb(_batch(cfg.vocab_size, seed=i)), i)
        outs.append((met["loss"], params, state))
    for other in outs[1:]:
        assert torch.equal(outs[0][0], other[0])
        assert _equal_trees(outs[0][1], other[1])
        assert _equal_trees(outs[0][2], other[2])


# ------------------------------------------------ against the reference

_REF_SCRIPT = """
import sys, dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_arch, reduced
from repro.models import Model
from repro.train.loop import make_train_step
from repro.train.optimizer import optimizer_for, schedule_for
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


def setup(cfg, shape, fsdp):
    n = shape[0] * shape[1]
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                ("data", "model"))
    model = Model(cfg)
    model.mesh = mesh
    plan = ShardingPlan(mesh=mesh, fsdp=fsdp, dp_axes=("data",))
    psh = plan.param_shardings(model.param_logical_axes(),
                               model.param_structs())
    return mesh, model, psh


batch = {"tokens": jnp.asarray(inp["tokens"]),
         "labels": jnp.asarray(inp["labels"])}
for case in [str(c) for c in inp["cases"]]:
    arch, shape = case.split("|")
    shape = tuple(int(x) for x in shape.split("x"))
    cfg = dataclasses.replace(reduced(get_arch(arch)),
                              compute_dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    mesh, model, psh = setup(cfg, shape, True)
    with mesh:
        ps = jax.device_put(unflat("p/" + arch + "/"), psh)
        (loss, _), g = jax.jit(jax.value_and_grad(
            model.forward_train, has_aux=True))(ps, batch)
    out[case + "/loss"] = np.asarray(loss)
    flat(g, case + "/g/")

# the reference's own recipe, tests/test_multidevice.py:83
cfg = reduced(get_arch("llama3.2-3b"))
mesh, model, psh = setup(cfg, (2, 4), True)
opt = optimizer_for(cfg)
lr = schedule_for(cfg.name, 1e-3, 100)
ones = {"tokens": jnp.ones((8, 16), jnp.int32),
        "labels": jnp.ones((8, 16), jnp.int32)}
with mesh:
    ps = jax.device_put(unflat("bf16/"), psh)
    p2, _, m2 = jax.jit(make_train_step(model, opt, lr))(
        ps, opt.init(ps), ones, jnp.asarray(0, jnp.int32))
out["bf16/loss"] = np.asarray(m2["loss"])
flat(p2, "bf16/p/")

# the same recipe under REPRO_GATHER_BF16=1 (read as the step is traced)
import os
os.environ["REPRO_GATHER_BF16"] = "1"
with mesh:
    ps = jax.device_put(unflat("bf16/"), psh)
    p3, _, m3 = jax.jit(make_train_step(model, opt, lr))(
        ps, opt.init(ps), ones, jnp.asarray(0, jnp.int32))
out["gbf16/loss"] = np.asarray(m3["loss"])
flat(p3, "gbf16/p/")
np.savez(sys.argv[2], **out)
"""

REF_CASES = ["llama3.2-3b|2x4", "gemma2-27b|2x4"] + [
    f"moonshot-v1-16b-a3b|{a}x{b}" for a, b in SHAPES]


def _flat(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}{k}/", out)
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _bf16_params():
    cfg = jax_reduced(jax_get_arch("llama3.2-3b"))
    return _np(JaxModel(cfg).init(jax.random.key(0)))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's sharded gradients and its bf16 recipe's step, on
    8 forced host devices in one subprocess."""
    d = tmp_path_factory.mktemp("mesh_train_ref")
    inp = dict(_batch(512), cases=np.asarray(REF_CASES))
    for arch in ARCHS:
        _flat(_params(arch), f"p/{arch}/", inp)
    _flat(_bf16_params(), "bf16/", inp)
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


def _ref_tree(ref, prefix):
    tree = {}
    for k, v in ref.items():
        if not k.startswith(prefix):
            continue
        node = tree
        parts = k[len(prefix):].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = torch.from_numpy(np.array(v))
    return tree


@pytest.mark.parametrize("case", REF_CASES)
def test_sharded_gradients_match_reference_sharded(ref, case):
    """The port's sharded loss and gradients against the reference's on
    the same mesh shape, weights and batch (FSDP on): the loss within
    1e-5, every leaf within 1e-5 of its largest magnitude; moonshot with
    its aux loss (the first block's value, the blocks' mean gradient)."""
    arch, shape = case.split("|")
    shape = tuple(int(x) for x in shape.split("x"))
    model, params = _setup(arch, shape, True)
    loss, _, grads = loss_and_grads(model, params, _tb(_batch(512)))
    want = float(ref[case + "/loss"])
    assert abs(float(loss) / want - 1) <= TOL
    key, err = _worst(grads, _ref_tree(ref, case + "/g/"))
    assert err <= TOL, (key, err)


def test_sharded_dense_step_matches_reference_unsharded():
    """Dense configurations: the reference's sharding changes no number
    beyond float32 rounding, so the port's sharded loss and gradients on
    each mesh shape are within 1e-5 of the reference's unsharded
    ``jax.value_and_grad``."""
    for arch in ("llama3.2-3b", "gemma2-27b"):
        cfg = _cfg(jax_get_arch, jax_reduced, arch)
        jm = JaxModel(cfg)
        b = _batch(512)
        (lj, _), gj = jax.jit(jax.value_and_grad(
            jm.forward_train, has_aux=True))(
                jax.tree.map(jnp.asarray, _params(arch)),
                {k: jnp.asarray(v) for k, v in b.items()})
        want = _ref_tree(_flat(_np(gj), "", {}), "")
        for shape in SHAPES:
            model, params = _setup(arch, shape)
            loss, _, grads = loss_and_grads(model, params, _tb(b))
            assert abs(float(loss) / float(lj) - 1) <= TOL, (arch, shape)
            key, err = _worst(grads, want)
            assert err <= TOL, (arch, shape, key, err)


def test_bf16_recipe_matches_reference(ref):
    """``tests/test_multidevice.py:83`` on the port: reduced llama3.2-3b
    in bf16 compute on a (data 2, model 4) mesh, FSDP on, a batch of
    ones, one AdamW step: the loss within 5e-2 and every updated leaf
    within 3e-2 (rtol and atol) of the reference's sharded step."""
    _bf16_recipe(ref, "bf16")


def test_bf16_recipe_under_gather_bf16_matches_reference(ref, monkeypatch):
    """The same recipe with ``REPRO_GATHER_BF16=1`` on both sides, at
    the same bounds: the reference casts before its gathers and folds a
    shared piece's gradients in bf16, the port in float32."""
    monkeypatch.setenv("REPRO_GATHER_BF16", "1")
    _bf16_recipe(ref, "gbf16")


def _bf16_recipe(ref, key):
    cfg = reduced(get_arch("llama3.2-3b"))
    model = Model(cfg)
    model.mesh = _mesh((2, 4))
    params = interop.model_params_from_arrays(
        _bf16_params(), cfg, plan=ShardingPlan(model.mesh, True, ("data",)))
    opt = optimizer_for(cfg)
    ones = {"tokens": torch.ones((8, 16), dtype=torch.int32),
            "labels": torch.ones((8, 16), dtype=torch.int32)}
    p2, _, met = make_train_step(model, opt, schedule_for(
        cfg.name, 1e-3, 100))(params, opt.init(params), ones, 0)
    assert abs(float(met["loss"]) - float(ref[key + "/loss"])) < 5e-2
    want = _ref_tree(ref, key + "/p/")
    tree_map(lambda g, w: np.testing.assert_allclose(
        _full(g).float().numpy(), w.numpy(), rtol=3e-2, atol=3e-2),
        p2, want)


# -------------------------------------------------------- elastic restore

def _byte_files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if p.suffix == ".npy"}


def test_elastic_restore_across_mesh_shapes(tmp_path):
    """Two steps on a (2, 4) mesh, saved; the files are byte-identical
    to those of the same tree saved whole.  Restored onto (4, 2) and
    (8, 1) with ``shardings=`` (each leaf placed by the new mesh's
    plan), the third step's loss, gradient norm and gradients are within
    1e-5 of the unsharded third step from the same files."""
    arch = "llama3.2-3b"
    m_a, params = _setup(arch, (2, 4))
    cfg = m_a.cfg
    opt = optimizer_for(cfg)
    lr = schedule_for(cfg.name, 1e-3, 100)
    state = opt.init(params)
    step = make_train_step(m_a, opt, lr)
    for i in range(2):
        params, state, _ = step(params, state,
                                _tb(_batch(cfg.vocab_size, seed=i)), i)
    placed_dir = TCK.save_checkpoint(tmp_path / "a", 2, (params, state))
    whole = tree_map(_full, (params, state)[0]), tree_map(_full, state)
    whole_dir = TCK.save_checkpoint(tmp_path / "w", 2, whole)
    assert _byte_files(placed_dir) == _byte_files(whole_dir)

    batch = _tb(_batch(cfg.vocab_size, seed=2))
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
    for shape in ((4, 2), (8, 1)):
        m_b = Model(cfg)
        m_b.mesh = _mesh(shape)
        plan = ShardingPlan(m_b.mesh, True, ("data",))
        psh = plan.param_shardings(m_b.param_logical_axes(),
                                   m_b.param_structs())
        osh = {"m": psh, "v": psh, "count": Sharding(m_b.mesh, ())}
        (p_b, s_b), at_b, _ = TCK.restore_checkpoint(
            tmp_path / "a", (like, opt.init(like)), shardings=(psh, osh))
        assert at_b == 2 and int(s_b["count"]) == 2
        for p, sh in zip(tree_leaves(p_b), tree_leaves(psh)):
            assert isinstance(p, Placed) and p.spec == sh.spec \
                and p.mesh is m_b.mesh
        assert _equal_trees(p_b, whole[0]) and _equal_trees(s_b, whole[1])
        _, _, got = make_train_step(m_b, opt, lr, grad_hook=keep)(
            p_b, s_b, batch, at_b)
        assert abs(float(got["loss"]) / float(want["loss"]) - 1) <= TOL
        assert abs(float(got["gnorm"]) / float(want["gnorm"]) - 1) <= TOL
        key, err = _worst(grads[-1], grads[0])
        assert err <= TOL, (shape, key, err)


def test_checkpoint_refusals_stay_with_shardings(tmp_path):
    """A dtype other than the skeleton's still raises with
    ``shardings=``, and a shardings tree of another length raises."""
    model, params = _setup("llama3.2-3b", (2, 4))
    TCK.save_checkpoint(tmp_path, 1, params)
    psh = tree_map(lambda p: Sharding(p.mesh, p.spec), params)
    like = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float64),
                    params)
    with pytest.raises(TypeError, match="checkpoint dtype"):
        TCK.restore_checkpoint(tmp_path, like, shardings=psh)
    with pytest.raises(ValueError, match="shardings has"):
        TCK.restore_checkpoint(tmp_path, params, shardings=[None])


# -------------------------------------------------------------- the knobs

def _rounded(params):
    """``params`` with every stacked leaf of 3 or more dims rounded to
    bf16 (and kept float32)."""
    def r(path, t):
        if path[0] == "layers" and t.dim() >= 3:
            return t.to(torch.bfloat16).float()
        return t
    return tree_map(r, params, path=())


@pytest.mark.parametrize("shape", [None, (2, 2), (2, 4)],
                         ids=["whole", "2x2", "2x4"])
def test_gather_bf16_equals_the_rounded_tree(shape, monkeypatch):
    """``REPRO_GATHER_BF16=1`` (bf16 compute): the step's loss, gradient
    norm and gradients ``torch.equal`` to the same step without the knob
    on a tree whose stacked leaves of 3 or more dims were rounded to bf16
    first; unsharded, the prefill and a decode step too.  On (2, 4) the
    plan stores each kv head's columns over two shards that both read
    it: the piece is cast as it is sent, and its two gradients fold in
    float32 as they do without the knob."""
    arch = "llama3.2-3b"
    cfg = reduced(get_arch(arch))
    model = Model(cfg)
    params = interop.model_params_from_arrays(_params(arch), cfg, device=CPU)
    rounded = _rounded(params)
    if shape is not None:
        model.mesh = _mesh(shape)
        psh = ShardingPlan(model.mesh, True, ("data",)).param_shardings(
            model.param_logical_axes(), model.param_structs())
        params, rounded = place_tree(params, psh), place_tree(rounded, psh)
    opt = optimizer_for(cfg)
    batch = _tb(_batch(cfg.vocab_size))
    out = []
    for knob, p in (("1", params), ("0", rounded)):
        monkeypatch.setenv("REPRO_GATHER_BF16", knob)
        seen = []
        _, _, met = make_train_step(
            model, opt, schedule_for(cfg.name, 1e-3, 100),
            grad_hook=lambda g: seen.append(tree_map(
                lambda t: _full(t).clone(), g)) or g)(
                    tree_map(lambda t: place(_full(t).clone(), Sharding(
                        t.mesh, t.spec)) if isinstance(t, Placed)
                        else t.clone(), p), opt.init(p), batch, 0)
        out.append((met, seen[0]))
        if shape is None:
            lg, cache = model.prefill(p, {"tokens": batch["tokens"][:2]},
                                      model.init_cache(2, 32, device=CPU))
            lg2, _ = model.decode_step(
                p, {"tokens": batch["tokens"][:2, :1]}, cache, 16)
            out[-1] += (lg, lg2)
    (a, ga, *la), (b, gb, *lb) = out
    assert torch.equal(a["loss"], b["loss"])
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert torch.equal(a["gnorm"], b["gnorm"])
    assert _equal_trees(ga, gb)


def test_gather_bf16_matches_reference_at_bf16_bounds(monkeypatch):
    """Under the knob on both sides, the bf16 ``forward_train`` loss and
    the prefill logits within the bf16 bounds of
    ``tests/test_torch_models.py`` (atol 5e-2, rtol 1e-2)."""
    monkeypatch.setenv("REPRO_GATHER_BF16", "1")
    arch = "moonshot-v1-16b-a3b"
    jcfg = jax_reduced(jax_get_arch(arch))
    tcfg = reduced(get_arch(arch))
    jm, tm = JaxModel(jcfg), Model(tcfg)
    jp = jm.init(jax.random.key(4))
    tp = interop.model_params_from_arrays(_np(jp), tcfg, device=CPU)
    b = _batch(tcfg.vocab_size, b=2)
    lj, _ = jm.forward_train(jp, {k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad():
        lt, _ = tm.forward_train(tp, _tb(b))
    np.testing.assert_allclose(float(lt), float(lj), atol=5e-2, rtol=1e-2)
    gj, _ = jm.prefill(jp, {"tokens": jnp.asarray(b["tokens"])},
                       jm.init_cache(2, 32))
    gt, _ = tm.prefill(tp, _tb({"tokens": b["tokens"]}),
                       tm.init_cache(2, 32, device=CPU))
    np.testing.assert_allclose(gt.float().numpy(),
                               np.asarray(gj, np.float32),
                               atol=5e-2, rtol=1e-2)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("shape", [None, (2, 2)], ids=["whole", "2x2"])
def test_remat_policy_dots_keeps_the_products(shape, monkeypatch):
    """``REPRO_REMAT_POLICY=dots`` with remat on: gradients
    ``torch.equal`` to the default policy's, and the backward runs fewer
    ``aten.mm``/``addmm`` (the saved products are not recomputed)."""
    cfg = dataclasses.replace(_cfg(get_arch, reduced, "llama3.2-3b"),
                              remat=True)
    model = Model(cfg)
    params = interop.model_params_from_arrays(_params("llama3.2-3b"), cfg,
                                              device=CPU)
    if shape is not None:
        model.mesh = _mesh(shape)
        params = place_tree(params, ShardingPlan(
            model.mesh, True, ("data",)).param_shardings(
                model.param_logical_axes(), model.param_structs()))
    batch = _tb(_batch(cfg.vocab_size))
    out = {}
    for pol in ("nothing", "dots"):
        monkeypatch.setenv("REPRO_REMAT_POLICY", pol)
        count = _CountMM()
        real_grad = torch.autograd.grad

        def counted(*a, **k):
            with count:
                return real_grad(*a, **k)
        monkeypatch.setattr(torch.autograd, "grad", counted)
        loss, _, g = loss_and_grads(model, params, batch)
        monkeypatch.setattr(torch.autograd, "grad", real_grad)
        out[pol] = (loss, g, count.n)
    assert torch.equal(out["dots"][0], out["nothing"][0])
    assert _equal_trees(out["dots"][1], out["nothing"][1])
    assert 0 < out["dots"][2] < out["nothing"][2], (out["dots"][2],
                                                     out["nothing"][2])


# ------------------------------------------------------- the decode cache

def _decode_run(model, params, cache, tokens, dec, pos_vec=None):
    lg, cache = model.prefill(params, {"tokens": tokens}, cache)
    outs = [lg]
    for i in range(dec.shape[0]):
        step = {"tokens": dec[i]}
        if pos_vec is None:
            pos = 20 + i
        else:
            pos = pos_vec + i
            step["positions"] = pos[:, None]
        lg, cache = model.decode_step(params, step, cache, pos)
        outs.append(lg)
    return outs


@pytest.mark.parametrize("shape", [(2, 4), (1, 4)], ids=["2x4", "1x4"])
def test_placed_decode_cache_equals_the_whole_cache(shape, monkeypatch):
    """``Model.init_cache`` with a mesh places the cache by
    ``cache_shardings`` (k/v on the sequence, the batch on data when it
    splits); prefill writes its blocks in place and each decode shard
    reads the block on its own device, no slice of the cache moved:
    every step's logits ``torch.equal`` to the same mesh's run on a
    whole cache, with scalar positions and (on (1, 4)) per-row ones."""
    arch = "moonshot-v1-16b-a3b"
    cfg = _cfg(get_arch, reduced, arch)
    params = interop.model_params_from_arrays(_params(arch), cfg, device=CPU)
    rng = np.random.default_rng(13)
    tokens = torch.as_tensor(rng.integers(0, 512, (2, 20)))
    dec = torch.as_tensor(rng.integers(0, 512, (4, 2, 1)))
    model = Model(cfg)
    model.mesh = _mesh(shape)
    placed = model.init_cache(2, 32, device=CPU)
    k = placed["pos0"]["kv"]["k"]
    assert isinstance(k, Placed) and k.spec[2] == "model"
    assert k.spec[1] == "data"             # 2 rows split over data
    assert k.grid[:3] == (1, shape[0], 4)
    read = []
    real = DA._shard_block

    def spy(cache, coords, dev, rows, cols):
        got = real(cache, coords, dev, rows, cols)
        if isinstance(cache, Placed):
            read.append(any(got is t for c in cache.copies.values()
                            for t in c.values()))
        return got
    monkeypatch.setattr(DA, "_shard_block", spy)
    got = _decode_run(model, params, placed, tokens, dec)
    whole = Model(cfg).init_cache(2, 32, device=CPU)
    want = _decode_run(model, params, whole, tokens, dec)
    assert read and all(read)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(tree_leaves(placed)[0].full(), tree_leaves(whole)[0])
    if shape[0] == 1:
        vec = torch.tensor([20, 13])
        got = _decode_run(model, params, model.init_cache(2, 32, device=CPU),
                          tokens, dec, vec)
        want = _decode_run(model, params,
                           Model(cfg).init_cache(2, 32, device=CPU),
                           tokens, dec, vec)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# ------------------------------------------------------------- interop

def test_interop_places_reference_state_by_the_plan():
    """The reference's parameters and AdamW / Adafactor states as numpy,
    placed on a port mesh: each leaf equal to the unsharded install and
    placed as the plan and ``optimizer.init`` place it; the hybrid's
    (Adafactor) leaves, its ``mamba_inner`` ones among them, each with
    the spec the reference's ``param_shardings`` gives it on the same
    mesh shape (a ``jax.sharding.AbstractMesh``)."""
    from jax.sharding import AbstractMesh
    from repro.distributed.sharding import ShardingPlan as JaxPlan
    for arch, kind in (("llama3.2-3b", "adamw"), ("gemma2-27b",
                                                  "adafactor"),
                       ("jamba-1.5-large-398b", "adafactor")):
        cfg = _cfg(get_arch, reduced, arch)
        mesh = _mesh((2, 4))
        plan = ShardingPlan(mesh, True, ("data",))
        whole = interop.model_params_from_arrays(_params(arch), cfg,
                                                 device=CPU)
        placed = interop.model_params_from_arrays(_params(arch), cfg,
                                                  plan=plan)
        assert _equal_trees(placed, whole)
        jm = JaxModel(_cfg(jax_get_arch, jax_reduced, arch))
        want = dict(jax.tree_util.tree_leaves_with_path(
            JaxPlan(AbstractMesh((2, 4), ("data", "model")), True,
                    ("data",)).param_shardings(jm.param_logical_axes(),
                                               jm.param_structs())))
        want = {"/".join(k.key for k in path): tuple(ns.spec)
                for path, ns in want.items()}
        got = dict(tree_leaves(tree_map(
            lambda path, p: ("/".join(path), p.spec), placed, path=())))
        assert set(got) == set(want)
        for k, spec in got.items():
            assert spec[:len(want[k])] == want[k] and not any(
                spec[len(want[k]):]), (k, spec, want[k])
        if arch.startswith("jamba"):
            core = placed["layers"]["pos1"]["core"]
            assert core["in_proj"].spec == (None, "data",
                                            "model")
            assert core["A_log"].grid[1] == 4 and core["out_proj"].grid[
                1:] == (4, 2)
        opt = optimizer_for(cfg)
        arrays = tree_map(lambda t: (t + 0.5).numpy()
                          if t.is_floating_point() else t.numpy(),
                          opt.init(whole))
        got = interop.optimizer_state_from_arrays(arrays, placed, kind)
        want = interop.optimizer_state_from_arrays(arrays, whole, kind,
                                                   device=CPU)
        assert _equal_trees(got, want)
        init = opt.init(placed)
        for g, i in zip(tree_leaves(got), tree_leaves(init)):
            assert isinstance(g, Placed) == isinstance(i, Placed)
            if isinstance(g, Placed):
                assert g.spec == i.spec and g.mesh is mesh


def test_make_plan_turns_fsdp_on_past_the_threshold():
    mesh = _mesh((2, 2))
    assert make_plan(mesh, 3_212_749_824).fsdp
    assert not make_plan(mesh, 400_000_000).fsdp
    assert not make_plan(make_local_mesh((4,), ("model",), [CPU]),
                         3_212_749_824).fsdp
