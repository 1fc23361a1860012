"""PyTorch port, the sharding plan (``ShardingPlan``, ``make_plan``,
``FSDP_THRESHOLD``) and placement (``place``, ``Placed``, ``gather``)
against the JAX reference.

The reference's plan reads only ``mesh.shape``, so it runs in this
process on a ``jax.sharding.AbstractMesh`` of the same shape and axis
names as the port's CPU mesh.  Every leaf of all ten configurations at
their published sizes, on the production meshes and the two test
meshes, with ``make_plan``'s FSDP and with FSDP forced both ways: the
port's spec equals the reference's ``PartitionSpec`` entry for entry.
The same for the batch (sizes that divide the data-parallel size and
sizes that do not) and for each configuration's decode cache."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_arch as jax_get_arch
from repro.distributed import sharding as JS
from repro.models import Model as JaxModel
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as TS
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import Model
from repro_torch.models.layers import tree_leaves, tree_map

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    return (AbstractMesh(shape, axes),
            make_local_mesh(shape, axes, devices=["cpu"]))


def _plans(name, fsdp, n_params):
    jm, tm = _meshes(name)
    if fsdp == "make_plan":
        return JS.make_plan(jm, n_params), TS.make_plan(tm, n_params)
    dp = tuple(a for a in ("pod", "data") if a in tm.axis_names)
    return (JS.ShardingPlan(jm, fsdp, dp), TS.ShardingPlan(tm, fsdp, dp))


def _jspec(ns) -> tuple:
    return tuple(ns.spec)


@pytest.mark.parametrize("fsdp", ["make_plan", True, False])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_param_shardings_equal_reference(arch, mesh, fsdp):
    """``param_shardings`` with the structs (and without: no
    divisibility rule) and ``make_plan``: the port's specs are the
    reference's, leaf for leaf; ``make_plan``'s FSDP is the reference's
    for the configuration's size."""
    jmod, tmod = JaxModel(jax_get_arch(arch)), Model(get_arch(arch))
    n = sum(int(np.prod(s.shape)) for s in
            jax.tree.leaves(jmod.param_structs()))
    jp, tp = _plans(mesh, fsdp, n)
    assert (jp.fsdp, tuple(jp.dp_axes)) == (tp.fsdp, tp.dp_axes)
    if fsdp == "make_plan":
        assert tp.fsdp == (n > TS.FSDP_THRESHOLD)
    assert TS.FSDP_THRESHOLD == JS.FSDP_THRESHOLD
    for structs in (True, False):
        want = jp.param_shardings(
            jmod.param_logical_axes(),
            jmod.param_structs() if structs else None)
        got = tp.param_shardings(
            tmod.param_logical_axes(),
            tmod.param_structs() if structs else None)
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(tree_leaves(tree_map(
            lambda path, s: ("/".join(path), s), got, path=())))
        assert len(flat_w) == len(flat_g)
        for path, ns in flat_w:
            key = "/".join(p.key for p in path)
            assert flat_g[key].spec == _jspec(ns), (key, structs)
            assert flat_g[key].mesh is tp.mesh


def test_param_structs_and_logical_axes_equal_reference():
    """``Model.param_structs`` (meta tensors: no storage) and
    ``param_logical_axes`` carry the reference's shapes, dtypes and
    axes, leaf for leaf."""
    for arch in sorted(JAX_ARCHS):
        jmod, tmod = JaxModel(jax_get_arch(arch)), Model(get_arch(arch))
        ja = jax.tree.leaves(jmod.param_logical_axes(),
                             is_leaf=lambda x: isinstance(x, tuple))
        ta = tree_leaves(tmod.param_logical_axes())
        assert ja == ta, arch
        js = jax.tree.leaves(jmod.param_structs())
        ts = tree_leaves(tmod.param_structs())
        assert [tuple(s.shape) for s in js] == [tuple(s.shape) for s in ts]
        assert all(t.device.type == "meta" for t in ts)
        assert {str(s.dtype) for s in js} == {"float32"}
        assert {t.dtype for t in ts} == {torch.float32}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("batch", [1, 3, 8, 64, 96])
def test_batch_shardings_equal_reference(mesh, batch):
    """Tokens, labels, (3, B, S) M-RoPE positions, vision rows and a
    0-d leaf, at batch sizes that divide the data-parallel size and
    sizes that do not."""
    jp, tp = _plans(mesh, "make_plan", 1)
    shapes = {"tokens": (batch, 16), "labels": (batch, 16),
              "positions": (3, batch, 16),
              "vision_embeds": (batch, 4, 32), "step": ()}
    want = jp.batch_shardings({k: jax.ShapeDtypeStruct(s, "int32")
                               for k, s in shapes.items()})
    got = tp.batch_shardings({k: torch.empty(s, device="meta")
                              for k, s in shapes.items()})
    for k in shapes:
        assert got[k].spec == _jspec(want[k]), k
    assert tp.dp_size() == jp.dp_size()
    assert tp.batch_spec(batch, 2) == tuple(jp.batch_spec(batch, 2))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_cache_shardings_equal_reference(arch, mesh):
    """Each configuration's decode cache (its own ``cache_specs``) at a
    batch that divides the data-parallel size and one that does not:
    k/v and whisper's cross keys on the sequence, Mamba's ssm/conv and
    the mLSTM's C on their channel dims, every other leaf on the
    batch alone."""
    jp, tp = _plans(mesh, "make_plan", 1)
    jmod, tmod = JaxModel(jax_get_arch(arch)), Model(get_arch(arch))
    for b in (tp.dp_size() * 2, 3):
        want = jax.tree_util.tree_flatten_with_path(
            jp.cache_shardings(jmod.cache_specs(b, 4096), b))[0]
        got = dict(tree_leaves(tree_map(
            lambda path, s: ("/".join(path), s),
            tp.cache_shardings(tmod.cache_specs(b, 4096), b), path=())))
        assert len(want) == len(got)
        for path, ns in want:
            key = "/".join(p.key for p in path)
            assert got[key].spec == _jspec(ns), (key, b)


# ------------------------------------------------------------ placement

def test_place_stores_each_block_once_per_distinct_device():
    """On one device repeated each block is stored once; on distinct
    devices a block replicated over an axis is stored on each device
    that holds it; the full leaf gathers back equal; a region reads the
    slice a shard computes with."""
    t = torch.arange(12 * 6, dtype=torch.float32).reshape(12, 6)
    one = make_local_mesh((2, 3), devices=["cpu"])
    p = TS.place(t, TS.Sharding(one, ("model", None)))
    assert p.grid == (3, 1)
    assert all(len(c) == 1 for c in p.copies.values())
    assert torch.equal(p.full(), t) and torch.equal(TS.gather(p), t)
    assert torch.equal(TS.gather(p, region=((2, 5), None)), t[2:5])
    devs = np.empty((2, 3), dtype=object)
    devs[:] = [[torch.device("cpu", 3 * i + j) for j in range(3)]
               for i in range(2)]
    many = TS.Mesh(devs, ("data", "model"))
    q = TS.place(t, TS.Sharding(many, (None, "model")))
    assert q.grid == (1, 3)
    # block j is held by (0, j) and (1, j): two devices each, owner first
    assert [list(q.copies[(0, j)]) for j in range(3)] == [
        [devs[0, j], devs[1, j]] for j in range(3)]
    assert torch.equal(q.full(), t)
    r = TS.place(t, TS.Sharding(many, (("data", "model"), None)))
    assert r.grid == (6, 1) and all(len(c) == 1 for c in r.copies.values())
    assert torch.equal(r.full(), t)
    with pytest.raises(ValueError, match="does not split"):
        TS.place(torch.ones(5, 2), TS.Sharding(one, ("model",)))
    z = TS.place(torch.tensor(3, dtype=torch.int32), TS.Sharding(one, ()))
    assert torch.is_tensor(z) and int(z) == 3


def test_placed_write_and_sync_reach_every_copy():
    """A region written into a placed leaf lands in every block it
    meets and every copy of them; ``write_rows`` writes each row at its
    own slot without a host read; ``sync`` copies owners to replicas."""
    devs = np.empty((2, 2), dtype=object)
    devs[:] = [[torch.device("cpu", 2 * i + j) for j in range(2)]
               for i in range(2)]
    mesh = TS.Mesh(devs, ("data", "model"))
    want = torch.zeros(4, 8, 3)
    p = TS.placed_zeros(TS.Sharding(mesh, (None, "model")), (4, 8, 3),
                        torch.float32)
    val = torch.arange(4 * 5 * 3, dtype=torch.float32).reshape(4, 5, 3)
    p[:, 2:7] = val
    want[:, 2:7] = val
    assert torch.equal(p.full(), want)
    for c in p.copies.values():
        first, second = c.values()
        assert torch.equal(first, second)
    slot = torch.tensor([0, 3, 4, 7])
    rows = torch.full((4, 3), -1.0)
    p.write_rows(slot, rows)
    want[torch.arange(4), slot] = rows
    assert torch.equal(p.full(), want)
    p.owner((0, 1, 0)).fill_(9.0)
    p.sync()
    assert all(torch.equal(t, torch.full_like(t, 9.0))
               for t in p.copies[(0, 1, 0)].values())
