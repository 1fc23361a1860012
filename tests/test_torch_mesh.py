"""PyTorch port, device meshes (``mesh=``): the fleet rows sharded over a
fleet mesh (``fleet_reconstruct``, ``CounterAttributeStage``,
``FleetStream``), sequence-sharded flash-decode, expert-parallel MoE,
the model and the serving engines with ``Model.mesh`` set, and the mesh
constructors — the port on CPU meshes that repeat the CPU (one device
standing for every shard, as one card does on the chip) against the JAX
reference.

Where the reference says sharded equals unsharded (the fleet rows) its
unsharded path runs in this process; where sharding changes the result
(per-shard MoE capacity, the decode combine's order) the reference runs
in a subprocess with ``--xla_force_host_platform_device_count`` set
before JAX is imported, and hands its results back as ``.npz``.  Float32
within 1e-5 of the reference output's largest magnitude; the sharded
fleet rows ``torch.equal`` to the unsharded ones."""
import dataclasses
import gc
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro import fleet as jfleet
from repro.configs import get_arch as jax_get_arch, reduced as jax_reduced
from repro.core.measurement_model import SensorSpec as JSensorSpec
from repro.core.sensors import SensorTrace as JSensorTrace
from repro.models import Model as JaxModel
from repro_torch import fleet as tfleet
from repro_torch import interop
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.distributed.decode_attention import decode_attention
from repro_torch.distributed.sharding import (Mesh, fleet_mesh,
                                              fleet_row_padding,
                                              fleet_shard_map)
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import Model
from repro_torch.models import moe as MOE
from repro_torch.serve import FixedBatchEngine, Request, ServeEngine

torch.use_deterministic_algorithms(True)
# the test workers share the machine's cores: keep torch from taking them all
torch.set_num_threads(2)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = "cpu"
TOL = 1e-5


def _close(got, want, tol=TOL):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float32) - want).max()) / scale
    assert err <= tol, err


def _cpu_mesh(shape, axes=("data", "model")):
    return make_local_mesh(shape, axes, devices=[CPU])


def _counting(monkeypatch, module, name):
    """Replace ``module.name`` (a kernel wrapper) by one that counts its
    calls (the CPU path counts no launch) -> the counter list."""
    calls = []
    fn = getattr(module, name)

    def wrapped(*args):
        calls.append(args[0].shape[0])
        return fn(*args)
    monkeypatch.setattr(module, name, wrapped)
    return calls


# ------------------------------------------------------------ fleet rows

def _fleet_traces(n, seed, length, spread):
    """``tests/test_multidevice.py``'s counter traces: ``n`` cumulative
    counters of ~``length`` reads, every other one wrapping at 24 bits."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = length - int(rng.integers(0, spread))
        dt = rng.uniform(0.5e-3, 2e-3, k)
        t = np.cumsum(dt)
        p = rng.uniform(40, 260, k)
        e = np.cumsum(p * dt)
        wb = 24 if i % 2 == 0 else 0
        spec = JSensorSpec(name=f"s{i}", scope="chip", kind="energy_cum",
                           quantum=1e-6, wrap_bits=wb)
        if wb:
            e = np.mod(e, (2.0 ** wb) * spec.quantum)
        out.append(JSensorTrace(spec.name, spec, t + 1e-4, t, e))
    return out


# the reference's two multi-device fleet tests: 16 traces on 8 devices,
# 6 traces (8 packed rows) on 3
FLEET_CASES = {"8dev": (16, 0, 300, 40, 8), "3dev": (6, 5, 260, 30, 3)}


def _fleet_case(name):
    n, seed, length, spread, n_dev = FLEET_CASES[name]
    traces = _fleet_traces(n, seed, length, spread)
    jp = jfleet.pack_traces(traces)
    tp = interop.packed_fleet_from_fields(dataclasses.asdict(jp))
    return traces, jp, tp, make_local_mesh((n_dev,), ("fleet",), [CPU])


@pytest.mark.parametrize("name", sorted(FLEET_CASES))
def test_fleet_reconstruct_sharded_matches_unsharded_and_reference(
        name, monkeypatch):
    """The packed fleet split over a fleet mesh of 8 (and padded to 9 on
    a mesh of 3): ``torch.equal`` to the port's unsharded run, valid
    masks equal to the reference's and the host mirror's, power within
    1e-5 relative of the reference's unsharded path and of
    ``fleet_reconstruct_host``; one B2 call a shard, on its rows."""
    import repro_torch.fleet.reconstruct as recon
    calls = _counting(monkeypatch, recon, "power_reconstruct_fleet_kernel")
    _, jp, tp, mesh = _fleet_case(name)
    got = tfleet.fleet_reconstruct(tp, device=CPU, mesh=mesh)
    n = mesh.shape["fleet"]
    assert calls == [-(-tp.shape[0] // n)] * n
    assert got[0].shape[0] == tp.shape[0]          # padding sliced off
    un = tfleet.fleet_reconstruct(tp, device=CPU, mesh=None)
    for g, u in zip(got, un):
        assert torch.equal(g, u)
    pj, _, vj = (np.asarray(a) for a in jfleet.fleet_reconstruct(
        jp, mesh=None))
    ph, _, vh = tfleet.fleet_reconstruct_host(tp)
    v = got[2].numpy()
    assert (v == vj).all() and (v == vh).all()
    p = got[0].numpy().astype(np.float64)
    for want in (pj.astype(np.float64), ph):
        rel = np.abs(p[v] - want[v]) / np.maximum(np.abs(want[v]), 1.0)
        assert rel.max() <= TOL, rel.max()


def test_fleet_reconstruct_reordered_row_runs_the_carry_pass_on_real_rows():
    """A row whose timestamps go backwards on a padded 3-mesh: the
    carry-forward pass runs unsharded on the real rows, equal to the
    unsharded run and to the reference's."""
    traces = _fleet_traces(6, 5, 260, 30)
    tr = traces[4]
    tm = tr.t_measured.copy()
    tm[60] = tm[58]
    traces[4] = JSensorTrace(tr.name, tr.spec, tr.t_read, tm, tr.value)
    jp = jfleet.pack_traces(traces)
    tp = interop.packed_fleet_from_fields(dataclasses.asdict(jp))
    got = tfleet.fleet_reconstruct(
        tp, device=CPU, mesh=make_local_mesh((3,), ("fleet",), [CPU]))
    assert got[0].shape == tp.shape
    for g, u, w in zip(got, tfleet.fleet_reconstruct(tp, device=CPU,
                                                     mesh=None),
                       jfleet.fleet_reconstruct(jp, mesh=None)):
        assert torch.equal(g, u)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[1].numpy()[4] != tp.times[4]).any()


@pytest.mark.parametrize("name", sorted(FLEET_CASES))
def test_fleet_stream_sharded_matches_unsharded_and_reference(
        name, monkeypatch):
    """``FleetStream`` over the packed counters in 100-read chunks on the
    mesh: totals ``np.array_equal`` to the unsharded stream's and within
    1e-5 x max(|E|, 1 J) of the reference's; one B7 call a shard a
    chunk; a mesh of 3 pads the 8 rows to 9."""
    import repro_torch.fleet.pipeline as pipe
    calls = _counting(monkeypatch, pipe, "fleet_attribute_kernel")
    traces, jp, tp, mesh = _fleet_case(name)
    span = float(max(tr.t_measured[-1] for tr in traces))
    edges = np.linspace(0.0, span, 5)
    wins = list(zip(edges[:-1], edges[1:]))
    f = jp.shape[0]
    s_sh = tfleet.FleetStream(wins, f, wrap_period=jp.wrap_period,
                              device=CPU, mesh=mesh)
    s_un = tfleet.FleetStream(wins, f, wrap_period=jp.wrap_period,
                              device=CPU, mesh=None)
    s_j = jfleet.FleetStream(wins, f, wrap_period=jp.wrap_period,
                             mesh=None)
    assert s_sh.mesh is mesh and s_un.mesh is None
    assert s_sh._attr._row_pad == fleet_row_padding(mesh, f)
    chunks = 0
    for lo in range(0, jp.shape[1], 100):
        sl = slice(lo, lo + 100)
        for s in (s_sh, s_un, s_j):
            s.update(jp.times[:, sl], jp.energy[:, sl])
        chunks += 1
    n = mesh.shape["fleet"]
    # each chunk: n shards of the padded rows, then the unsharded stream
    assert calls == ([-(-f // n)] * n + [f]) * chunks
    got, want = s_sh.totals(), s_j.totals()
    np.testing.assert_array_equal(got, s_un.totals())
    assert got.shape == want.shape == (f, 4)
    assert (np.abs(got - want) <= TOL * np.maximum(np.abs(want), 1.0)).all()


@pytest.mark.parametrize("n_rows", [2, 4])
def test_counter_attribute_stage_pads_rows_to_the_mesh(n_rows):
    """The reference's rows = mesh -+ 1 on a 3-mesh: the stream pads to
    divisibility with copies of the last row, keeps each row's carry
    across updates, and its totals equal the unsharded stream's and the
    reference's (1e-5)."""
    rng = np.random.default_rng(11)
    dt = rng.uniform(0.5e-3, 2e-3, (n_rows, 300))
    t = np.cumsum(dt, axis=1).astype(np.float32)
    p = rng.uniform(40, 260, (n_rows, 300))
    e = np.cumsum(p * dt, axis=1).astype(np.float32)
    edges = np.linspace(0.0, float(t.max()), 4)
    wins = list(zip(edges[:-1], edges[1:]))
    mesh = make_local_mesh((3,), ("fleet",), [CPU])
    s_sh = tfleet.FleetStream(wins, n_rows, device=CPU, mesh=mesh)
    s_un = tfleet.FleetStream(wins, n_rows, device=CPU, mesh=None)
    s_j = jfleet.FleetStream(wins, n_rows, mesh=None)
    assert s_sh._attr._row_pad == (-n_rows) % 3
    for lo in range(0, 300, 100):
        for s in (s_sh, s_un, s_j):
            s.update(t[:, lo:lo + 100], e[:, lo:lo + 100])
    got = s_sh.totals()
    assert got.shape == (n_rows, 3)
    np.testing.assert_array_equal(got, s_un.totals())
    want = s_j.totals()
    assert (np.abs(got - want) <= TOL * np.maximum(np.abs(want), 1.0)).all()
    # the stage alone: the carry edge comes from the ingest stage, so a
    # window of one column past the last reads adds the same on both
    st_sh = tfleet.CounterAttributeStage(wins, n_rows, device=CPU,
                                         mesh=mesh)
    st_un = tfleet.CounterAttributeStage(wins, n_rows, device=CPU,
                                         mesh=None)
    from repro_torch.fleet.pipeline import ClosedWindow
    win = ClosedWindow(torch.from_numpy(t), torch.from_numpy(e),
                       torch.full((n_rows,), float(t[0, 0]),
                                  dtype=torch.float64))
    st_sh.update(win)
    st_un.update(win)
    np.testing.assert_array_equal(st_sh.totals(), st_un.totals())


def test_fleet_row_padding_and_fleet_mesh():
    """``fleet_row_padding`` as the reference's 3-device test states it;
    ``fleet_mesh`` is None on the CPU."""
    mesh = make_local_mesh((3,), ("fleet",), [CPU])
    assert fleet_row_padding(mesh, 8) == 1
    assert fleet_row_padding(mesh, 9) == 0
    assert fleet_row_padding(mesh, 16) == 2
    assert fleet_row_padding(None, 16) == 0
    assert fleet_mesh() is None


def test_fleet_entries_default_to_one_device_and_take_auto():
    """The fleet entries default to ``mesh=None`` (one device);
    ``"auto"`` is ``fleet_mesh()``, None on the CPU, so it runs the same
    unsharded path."""
    _, _, tp, _ = _fleet_case("3dev")
    base = tfleet.fleet_reconstruct(tp, device=CPU)
    auto = tfleet.fleet_reconstruct(tp, device=CPU, mesh="auto")
    assert all(torch.equal(a, b) for a, b in zip(base, auto))
    assert tfleet.FleetStream([(0, 1)], 2, device=CPU).mesh is None
    assert tfleet.FleetStream([(0, 1)], 2, device=CPU,
                              mesh="auto").mesh is None
    stage = tfleet.CounterAttributeStage([(0, 1)], 2, device=CPU)
    assert stage.mesh is None and stage._sharded is None


def test_fleet_mesh_spans_the_local_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    mesh = fleet_mesh()
    assert mesh.axis_names == ("fleet",) and mesh.shape == {"fleet": 3}
    assert [str(d) for d in mesh.devices] == ["cuda:0", "cuda:1", "cuda:2"]
    assert fleet_mesh(min_devices=4) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert fleet_mesh() is None


def test_fleet_shard_map_splits_rows_and_replicates():
    """Each shard sees its row block and the whole replicated input; the
    outputs come back in row order; rows that do not split raise."""
    mesh = make_local_mesh((4,), ("fleet",), [CPU])
    seen = []

    def fn(a, table):
        seen.append((a.shape, table.shape))
        return a * 2 + table.sum(), a[:, :1]

    run = fleet_shard_map(fn, mesh, n_in=2, n_out=2, replicated_in=(1,))
    a = torch.arange(24.0).reshape(8, 3)
    out, first = run(a, torch.ones(5))
    assert seen == [((2, 3), (5,))] * 4
    assert torch.equal(out, a * 2 + 5) and torch.equal(first, a[:, :1])
    with pytest.raises(ValueError, match="do not split"):
        run(torch.ones(6, 3), torch.ones(5))


def test_fleet_entries_refuse_a_bad_mesh():
    """A value that is not a ``Mesh`` raises; so does a mesh of another
    device type than the entry's, and one without a fleet axis."""
    _, _, tp, _ = _fleet_case("3dev")
    with pytest.raises(TypeError, match="Mesh"):
        tfleet.fleet_reconstruct(tp, device=CPU, mesh=1)
    with pytest.raises(TypeError, match="Mesh"):
        tfleet.FleetStream([(0, 1)], 2, device=CPU, mesh=object())
    with pytest.raises(ValueError, match="fleet"):
        tfleet.FleetStream([(0, 1)], 2, device=CPU,
                           mesh=_cpu_mesh((1, 2)))
    cuda_mesh = Mesh([torch.device("cuda", 0)], ("fleet",))
    with pytest.raises(ValueError, match="cannot shard"):
        tfleet.fleet_reconstruct(tp, device=CPU, mesh=cuda_mesh)


# ---------------------------------------------------- the mesh objects

def test_mesh_construction_and_refusals():
    m = Mesh([["cpu", "cpu"], ["cpu", "cpu"]], ("data", "model"))
    assert m.shape == {"data": 2, "model": 2} and m.size == 4
    assert m.axis_names == ("data", "model") and m.device == torch.device(
        "cpu")
    assert m.device_at(model=1) == torch.device("cpu")
    assert m.distinct_devices() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        Mesh(["cpu", "cuda:0"], ("fleet",))
    with pytest.raises(ValueError, match="axis name"):
        Mesh(["cpu", "cpu"], ("data", "model"))
    with pytest.raises(ValueError, match="repeated"):
        Mesh([["cpu"]], ("data", "data"))


def test_mesh_data_split_and_block_index():
    """The data axes a mesh has split a batch they divide into row-major
    blocks; a batch they do not divide replicates (the axes drop)."""
    m = Mesh([[["cpu"] * 2] * 3] * 2, ("pod", "data", "model"))
    assert m.data_split(("pod", "data"), 12) == (("pod", "data"), 6)
    assert m.data_split(("pod", "data"), 8) == ((), 1)
    assert m.data_split(("data", "expert"), 9) == (("data",), 3)
    assert m.data_split((), 5) == ((), 1)
    blocks = [m.block_index(dict(pod=p, data=d, model=1), ("pod", "data"))
              for p in range(2) for d in range(3)]
    assert blocks == list(range(6))
    assert m.block_index(dict(pod=1, data=2), ()) == 0


def test_mesh_put_places_once_and_forgets_the_freed():
    """On the tensor's own device ``put`` is a view; on another device
    the copy is made once and dropped when its source is freed."""
    m = Mesh([torch.device("cpu", 0), torch.device("cpu", 1)], ("model",))
    w = torch.arange(12.0).reshape(4, 3)
    view = Mesh(["cpu"], ("model",)).put(w, CPU, 0, 2, 4)
    assert view.data_ptr() == w[2:].data_ptr()
    a = m.put(w, m.devices[1], 0, 2, 4)
    assert m.put(w, m.devices[1], 0, 2, 4) is a
    assert torch.equal(a, w[2:]) and len(m._placed) == 1
    del w, a, view
    gc.collect()
    assert not m._placed


def test_make_local_and_production_mesh(monkeypatch):
    m = make_local_mesh((2, 4), devices=[CPU])
    assert m.shape == {"data": 2, "model": 4}
    assert m.axis_names == ("data", "model")
    m3 = make_local_mesh((2, 1, 2), ("pod", "data", "model"),
                         devices=["cpu"] * 4)
    assert m3.shape == {"pod": 2, "data": 1, "model": 2}
    with pytest.raises(RuntimeError, match="needs 8 devices"):
        make_local_mesh((2, 4), devices=[CPU, CPU])
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 devices"):
        make_production_mesh(multi_pod=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.raises(RuntimeError, match="needs 256 devices, have 8"):
        make_production_mesh()
    local = make_local_mesh((1, 4))
    assert [str(d) for d in local.devices.flat] == [
        "cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    one = make_local_mesh((1, 4))
    assert one.distinct_devices() == [torch.device("cuda", 0)]


# ----------------------------------------- the reference on N devices

_REF_SCRIPT = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_arch, reduced
from repro.configs.base import ArchConfig, MoEConfig
from repro.distributed.decode_attention import decode_attention
from repro.models import Model
from repro.models.moe import moe_apply
import dataclasses

assert jax.device_count() == 8
inp = dict(np.load(sys.argv[1]))
out = {}
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "model"))
mesh14 = Mesh(np.asarray(jax.devices()[:4]).reshape(1, 4),
              ("data", "model"))

q, ck, cv = (jnp.asarray(inp["dec_" + k]) for k in ("q", "ck", "cv"))
pos = jnp.asarray(40, jnp.int32)
vpos = jnp.asarray(inp["dec_vpos"])
for name, kw in (("plain", {}), ("window", dict(window=16)),
                 ("cap", dict(logit_cap=30.0)),
                 ("window_cap", dict(window=16, logit_cap=30.0))):
    with mesh:
        out["dec_" + name] = np.asarray(jax.jit(
            lambda q, k, v, p: decode_attention(q, k, v, p, mesh, **kw))(
                q, ck, cv, pos))
        out["dec_vec3_" + name] = np.asarray(jax.jit(
            lambda q, k, v, p: decode_attention(q, k, v, p, mesh, **kw))(
                q[:3], ck[:3], cv[:3], vpos[:3]))
    with mesh14:
        out["dec_vec14_" + name] = np.asarray(jax.jit(
            lambda q, k, v, p: decode_attention(q, k, v, p, mesh14, **kw))(
                q, ck, cv, vpos))
try:
    with mesh:
        jax.jit(lambda q, k, v, p: decode_attention(q, k, v, p, mesh))(
            q, ck, cv, vpos)
    out["dec_vec_split_raises"] = np.asarray(False)
except ValueError:
    out["dec_vec_split_raises"] = np.asarray(True)

x = jnp.asarray(inp["moe_x"])
p = {k[6:]: jnp.asarray(v) for k, v in inp.items()
     if k.startswith("moe_p/") and "/" not in k[6:]}
p["shared"] = {k[13:]: jnp.asarray(v) for k, v in inp.items()
               if k.startswith("moe_p/shared/")}
for cf in (8.0, 0.5):
    cfg = ArchConfig(
        name="t", family="moe", num_layers=2, d_model=16, num_heads=4,
        num_kv_heads=2, d_ff=32, vocab_size=64, head_dim=8,
        moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=32,
                      num_shared_experts=1, capacity_factor=cf))
    with mesh:
        y, aux = jax.jit(lambda p, x: moe_apply(p, cfg, x, mesh=mesh))(p, x)
    out[f"moe_y_{cf}"], out[f"moe_aux_{cf}"] = np.asarray(y), np.asarray(aux)

cfg = dataclasses.replace(reduced(get_arch("moonshot-v1-16b-a3b")),
                          compute_dtype="float32")
jm = Model(cfg)
jm.mesh = mesh


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


params = unflat("model_p/")
with mesh:
    lg, cache = jax.jit(jm.prefill)(
        params, {"tokens": jnp.asarray(inp["model_tokens"])},
        jm.init_cache(2, 32))
    out["model_prefill"] = np.asarray(lg)
    step = jax.jit(jm.decode_step)
    for i in range(4):
        lg, cache = step(params,
                         {"tokens": jnp.asarray(inp["model_dec"][i])},
                         cache, jnp.asarray(20 + i, jnp.int32))
        out[f"model_decode_{i}"] = np.asarray(lg)
np.savez(sys.argv[2], **out)
"""


def _flat(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}{k}/", out)
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _moe_inputs():
    """The reference's 2x4 MoE case (8 experts top-2, d 16, 8 x 16
    tokens) with a shared expert and a router that separates the
    experts (no near-ties between the two packages' top-k)."""
    rng = np.random.default_rng(3)

    def w(*shape, s=0.2):
        return rng.normal(0, s, shape).astype(np.float32)
    p = {"router": w(16, 8, s=0.8), "w_gate": w(8, 16, 32),
         "w_up": w(8, 16, 32), "w_down": w(8, 32, 16),
         "shared": {"w_gate": w(16, 32), "w_up": w(16, 32),
                    "w_down": w(32, 16)}}
    x = rng.normal(0, 1.0, (8, 16, 16))
    x = (x + 1.5 * rng.normal(0, 1.0, (16,))).astype(np.float32)
    return p, x


def _moe_cfg(cf):
    return ArchConfig(
        name="t", family="moe", num_layers=2, d_model=16, num_heads=4,
        num_kv_heads=2, d_ff=32, vocab_size=64, head_dim=8,
        moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=32,
                      num_shared_experts=1, capacity_factor=cf))


def _model_setup():
    cj = dataclasses.replace(jax_reduced(jax_get_arch("moonshot-v1-16b-a3b")),
                             compute_dtype="float32")
    ct = dataclasses.replace(reduced(get_arch("moonshot-v1-16b-a3b")),
                             compute_dtype="float32")
    params = _flat(JaxModel(cj).init(jax.random.key(1)), "", {})
    rng = np.random.default_rng(13)
    tokens = rng.integers(0, cj.vocab_size, (2, 20)).astype(np.int32)
    dec = rng.integers(0, cj.vocab_size, (4, 2, 1)).astype(np.int32)
    return ct, params, tokens, dec


def _decode_inputs():
    rng = np.random.default_rng(7)
    q = rng.normal(0, 1.0, (4, 1, 8, 32)).astype(np.float32)
    ck = rng.normal(0, 1.0, (4, 64, 4, 32)).astype(np.float32)
    cv = rng.normal(0, 1.0, (4, 64, 4, 32)).astype(np.float32)
    return q, ck, cv, np.array([3, 40, 63, 17], np.int32)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's sharded runs, on 8 forced host devices in one
    subprocess (XLA_FLAGS must be set before JAX is imported)."""
    d = tmp_path_factory.mktemp("mesh_ref")
    q, ck, cv, vpos = _decode_inputs()
    p, x = _moe_inputs()
    _, mparams, tokens, dec = _model_setup()
    inp = {"dec_q": q, "dec_ck": ck, "dec_cv": cv, "dec_vpos": vpos,
           "moe_x": x, "model_tokens": tokens, "model_dec": dec}
    _flat(p, "moe_p/", inp)
    _flat(mparams, "model_p/", inp)
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF_SCRIPT),
                        str(d / "in.npz"), str(d / "out.npz")],
                       capture_output=True, text=True, env=env, timeout=420)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return dict(np.load(d / "out.npz"))


# ------------------------------------------------------------ decode

DECODE_KW = {"plain": {}, "window": dict(window=16),
             "cap": dict(logit_cap=30.0),
             "window_cap": dict(window=16, logit_cap=30.0)}


@pytest.mark.parametrize("name", sorted(DECODE_KW))
def test_decode_attention_sharded_matches_reference(ref, name):
    """On a (data 2, model 4) mesh: a scalar position (batch split over
    data, sequence over model) and a (3,) per-row position (3 rows do
    not split over data 2, so the batch stays whole); on a (data 1,
    model 4) mesh the (4,) per-row positions: each within 1e-5 of the
    reference's sharded run."""
    q, ck, cv, vpos = (torch.from_numpy(a) for a in _decode_inputs())
    kw = DECODE_KW[name]
    mesh = _cpu_mesh((2, 4))
    _close(decode_attention(q, ck, cv, 40, mesh, **kw), ref[f"dec_{name}"])
    _close(decode_attention(q[:3], ck[:3], cv[:3], vpos[:3], mesh, **kw),
           ref[f"dec_vec3_{name}"])
    _close(decode_attention(q, ck, cv, vpos, _cpu_mesh((1, 4)), **kw),
           ref[f"dec_vec14_{name}"])


def test_decode_attention_vector_pos_with_a_split_batch_raises(ref):
    """Per-row positions with the batch split over data: the reference
    raises (its replicated positions cannot broadcast to the shard's
    rows), and so does the port."""
    assert bool(ref["dec_vec_split_raises"])
    q, ck, cv, vpos = (torch.from_numpy(a) for a in _decode_inputs())
    with pytest.raises(ValueError, match="broadcast"):
        decode_attention(q, ck, cv, vpos, _cpu_mesh((2, 4)))


def test_decode_attention_single_shard_cases_equal_no_mesh():
    """A cache that does not split over the model axis (or an axis of
    one) runs on one shard: exactly the unsharded result."""
    q, ck, cv, vpos = (torch.from_numpy(a) for a in _decode_inputs())
    want = decode_attention(q, ck[:, :63], cv[:, :63], vpos, None)
    got = decode_attention(q, ck[:, :63], cv[:, :63], vpos,
                           _cpu_mesh((1, 4)))
    assert torch.equal(got, want)
    assert torch.equal(decode_attention(q, ck, cv, 40, _cpu_mesh((4, 1))),
                       decode_attention(q, ck, cv, 40, None))
    with pytest.raises(TypeError, match="Mesh"):
        decode_attention(q, ck, cv, 40, object())


# --------------------------------------------------------------- MoE

def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_moe_apply_expert_parallel_matches_reference(ref, cf):
    """Experts over model 4, tokens over data 2: the output and the aux
    loss (the first data shard's) within 1e-5 of the reference's sharded
    run.  At capacity factor 0.5 each data shard's capacity binds, and
    the sharded result differs from the unsharded one, as the
    reference's does; at 8.0 nothing is dropped and they agree."""
    p, x = _moe_inputs()
    tp, tx = _torch_tree(p), torch.from_numpy(x)
    cfg = _moe_cfg(cf)
    mesh = _cpu_mesh((2, 4))
    y, aux = MOE.moe_apply(tp, cfg, tx, mesh=mesh)
    _close(y, ref[f"moe_y_{cf}"])
    _close(aux, ref[f"moe_aux_{cf}"])
    # the aux is the first data shard's, computed on its own tokens
    _, aux0 = MOE.moe_apply(tp, cfg, tx[:4])
    assert torch.equal(aux, aux0)
    y_un, _ = MOE.moe_apply(tp, cfg, tx)
    diff = float((y - y_un).abs().max() / y_un.abs().max())
    if cf == 8.0:
        assert diff <= TOL, diff
    else:
        assert diff > 1e-2, diff
        _, kept = MOE.moe_assignments(tp, cfg, tx)
        assert not kept.all()


def test_moe_apply_on_distinct_devices_places_expert_slices_once():
    """The same MoE on a mesh of distinct (CPU) devices: the result is
    ``torch.equal`` to the repeated-device mesh's, each shard's expert
    slices and shared d_ff slices are placed on its device once, and a
    batch that does not split over data replicates."""
    p, x = _moe_inputs()
    tp, tx = _torch_tree(p), torch.from_numpy(x)
    cfg = _moe_cfg(0.5)
    devs = np.empty((2, 4), dtype=object)
    devs[:] = [[torch.device("cpu", 4 * i + j) for j in range(4)]
               for i in range(2)]
    mesh = Mesh(devs, ("data", "model"))
    y, aux = MOE.moe_apply(tp, cfg, tx, mesh=mesh)
    want, want_aux = MOE.moe_apply(tp, cfg, tx, mesh=_cpu_mesh((2, 4)))
    assert torch.equal(y, want) and torch.equal(aux, want_aux)
    # per device a router, three expert and three shared-expert slices
    # (no device of this mesh is the weights' own "cpu")
    n_placed = len(mesh._placed)
    assert n_placed == 8 * 7
    MOE.moe_apply(tp, cfg, tx, mesh=mesh)
    assert len(mesh._placed) == n_placed
    y3, _ = MOE.moe_apply(tp, cfg, tx[:3], mesh=mesh)
    y3_want, _ = MOE.moe_apply(tp, cfg, tx[:3], mesh=_cpu_mesh((1, 4)))
    assert torch.equal(y3, y3_want)


def test_moe_apply_mesh_without_the_expert_axis_is_unsharded():
    p, x = _moe_inputs()
    tp, tx = _torch_tree(p), torch.from_numpy(x)
    cfg = _moe_cfg(0.5)
    got = MOE.moe_apply(tp, cfg, tx, mesh=make_local_mesh((2,), ("data",),
                                                          [CPU]))
    want = MOE.moe_apply(tp, cfg, tx)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="not divisible by EP=3"):
        MOE.moe_apply(tp, cfg, tx, mesh=_cpu_mesh((1, 3)))
    cfg16 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=16))
    p16 = dict(tp, router=torch.cat([tp["router"]] * 2, dim=1),
               **{k: torch.cat([tp[k]] * 2) for k in
                  ("w_gate", "w_up", "w_down")})
    p16["shared"] = {k: v[:, :30] if k != "w_down" else v[:30]
                     for k, v in tp["shared"].items()}
    with pytest.raises(ValueError, match="does not split over EP=4"):
        MOE.moe_apply(p16, cfg16, tx, mesh=_cpu_mesh((1, 4)))


# ------------------------------------------------ the model, the engines

def test_model_with_mesh_prefill_and_decode_match_reference(ref):
    """A reduced MoE configuration (moonshot: experts and a shared
    expert) with ``Model.mesh`` a (data 2, model 4) mesh, float32:
    prefill of 2 x 20 tokens, then 4 decode steps, each step's logits
    within 1e-5 of the reference's sharded model."""
    ct, params, tokens, dec = _model_setup()
    tm = Model(ct)
    tm.mesh = _cpu_mesh((2, 4))
    tp = interop.model_params_from_arrays(_unflat(params), ct, device=CPU)
    lg, cache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)},
                           tm.init_cache(2, 32, device=CPU))
    _close(lg, ref["model_prefill"])
    for i in range(4):
        lg, cache = tm.decode_step(tp, {"tokens": torch.from_numpy(dec[i])},
                                   cache, 20 + i)
        _close(lg, ref[f"model_decode_{i}"])


def test_model_on_distinct_devices_places_each_layers_experts_once():
    """``Model.mesh`` over distinct (CPU) devices: a layer's weights are
    a fresh view of the stacked leaf at every call, and still each
    shard's slices are placed once (a second prefill adds none); the
    logits ``torch.equal`` the repeated-device mesh's."""
    ct, params, tokens, _ = _model_setup()
    tp = interop.model_params_from_arrays(_unflat(params), ct, device=CPU)
    devs = np.empty((1, 4), dtype=object)
    devs[0] = [torch.device("cpu", j) for j in range(4)]
    out = []
    for mesh in (Mesh(devs, ("data", "model")), _cpu_mesh((1, 4))):
        tm = Model(ct)
        tm.mesh = mesh
        for _ in range(2):
            lg, _ = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)},
                               tm.init_cache(2, 32, device=CPU))
            if len(out) == 0:
                placed = len(mesh._placed)
        out.append(lg)
        if mesh.devices[0, 0].index is not None:
            # per device and layer: router, 3 expert and 3 shared slices
            assert placed == len(mesh._placed) == 4 * 7 * ct.num_layers
    assert torch.equal(out[0], out[1])


def _unflat(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return tree


def _requests(vocab):
    r = np.random.default_rng(5)
    return [Request(rid=i, prompt=r.integers(1, vocab, n).astype(np.int32),
                    max_new_tokens=m)
            for i, (n, m) in enumerate(((9, 5), (4, 3), (12, 4), (6, 2)))]


@pytest.mark.parametrize("engine", ["continuous", "fixed"])
def test_engines_with_model_mesh_give_the_same_tokens(engine):
    """The serving engines on a reduced MoE model in float32, with
    ``model.mesh`` a (data 1, model 4) mesh (the continuous engine's
    per-row positions go through the sharded decode) and without: the
    same greedy tokens for every request."""
    ct, params, _, _ = _model_setup()
    tp = interop.model_params_from_arrays(_unflat(params), ct, device=CPU)
    out = []
    for mesh in (None, _cpu_mesh((1, 4))):
        tm = Model(ct)
        tm.mesh = mesh
        if engine == "continuous":
            eng = ServeEngine(tm, tp, batch_slots=2, max_len=32,
                              flush_interval=2, device=CPU)
        else:
            eng = FixedBatchEngine(tm, tp, batch_slots=2, max_len=32,
                                   device=CPU)
        out.append(eng.run(_requests(ct.vocab_size)))
    assert out[0] == out[1]
    assert sorted(out[1]) == [0, 1, 2, 3]
