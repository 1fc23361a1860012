"""PyTorch port, serving: the continuous-batching ``ServeEngine`` and the
``FixedBatchEngine`` against the JAX reference's on the same weights and
requests (float32, so greedy tokens must be identical), the load
generator, the phase attribution of a served timeline (with health and
the registry), per-request metering, the launcher and the options that
are not ported."""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch, reduced as jax_reduced
from repro.core import NodeFabric as JaxNodeFabric
from repro.core import ToolSpec as JaxToolSpec
from repro.core import phase_power as jax_phase_power
from repro.core.power_model import occupancy_power as jax_occupancy_power
from repro.models import Model as JaxModel
from repro.serve import FixedBatchEngine as JaxFixedBatchEngine
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import poisson_requests as jax_poisson_requests
from repro_torch import interop
from repro_torch.configs import get_arch, reduced
from repro_torch.models import Model
from repro_torch.serve import (FixedBatchEngine, Request, ServeEngine,
                               poisson_requests)

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

CPU = "cpu"
_CACHE = {}


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    return np.asarray(t)


def _setup(arch="llama3.2-3b"):
    """Both packages' float32 reduced model with the same weights."""
    if arch not in _CACHE:
        cj = dataclasses.replace(jax_reduced(jax_get_arch(arch)),
                                 compute_dtype="float32", moe=None)
        ct = dataclasses.replace(reduced(get_arch(arch)),
                                 compute_dtype="float32", moe=None)
        jm = JaxModel(cj)
        params = jm.init(jax.random.key(0))
        tp = interop.model_params_from_arrays(_np_tree(params), ct,
                                              device=CPU)
        _CACHE[arch] = (jm, params, Model(ct), tp)
    return _CACHE[arch]


def _reqs(cls, vocab, lens, max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(1, vocab, size=(ln,))
                .astype(np.int32), max_new_tokens=mn)
            for i, (ln, mn) in enumerate(zip(lens, max_new))]


def _schedule(engine):
    return [(s.kind, s.rids, s.tokens) for s in engine.segments]


def _regions(engine):
    return [(e.name, e.depth, e.slot, e.step) for e in engine.tracer.events]


# mixed lengths and budgets on two slots: admissions mid-decode, evictions
_LENS, _NEW = [4, 7, 5, 6, 4], [5, 2, 7, 3, 4]


@pytest.mark.parametrize("arch,bucket", [("llama3.2-3b", 1),
                                         ("llama3.2-3b", 4),
                                         ("jamba-1.5-large-398b", 1)])
def test_serve_engine_matches_reference(arch, bucket):
    """Greedy tokens, the SlotSegment schedule (kinds, rids, weights),
    host transfers and counters identical to the reference's engine;
    ``prefill_bucket=4`` left-pads and attends over the pad tokens, as
    the reference does."""
    jm, params, tm, tp = _setup(arch)
    vocab = jm.cfg.vocab_size
    kw = dict(batch_slots=2, max_len=32, flush_interval=3,
              prefill_bucket=bucket)
    ref = JaxServeEngine(jm, params, **kw)
    want = ref.run(_reqs(JaxRequest, vocab, _LENS, _NEW))
    eng = ServeEngine(tm, tp, device=CPU, **kw)
    got = eng.run(_reqs(Request, vocab, _LENS, _NEW))
    assert got == want
    assert _schedule(eng) == _schedule(ref)
    assert eng.host_transfers == ref.host_transfers
    assert eng.tokens_emitted == ref.tokens_emitted == sum(_NEW)
    assert eng.requests_served == ref.requests_served == len(_NEW)
    # the same depth-0 and slot-scoped depth-1 regions, in order
    assert _regions(eng) == _regions(ref)
    # the schedule tiles the depth-0 phases exactly
    ph = sorted((a, b) for _, a, b in eng.tracer.phases(depth=0))
    assert ph == sorted((s.t_lo, s.t_hi) for s in eng.segments)


def test_fixed_batch_engine_matches_reference():
    jm, params, tm, tp = _setup()
    vocab = jm.cfg.vocab_size
    kw = dict(batch_slots=2, max_len=32, flush_interval=3)
    ref = JaxFixedBatchEngine(jm, params, **kw)
    want = ref.run(_reqs(JaxRequest, vocab, _LENS, _NEW))
    eng = FixedBatchEngine(tm, tp, device=CPU, **kw)
    got = eng.run(_reqs(Request, vocab, _LENS, _NEW))
    assert got == want
    assert eng.host_transfers == ref.host_transfers
    assert eng.tokens_emitted == ref.tokens_emitted
    assert [p[0] for p in eng.tracer.phases(depth=0)] == \
        [p[0] for p in ref.tracer.phases(depth=0)]


def test_continuous_matches_fixed_batch():
    """The reference's own parity, on the port alone: equal-length
    prompts (no padding skew) decode the same greedy tokens."""
    _, _, tm, tp = _setup()
    vocab = tm.cfg.vocab_size
    lens, max_new = [6, 6, 6, 6], [7, 3, 5, 2]
    out_f = FixedBatchEngine(tm, tp, batch_slots=2, max_len=32,
                             device=CPU).run(
        _reqs(Request, vocab, lens, max_new))
    cont = ServeEngine(tm, tp, batch_slots=2, max_len=32, flush_interval=2,
                       device=CPU)
    out_c = cont.run(_reqs(Request, vocab, lens, max_new))
    assert out_c == out_f
    assert all(len(out_c[r]) == max_new[r] for r in out_c)
    assert cont.requests_served == 4
    assert cont.tokens_emitted == sum(max_new)


_ZOO = {}


def _setup_zoo(arch):
    """Both packages' float32 reduced model with the same weights,
    experts kept."""
    if arch not in _ZOO:
        cj = dataclasses.replace(jax_reduced(jax_get_arch(arch)),
                                 compute_dtype="float32")
        ct = dataclasses.replace(reduced(get_arch(arch)),
                                 compute_dtype="float32")
        jm = JaxModel(cj)
        params = jm.init(jax.random.key(0))
        tp = interop.model_params_from_arrays(_np_tree(params), ct,
                                              device=CPU)
        _ZOO[arch] = (jm, params, Model(ct), tp)
    return _ZOO[arch]


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "jamba-1.5-large-398b", "xlstm-1.3b"])
def test_engines_on_moe_and_xlstm_match_reference(arch):
    """MoE (moonshot: shared experts; Jamba: MoE every other layer of
    its attention+Mamba pattern) and xLSTM (float32 mLSTM/sLSTM states
    carried through ``_scatter_slot`` and the masked step): each engine
    gives the reference's engine's greedy tokens, token for token, with
    the same schedule and host transfers."""
    jm, params, tm, tp = _setup_zoo(arch)
    vocab = jm.cfg.vocab_size
    kw = dict(batch_slots=2, max_len=32, flush_interval=3)
    ref = JaxServeEngine(jm, params, **kw)
    want = ref.run(_reqs(JaxRequest, vocab, _LENS, _NEW))
    eng = ServeEngine(tm, tp, device=CPU, **kw)
    assert eng.run(_reqs(Request, vocab, _LENS, _NEW)) == want
    assert _schedule(eng) == _schedule(ref)
    assert eng.host_transfers == ref.host_transfers
    fkw = dict(batch_slots=2, max_len=32, flush_interval=3)
    ref_f = JaxFixedBatchEngine(jm, params, **fkw)
    want_f = ref_f.run(_reqs(JaxRequest, vocab, _LENS, _NEW))
    eng_f = FixedBatchEngine(tm, tp, device=CPU, **fkw)
    assert eng_f.run(_reqs(Request, vocab, _LENS, _NEW)) == want_f
    assert eng_f.host_transfers == ref_f.host_transfers


def test_moe_engines_match_reference_where_capacity_splits_them():
    """An MoE layout whose batch-1 prefill (continuous) and 2-slot prefill
    (fixed) drop different assignments (moonshot's 64 experts top-6 at
    d_model 256, 2 layers, an untied head so the greedy tokens show it):
    the reference's two engines disagree, and each of the port's engines
    gives its counterpart's tokens, token for token (ROADMAP C)."""
    base = (jax_get_arch("moonshot-v1-16b-a3b"),
            get_arch("moonshot-v1-16b-a3b"))
    cj, ct = (dataclasses.replace(
        b, num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
        vocab_size=1024, compute_dtype="float32", tie_embeddings=False,
        moe=dataclasses.replace(b.moe, expert_d_ff=64)) for b in base)
    jm = JaxModel(cj)
    params = jm.init(jax.random.key(0))
    tm = Model(ct)
    tp = interop.model_params_from_arrays(_np_tree(params), ct, device=CPU)
    lens, max_new = [64] * 4, [7, 3, 5, 2]
    kw = dict(batch_slots=2, max_len=144)
    ref_f = JaxFixedBatchEngine(jm, params, **kw).run(
        _reqs(JaxRequest, 1024, lens, max_new))
    ref_c = JaxServeEngine(jm, params, flush_interval=2, **kw).run(
        _reqs(JaxRequest, 1024, lens, max_new))
    assert ref_c != ref_f
    got_f = FixedBatchEngine(tm, tp, device=CPU, **kw).run(
        _reqs(Request, 1024, lens, max_new))
    got_c = ServeEngine(tm, tp, flush_interval=2, device=CPU, **kw).run(
        _reqs(Request, 1024, lens, max_new))
    assert got_f == ref_f
    assert got_c == ref_c


def test_host_transfer_counts_and_zero_budget():
    _, _, tm, tp = _setup()
    vocab = tm.cfg.vocab_size
    fixed = FixedBatchEngine(tm, tp, batch_slots=2, max_len=64,
                             flush_interval=8, device=CPU)
    fixed.run(_reqs(Request, vocab, [4, 4], [20, 20]))
    assert fixed.host_transfers == 3
    cont = ServeEngine(tm, tp, batch_slots=2, max_len=64, flush_interval=16,
                       device=CPU)
    out = cont.run(_reqs(Request, vocab, [4, 4], [33, 0]))
    assert cont.host_transfers == 2
    assert out[1] == [] and len(out[0]) == 33


def test_arrival_respecting_run_completes():
    _, _, tm, tp = _setup()
    reqs = poisson_requests(4, rate_rps=2000.0, seed=3, prompt_lens=(4, 6),
                            new_tokens=(1, 4), vocab_size=tm.cfg.vocab_size)
    engine = ServeEngine(tm, tp, batch_slots=2, max_len=32,
                         flush_interval=2, device=CPU)
    out = engine.run(reqs, respect_arrivals=True)
    assert sorted(out) == list(range(4))
    for r in reqs:
        assert len(r.generated) == r.max_new_tokens
        assert r.ttft_s >= 0.0 and r.latency_s >= r.ttft_s


@pytest.mark.parametrize("seed", [0, 7])
def test_poisson_requests_match_reference(seed):
    kw = dict(rate_rps=100.0, seed=seed, prompt_lens=(128, 512, 1000),
              new_tokens=(8, 64), vocab_size=128_256)
    a, b = poisson_requests(16, **kw), jax_poisson_requests(16, **kw)
    assert [r.arrival_s for r in a] == [r.arrival_s for r in b]
    assert [r.max_new_tokens for r in a] == [r.max_new_tokens for r in b]
    assert [r.user for r in a] == [r.user for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


# ---------------------------------------------- attribution of a timeline

def _served_fabric():
    """The reference engine's served timeline, a two-chip fabric whose
    truth follows it (``launch/serve.py``'s recipe), and the port's
    engine holding the same timeline."""
    if "fabric" not in _CACHE:
        jm, params, tm, tp = _setup()
        ref = JaxServeEngine(jm, params, batch_slots=2, max_len=32,
                             flush_interval=3)
        ref.run(_reqs(JaxRequest, jm.cfg.vocab_size, _LENS, _NEW))
        lead = 0.05
        occ = {"admission": (0.0, 0.05, 0.0), "prefill": (1.0, 0.5, 0.1),
               "decode": (0.15, 1.0, 0.1)}
        shifted = [(n, a + lead, b + lead)
                   for n, a, b in ref.tracer.phases(depth=0)]
        watts = {n: {"watts": jax_occupancy_power(*occ[n])}
                 for n, _, _ in shifted}
        truth = jax_phase_power([("__lead__", 0.0, lead)] + shifted,
                                {**watts, "__lead__": {"watts": 55.0}})
        traces = JaxNodeFabric(chip_truths=[truth] * 2).sample_all(
            JaxToolSpec(), seed=0)
        eng = ServeEngine(tm, tp, batch_slots=2, max_len=32, device=CPU)
        eng.tracer = interop.tracer_from_arrays(ref.tracer.to_arrays())
        port_traces = {k: interop.trace_from_fields(
            tr.name, dataclasses.asdict(tr.spec), tr.t_read, tr.t_measured,
            tr.value) for k, tr in traces.items()}
        _CACHE["fabric"] = (ref, traces, eng, port_traces, lead)
    return _CACHE["fabric"]


def _energy_close(got_rows, want_rows):
    got = np.array([[p.energy_j for p in row] for row in got_rows])
    want = np.array([[p.energy_j for p in row] for row in want_rows])
    assert got.shape == want.shape and got.size
    assert (np.abs(got - want)
            <= 1e-5 * np.maximum(np.abs(want), 1.0)).all()


def test_attribute_phases_counters_match_reference():
    ref, traces, eng, port_traces, lead = _served_fabric()
    want = ref.attribute_phases(traces, t_shift=lead)
    got = eng.attribute_phases(port_traces, t_shift=lead)
    assert list(got) == list(want)
    _energy_close(got.values(), want.values())


def test_attribute_phases_fused_batch_matches_reference():
    ref, traces, eng, port_traces, lead = _served_fabric()
    want = ref.attribute_phases(traces, t_shift=lead, fuse=True)
    got = eng.attribute_phases(port_traces, t_shift=lead, fuse=True)
    assert list(got) == list(want)
    _energy_close(got.values(), want.values())


def test_attribute_phases_fused_windowed_matches_reference():
    """``streaming=True``: the windowed pipeline on the fused streams,
    delays fixed (no tracking), on both sides."""
    ref, traces, eng, port_traces, lead = _served_fabric()
    with pytest.warns(DeprecationWarning):
        want = ref.attribute_phases(traces, t_shift=lead, fuse=True,
                                    streaming=True, track=False)
    with pytest.warns(DeprecationWarning):
        got = eng.attribute_phases(port_traces, t_shift=lead, fuse=True,
                                   streaming=True, track=False)
    assert list(got) == list(want)
    _energy_close(got.values(), want.values())


def test_unported_serve_options_raise_naming_the_roadmap():
    """``mesh=`` takes a ``distributed.sharding.Mesh`` (the serving
    model's sharded decode, tests/test_torch_mesh.py) and refuses any
    other value; multi-host ``shard``/``collectives`` run the streaming
    pipeline (tests/test_torch_multihost.py) and refuse the batch one."""
    from repro_torch.models.layers import attention_apply
    _, _, eng, port_traces, _ = _served_fabric()
    with pytest.raises(TypeError, match="Mesh"):
        attention_apply(None, None, None, None, mesh=object())
    with pytest.raises(ValueError, match="streaming pipeline"):
        eng.attribute_phases(port_traces, fuse=True, shard=object(),
                             collectives=object())


# ---------------------------------------------- per-request metering

# seconds per depth-0 region on the fixed timeline (decode: per step)
_SECONDS = {"admission": 0.004, "prefill": 0.06, "decode": 0.02}


def _fixed_timeline(engine):
    """Replace a reference engine's measured timeline with a fixed one:
    every boundary of its depth-0 regions is moved so that each region
    lasts ``_SECONDS`` of its kind (decode: per step of its segment) and
    each host gap 2 ms, keeping the order, the slot-scoped regions and
    the slot schedule (which share those boundaries).  The served tokens
    do not depend on time; the attributed energies then do not depend
    on how loaded the machine was."""
    from repro.core.tracing import RegionTracer as JaxTracer
    ev0 = sorted((e for e in engine.tracer.events if e.depth == 0),
                 key=lambda e: e.t_start)
    steps = {(sg.t_lo, sg.t_hi): max(sg.tokens) for sg in engine.segments
             if sg.kind == "decode"}
    new, t = {}, 0.1
    for e in ev0:
        t = new.setdefault(e.t_start, t + (0.002 if new else 0.0))
        dur = _SECONDS[e.name] * (steps[(e.t_start, e.t_end)]
                                  if e.name == "decode" else 1.0)
        t = new.setdefault(e.t_end, t + dur)
    tracer = JaxTracer(timebase=lambda: 0.0)
    tracer.t0 = 0.0
    for e in engine.tracer.events:
        tracer.add_region(e.name, new[e.t_start], new[e.t_end],
                          depth=e.depth, device=e.device, step=e.step,
                          slot=e.slot)
    engine.tracer = tracer
    engine.segments = [dataclasses.replace(sg, t_lo=new[sg.t_lo],
                                           t_hi=new[sg.t_hi])
                       for sg in engine.segments]


def _metered():
    """The reference's engine and the port's on the same weights and
    requests (so the same prompts and tokens), on a fixed timeline; the
    port's engine holds the reference's timeline and slot schedule, so
    both meter the same segments, on a two-chip fabric that follows
    them.  Each engine has its own registry."""
    if "metered" not in _CACHE:
        from repro.health import HealthRegistry as JaxRegistry
        from repro_torch.fleet import SlotSegment
        from repro_torch.health import HealthRegistry
        jm, params, tm, tp = _setup()
        vocab = jm.cfg.vocab_size
        kw = dict(batch_slots=2, max_len=32, flush_interval=3)
        jreg, reg = JaxRegistry(), HealthRegistry()
        ref = JaxServeEngine(jm, params, registry=jreg, **kw)
        jreqs = _reqs(JaxRequest, vocab, _LENS, _NEW)
        treqs = _reqs(Request, vocab, _LENS, _NEW)
        for i, (a, b) in enumerate(zip(jreqs, treqs)):
            a.user = b.user = f"user{i % 2}"
        ref.run(jreqs)
        _fixed_timeline(ref)
        eng = ServeEngine(tm, tp, registry=reg, device=CPU, **kw)
        eng.run(treqs)
        eng.tracer = interop.tracer_from_arrays(ref.tracer.to_arrays())
        eng.segments = [SlotSegment(**dataclasses.asdict(sg))
                        for sg in ref.segments]
        lead = 0.05
        occ = {"admission": (0.0, 0.05, 0.0), "prefill": (1.0, 0.5, 0.1),
               "decode": (0.15, 1.0, 0.1)}
        shifted = [(n, a + lead, b + lead)
                   for n, a, b in ref.tracer.phases(depth=0)]
        watts = {n: {"watts": jax_occupancy_power(*occ[n])}
                 for n, _, _ in shifted}
        truth = jax_phase_power([("__lead__", 0.0, lead)] + shifted
                                + [("__tail__", shifted[-1][2],
                                    shifted[-1][2] + 0.1)],
                                {**watts, "__lead__": {"watts": 55.0},
                                 "__tail__": {"watts": 55.0}})
        traces = JaxNodeFabric(chip_truths=[truth] * 2).sample_all(
            JaxToolSpec(), seed=0)
        port_traces = {k: interop.trace_from_fields(
            tr.name, dataclasses.asdict(tr.spec), tr.t_read, tr.t_measured,
            tr.value) for k, tr in traces.items()}
        _CACHE["metered"] = (ref, jreg, traces, eng, reg, port_traces,
                             lead)
    return _CACHE["metered"]


def test_attribute_requests_matches_reference_and_conserves(tmp_path,
                                                             monkeypatch):
    """Every request billed, within 1e-5 of the reference's bill; the
    bills sum to the port's fused phase totals within 1e-5 and to the
    metering stage's segment totals within 1e-9; the registry's serve
    gauges and the JSONL artifact; a second attribution bit-identical."""
    from repro_torch.serve import METER_LOG_ENV
    ref, jreg, traces, eng, reg, port_traces, lead = _metered()
    with pytest.warns(DeprecationWarning):
        want = ref.attribute_requests(traces, t_shift=lead, track=False)
    with monkeypatch.context() as m:
        m.setenv(METER_LOG_ENV, str(tmp_path))
        with pytest.warns(DeprecationWarning):
            got = eng.attribute_requests(port_traces, t_shift=lead,
                                         track=False)
    assert [r.rid for r in got.requests] == \
        [r.rid for r in want.requests] == list(range(len(_LENS)))
    for g, w in zip(got.requests, want.requests):
        assert g.energy_j > 0.0 and g.tokens == w.tokens
        assert abs(g.energy_j - w.energy_j) <= 1e-5 * abs(w.energy_j)
        assert g.user == w.user
        assert g.j_per_token == pytest.approx(g.energy_j / g.tokens)
    assert got.segment_totals.shape == want.segment_totals.shape
    with pytest.warns(DeprecationWarning):
        fused = eng.attribute_phases(port_traces, t_shift=lead, fuse=True,
                                     streaming=True, track=False)
    phase_totals = np.asarray([[p.energy_j for p in row]
                               for row in fused.values()])
    assert got.conservation_rel_err(phase_totals) <= 1e-5
    assert got.conservation_rel_err(got.segment_totals) <= 1e-9
    assert set(got.per_user()) == {"user0", "user1"}
    snap, jsnap = reg.json_snapshot(), jreg.json_snapshot()
    for k in ("serve_requests_total", "serve_tokens_total",
              "serve_queue_depth", "serve_active_slots"):
        assert snap[k] == jsnap[k]
    assert snap["meter_j_per_request"]["p50"] > 0.0
    assert "repro_meter_j_per_request" in reg.prometheus_text()
    files = list(tmp_path.glob("request-energies-*.jsonl"))
    assert len(files) == 1
    lines = [json.loads(ln) for ln in files[0].read_text().splitlines()]
    assert [ln["rid"] for ln in lines] == list(range(len(_LENS)))
    with pytest.warns(DeprecationWarning):
        again = eng.attribute_requests(port_traces, t_shift=lead,
                                       track=False)
    for r1, r2 in zip(got.requests, again.requests):
        assert r1.energy_by_device == r2.energy_by_device, r1.rid


def _permuted_meters(pkg, fleet, stream, traces, device):
    groups = list(pkg.group_traces_by_device(traces).values())
    phases = [("work", 0.5, 1.2), ("work", 1.2, 2.0)]
    segs_a = [fleet.SlotSegment(0.5, 1.2, (0, 1, 2), (3.0, 1.0, 2.0)),
              fleet.SlotSegment(1.2, 2.0, (1, 2), (2.0, 5.0))]
    segs_b = [fleet.SlotSegment(1.2, 2.0, (2, 1), (5.0, 2.0)),
              fleet.SlotSegment(0.5, 1.2, (2, 0, 1), (2.0, 3.0, 1.0))]
    out = []
    for segs in (segs_a, segs_b):
        with pytest.warns(DeprecationWarning):
            _, pipe = stream(groups, phases, meter=segs, track=False,
                             return_pipe=True, **device)
        out.append(pipe.request_energies())
    return out, pipe


def test_metering_deterministic_under_permutation():
    """Bit-identical per-request energies under slot-assignment
    permutations (segment order and within-segment rid order), shares
    that conserve, and bills within 1e-5 of the reference's."""
    import repro.align as jalign
    import repro.fleet.pipeline as jfleet
    import repro_torch.align as talign
    import repro_torch.fleet.pipeline as tfleet
    from repro.core import NodeFabric as JFabric
    from repro.core import ToolSpec as JTool
    from repro.core import square_wave as jsq
    truth = jsq(1.0, 2, lead_s=0.5, tail_s=0.5)
    traces = JFabric(chip_truths=[truth] * 2).sample_all(JTool(), seed=0)
    port_traces = {k: interop.trace_from_fields(
        tr.name, dataclasses.asdict(tr.spec), tr.t_read, tr.t_measured,
        tr.value) for k, tr in traces.items()}
    (a, b), pipe = _permuted_meters(
        talign, tfleet, tfleet.attribute_energy_fused_streaming,
        port_traces, {"device": CPU})
    (ja, _), _ = _permuted_meters(
        jalign, jfleet, jfleet.attribute_energy_fused_streaming, traces, {})
    assert sorted(a) == sorted(b) == sorted(ja) == [0, 1, 2]
    for rid in a:
        assert np.array_equal(a[rid], b[rid]), rid
        np.testing.assert_allclose(a[rid], ja[rid], rtol=1e-5)
    tot = np.sum([a[r] for r in a], axis=0)
    seg_tot = pipe.meter_stage.segment_totals().sum(axis=1)
    np.testing.assert_allclose(tot, seg_tot, rtol=1e-12)


def test_attribute_phases_health_and_registry_match_reference():
    """``health=`` composes the health stage into the windowed path and
    ``registry=`` collects its metrics; the energies match the
    reference's and, all sensors healthy, equal the plain run's."""
    from repro.health import HealthRegistry as JaxRegistry
    from repro_torch.health import HealthRegistry
    ref, _, traces, eng, _, port_traces, lead = _metered()
    jreg, reg = JaxRegistry(), HealthRegistry()
    kw = dict(t_shift=lead, fuse=True, streaming=True, track=False,
              health=True)
    with pytest.warns(DeprecationWarning):
        want = ref.attribute_phases(traces, registry=jreg, **kw)
    with pytest.warns(DeprecationWarning):
        got = eng.attribute_phases(port_traces, registry=reg, **kw)
    with pytest.warns(DeprecationWarning):
        plain = eng.attribute_phases(port_traces, t_shift=lead, fuse=True,
                                     streaming=True, track=False)
    assert list(got) == list(want)
    _energy_close(got.values(), want.values())
    for a, b in zip(got.values(), plain.values()):
        assert [p.energy_j for p in a] == [p.energy_j for p in b]
    snap, jsnap = reg.json_snapshot(), jreg.json_snapshot()
    assert snap["sensor_state"] == jsnap["sensor_state"]
    assert snap["health_windows_total"] == jsnap["health_windows_total"]
    assert snap["quarantined_sensors"] == 0.0


def test_engines_register_their_sources():
    from repro_torch.health import HealthRegistry
    _, _, tm, tp = _setup()
    reg = HealthRegistry()
    fixed = FixedBatchEngine(tm, tp, batch_slots=2, max_len=32,
                             registry=reg, device=CPU)
    fixed.run(_reqs(Request, tm.cfg.vocab_size, [4, 5], [2, 3]))
    snap = reg.json_snapshot()
    assert snap["tracer_events"] == {"serve": float(len(
        fixed.tracer.events))} and snap["tracer_events"]["serve"] > 0
    reg = HealthRegistry()
    eng = ServeEngine(tm, tp, batch_slots=2, max_len=32, registry=reg,
                      device=CPU)
    eng.run(_reqs(Request, tm.cfg.vocab_size, [4, 5, 6], [2, 3, 1]))
    snap = reg.json_snapshot()
    assert snap["serve_requests_total"] == 3.0
    assert snap["serve_tokens_total"] == 6.0
    assert snap["serve_queue_depth"] == snap["serve_active_slots"] == 0.0
    assert "meter_j_per_request" not in snap     # nothing metered yet
    assert len(eng.slot_schedule()) == len(eng.segments) > 0
    with pytest.raises(TypeError, match="dict input"):
        eng.attribute_requests([])


def test_engine_refuses_parameters_on_another_device():
    _, _, tm, tp = _setup()
    with pytest.raises(ValueError, match="parameters are on cpu"):
        ServeEngine(tm, tp, device="meta")


def test_serve_launcher_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main
    assert main(["--device", "cpu", "--requests", "3", "--max-new",
                 "4"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out
    assert "energy per generated token" in out
    assert not math.isnan(float(out.rsplit(":", 1)[1].split()[0]))
