"""PyTorch port, serving: the continuous-batching ``ServeEngine`` and the
``FixedBatchEngine`` against the JAX reference's on the same weights and
requests (float32, so greedy tokens must be identical), the load
generator, the phase attribution of a served timeline, the launcher and
the options that are not ported."""
import dataclasses
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
    _, _, eng, port_traces, _ = _served_fabric()
    with pytest.raises(NotImplementedError, match="A5"):
        eng.attribute_requests(port_traces)
    with pytest.raises(NotImplementedError, match="A9"):
        eng.attribute_phases(port_traces, fuse=True, streaming=True,
                             shard=object(), collectives=object())
    with pytest.raises(NotImplementedError, match="A5"):
        eng.attribute_phases(port_traces, registry=object())
    with pytest.raises(NotImplementedError, match="A5"):
        eng.attribute_phases(port_traces, fuse=True, streaming=True,
                             health=True)
    _, _, tm, tp = _setup()
    with pytest.raises(NotImplementedError, match="A5"):
        ServeEngine(tm, tp, registry=object(), device=CPU)


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
