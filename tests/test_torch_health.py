"""PyTorch port, fleet health and data quality on the windowed path: fault
injection, the ``SensorHealthStage`` (statistics on the device, state
machine on the host) inside ``attribute_energy_fused_streaming``, the
quarantine-aware fusion, the event artifact, the metrics registry and
the ``DataQualityPolicy`` raise modes, each against the JAX package on
the same seeded traces.

Bounds: with every sensor healthy the health-enabled port is
bit-identical to the plain port; state sequences and events equal the
reference's window by window; energies within 1e-5 of the reference's;
the per-window statistics block within 1e-9 relative (the device sums
in another order)."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from multihost.simdata import (energy_matrix, shared_grid_and_phases,
                               sim_groups)
from repro.core import FaultSpec as JFault
from repro.core import inject_fault as jax_inject_fault
from repro.fleet import pipeline as jpl
from repro.fleet.pipeline import attribute_energy_fused_streaming as jstream
from repro.health import HealthConfig as JCfg
from repro.health import HealthRegistry as JRegistry
from repro.health import SensorHealthStage as JStage
from repro_torch import interop
from repro_torch.core import FaultSpec, inject_fault
from repro_torch.fleet import pipeline as tpl
from repro_torch.fleet import (DataQualityError, DataQualityPolicy,
                               attribute_energy_fused_streaming)
from repro_torch.health import (HEALTHY, N_STATS, QUARANTINED, RECOVERING,
                                SUSPECT, HealthConfig, HealthEvent,
                                HealthRegistry, Metric, SensorHealthStage,
                                write_events_jsonl)

torch.set_num_threads(2)
CPU = "cpu"

# the reference tests' pacing: one strike to SUSPECT, one more to
# QUARANTINED, one clean fold to start recovering
PACE = dict(suspect_after=1, quarantine_after=1, recover_after=1,
            min_slots=8, bias_limit_w=15.0, rms_limit_w=60.0)
CFG, JAX_CFG = HealthConfig(**PACE), JCfg(**PACE)
E_TOL = 1e-5


def _port_trace(tr):
    return interop.trace_from_fields(tr.name, dataclasses.asdict(tr.spec),
                                     tr.t_read, tr.t_measured, tr.value)


def _groups(n_devices=3, faults=None, **kw):
    """The reference's clean traces, each package's own fault injection:
    (jax groups, port groups, delays)."""
    _, groups, delays = sim_groups(n_devices, **kw)
    faults = faults or {}
    jg, tg = [], []
    for g in groups:
        jg.append([jax_inject_fault(tr, JFault(**faults[tr.name]))
                   if tr.name in faults else tr for tr in g])
        tg.append([inject_fault(_port_trace(tr), FaultSpec(**faults[tr.name]))
                   if tr.name in faults else _port_trace(tr) for tr in g])
    return jg, tg, delays


def _run_both(faults=None, tail=None, n_devices=3, chunk=257,
              registry=None, jregistry=None):
    jg, tg, delays = _groups(n_devices, faults)
    grid, phases = shared_grid_and_phases(jg)
    kw = dict(grid=grid, delays=delays, chunk=chunk, return_pipe=True,
              tail=tail)
    with pytest.warns(DeprecationWarning):
        jout, jpipe = jstream(jg, phases, health=JAX_CFG,
                              registry=jregistry, **kw)
    with pytest.warns(DeprecationWarning):
        tout, tpipe = attribute_energy_fused_streaming(
            tg, phases, health=CFG, registry=registry, device=CPU, **kw)
    return (energy_matrix(tout), tpipe), (energy_matrix(jout), jpipe)


def _events(stage):
    return [(e.kind, e.window, e.t, e.sensor, e.name, e.state_from,
             e.state_to, e.flags) for e in stage.events]


def _transitions(stage):
    return [(e.window, e.name, e.state_from, e.state_to)
            for e in stage.events if e.kind == "transition"]


def _close(got, want, tol=E_TOL):
    assert got.shape == want.shape
    assert (np.abs(got - want) <= tol * np.maximum(np.abs(want), 1.0)).all()


def _assert_same_machine(ths, jhs):
    """State sequences and events equal, window by window."""
    assert ths.windows == jhs.windows
    assert _events(ths) == _events(jhs)
    for a, b in zip(ths.events, jhs.events):
        for k in a.detail:
            np.testing.assert_allclose(a.detail[k], b.detail[k],
                                       rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(ths.state, jhs.state)
    np.testing.assert_array_equal(ths.flag_streak, jhs.flag_streak)
    np.testing.assert_array_equal(ths.clean_streak, jhs.clean_streak)
    for k, v in jhs.flags_last.items():
        np.testing.assert_array_equal(ths.flags_last[k], v)
    np.testing.assert_allclose(ths.bias, jhs.bias, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(ths.rms, jhs.rms, rtol=1e-9, atol=1e-9)


# -- fault injection -----------------------------------------------------

@pytest.mark.parametrize("name,fault", [
    ("d0_power", dict(kind="dropout", t_start=0.9, t_end=1.2)),
    ("d0_power", dict(kind="stuck", t_start=1.0, t_end=2.0)),
    ("d0_energy", dict(kind="stuck", t_start=1.2)),
    ("d0_power", dict(kind="step_drift", t_start=1.0, magnitude_w=40.0)),
    ("d0_energy", dict(kind="step_drift", t_start=1.0, t_end=1.7,
                       magnitude_w=40.0)),
], ids=["dropout", "stuck_power", "stuck_energy", "drift_power",
        "drift_energy"])
def test_inject_fault_matches_reference(name, fault):
    jg, tg, _ = _groups(1, {name: fault})
    k = 0 if name.endswith("energy") else 1
    got, want = tg[0][k], jg[0][k]
    for f in ("t_read", "t_measured", "value"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    clean = _groups(1)[1][0][k]
    if fault["kind"] == "dropout":
        assert len(got) < len(clean)
        assert not np.any((got.t_read >= 0.9) & (got.t_read < 1.2))
    elif fault["kind"] == "stuck":
        in_f = (got.t_measured >= fault["t_start"]) \
            & (got.t_measured < fault.get("t_end", np.inf))
        assert in_f.any() and np.unique(got.value[in_f]).size == 1
        np.testing.assert_array_equal(got.t_measured, clean.t_measured)
    elif got.spec.is_cumulative:
        np.testing.assert_allclose(
            got.value - clean.value, 40.0 * np.clip(
                np.minimum(clean.t_measured, 1.7) - 1.0, 0.0, None))
    else:
        in_f = got.t_measured >= 1.0
        np.testing.assert_allclose(got.value[in_f], clean.value[in_f] + 40)
        np.testing.assert_array_equal(got.value[~in_f], clean.value[~in_f])


def test_inject_fault_unknown_kind_raises():
    _, tg, _ = _groups(1)
    with pytest.raises(ValueError, match="unknown fault kind"):
        inject_fault(tg[0][0], FaultSpec("melt", 0.0))


# -- all-healthy bit-identity --------------------------------------------

def test_all_healthy_bit_identical_to_plain_pipeline():
    jg, tg, delays = _groups(3)
    grid, phases = shared_grid_and_phases(jg)
    kw = dict(grid=grid, delays=delays, chunk=257)
    with pytest.warns(DeprecationWarning):
        plain = energy_matrix(attribute_energy_fused_streaming(
            tg, phases, device=CPU, **kw))
    reg, jreg = HealthRegistry(), JRegistry()
    (e, pipe), (je, jpipe) = _run_both(registry=reg, jregistry=jreg)
    np.testing.assert_array_equal(e, plain)           # BITWISE
    _close(e, je)
    hs = pipe.health_stage
    assert hs.windows > 0 and not hs.events
    assert np.all(hs.state == HEALTHY)
    _assert_same_machine(hs, jpipe.health_stage)
    snap, jsnap = reg.json_snapshot(), jreg.json_snapshot()
    assert snap["quarantined_sensors"] == 0.0
    assert snap["health_windows_total"] == float(hs.windows)
    assert snap["pipeline_windows_total"] == jsnap["pipeline_windows_total"]
    assert set(snap["sensor_state"]) == set(hs.names)
    assert set(snap) == set(jsnap)


# -- detection, transitions and recovery per fault kind -------------------

FAULTS = {
    "stuck_power": ({"d1_power": dict(kind="stuck", t_start=1.0)}, None),
    "dropout_burst": ({"d1_power": dict(kind="dropout", t_start=0.9,
                                        t_end=1.2)}, 1024),
    "step_drift": ({"d2_power": dict(kind="step_drift", t_start=1.0,
                                     magnitude_w=40.0)}, None),
    "stuck_energy": ({"d0_energy": dict(kind="stuck", t_start=1.2)}, None),
    "recovery": ({"d2_power": dict(kind="step_drift", t_start=0.7,
                                   t_end=1.6, magnitude_w=40.0)}, None),
    "large_drift": ({"d2_power": dict(kind="step_drift", t_start=1.0,
                                      magnitude_w=120.0)}, None),
}


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(key):
        if key not in cache:
            faults, tail = FAULTS[key]
            cache[key] = _run_both(faults, tail=tail)
        return cache[key]
    return get


@pytest.mark.parametrize("key", list(FAULTS))
def test_fault_states_and_events_match_reference(runs, key):
    (e, pipe), (je, jpipe) = runs(key)
    _assert_same_machine(pipe.health_stage, jpipe.health_stage)
    assert pipe.health_stage.events
    _close(e, je)


def test_stuck_power_sensor_quarantined_within_two_windows(runs):
    (_, pipe), _ = runs("stuck_power")
    hs = pipe.health_stage
    tr = [t for t in _transitions(hs) if t[1] == "d1_power"]
    assert tr[0][2:] == (HEALTHY, SUSPECT) and tr[0][0] <= 6
    assert (tr[0][0], "d1_power", SUSPECT, QUARANTINED) in [
        (t[0] - 1, t[1], t[2], t[3]) for t in tr]
    i = hs.names.index("d1_power")
    assert hs.state[i] == QUARANTINED and not hs.fusion_mask()[i]


def test_dropout_burst_flagged_as_dropout_and_recovers(runs):
    (_, pipe), _ = runs("dropout_burst")
    hs = pipe.health_stage
    evs = [ev for ev in hs.events if ev.name == "d1_power"]
    assert evs and evs[0].state_to == SUSPECT
    assert "dropout" in evs[0].flags and evs[0].window <= 6
    assert hs.state[hs.names.index("d1_power")] == HEALTHY


def test_step_drift_quarantines_group_with_bias_flag(runs):
    (_, pipe), _ = runs("step_drift")
    by = {}
    for ev in pipe.health_stage.events:
        by.setdefault(ev.name, []).append(ev)
    for nm in ("d2_power", "d2_energy"):
        assert [ev.state_to for ev in by[nm]
                if ev.kind == "transition"] == [SUSPECT, QUARANTINED]
        assert "bias" in by[nm][0].flags and by[nm][0].window <= 6
    assert not any(n.startswith(("d0", "d1")) for n in by)


def test_stuck_energy_counter_detected(runs):
    (_, pipe), _ = runs("stuck_energy")
    hs = pipe.health_stage
    assert hs.state[hs.names.index("d0_energy")] == QUARANTINED
    evs = [ev for ev in hs.events if ev.name == "d0_energy"]
    assert evs[0].window <= 7 and evs[0].state_to == SUSPECT


def test_bounded_fault_full_recovery_cycle_with_recalibration(runs):
    (_, pipe), (_, jpipe) = runs("recovery")
    hs = pipe.health_stage
    seq = [(t[2], t[3]) for t in _transitions(hs) if t[1] == "d2_power"]
    assert seq == [(HEALTHY, SUSPECT), (SUSPECT, QUARANTINED),
                   (QUARANTINED, RECOVERING), (RECOVERING, HEALTHY)]
    recal = [ev for ev in hs.events if ev.kind == "recalibrate"]
    assert {ev.name for ev in recal} == {"d2_energy", "d2_power"}
    off = hs.suggested_corrections().offsets_w
    joff = jpipe.health_stage.suggested_corrections().offsets_w
    assert off.keys() == joff.keys()
    for k in off:
        np.testing.assert_allclose(off[k], joff[k], rtol=1e-9)
    assert off["d2_power"] > 1.0
    np.testing.assert_allclose(off["d2_power"], -off["d2_energy"])
    assert np.all(hs.state == HEALTHY)


def test_quarantine_changes_fused_energy(runs):
    """Masking a faulty sensor out of fusion changes its device's
    energy and leaves the other devices bit for bit alone."""
    faults, _ = FAULTS["large_drift"]
    jg, tg, delays = _groups(3, faults)
    grid, phases = shared_grid_and_phases(jg)
    with pytest.warns(DeprecationWarning):
        plain = energy_matrix(attribute_energy_fused_streaming(
            tg, phases, grid=grid, delays=delays, chunk=257, device=CPU))
    (masked, pipe), (jmasked, _) = runs("large_drift")
    assert pipe.health_stage.state.max() >= QUARANTINED
    assert not np.allclose(plain[2], masked[2])
    np.testing.assert_array_equal(plain[:2], masked[:2])
    _close(masked, jmasked)


def test_tracked_pipeline_health_matches_reference():
    """With online delay tracking the drift flag reads the tracked delays
    (fetched with the statistics block): the same machine as the
    reference's."""
    from repro.core import square_wave as jsq
    from repro_torch.core import square_wave as tsq
    faults = {"d1_power": dict(kind="stuck", t_start=1.0)}
    jg, tg, _ = _groups(3, faults)
    _, phases = shared_grid_and_phases(jg)
    span = 2.5
    jtruth = jsq(span / 4.0, 3, lead_s=span / 8, tail_s=span / 8)
    ttruth = tsq(span / 4.0, 3, lead_s=span / 8, tail_s=span / 8)
    kw = dict(chunk=257, return_pipe=True, window=512, hop=128)
    with pytest.warns(DeprecationWarning):
        jout, jpipe = jstream(jg, phases, reference=jtruth, health=JAX_CFG,
                              **kw)
    with pytest.warns(DeprecationWarning):
        tout, tpipe = attribute_energy_fused_streaming(
            tg, phases, reference=ttruth, health=CFG, device=CPU, **kw)
    assert len(tpipe.delay_history) >= 2
    _assert_same_machine(tpipe.health_stage, jpipe.health_stage)
    _close(energy_matrix(tout), energy_matrix(jout))


# -- the statistics block on the device ----------------------------------

@pytest.mark.parametrize("quarantine", [(), (1,), (2, 3)],
                         ids=["healthy", "one", "dark_group"])
def test_stats_block_matches_reference(quarantine):
    """One window's (N_STATS, n) block against the reference's numpy
    block, all-healthy and with quarantined rows (a fully quarantined
    group falls back to its raw mean); the masked window follows."""
    rng = np.random.default_rng(1)
    sizes = [2, 2, 3]
    n, g = sum(sizes), 300
    vals = (100 + 30 * rng.standard_normal((n, g))).astype(np.float32)
    vals[:, ::7] = vals[:, 1::7][:, :vals[:, ::7].shape[1]]
    mask = rng.uniform(size=(n, g)) > 0.1
    grid = 1.0 + 1e-3 * np.arange(g)
    jst = JStage(sizes, JCfg(), grid_step=1e-3)
    tst = SensorHealthStage(sizes, HealthConfig(), grid_step=1e-3,
                            device=CPU)
    for st in (jst, tst):
        st.state[list(quarantine)] = QUARANTINED
    jgw = jpl.GriddedWindow(lo=0, grid=grid, values=vals, mask=mask)
    tgw = tpl.GriddedWindow(lo=0, grid=torch.as_tensor(grid),
                            values=torch.as_tensor(vals),
                            mask=torch.as_tensor(mask))
    for _ in range(2):                     # pending accumulates
        jout, tout = jst.update(jgw), tst.update(tgw)
    want, got = jst.take_pending(), tst.take_pending()
    assert got.shape == want.shape == (N_STATS, n)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(tout.mask.numpy(), jout.mask)
    assert (tout is tgw) == (not quarantine)
    assert not tst.take_pending().any()


# -- events: typing, serialization, artifact ------------------------------

def test_health_event_json_roundtrip(tmp_path):
    from repro.health import HealthEvent as JEvent
    kw = dict(kind="transition", window=3, t=1.5, sensor=2,
              name="d1_power", state_from=HEALTHY, state_to=SUSPECT,
              flags=("bias",), detail={"bias_w": 20.0})
    ev = HealthEvent(**kw)
    d = ev.to_json()
    assert d == JEvent(**kw).to_json()
    assert d["state_from"] == "healthy" and d["flags"] == ["bias"]
    p = tmp_path / "ev.jsonl"
    assert write_events_jsonl([ev, ev], p) == 2
    lines = [json.loads(x) for x in p.read_text().splitlines()]
    assert lines[0] == lines[1] == json.loads(json.dumps(d))


def test_health_log_dir_writes_jsonl_artifact(tmp_path, monkeypatch, runs):
    monkeypatch.setenv("REPRO_HEALTH_LOG_DIR", str(tmp_path))
    (_, pipe), (_, jpipe) = _run_both(
        {"d0_energy": dict(kind="stuck", t_start=1.2)})
    files = sorted(tmp_path.glob("health-events-*.jsonl"))
    assert len(files) == 1                 # one pid: both runs appended
    evs = [json.loads(x) for x in files[0].read_text().splitlines()]
    n = len(pipe.health_stage.events)
    assert n and len(evs) == 2 * n
    for want, got in zip(evs[:n], evs[n:]):  # the reference's, then ours
        wd, gd = want.pop("detail"), got.pop("detail")
        assert got == want
        assert gd.keys() == wd.keys()
        for k in gd:
            assert gd[k] == pytest.approx(wd[k], rel=1e-9, abs=1e-9)
    assert any(e["name"] == "d0_energy" for e in evs)


# -- stage unit behavior --------------------------------------------------

def test_stage_fold_ignores_sparse_windows():
    hs = SensorHealthStage([2], HealthConfig(min_slots=8), grid_step=1e-3,
                           device=CPU)
    st = np.zeros((N_STATS, 2))
    st[1] = 4.0                            # n_expected < min_slots
    hs.fold(st.ravel())
    assert hs.windows == 1 and not hs.events
    assert np.all(hs.state == HEALTHY)
    assert not hs.take_pending().any()     # nothing pending: zeros


def test_stage_local_names_placed_at_global_rows():
    hs = SensorHealthStage([2], grid_step=1e-3, row_ids=[4, 5],
                           n_global=8, names=["a", "b"], device=CPU)
    assert hs.names[4:6] == ["a", "b"] and hs.names[0] == "s0"
    assert hs.local_mask().shape == (2,)
    assert hs.fusion_mask().shape == (8,)


def test_stage_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SensorHealthStage([2], grid_step=1e-3)


# -- telemetry registry ---------------------------------------------------

def test_registry_prometheus_text_and_json_match_reference():
    out = []
    for reg_cls, metric_cls in ((HealthRegistry, Metric),
                                (JRegistry, None)):
        if metric_cls is None:
            from repro.health import Metric as metric_cls
        reg = reg_cls(namespace="repro")
        reg.set_gauge("answer", 42.0)
        reg.inc("requests_total", 3)
        reg.register_source("x", lambda m=metric_cls: [
            m("per_thing", {"a": 1.0, "b": 2.5}, label="thing",
              help="things per thing")])
        out.append((reg.prometheus_text(), reg.json_snapshot()))
    (text, snap), (jtext, jsnap) = out
    assert text == jtext and snap == jsnap
    assert 'repro_per_thing{thing="b"} 2.5' in text
    assert '# TYPE repro_requests_total counter' in text
    assert snap == {"per_thing": {"a": 1.0, "b": 2.5}, "answer": 42.0,
                    "requests_total": 3.0}


def test_registry_tracks_tracer_and_sampler_drops():
    from repro_torch.core import RegionTracer
    reg = HealthRegistry()
    tr = RegionTracer(max_events=2)
    reg.track_tracer("serve", tr)
    for k in range(5):
        tr.add_region(f"r{k}", float(k), k + 0.5)

    class Sampler:                         # duck-typed sampler buffer
        t_read = [0.1, 0.2, 0.3]
        dropped = 4
    reg.track_sampler("node", Sampler())
    snap = reg.json_snapshot()
    assert snap["tracer_events"] == {"serve": 2.0}
    assert snap["tracer_dropped_total"] == {"serve": 3.0}
    assert snap["sampler_samples"] == {"node": 3.0}
    assert snap["sampler_dropped_total"] == {"node": 4.0}
    reg.unregister_source("tracer:serve")
    assert "tracer_events" not in reg.json_snapshot()


def test_pipeline_self_metrics_exported():
    reg, jreg = HealthRegistry(), JRegistry()
    _run_both(registry=reg, jregistry=jreg)
    snap, jsnap = reg.json_snapshot(), jreg.json_snapshot()
    assert {"RegridFuseStage", "SensorHealthStage",
            "FusedPhaseAttributeStage"} <= set(snap["stage_wall_seconds"])
    assert set(snap["stage_wall_seconds"]) == \
        set(jsnap["stage_wall_seconds"])
    assert all(v >= 0.0 for v in snap["stage_wall_seconds"].values())
    assert snap["emitted_slots_total"] == jsnap["emitted_slots_total"] > 0
    assert snap["emit_frontier_lag_s"] == pytest.approx(
        jsnap["emit_frontier_lag_s"], abs=1e-9)
    for k in ("sensor_state", "sensor_bias_w", "window_coverage_frac"):
        assert snap[k].keys() == jsnap[k].keys()
        for s in snap[k]:
            assert snap[k][s] == pytest.approx(jsnap[k][s], rel=1e-9,
                                               abs=1e-9)


# -- data-quality policies ------------------------------------------------

def _live_pipes(policy, jpolicy):
    kw = dict(grid_origin=0.0, grid_step=0.01, delays=np.zeros(2),
              track=False)
    return (tpl.StreamingFusedPipeline([2], [(0.0, 1.0)], dq_policy=policy,
                                       device=CPU, **kw),
            jpl.StreamingFusedPipeline([2], [(0.0, 1.0)],
                                       dq_policy=jpolicy, **kw))


def test_dq_late_samples_counted_on_live_ingest():
    for pipe in _live_pipes(DataQualityPolicy(), jpl.DataQualityPolicy()):
        pipe.update(np.array([[0.00, 0.01, 0.02, 0.03]] * 2),
                    np.full((2, 4), 100.0))
        pipe.update(np.array([[0.04, 0.015, 0.05, 0.06],
                              [0.04, 0.045, 0.05, 0.06]]),
                    np.full((2, 4), 100.0))
        late = np.asarray(pipe.ingest.dq_late[:2])
        assert late.tolist() == [1, 0]
        assert int(pipe.ingest.dq_last["late"][0]) == 1


def test_dq_dropped_samples_counted_from_valid_mask():
    t = np.array([[0.00, 0.01, 0.02, 0.03]] * 2)
    valid = np.ones((2, 4), bool)
    valid[1, 2] = False
    for pipe in _live_pipes(DataQualityPolicy(), jpl.DataQualityPolicy()):
        pipe.update(t, np.full((2, 4), 100.0), valid)
        assert np.asarray(pipe.ingest.dq_masked[:2]).tolist() == [0, 1]


@pytest.mark.parametrize("mode", ["late", "dropped"])
def test_dq_policy_raise_on_late_and_dropped(mode):
    msgs = []
    for pipe, err in zip(_live_pipes(DataQualityPolicy(**{mode: "raise"}),
                                     jpl.DataQualityPolicy(
                                         **{mode: "raise"})),
                         (DataQualityError, jpl.DataQualityError)):
        with pytest.raises(err) as ei:
            if mode == "late":
                pipe.update(np.array([[0.00, 0.01]] * 2),
                            np.full((2, 2), 1.0))
                pipe.update(np.array([[0.02, 0.005], [0.02, 0.025]]),
                            np.full((2, 2), 1.0))
            else:
                bad = np.ones((2, 2), bool)
                bad[0, 1] = False
                pipe.update(np.array([[0.00, 0.01]] * 2),
                            np.full((2, 2), 1.0), bad)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert ("late/reordered" if mode == "late" else "dropped") in msgs[0]


def _dead_sensor_groups():
    """Device 1's power sensor stops publishing at a third of the span."""
    jg, tg, delays = _groups(2, span_s=1.5)
    n_keep = len(jg[1][1].t_measured) // 3
    jg[1][1] = dataclasses.replace(
        jg[1][1], t_measured=jg[1][1].t_measured[:n_keep].copy(),
        t_read=jg[1][1].t_read[:n_keep].copy(),
        value=jg[1][1].value[:n_keep].copy())
    tg[1][1] = _port_trace(jg[1][1])
    return jg, tg, delays


def test_dq_policy_coverage_flag_matches_reference():
    jg, tg, delays = _dead_sensor_groups()
    grid, phases = shared_grid_and_phases(jg, n_phases=4)
    kw = dict(grid=grid, delays=delays, chunk=257, tail=4096,
              return_pipe=True)
    with pytest.warns(DeprecationWarning):
        jout, jpipe = jstream(jg, phases, dq_policy=jpl.DataQualityPolicy(
            min_coverage=0.9), **kw)
    with pytest.warns(DeprecationWarning):
        out, pipe = attribute_energy_fused_streaming(
            tg, phases, dq_policy=DataQualityPolicy(min_coverage=0.9),
            device=CPU, **kw)
    low = pipe.fuse.dq_low_coverage.numpy()
    assert low[3] and float(pipe.fuse.dq_last_coverage[3]) < 0.9
    np.testing.assert_array_equal(low, jpipe.fuse.dq_low_coverage)
    np.testing.assert_allclose(pipe.fuse.dq_last_coverage.numpy(),
                               jpipe.fuse.dq_last_coverage, rtol=1e-12)
    np.testing.assert_array_equal(pipe.fuse.dq_covered.numpy(),
                                  jpipe.fuse.dq_covered)
    assert pipe.fuse.dq_slots == jpipe.fuse.dq_slots
    _close(energy_matrix(out), energy_matrix(jout))


def test_dq_policy_coverage_raise_matches_reference():
    jg, tg, delays = _dead_sensor_groups()
    grid, phases = shared_grid_and_phases(jg, n_phases=4)
    kw = dict(grid=grid, delays=delays, chunk=257, tail=4096)
    msgs = []
    for fn, pol, err, extra in (
            (jstream, jpl.DataQualityPolicy, jpl.DataQualityError, {}),
            (attribute_energy_fused_streaming, DataQualityPolicy,
             DataQualityError, {"device": CPU})):
        with pytest.warns(DeprecationWarning), pytest.raises(err) as ei:
            fn(jg if fn is jstream else tg, phases,
               dq_policy=pol(min_coverage=0.9, coverage="raise"),
               **kw, **extra)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "min_coverage" in msgs[0]


def test_dq_registry_source_exports_flags():
    jg, tg, delays = _groups(2, span_s=1.5)
    grid, phases = shared_grid_and_phases(jg, n_phases=4)
    reg, jreg = HealthRegistry(), JRegistry()
    kw = dict(grid=grid, delays=delays, chunk=257)
    with pytest.warns(DeprecationWarning):
        jstream(jg, phases, dq_policy=jpl.DataQualityPolicy(),
                registry=jreg, **kw)
    with pytest.warns(DeprecationWarning):
        attribute_energy_fused_streaming(
            tg, phases, dq_policy=DataQualityPolicy(), registry=reg,
            device=CPU, **kw)
    names = {m.name for m in reg.collect()}
    assert {"ingest_late_samples_total", "ingest_dropped_samples_total",
            "window_coverage_frac", "dq_flag"} <= names
    assert names == {m.name for m in jreg.collect()}
    snap, jsnap = reg.json_snapshot(), jreg.json_snapshot()
    for k in ("ingest_late_samples_total", "ingest_dropped_samples_total",
              "dq_flag"):
        assert snap[k] == jsnap[k]


def test_dq_policy_validates_fields():
    with pytest.raises(AssertionError):
        DataQualityPolicy(late="explode")
    with pytest.raises(AssertionError):
        DataQualityPolicy(min_coverage=1.5)
