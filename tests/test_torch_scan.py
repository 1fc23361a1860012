"""PyTorch port, the fused-scan engine (``engine="scan"``,
``fleet.scan.attribute_totals_fused_scan``) and the float64 host mirror
(``host=True``): the port against the reference's own scan engine, the
reference's windowed engine and the port's windowed engine on the same
seeded traces (the cases of ``tests/test_scan_engine.py``), its plan
array-equal to the reference's, its tracker history, the closed rows,
the refusals, and the scan through ``fused_fleet_energize`` and serving's
``attribute_phases``.

The installed JAX has ``jax.enable_x64`` but no
``jax.experimental.enable_x64``, which the reference's scan engine
imports; each test that runs that engine sets the alias for its own
duration (``monkeypatch``), and nothing else changes.
"""
import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.core import ToolSpec, simulate_sensor, square_wave
from repro.core.measurement_model import SensorSpec
from repro.fleet import attribute_energy_fused_streaming as jax_streaming
from repro.fleet import pipeline as jpl
from repro.fleet.config import PipelineConfig as JCfg
from repro.fleet.config import StreamConfig as JStream
from repro.fleet.config import TrackConfig as JTrack
from repro_torch import interop
from repro_torch.fleet import (CheckpointConfig, PipelineConfig,
                               ScanResult, SlotSegment, StreamConfig,
                               TrackConfig,
                               attribute_energy_fused_streaming,
                               attribute_totals_fused_scan)
from repro_torch.fleet import pipeline as tpl
from repro_torch.fleet import scan as tscan

CPU = "cpu"
REL = 1e-5

# the test workers share the machine's cores: keep torch from taking them all
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


@pytest.fixture
def x64(monkeypatch):
    """The alias the reference's scan engine needs on this JAX, for one
    test."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def _sim_groups(n_devices, seed=0, span_s=3.0, noise=3.0):
    """``tests/test_scan_engine.py``'s recipe."""
    truth = square_wave(span_s / 4.0, 3, lead_s=span_s / 8,
                        tail_s=span_s / 8)
    tool = ToolSpec(0.9e-3)
    groups = []
    for d in range(n_devices):
        specs = [
            SensorSpec(name=f"d{d}_energy", scope="chip",
                       kind="energy_cum", quantum=1e-6, wrap_bits=26,
                       delay_s=0.004 * (d % 5)),
            SensorSpec(name=f"d{d}_power", scope="chip",
                       kind="power_inst", noise_w=noise, quantum=1e-6,
                       delay_s=0.011 + 0.003 * (d % 3)),
        ]
        groups.append([simulate_sensor(sp, tool, truth,
                                       seed=seed + 31 * d + i)
                       for i, sp in enumerate(specs)])
    return truth, groups


def _unequal_groups(sizes, span=2.5):
    truth = square_wave(span / 4.0, 3, lead_s=span / 8, tail_s=span / 8)
    tool = ToolSpec(0.9e-3)
    groups, i = [], 0
    for d, sz in enumerate(sizes):
        grp = []
        for j in range(sz):
            kind = "energy_cum" if j % 2 == 0 else "power_inst"
            sp = SensorSpec(name=f"d{d}_{j}", scope="chip", kind=kind,
                            quantum=1e-6,
                            wrap_bits=26 if kind == "energy_cum" else 0,
                            noise_w=0.0 if kind == "energy_cum" else 3.0,
                            delay_s=0.002 * (i % 7))
            grp.append(simulate_sensor(sp, tool, truth, seed=100 + 17 * i))
            i += 1
        groups.append(grp)
    return truth, groups


def _port_groups(groups):
    return [[interop.trace_from_fields(tr.name, dataclasses.asdict(tr.spec),
                                       tr.t_read, tr.t_measured, tr.value)
             for tr in g] for g in groups]


def _port_truth(truth):
    return interop.power_from_arrays(truth.times, truth.watts)


def _pinned(groups, truth):
    from repro.align import align_and_fuse
    fused = align_and_fuse(groups, reference=truth)
    grid = fused[0].grid
    d_all = np.concatenate([fs.delays for fs in fused])
    edges = np.linspace(float(grid[0]), float(grid[-1]), 7)
    phases = [(f"p{k}", float(a), float(b))
              for k, (a, b) in enumerate(zip(edges[:-1], edges[1:]))]
    return grid, d_all, phases


def _worst(a, b):
    return max(abs(x.energy_j - y.energy_j) / max(abs(y.energy_j), 1.0)
               for ra, rb in zip(a, b) for x, y in zip(ra, rb))


def _recorder(monkeypatch):
    """Record the reference's scan inputs and result and the port's plan
    and result as each engine runs."""
    rec = {}

    def wrap(module, name, key, record):
        orig = getattr(module, name)

        def fn(*args, **kw):
            out = orig(*args, **kw)
            rec[key] = record(args, kw, out)
            return out
        monkeypatch.setattr(module, name, fn)

    wrap(jpl, "_fused_scan_steps", "jax_steps",
         lambda a, kw, out: dict(xs=[np.asarray(x) for x in a[1]],
                                 width=kw["width"]))
    wrap(jpl, "attribute_totals_fused_scan", "jax_result",
         lambda a, kw, out: out)
    wrap(jpl, "_scan_track_delays", "jax_delays", lambda a, kw, out: out[0])
    wrap(tscan, "_scan_plan", "port_plan", lambda a, kw, out: (a, kw, out))
    wrap(tscan, "attribute_totals_fused_scan", "port_result",
         lambda a, kw, out: out)
    return rec


def _assert_plan_equal(plan, steps, n_slots, d32_atol=0.0):
    lo, cnt, starts, d32 = steps["xs"]
    assert plan.n_steps == len(lo) > 0
    for got, want in ((plan.lo, lo), (plan.cnt, cnt),
                      (plan.starts, starts), (plan.d32, d32)):
        assert got.dtype == want.dtype
    for got, want in ((plan.lo, lo), (plan.cnt, cnt),
                      (plan.starts, starts)):
        np.testing.assert_array_equal(got, want)
    if d32_atol:
        np.testing.assert_allclose(plan.d32, d32, rtol=0, atol=d32_atol)
    else:
        np.testing.assert_array_equal(plan.d32, d32)
    assert plan.width == steps["width"]
    assert plan.n_slots == n_slots


def _assert_same_plan(rec):
    """The port's plan equals the reference's.  Tracked, the delays come
    from the trackers' scores, which the two packages round differently
    (ROADMAP C: a delay ~1e-7 s apart), so the run's own float32 delays
    are held to the history bound, and the planner is held exactly on
    the reference's delays."""
    (args, kw, plan), steps = rec["port_plan"], rec["jax_steps"]
    got, want = rec["port_result"], rec["jax_result"]
    assert (got.n_steps, got.n_slots) == (want.n_steps, want.n_slots)
    if "jax_delays" not in rec:
        _assert_plan_equal(plan, steps, want.n_slots)
        return
    _assert_plan_equal(plan, steps, want.n_slots,
                       d32_atol=1e-3 * kw["step"])
    replan = tscan._scan_plan(args[0], args[1], rec["jax_delays"],
                              *args[3:], **kw)
    _assert_plan_equal(replan, steps, want.n_slots)


def _assert_same_history(got, want, step):
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal([p.t_lo for p in got],
                                  [p.t_lo for p in want])
    np.testing.assert_array_equal([p.t_hi for p in got],
                                  [p.t_hi for p in want])
    ema_g = np.array([p.ema for p in got])
    ema_w = np.array([p.ema for p in want])
    assert np.abs(ema_g - ema_w).max() / step <= 1e-3


def _four_ways(monkeypatch, groups, phases, chunk, truth=None, **kw):
    """The port's scan against the reference's scan, the reference's
    windowed engine and the port's windowed engine (<= 1e-5 each), and
    the port's plan against the reference's."""
    rec = _recorder(monkeypatch)
    port, jref = {}, {}
    if truth is not None:
        jref["reference"] = truth
        port["reference"] = _port_truth(truth)
    pg = _port_groups(groups)
    out = {}
    for engine in ("scan", "windowed"):
        out["jax", engine] = jax_streaming(
            groups, phases, config=JCfg(
                stream=JStream(chunk=chunk, engine=engine,
                               grid=kw.get("grid")),
                track=JTrack(**kw.get("track", {}))), **jref)
        out["port", engine] = attribute_energy_fused_streaming(
            pg, phases, config=PipelineConfig(
                stream=StreamConfig(chunk=chunk, engine=engine,
                                    grid=kw.get("grid")),
                track=TrackConfig(**kw.get("track", {}))),
            device=CPU, **port)
    scan = out["port", "scan"]
    errs = {"/".join(k): _worst(scan, out[k]) for k in
            (("jax", "scan"), ("jax", "windowed"), ("port", "windowed"))}
    print(f"port scan vs {errs}")
    assert max(errs.values()) <= REL, errs
    _assert_same_plan(rec)
    return rec


@pytest.mark.parametrize("chunk", [193, 512])
def test_scan_untracked_matches_reference(x64, monkeypatch, chunk):
    """Fixed delays on the pinned grid (the replay-parity case)."""
    truth, groups = _sim_groups(2)
    grid, d_all, phases = _pinned(groups, truth)
    _four_ways(monkeypatch, groups, phases, chunk, grid=grid,
               track=dict(delays=d_all, track=False))


def test_scan_tracked_matches_reference(x64, monkeypatch):
    """Online tracking against the known schedule: the same energies and
    the reference's tracker history."""
    truth, groups = _sim_groups(2)
    grid, _, phases = _pinned(groups, truth)
    rec = _four_ways(monkeypatch, groups, phases, 256, truth=truth,
                     grid=grid, track=dict(track=True, window=512, hop=128))
    got, want = rec["port_result"], rec["jax_result"]
    step = float(np.median(np.diff(grid)))
    _assert_same_history(got.history, want.history, step)
    np.testing.assert_allclose(got.delays, want.delays, rtol=0,
                               atol=1e-3 * step)
    np.testing.assert_allclose(got.weights, want.weights, rtol=REL)


def test_scan_selfref_default_grid_matches_reference(x64, monkeypatch):
    """No reference and no pinned grid: per-group self-reference tracking
    on the derived default grid."""
    _, groups = _sim_groups(2, seed=5)
    phases = [("a", 0.6, 1.4), ("b", 1.6, 2.6)]
    rec = _four_ways(monkeypatch, groups, phases, 256,
                     track=dict(track=True, window=512, hop=128))
    got, want = rec["port_result"], rec["jax_result"]
    rows = jpl.pack_stream_rows([tr for g in groups for tr in g])
    _assert_same_history(got.history, want.history,
                         0.5 * jpl._min_cadence(rows))


def test_scan_unequal_group_sizes_match_reference(x64, monkeypatch):
    """Group sizes 1/3/2: padding slots of the (device, k_max) layout
    stay out of the statistics and the pattern integrals."""
    truth, groups = _unequal_groups([1, 3, 2])
    grid, d_all, phases = _pinned(groups, truth)
    _four_ways(monkeypatch, groups, phases, 200, grid=grid,
               track=dict(delays=d_all, track=False))


def _surface_case(seed=9):
    truth, groups = _sim_groups(2, seed=seed)
    flat = [tr for g in groups for tr in g]
    rows_j = jpl.pack_stream_rows(flat)
    rows_t = tpl.pack_stream_rows([tr for g in _port_groups(groups)
                                   for tr in g])
    np.testing.assert_array_equal(rows_t.times, rows_j.times)
    origin = float(rows_j.times[:rows_j.n_streams, 0].astype(np.float64)
                   .min())
    t0 = rows_j.t0
    phases = [(0.6 - t0, 1.4 - t0), (1.6 - t0, 2.6 - t0)]
    kw = dict(grid_origin=origin, grid_step=5e-4, chunk=256,
              reference=lambda t: truth.power_at(t + t0), track=True,
              window=512, hop=128)
    return rows_j, rows_t, phases, kw


def test_scan_result_surface_matches_reference(x64):
    """``attribute_totals_fused_scan`` returns the reference's
    ``ScanResult``: totals, weights, final delays, the tracker history,
    steps and slots, all host numpy."""
    rows_j, rows_t, phases, kw = _surface_case()
    want = jpl.attribute_totals_fused_scan(rows_j, [2, 2], phases, **kw)
    res = attribute_totals_fused_scan(rows_t, [2, 2], phases, device=CPU,
                                      **kw)
    assert isinstance(res, ScanResult)
    assert res.totals.shape == (2, 2)
    assert res.weights.shape == (4,) and (res.weights > 0).all()
    assert res.delays.shape == (4,)
    assert (res.n_steps, res.n_slots) == (want.n_steps, want.n_slots)
    assert res.n_steps > 0 and res.n_slots > 0
    rel = np.abs(res.totals - want.totals) / np.maximum(
        np.abs(want.totals), 1.0)
    assert rel.max() <= REL
    np.testing.assert_allclose(res.weights, want.weights, rtol=REL)
    _assert_same_history(res.history, want.history, 5e-4)
    assert all(isinstance(p.ema, np.ndarray) for p in res.history)
    # configured delays recovered within a grid step or two
    want_d = np.asarray([0.004 * (d % 5) for d in range(2)])
    assert np.all(np.abs(res.delays[::2] - want_d) <= 2e-3)


@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
def test_scan_closed_rows_match_reference(host):
    """The full-run closed rows: times and opening times equal to the
    reference's, dE/dt exactly equal (the plain version equals the
    reference's reconstruction bit for bit, as in
    ``test_torch_kernels.py``)."""
    _, groups = _sim_groups(3)
    rows_j = jpl.pack_stream_rows([tr for g in groups for tr in g])
    rows_t = tpl.pack_stream_rows([tr for g in _port_groups(groups)
                                   for tr in g])
    tj, vj, fj = jpl._scan_closed_rows(rows_j, interpret=True,
                                       use_kernel=None, host=host)
    tt, vt, ft = tscan._scan_closed_rows(rows_t, host=host, device=CPU)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(ft, fj)
    assert vt.dtype == torch.float32
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("tracked", [False, True],
                         ids=["untracked", "tracked"])
@pytest.mark.parametrize("engine", ["windowed", "scan"])
def test_host_mirror_matches_reference(x64, engine, tracked):
    """``host=True`` (the float64 mirror, on the CPU) on both engines
    against the reference's mirror, <= 1e-5 per phase."""
    truth, groups = _sim_groups(2)
    grid, d_all, phases = _pinned(groups, truth)
    track = (dict(track=True, window=512, hop=128) if tracked
             else dict(delays=d_all, track=False))
    want = jax_streaming(groups, phases, config=JCfg(
        stream=JStream(chunk=256, engine=engine, grid=grid,
                                host=True),
        track=JTrack(**track)), reference=truth)
    got = attribute_energy_fused_streaming(
        _port_groups(groups), phases, config=PipelineConfig(
            stream=StreamConfig(chunk=256, engine=engine, grid=grid,
                                host=True),
            track=TrackConfig(**track)), reference=_port_truth(truth))
    worst = _worst(got, want)
    print(f"host mirror ({engine}) vs the reference's: {worst:.3e}")
    assert worst <= REL, f"host mirror vs the reference's: {worst:.3e}"


def test_host_mirror_refuses_a_card():
    """``host=True`` is the caller asking for the host: an explicit CUDA
    device is refused, by the entry point and by the scan engine."""
    truth, groups = _sim_groups(1)
    with pytest.raises(ValueError, match="host=True"):
        attribute_energy_fused_streaming(
            _port_groups(groups), [("a", 0.5, 1.0)],
            config=StreamConfig(host=True), device="cuda")
    _, rows_t, phases, kw = _surface_case()
    with pytest.raises(ValueError, match="host=True"):
        attribute_totals_fused_scan(rows_t, [2, 2], phases, host=True,
                                    device="cuda", **kw)


_REFUSALS = {
    "health": lambda c: dict(config=dataclasses.replace(c, health=True)),
    "meter": lambda c: dict(config=c, meter=[SlotSegment(
        0.5, 1.0, (0,), (1,))]),
    "checkpoint": lambda c: dict(config=dataclasses.replace(
        c, checkpoint=CheckpointConfig(dir="unused", every=1))),
    "on_window": lambda c: dict(config=c, on_window=lambda p, w: None),
    "return_pipe": lambda c: dict(config=c, return_pipe=True),
}


@pytest.mark.parametrize("option", list(_REFUSALS))
def test_scan_refuses_what_the_reference_refuses(option):
    """The scan engine takes no health stage, meter, checkpoint,
    ``on_window`` or ``return_pipe``: ``AssertionError`` in both
    packages."""
    from repro.fleet.pipeline import SlotSegment as JSlotSegment
    truth, groups = _sim_groups(1)
    phases = [("a", 0.5, 1.0)]
    jcfg = JCfg(stream=JStream(engine="scan"))
    jkw = _REFUSALS[option](jcfg)
    if "meter" in jkw:
        jkw["meter"] = [JSlotSegment(0.5, 1.0, (0,), (1,))]
    with pytest.raises(AssertionError):
        jax_streaming(groups, phases, **jkw)
    cfg = PipelineConfig(stream=StreamConfig(engine="scan"))
    with pytest.raises(AssertionError):
        attribute_energy_fused_streaming(_port_groups(groups), phases,
                                         device=CPU, **_REFUSALS[option](cfg))


def test_scan_rejects_unknown_engine():
    _, groups = _sim_groups(1)
    with pytest.raises(AssertionError):
        attribute_energy_fused_streaming(
            _port_groups(groups), [("a", 0.5, 1.0)],
            config=StreamConfig(engine="warp"), device=CPU)


@pytest.mark.parametrize("option", [dict(interpret=True),
                                    dict(use_kernel=False)],
                         ids=["interpret", "no_kernel"])
def test_scan_refuses_the_pallas_knobs(option):
    _, rows_t, phases, kw = _surface_case()
    with pytest.raises(NotImplementedError):
        attribute_totals_fused_scan(rows_t, [2, 2], phases, device=CPU,
                                    **kw, **option)


def test_scan_runs_eight_sensor_groups():
    """k_max = 8, the most the dense pattern accumulator holds (256
    coverage patterns a device): the scan against the port's windowed
    engine, <= 1e-5."""
    truth, groups = _unequal_groups([8, 3])
    grid, d_all, phases = _pinned(groups, truth)
    cfg = dict(grid=grid, chunk=256)
    track = TrackConfig(delays=d_all, track=False)
    pg = _port_groups(groups)
    scan = attribute_energy_fused_streaming(
        pg, phases, config=PipelineConfig(
            stream=StreamConfig(engine="scan", **cfg), track=track),
        device=CPU)
    win = attribute_energy_fused_streaming(
        pg, phases, config=PipelineConfig(stream=StreamConfig(**cfg),
                                          track=track), device=CPU)
    assert _worst(scan, win) <= REL


def test_fused_fleet_energize_scan_matches_reference(x64):
    """The §V-B accounting with ``engine="scan"`` on 2 nodes, against the
    reference's, <= 1e-5."""
    from repro.hpl import energy as jenergy
    from repro_torch.hpl import energy as tenergy
    from test_torch_hpl import _assert_energy_close, _tracers
    full, _ = _tracers()
    cfg = JCfg(stream=JStream(engine="scan"))
    want = jenergy.fused_fleet_energize(full, 2, streaming=True,
                                        config=cfg)
    got = tenergy.fused_fleet_energize(
        interop.tracer_from_arrays(full.to_arrays()), 2, streaming=True,
        config=PipelineConfig(stream=StreamConfig(engine="scan")),
        device=CPU)
    _assert_energy_close(got, want)


def test_serve_attribute_phases_scan_matches_windowed():
    """Serving's ``attribute_phases(fuse=True, streaming=True)`` on the
    scan engine against its windowed twin on the same served timeline,
    <= 1e-5."""
    from test_torch_serve import _energy_close, _served_fabric
    _, _, eng, port_traces, lead = _served_fabric()
    got = {}
    for engine in ("scan", "windowed"):
        got[engine] = eng.attribute_phases(
            port_traces, t_shift=lead, fuse=True, streaming=True,
            config=PipelineConfig(stream=StreamConfig(engine=engine),
                                  track=TrackConfig(track=False)))
    assert list(got["scan"]) == list(got["windowed"])
    _energy_close(got["scan"].values(), got["windowed"].values())
