"""PyTorch port, the batch align-and-fuse path and ``fleet.api``: the port
(its kernels' plain versions on the CPU) against the JAX package's batch
path on the same seeded traces and the same packed arrays — whole-fleet
reconstruction, the two-stage fleet streams, regridding, alignment and
fusion, the §V-B report, the three trace-level entry points, and the
batch path against the port's own windowed pipeline."""
import dataclasses

import numpy as np
import pytest
import torch

from repro import align as jalign
from repro import fleet as jfleet
from repro.core import ToolSpec, simulate_sensor, square_wave
from repro.core.measurement_model import SensorSpec, chip_energy_sensor
from repro.core.reconstruction import PowerSeries as JPowerSeries
from repro.core.sensors import SensorTrace as JSensorTrace
from repro_torch import align as talign
from repro_torch import fleet as tfleet
from repro_torch import interop
from repro_torch.core.reconstruction import PowerSeries
from repro_torch.fleet import PipelineConfig, StreamConfig, TrackConfig

CPU = "cpu"
REL = 1e-5

# the test workers share the machine's cores: keep torch from taking them all
torch.set_num_threads(2)


def _sim_groups(n_devices, seed=0, span_s=0.6, noise=3.0):
    """The reference's test recipe, short: per device a wrapping energy
    counter and a noisy power sensor with distinct configured delays."""
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


def _port_trace(tr):
    return interop.trace_from_fields(tr.name, dataclasses.asdict(tr.spec),
                                     tr.t_read, tr.t_measured, tr.value)


def _port_groups(groups):
    return [[_port_trace(tr) for tr in g] for g in groups]


def _phases(grid, n=5):
    edges = np.linspace(float(grid[0]), float(grid[-1]), n + 1)
    return [(f"p{k}", float(a), float(b))
            for k, (a, b) in enumerate(zip(edges[:-1], edges[1:]))]


def _energies(rows):
    return np.array([[pe.energy_j for pe in row] for row in rows])


def _assert_energy_close(got, want, rel=REL):
    """Per-phase energies within ``rel`` x max(|E|, 1 J)."""
    g, w = _energies(got), _energies(want)
    assert g.shape == w.shape and np.isfinite(g).all()
    err = np.abs(g - w) / np.maximum(np.abs(w), 1.0)
    assert err.max() <= rel, err.max()


def _counter_traces(n=5, seed=0, reorder_row=None):
    """Cumulative counters of mixed length; one row optionally with a
    timestamp that goes backwards."""
    truth = square_wave(0.1, 2, lead_s=0.05, tail_s=0.05)
    tool = ToolSpec(1e-3)
    out = [simulate_sensor(chip_energy_sensor(i), tool, truth,
                           seed=seed + i) for i in range(n)]
    if reorder_row is not None:
        tr = out[reorder_row]
        tm = tr.t_measured.copy()
        tm[60] = tm[58]
        out[reorder_row] = JSensorTrace(tr.name, tr.spec, tr.t_read, tm,
                                        tr.value)
    return truth, out


@pytest.fixture(scope="module")
def case():
    truth, groups = _sim_groups(3)
    fused = jalign.align_and_fuse(groups, reference=truth)
    grid = fused[0].grid
    return dict(truth=truth, groups=groups, fused=fused, grid=grid,
                delays=np.concatenate([fs.delays for fs in fused]),
                phases=_phases(grid), port_groups=_port_groups(groups),
                port_truth=interop.power_from_arrays(truth.times,
                                                     truth.watts))


# ------------------------------------------------ fleet reconstruction

@pytest.mark.parametrize("reorder_row", [None, 3])
def test_fleet_reconstruct_matches_jax_and_host(reorder_row):
    """Bit-identical to the JAX fleet_reconstruct on the fast and the
    carry-forward path; within 1e-5 of the float64 host mirror."""
    _, traces = _counter_traces(reorder_row=reorder_row)
    jp = jfleet.pack_traces(traces)
    tp = interop.packed_fleet_from_fields(dataclasses.asdict(jp))
    want = jfleet.fleet_reconstruct(jp, mesh=None)
    got = tfleet.fleet_reconstruct(tp, device=CPU)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the reordered row really took the carry-forward path
    t_out = got[1].numpy()
    assert (t_out[reorder_row or 0] != tp.times[reorder_row or 0]).any() \
        == (reorder_row is not None)
    host = tfleet.fleet_reconstruct_host(tp)
    for h, w in zip(host, jfleet.fleet_reconstruct_host(jp)):
        np.testing.assert_array_equal(h, w)
    np.testing.assert_array_equal(got[2].numpy(), host[2])
    p, ph = got[0].numpy().astype(np.float64), host[0]
    assert (np.abs(p - ph) <= REL * np.maximum(np.abs(ph), 1.0)).all()


def test_unpack_series_and_power_series_match_jax():
    _, traces = _counter_traces(reorder_row=1)
    got = tfleet.fleet_power_series([_port_trace(tr) for tr in traces],
                                    device=CPU)
    want = jfleet.fleet_power_series(traces)
    assert len(got) == len(want) == len(traces)
    grid = np.linspace(0.02, 0.3, 97)
    for g, w in zip(got, want):
        assert g.source == w.source
        np.testing.assert_array_equal(g.t, w.t)
        np.testing.assert_array_equal(g.watts, w.watts)
        np.testing.assert_array_equal(g.resample(grid).watts,
                                      w.resample(grid).watts)
        assert g.energy_between(0.05, 0.27) == w.energy_between(0.05, 0.27)
    ps = PowerSeries(np.array([0.0, 1.0, 2.5]), np.array([3.0, 5.0, 7.0]))
    jps = JPowerSeries(ps.t, ps.watts)
    assert ps.energy_between(0.2, 2.2) == jps.energy_between(0.2, 2.2)


# ------------------------------------------------ two-stage fleet streams

@pytest.mark.parametrize("chunk", [37, 128])
def test_fleet_stream_matches_jax(chunk):
    """FleetStream on raw counter chunks (a reordered read, masked slots)
    within 1e-5 x max(|E|, 1 J) of the JAX class, and reset works."""
    truth, traces = _counter_traces(n=6, reorder_row=2)
    jp = jfleet.pack_traces(traces)
    windows = [(0.0, 0.08), (0.06, 0.21), (0.2, 0.5)]
    valid = np.random.default_rng(chunk).random(jp.shape) > 0.05
    js = jfleet.FleetStream(windows, jp.shape[0], jp.wrap_period, mesh=None)
    ts = tfleet.FleetStream(windows, jp.shape[0], jp.wrap_period,
                            device=CPU)
    for rnd in range(2):
        for lo in range(0, jp.shape[1], chunk):
            sl = slice(lo, lo + chunk)
            js.update(jp.times[:, sl], jp.energy[:, sl], valid[:, sl])
            ts.update(jp.times[:, sl], jp.energy[:, sl], valid[:, sl])
        got, want = ts.totals(), js.totals()
        assert got.shape == want.shape == (jp.shape[0], 3)
        assert (np.abs(got - want)
                <= REL * np.maximum(np.abs(want), 1.0)).all()
        assert got[:6].min() > 0
        js.reset()
        ts.reset()


@pytest.mark.parametrize("chunk", [41, 200])
def test_streaming_phase_accumulator_matches_jax(chunk):
    rng = np.random.default_rng(chunk)
    t = np.cumsum(rng.uniform(0.0, 2e-3, (9, 400)), axis=1)
    t = t.astype(np.float32)
    w = rng.uniform(40.0, 260.0, (9, 400)).astype(np.float32)
    valid = rng.random((9, 400)) > 0.1
    valid[4, :150] = False                    # a row dark at the start
    windows = [(0.05, 0.2), (0.15, 0.6), (0.0, 0.9)]
    ja = jfleet.StreamingPhaseAccumulator(windows, 9)
    ta = tfleet.StreamingPhaseAccumulator(windows, 9, device=CPU)
    for lo in range(0, 400, chunk):
        sl = slice(lo, lo + chunk)
        ja.update(t[:, sl], w[:, sl], valid=valid[:, sl])
        ta.update(t[:, sl], w[:, sl], valid=valid[:, sl])
    got, want = ta.totals(), ja.totals()
    assert (np.abs(got - want) <= REL * np.maximum(np.abs(want), 1.0)).all()


def test_power_accumulator_invalid_first_slot():
    """An invalid first sample does not seed the hold carry (the
    reference's own regression case), in both packages alike."""
    t = np.array([[0.0, 100.0, 100.1, 100.2, 100.3]], np.float32)
    w = np.array([[999.0, 50.0, 50.0, 50.0, 50.0]], np.float32)
    valid = np.array([[False, True, True, True, True]])
    ta = tfleet.StreamingPhaseAccumulator([(0.0, 200.0)], 1, device=CPU)
    ja = jfleet.StreamingPhaseAccumulator([(0.0, 200.0)], 1)
    ta.update(t, w, valid=valid)
    ja.update(t, w, valid=valid)
    e = float(ta.totals()[0, 0])
    assert abs(e - 50.0 * 0.3) < 1e-3, e
    assert abs(e - float(ja.totals()[0, 0])) <= REL * abs(e)


# ------------------------------------------------ regrid and delays

@pytest.mark.parametrize("mode", ["hold", "linear"])
def test_series_rows_and_regrid_match_jax(case, mode):
    flat = [tr for g in case["groups"] for tr in g]
    jrows = jalign.series_rows_from_traces(flat)
    trows = talign.series_rows_from_traces(
        [_port_trace(tr) for tr in flat], device=CPU)
    for f in ("times", "values", "n", "first"):
        np.testing.assert_array_equal(getattr(trows, f), getattr(jrows, f))
    assert trows.t0 == jrows.t0 and trows.names == jrows.names
    # the interop copy of the reference's rows is the same block
    crows = interop.series_rows_from_fields(
        {f.name: getattr(jrows, f.name)
         for f in dataclasses.fields(jrows)})
    np.testing.assert_array_equal(crows.times, trows.times)
    grid, d = case["grid"], case["delays"]
    want_v, want_m = jalign.regrid_rows(jrows, grid, delays=d, mode=mode)
    got_v, got_m = talign.regrid_rows(trows, grid, delays=d, mode=mode,
                                      device=CPU)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    if mode == "hold":
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    host_v, host_m = talign.regrid_rows_host(trows, grid, delays=d,
                                             mode=mode)
    jhost_v, jhost_m = jalign.regrid_rows_host(jrows, grid, delays=d,
                                               mode=mode)
    np.testing.assert_array_equal(host_m, jhost_m)
    np.testing.assert_array_equal(host_v, jhost_v)
    np.testing.assert_array_equal(host_m, got_m.numpy())
    np.testing.assert_allclose(got_v.numpy(), host_v, rtol=REL, atol=REL)


def test_delay_host_mirrors_match_jax(case):
    from repro.align.delay import estimate_delays_host as j_est_host
    from repro.align.delay import make_refbank_host as j_bank_host
    from repro.align.delay import schedule_reference as j_sched
    grid = case["grid"]
    ref = talign.schedule_reference(case["port_truth"], grid)
    np.testing.assert_array_equal(ref, j_sched(case["truth"], grid))
    np.testing.assert_array_equal(talign.make_refbank_host(ref, max_lag=9),
                                  j_bank_host(ref, max_lag=9))
    fs = case["fused"]
    vals = np.concatenate([f.stream_values for f in fs])
    mask = np.concatenate([f.stream_mask for f in fs])
    step = float(np.median(np.diff(grid)))
    got = talign.estimate_delays_host(vals, mask, ref, step=step,
                                      max_lag=40)
    want = j_est_host(vals, mask, ref, step=step, max_lag=40)
    np.testing.assert_allclose(got.delay_s.numpy(), want.delay_s,
                               rtol=0, atol=1e-9 * step)
    np.testing.assert_allclose(got.peak_corr.numpy(), want.peak_corr,
                               rtol=1e-12)


# ------------------------------------------------ align and fuse

def test_fuse_gridded_matches_jax_and_host():
    from repro.align import fuse_gridded as j_fuse
    rng = np.random.default_rng(3)
    v = rng.normal(150.0, 20.0, (4, 3, 257)).astype(np.float32)
    m = rng.random((4, 3, 257)) > 0.2
    m[1, 2] = False                          # a padding row
    m[2, :, 100:120] = False                 # no coverage
    got = talign.fuse_gridded(torch.from_numpy(v), torch.from_numpy(m))
    want = j_fuse(v, m)
    host = talign.fuse_gridded_host(v, m)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_array_equal(got[4].numpy(), host[4])
    # fused watts, confidence and weights within 1e-5 relative; the
    # disagreement is the root of a variance that cancels to float32
    # rounding (~1e-5 W at 150 W) where the streams agree, so it is held
    # to 1e-4 W absolute there
    for i, (g, w, h) in enumerate(zip(got[:4], want[:4], host[:4])):
        atol = 1e-4 if i == 1 else 1e-6
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=REL,
                                   atol=atol)
        np.testing.assert_allclose(g.numpy(), h, rtol=REL, atol=atol)


def test_align_and_fuse_fixed_delays_matches_jax(case):
    """Masks identical; fused watts within 1e-5 relative."""
    kw = dict(grid=case["grid"], delays=case["delays"])
    want = jalign.align_and_fuse(case["groups"], **kw)
    got = talign.align_and_fuse(case["port_groups"], device=CPU, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.names == w.names
        np.testing.assert_array_equal(g.grid, w.grid)
        np.testing.assert_array_equal(g.mask, w.mask)
        np.testing.assert_array_equal(g.stream_mask, w.stream_mask)
        np.testing.assert_array_equal(g.stream_values, w.stream_values)
        np.testing.assert_array_equal(g.delays, w.delays)
        np.testing.assert_allclose(g.watts, w.watts, rtol=REL, atol=1e-6)
        np.testing.assert_allclose(g.weights, w.weights, rtol=REL)
        np.testing.assert_allclose(g.disagreement_w, w.disagreement_w,
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g.series.energy_between(0.1, 0.5),
                                   w.series.energy_between(0.1, 0.5),
                                   rtol=REL)


def test_align_and_fuse_estimated_delays_matches_jax(case):
    """Delays within 1e-3 of a grid step; per-phase energies within
    1e-5 relative."""
    got = talign.align_and_fuse(case["port_groups"],
                                reference=case["port_truth"], device=CPU)
    want = case["fused"]
    step = float(np.median(np.diff(case["grid"])))
    d_got = np.concatenate([fs.delays for fs in got])
    assert np.abs(d_got - case["delays"]).max() <= 1e-3 * step
    np.testing.assert_allclose(np.concatenate([fs.peak_corr for fs in got]),
                               np.concatenate([fs.peak_corr for fs in want]),
                               atol=1e-5)
    e_got = talign.attribute_energy_fused(case["port_groups"],
                                          case["phases"],
                                          reference=case["port_truth"],
                                          device=CPU)
    e_want = jalign.attribute_energy_fused(case["groups"], case["phases"],
                                           reference=case["truth"])
    _assert_energy_close(e_got, e_want)


def test_self_reference_alignment_matches_jax(case):
    """No reference: each group's first stream is its reference."""
    got = talign.align_and_fuse(case["port_groups"], device=CPU)
    want = jalign.align_and_fuse(case["groups"])
    step = float(np.median(np.diff(case["grid"])))
    for g, w in zip(got, want):
        assert np.abs(g.delays - w.delays).max() <= 1e-3 * step
        np.testing.assert_allclose(g.weights, w.weights, rtol=1e-4)


def test_ragged_groups_match_jax(case):
    """Groups of different sizes pad the (D, k_max, G) block with masked
    rows; an unaligned run (align=False) skips the second regrid."""
    groups = [case["groups"][0], case["groups"][1][:1], case["groups"][2]]
    tgroups = [[_port_trace(tr) for tr in g] for g in groups]
    want = jalign.align_and_fuse(groups, align=False)
    got = talign.align_and_fuse(tgroups, align=False, device=CPU)
    for g, w in zip(got, want):
        assert g.weights.shape == w.weights.shape
        np.testing.assert_array_equal(g.mask, w.mask)
        np.testing.assert_allclose(g.watts, w.watts, rtol=REL, atol=1e-6)


def test_validate_streams_matches_jax(case):
    kw = dict(grid=case["grid"], delays=case["delays"])
    got = talign.validate_streams(case["port_groups"], device=CPU, **kw)
    want = jalign.validate_streams(case["groups"], **kw)
    assert list(got.keys()) == list(want.keys()) == ["devices"]
    assert len(got.devices) == len(want.devices) == 3
    for g, w in zip(got.devices, want.devices):
        assert g.name == w.name and g.quality_flags == w.quality_flags
        assert g.coverage_counts == w.coverage_counts
        np.testing.assert_array_equal(g.slot_flags, w.slot_flags)
        assert abs(g.mean_disagreement_w - w.mean_disagreement_w) \
            <= 1e-4 * abs(w.mean_disagreement_w)
        for name, sw in w.streams.items():
            sg = g.streams[name]
            assert sg.delay_s == sw.delay_s
            assert abs(sg.bias_w - sw.bias_w) <= 1e-4 * max(abs(sw.rms_w),
                                                            1.0)
            assert abs(sg.rms_w - sw.rms_w) <= 1e-4 * abs(sw.rms_w)
            assert abs(sg.weight - sw.weight) <= REL * abs(sw.weight)
    assert got["devices"][0]["name"] == "device0"


def test_group_traces_by_device_matches_jax(case):
    named = {}
    for d, g in enumerate(case["groups"]):
        for tr in g:
            kind = tr.name.split("_")[1]
            named[f"chip{d}_{kind}"] = dataclasses.replace(
                tr, name=f"chip{d}_{kind}")
    named["node_power"] = case["groups"][0][1]
    want = jalign.group_traces_by_device(named, include_node=True)
    got = talign.group_traces_by_device(
        {k: _port_trace(tr) for k, tr in named.items()}, include_node=True)
    assert list(got) == list(want)
    for k in want:
        assert [tr.name for tr in got[k]] == [tr.name for tr in want[k]]


# ------------------------------------------------ fleet.api

@pytest.mark.parametrize("chunk", [53, 1024])
def test_attribute_energy_fleet_matches_jax(chunk):
    truth, traces = _counter_traces(n=5, reorder_row=4)
    phases = [("a", 0.05, 0.12), ("b", 0.11, 0.25), ("c", 0.2, 0.3)]
    got = tfleet.attribute_energy_fleet([_port_trace(tr) for tr in traces],
                                        phases, chunk=chunk, device=CPU)
    want = jfleet.attribute_energy_fleet(traces, phases, chunk=chunk)
    _assert_energy_close(got, want)
    assert [pe.phase for pe in got[0]] == ["a", "b", "c"]
    assert tfleet.attribute_energy_fleet(traces, [], device=CPU) \
        == [[] for _ in traces]


def test_fleet_api_attribute_energy_fused_both_paths(case):
    """The api's batch and streaming dispatch match the JAX api's."""
    kw = dict(grid=case["grid"], delays=case["delays"])
    got = tfleet.attribute_energy_fused(case["port_groups"], case["phases"],
                                        device=CPU, **kw)
    want = jfleet.attribute_energy_fused(case["groups"], case["phases"],
                                         **kw)
    _assert_energy_close(got, want)
    cfg = dict(stream=dict(grid=case["grid"], chunk=256),
               track=dict(delays=case["delays"]))
    got_s = tfleet.attribute_energy_fused(
        case["port_groups"], case["phases"], streaming=True, device=CPU,
        config=PipelineConfig(stream=StreamConfig(**cfg["stream"]),
                              track=TrackConfig(**cfg["track"])))
    want_s = jfleet.attribute_energy_fused(
        case["groups"], case["phases"], streaming=True,
        config=jfleet.PipelineConfig(
            stream=jfleet.StreamConfig(**cfg["stream"]),
            track=jfleet.TrackConfig(**cfg["track"])))
    _assert_energy_close(got_s, want_s)
    with pytest.raises(TypeError, match="streaming=True"):
        tfleet.attribute_energy_fused(case["port_groups"], case["phases"],
                                      config=PipelineConfig(), device=CPU)


@pytest.mark.parametrize("chunk", [257, 512])
def test_batch_matches_windowed_with_fixed_delays(case, chunk):
    """The port's batch path and its windowed pipeline, given the batch
    run's grid and delays, agree to 1e-5 relative per phase."""
    got_b = talign.attribute_energy_fused(
        case["port_groups"], case["phases"], reference=case["port_truth"],
        device=CPU)
    fused = talign.align_and_fuse(case["port_groups"],
                                  reference=case["port_truth"], device=CPU)
    delays = np.concatenate([fs.delays for fs in fused])
    got_w = tfleet.attribute_energy_fused_streaming(
        case["port_groups"], case["phases"], device=CPU,
        config=PipelineConfig(
            stream=StreamConfig(chunk=chunk, grid=fused[0].grid),
            track=TrackConfig(track=False, delays=delays)))
    _assert_energy_close(got_w, got_b)


# ------------------------------------------------ options not ported yet

@pytest.mark.parametrize("call", [
    lambda g, t: tfleet.attribute_energy_fleet(g[0][:1], [("p", 0, 1)],
                                               device=CPU,
                                               use_kernel=False),
    # multi-host runs the streaming pipeline only, and needs both
    lambda g, t: tfleet.attribute_energy_fused(g, [("p", 0, 1)],
                                               device=CPU, collectives=1),
    lambda g, t: tfleet.attribute_energy_fused(g, [("p", 0, 1)],
                                               device=CPU, shard=1),
    lambda g, t: talign.align_and_fuse(g, device=CPU, interpret=True),
    lambda g, t: tfleet.FleetStream([(0, 1)], 2, device=CPU, mesh=1),
    lambda g, t: tfleet.StreamingPhaseAccumulator([(0, 1)], 2, device=CPU,
                                                  use_kernel=False),
    lambda g, t: tfleet.fleet_reconstruct(t, device=CPU, mesh=1),
], ids=["aef-use_kernel", "fused-collectives", "fused-shard",
        "align-interpret", "stream-mesh", "acc-use_kernel", "recon-mesh"])
def test_unported_options_raise(case, call, request):
    _, traces = _counter_traces(n=1)
    packed = tfleet.pack_traces([_port_trace(traces[0])])
    if request.node.callspec.id in ("fused-collectives", "fused-shard"):
        with pytest.raises(ValueError, match="streaming pipeline|needs "
                                             "both"):
            call(case["port_groups"], packed)
        return
    with pytest.raises(NotImplementedError, match="does not support"):
        call(case["port_groups"], packed)


def test_power_series_rejects_a_power_sensor(case):
    with pytest.raises(ValueError, match="not an energy counter"):
        tfleet.fleet_power_series(case["port_groups"][0], device=CPU)
