"""PyTorch port, the sensor-characterization core: characterization,
confidence windows (Eq. 1), aliasing, the columnar trace store and its
integer codecs, boxcar inversion and series alignment, fault-free
attribution extras (power series, conservation residual, the stacked
node view on the fleet path and the host path, ``resp=`` steady-state
stats) and the per-trace ``align_fuse_host`` loop, each against the JAX
package's function on the same seeded data.

Bounds: host numpy on both sides, so results are held equal (exact);
``stacked_node_power`` on the fleet path and ``align_fuse_host`` within
1e-5 of the reference; the codecs and ``save_trace`` give the same
bytes."""
import dataclasses
import zipfile

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as jc
from repro.align import align_fuse_host as jax_align_fuse_host
from repro.core import characterization as jchar
from repro.core import measurement_model as jmm
from repro.core import reconstruction as jrec
from repro.core import trace_format as jtf
import repro_torch.core as tc
from repro_torch.align import align_fuse_host
from repro_torch.core import characterization as tchar
from repro_torch.core import measurement_model as tmm
from repro_torch.core import reconstruction as trec
from repro_torch.core import trace_format as ttf

torch.set_num_threads(2)
CPU = "cpu"


def _resp(mod, d=0.01, r=0.02, f=0.03):
    return mod.StepResponse(d, r, f, 55.0, 215.0, 10)


def _square(pkg, period, n, lead, tail):
    return pkg.square_wave(period, n, lead_s=lead, tail_s=tail)


def _sim(pkg, mm, spec_fn, tool, truth_args, seed=0):
    truth = _square(pkg, *truth_args)
    return truth, pkg.simulate_sensor(spec_fn(mm), tool(pkg), truth,
                                      seed=seed)


def _edges(truth):
    return truth.times[1:-1:2], truth.times[2:-1:2]


def _assert_same(a, b):
    """Dataclass / dict / array / float trees equal, NaN == NaN."""
    if dataclasses.is_dataclass(a):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------ confidence windows (Eq. 1)

@pytest.mark.parametrize("t_s,t_e", [(1.0, 2.0), (1.0, 1.05), (0.0, 0.08)])
@pytest.mark.parametrize("resp", [(0.01, 0.02, 0.03),
                                  (float("nan"), 0.02, float("nan")),
                                  (float("nan"),) * 3])
def test_confidence_window_matches_reference(t_s, t_e, resp):
    from repro.core.confidence import confidence_window as jcw
    from repro_torch.core.confidence import confidence_window as tcw
    want = jcw(t_s, t_e, _resp(jchar, *resp))
    got = tcw(t_s, t_e, _resp(tchar, *resp))
    assert (got.t_lo, got.t_hi, got.empty, got.width) == \
        (want.t_lo, want.t_hi, want.empty, want.width)
    assert tc.min_attributable_phase_s(_resp(tchar, *resp)) == \
        jc.min_attributable_phase_s(_resp(jchar, *resp))


def test_confidence_window_eq1():
    w = tc.confidence_window(1.0, 2.0, _resp(tchar))
    assert abs(w.t_lo - 1.03) < 1e-9 and abs(w.t_hi - 1.96) < 1e-9
    assert not w.empty
    assert tc.confidence_window(1.0, 1.05, _resp(tchar)).empty
    assert tc.min_attributable_phase_s(_resp(tchar)) > 0.05


def _chip_energy(mm):
    return mm.chip_energy_sensor(0)


def _pm_chip(mm):
    return mm.pm_chip_sensor(0, False)


def _tool(pkg):
    return pkg.ToolSpec(1e-3)


def test_steady_state_within_window_matches_reference():
    want_truth, jtr = _sim(jc, jmm, _chip_energy, _tool, (2.0, 3, 1.0, 1.0))
    _, ttr = _sim(tc, tmm, _chip_energy, _tool, (2.0, 3, 1.0, 1.0))
    np.testing.assert_array_equal(ttr.value, jtr.value)
    js, ts = jc.delta_e_over_delta_t(jtr), tc.delta_e_over_delta_t(ttr)
    eu, ed = _edges(want_truth)
    jresp = jchar.step_response(js, eu, ed)
    tresp = tchar.step_response(ts, eu, ed)
    _assert_same(tresp, jresp)
    jst = jc.steady_state(js, float(eu[0]), float(ed[0]), jresp)
    tst = tc.steady_state(ts, float(eu[0]), float(ed[0]), tresp)
    _assert_same(tst, jst)
    assert tst.reliable and abs(tst.mean_w - 215.0) < 5.0


def test_pm_cannot_attribute_short_phases_matches_reference():
    truth, jtr = _sim(jc, jmm, _pm_chip, _tool, (0.6, 6, 1.0, 1.0))
    _, ttr = _sim(tc, tmm, _pm_chip, _tool, (0.6, 6, 1.0, 1.0))
    eu, ed = _edges(truth)
    jresp = jchar.step_response(jrec.power_trace_series(jtr), eu, ed)
    tresp = tchar.step_response(trec.power_trace_series(ttr), eu, ed)
    _assert_same(tresp, jresp)
    w = tc.confidence_window(float(eu[0]), float(eu[0]) + 0.3, tresp)
    assert w.empty or w.width < 0.05


# ------------------------------------------------------- characterization

@pytest.mark.parametrize("spec_fn", [
    lambda mm: mm.chip_energy_sensor(1),
    lambda mm: mm.chip_power_avg_sensor(1),
    lambda mm: mm.chip_power_inst_sensor(1),
    lambda mm: mm.pm_chip_sensor(1, True),
    lambda mm: mm.pm_energy_sensor(1, False),
], ids=["chip_energy", "power_avg", "power_inst", "pm_power", "pm_energy"])
def test_characterize_sensor_matches_reference(spec_fn):
    """The whole record (update intervals, step response, read lag)
    equal to the reference's on the same seeded sensor."""
    truth, jtr = _sim(jc, jmm, spec_fn, _tool, (1.0, 3, 0.5, 0.5), seed=3)
    _, ttr = _sim(tc, tmm, spec_fn, _tool, (1.0, 3, 0.5, 0.5), seed=3)
    eu, ed = _edges(truth)
    want = jc.characterize_sensor(jtr, eu, ed)
    got = tc.characterize_sensor(ttr, eu, ed)
    _assert_same(got, want)
    assert got["update_intervals"]["observed"]["median"] > 0.0


def test_update_intervals_and_step_response_recover_the_spec():
    """The simulator's configured cadence and a finite response come
    back out of a blind characterization (paper §V-A)."""
    spec = tmm.SensorSpec("e", "chip", "energy_cum", quantum=1e-6,
                          production_interval_s=10e-3,
                          driver_refresh_s=10e-3)
    truth = tc.square_wave(0.5, 4, lead_s=0.5, tail_s=0.5)
    tr = tc.simulate_sensor(spec, tc.ToolSpec(1e-3), truth, seed=1)
    ui = tchar.update_intervals(tr).summary()
    assert abs(ui["published"]["median"] - 10e-3) < 2e-3
    assert abs(ui["observed"]["median"] - 1e-3) < 5e-4
    resp = tchar.step_response(tc.delta_e_over_delta_t(tr), *_edges(truth))
    assert np.isfinite(resp.delay_s) and resp.n_edges_used >= 1


# --------------------------------------------------------------- aliasing

def test_nyquist():
    assert tc.nyquist_limit_hz(1e-3) == jc.nyquist_limit_hz(1e-3) == 500.0


def _detect(pkg, mm, period, seed=5):
    truth = pkg.square_wave(period, max(6, int(1.0 / period)),
                            lead_s=0.2, tail_s=0.2)
    tr = pkg.simulate_sensor(mm.chip_energy_sensor(0),
                             pkg.ToolSpec(1e-3, n_sensors_polled=24), truth,
                             seed=seed)
    s = pkg.delta_e_over_delta_t(tr)
    return pkg.transition_detection_error(s, truth.times[1:-1])


@pytest.mark.parametrize("period", [0.1, 0.004, 0.002])
def test_transition_detection_matches_reference(period):
    got, want = _detect(tc, tmm, period), _detect(jc, jmm, period)
    _assert_same(got, want)


def test_aliasing_monotone_with_period():
    slow, mid, fast = (_detect(tc, tmm, p).error_rate
                       for p in (0.1, 0.004, 0.002))
    assert slow < 0.05 and fast > mid - 0.05 and fast > 0.3


def test_aliasing_sweep_matches_reference():
    def make(pkg, mm):
        def f(period):
            truth = pkg.square_wave(period, 8, lead_s=0.1, tail_s=0.1)
            tr = pkg.simulate_sensor(mm.chip_energy_sensor(0),
                                     pkg.ToolSpec(1e-3), truth, seed=2)
            return pkg.delta_e_over_delta_t(tr), truth.times[1:-1]
        return f
    periods = [0.2, 0.02, 0.005]
    _assert_same(tc.aliasing_sweep(make(tc, tmm), periods),
                 jc.aliasing_sweep(make(jc, jmm), periods))


@pytest.mark.parametrize("period,n,polled,seed,f_true", [
    (0.1, 40, 1, 0, 10.0), (0.004, 500, 24, 2, 250.0)],
    ids=["well_sampled", "undersampled"])
def test_fft_analysis_matches_reference(period, n, polled, seed, f_true):
    def run(pkg, mm):
        truth = pkg.square_wave(period, n, lead_s=0.1, tail_s=0.1)
        tr = pkg.simulate_sensor(mm.chip_energy_sensor(0),
                                 pkg.ToolSpec(1e-3, n_sensors_polled=polled),
                                 truth, seed=seed)
        return pkg.fft_analysis(pkg.delta_e_over_delta_t(tr),
                                true_freq_hz=f_true)
    got, want = run(tc, tmm), run(jc, jmm)
    _assert_same(got, want)
    if f_true == 10.0:
        assert not got.folded and abs(got.peak_hz - 10.0) < 1.5
    else:
        assert got.folded or got.noise_floor_ratio > 1e-4


# ---------------------------------------------------------- reconstruction

def test_invert_moving_average_matches_reference():
    t = np.arange(2000) * 1e-3
    x = np.where((t // 0.25).astype(int) % 2 == 0, 60.0, 210.0)
    k = 50
    y = np.convolve(x, np.ones(k) / k, mode="full")[:len(x)]
    got = trec.invert_moving_average(tc.PowerSeries(t, y, "p"),
                                     window_s=k * 1e-3)
    want = jrec.invert_moving_average(jc.PowerSeries(t, y, "p"),
                                      window_s=k * 1e-3)
    np.testing.assert_array_equal(got.t, want.t)
    np.testing.assert_array_equal(got.watts, want.watts)
    assert got.source == want.source == "p:deconv"
    err = np.abs(got.watts[3 * k:] - x[3 * k:])
    assert np.percentile(err, 90) < 1.0
    one = tc.PowerSeries(t, y)
    assert trec.invert_moving_average(one, window_s=1e-3) is one


def test_align_series_matches_reference():
    rng = np.random.default_rng(0)
    mk = [(np.sort(rng.uniform(0, 2, 50)), rng.uniform(0, 300, 50), f"s{i}")
          for i in range(3)]
    grid = np.linspace(0.0, 2.0, 77)
    gn, gm = trec.align_series([tc.PowerSeries(*a) for a in mk], grid)
    wn, wm = jrec.align_series([jc.PowerSeries(*a) for a in mk], grid)
    assert gn == wn == ["s0", "s1", "s2"]
    np.testing.assert_array_equal(gm, wm)


# ------------------------------------------------------------- attribution

def _fabric(pkg, seed=0):
    truth = pkg.square_wave(2.0, 4, lead_s=1.5, tail_s=1.5)
    return truth, pkg.NodeFabric(chip_truths=[truth] * 4).sample_all(
        pkg.ToolSpec(1e-3), seed=seed)


@pytest.fixture(scope="module")
def fabrics():
    return _fabric(jc), _fabric(tc)


@pytest.mark.parametrize("phases,conserves", [
    ([("a", 1.6, 2.4), ("b", 2.4, 3.3), ("c", 4.0, 5.5)], True),
    ([("a", 1.0, 2.0), ("b", 3.0, 4.0), ("c", 6.0, 6.5)], True),
    ([("a", 1.0, 3.0), ("b", 2.0, 4.0), ("c", 6.0, 6.5)], False),
], ids=["contiguous", "gaps", "overlapping"])
def test_energy_conservation_residual_matches_reference(fabrics, phases,
                                                        conserves):
    """Gaps are filled; overlapping phases count their overlap twice,
    in both packages."""
    (_, jt), (_, tt) = fabrics
    got = tc.energy_conservation_residual(tt["chip0_energy"], phases)
    want = jc.energy_conservation_residual(jt["chip0_energy"], phases)
    assert got == want
    assert (got < 1e-6) == conserves


@pytest.mark.parametrize("name", ["chip0_energy", "pm_accel1_power",
                                  "pm_cpu_power"])
def test_attribute_power_series_matches_reference(fabrics, name):
    (_, jt), (_, tt) = fabrics
    phases = [("a", 1.6, 2.4), ("b", 2.4, 3.3), ("a", 4.0, 5.5)]
    corr = tc.nic_rail_corrections()
    got = tc.attribute_power_series(tt[name], phases, corrections=corr)
    want = jc.attribute_power_series(jt[name], phases,
                                     corrections=jc.nic_rail_corrections())
    assert list(got) == list(want) == ["a", "b"]
    for k in got:
        _assert_same(got[k], want[k])


@pytest.mark.parametrize("name", ["chip2_energy", "pm_accel0_power",
                                  "pm_node_power"])
def test_attribute_energy_with_resp_matches_reference(fabrics, name):
    """``resp=``: power sensors carry their steady-state stats over each
    phase's confidence window; counters ignore it."""
    (truth, jt), (_, tt) = fabrics
    phases = [("active", float(truth.times[1]), float(truth.times[2])),
              ("idle", float(truth.times[2]), float(truth.times[3])),
              ("short", float(truth.times[1]), float(truth.times[1]) + 0.05)]
    got = tc.attribute_energy(tt[name], phases, resp=_resp(tchar))
    want = jc.attribute_energy(jt[name], phases, resp=_resp(jchar))
    _assert_same(got, want)
    if not tt[name].spec.is_cumulative:
        assert got[0].steady.reliable and not got[2].steady.reliable


def test_stacked_node_power_host_path_matches_reference(fabrics):
    (_, jt), (_, tt) = fabrics
    grid = np.arange(1.0, 10.0, 0.01)
    got = tc.stacked_node_power(tt, grid, use_fleet=False)
    want = jc.stacked_node_power(jt, grid, use_fleet=False)
    assert set(got["components"]) == set(want["components"]) >= {
        "chip0_energy", "chip1_energy", "chip2_energy", "chip3_energy",
        "pm_cpu_power", "pm_memory_power"}
    np.testing.assert_array_equal(got["grid"], want["grid"])
    for k in got["components"]:
        np.testing.assert_array_equal(got["components"][k],
                                      want["components"][k])


def test_stacked_node_power_fleet_path_matches_reference(fabrics):
    """The chip counters through the port's ``fleet_power_series`` (B2's
    plain version on the CPU) against the reference's fleet path: the
    float32 packing is the same, so per-component power within 1e-5 of
    the largest."""
    (_, jt), (_, tt) = fabrics
    grid = np.arange(1.0, 10.0, 0.01)
    got = tc.stacked_node_power(tt, grid, device=CPU)
    want = jc.stacked_node_power(jt, grid)
    assert set(got["components"]) == set(want["components"])
    for k in got["components"]:
        g, w = got["components"][k], want["components"][k]
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), k


# -------------------------------------------------------- align_fuse_host

@pytest.mark.parametrize("reference", ["truth", "self"])
def test_align_fuse_host_matches_reference(reference):
    jtruth, jt = _fabric(jc)
    ttruth, tt = _fabric(tc)
    from repro.align import group_traces_by_device as jgroup
    from repro_torch.align import group_traces_by_device as tgroup
    jg = list(jgroup(jt).values())[:2]
    tg = list(tgroup(tt).values())[:2]
    grid = np.arange(1.2, 9.5, 2e-3)
    want = jax_align_fuse_host(
        jg, grid, max_lag=64,
        reference=jtruth if reference == "truth" else None)
    got = align_fuse_host(
        tg, grid, max_lag=64,
        reference=ttruth if reference == "truth" else None)
    for g, w in zip(got, want):
        assert g.shape == w.shape
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-12)
    assert np.abs(got[0] - want[0]).max() <= 1e-5 * np.abs(want[0]).max()


# ---------------------------------------------------------- trace format

def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


def test_trace_format_roundtrip_and_bytes(tmp_path):
    """``save_trace`` writes the reference's columns byte for byte (the
    zip members; the archive's own timestamps aside), either package
    loads the other's file, and ``merge_traces`` prefixes by node."""
    res = {}
    for key, pkg in (("jax", jc), ("torch", tc)):
        truth = pkg.square_wave(1.0, 2, lead_s=0.5, tail_s=0.5)
        traces = pkg.NodeFabric(chip_truths=[truth] * 4).sample_all(
            pkg.ToolSpec(1e-2), seed=0)
        tracer = pkg.RegionTracer(timebase=lambda: 0.0)
        tracer.add_region("warmup", 0.0, 0.5)
        tracer.add_region("work", 0.5, 2.0, step=1)
        p = tmp_path / key / "node0.npz"
        pkg.save_trace(p, tracer, traces, meta={"node_id": 0})
        res[key] = (p, traces, tracer)
    pj, traces, _ = res["jax"]
    pt, ttraces, tracer = res["torch"]
    assert _members(pt) == _members(pj)
    t2, s2, meta = tc.load_trace(pj)          # the reference's file
    assert meta["node_id"] == 0
    assert [e.name for e in t2.events] == ["warmup", "work"]
    assert [(e.t_start, e.t_end, e.step) for e in t2.events] == \
        [(e.t_start, e.t_end, e.step) for e in jc.load_trace(pj)[0].events]
    assert set(s2) == set(traces)
    for name, tr in s2.items():
        assert tr.spec == ttraces[name].spec
        for f in ("t_read", "t_measured", "value"):
            np.testing.assert_array_equal(getattr(tr, f),
                                          getattr(traces[name], f))
    j2, js2, _ = jc.load_trace(pt)            # and the reverse
    np.testing.assert_array_equal(js2["chip0_energy"].value,
                                  traces["chip0_energy"].value)
    p2 = tmp_path / "torch" / "node1.npz"
    tc.save_trace(p2, tracer, ttraces, meta={"node_id": 1})
    reg, sensors, metas = tc.merge_traces([pt, p2])
    assert len(reg.events) == 4 and [m["node_id"] for m in metas] == [0, 1]
    assert {"node0/chip0_energy", "node1/chip0_energy"} <= set(sensors)


# ------------------------------------------------------------- codecs

i64 = st.integers(-(2**63), 2**63 - 1)


@given(st.lists(i64, max_size=64))
@settings(max_examples=60, deadline=None)
def test_prop_zigzag_delta_match_reference(xs):
    v = np.asarray(xs, np.int64)
    z = ttf.zigzag_encode(v)
    assert z.tobytes() == jtf.zigzag_encode(v).tobytes()
    np.testing.assert_array_equal(ttf.zigzag_decode(z), v)
    with np.errstate(over="ignore"):
        d = ttf.delta_encode(v)
        assert d.tobytes() == jtf.delta_encode(v).tobytes()
        np.testing.assert_array_equal(ttf.delta_decode(d), v)


@given(st.integers(0, 2**64 - 1))
@settings(max_examples=60, deadline=None)
def test_prop_varint_matches_reference(n):
    b = ttf.varint_encode(n)
    assert b == jtf.varint_encode(n)
    assert ttf.varint_decode(b + b"\x07") == (n, len(b))


@given(st.integers(0, 64), st.lists(st.integers(0, 2**64 - 1),
                                    max_size=40))
@settings(max_examples=60, deadline=None)
def test_prop_bitpack_matches_reference(bits, xs):
    v = np.asarray(xs, np.uint64)
    if bits < 64:
        v = v & np.uint64((1 << bits) - 1) if bits else v & np.uint64(0)
    b = ttf.bitpack(v, bits)
    assert b == jtf.bitpack(v, bits)
    np.testing.assert_array_equal(ttf.bitunpack(b, bits, v.size), v)


def test_codec_errors_match_reference():
    with pytest.raises(ValueError, match="truncated varint"):
        ttf.varint_decode(b"\x80\x80")
    with pytest.raises(ValueError, match="wider than 3 bits"):
        ttf.bitpack(np.asarray([9], np.uint64), 3)
    with pytest.raises(ValueError, match="bits=0"):
        ttf.bitpack(np.asarray([1], np.uint64), 0)
    with pytest.raises(ValueError, match="truncated bitpacked"):
        ttf.bitunpack(b"\x01", 9, 2)
