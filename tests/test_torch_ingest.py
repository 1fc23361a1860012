"""PyTorch port, live ingest: the port's ``repro_torch.ingest`` against the
reference's ``repro.ingest`` on the same scripts.  Backend discovery and
parsing on the tool/sysfs fixtures of ``tests/test_ingest.py`` (declared
wrap ranges and resolutions), ``PrioritizedIngest`` fallback, demotion,
retry, recovery and the stale cache under a fake clock (equal readings,
counters and event sequences), the reader and pump boundary (dedupe,
replicate-last padding, masked placeholders for dark rows), recorded
pump blocks through both pipelines (1e-5), the live kill-and-fallback
capture on the CPU, and ``LiveSampler`` with the registry's
``track_sampler``/``track_ingest``."""
import dataclasses
import itertools
import json
import time

import numpy as np
import pytest
import torch

import repro.ingest as jing
import repro_torch.ingest as ting
from repro.core import ToolSpec, simulate_sensor, square_wave
from repro.core.measurement_model import SensorSpec as JSpec
from repro.core.sensors import SensorTrace as JTrace
from repro.fleet.pipeline import StreamingFusedPipeline as JPipe
from repro.health.registry import HealthRegistry as JRegistry
from repro_torch import interop
from repro_torch.core import LiveSampler, RegionTracer, unwrap_counter
from repro_torch.core.measurement_model import SensorSpec
from repro_torch.core.sensors import SensorTrace
from repro_torch.fleet import FleetStream
from repro_torch.fleet.pipeline import StreamingFusedPipeline
from repro_torch.health.events import HEALTHY, QUARANTINED
from repro_torch.health.registry import HealthRegistry
from repro_torch.ingest.rocm import (ACCUMULATOR_BITS,
                                     DEFAULT_RESOLUTION_UJ)

CPU = "cpu"
E_TOL = 1e-5

# the pump thread and the plain versions share the machine's cores: a
# full torch thread pool spinning after each op delays the pump's polls
torch.set_num_threads(2)


# ------------------------------------------------ fixtures: fake tools

ROCM_ENERGY = {
    "card0": {"Energy counter": "1000000",
              "Accumulated Energy (uJ)": "15259000.0"},
    "card1": {"Energy counter": "2000000",
              "Accumulated Energy (uJ)": "30518000.0"},
}
ROCM_POWER = {
    "card0": {"Average Graphics Package Power (W)": "97.0"},
    "card1": {"Current Socket Graphics Package Power (W)": "105.5"},
}
AMD_ENERGY = [
    {"gpu": 0, "energy": {
        "total_energy_consumption": {"value": 123.5, "unit": "J"},
        "energy_accumulator": 8093946901,
        "counter_resolution": {"value": 15.259, "unit": "uJ"}}},
]
AMD_POWER = [
    {"gpu": 0, "power": {
        "socket_power": {"value": 150.0, "unit": "W"}}},
]


def _runner(pkg, docs):
    """A fake tool: the first flag of ``docs`` found in argv picks the
    JSON document printed; anything else fails like the tool would."""
    def run(argv, timeout_s):
        for flag, doc in docs.items():
            if flag in argv:
                return json.dumps(doc)
        raise pkg.BackendError(f"fake tool: unknown args {argv[1:]}")
    return run


def _rocm(pkg, energy=ROCM_ENERGY, power=ROCM_POWER):
    return pkg.RocmSmiBackend(tool_path="/fake/rocm-smi", runner=_runner(
        pkg, {"--showenergycounter": energy, "--showpower": power}))


def _amd(pkg, energy=AMD_ENERGY, power=AMD_POWER):
    return pkg.AmdSmiBackend(tool_path="/fake/amd-smi", runner=_runner(
        pkg, {"--energy": energy, "--power": power}))


def _rapl_tree(tmp_path):
    root = tmp_path / "powercap"
    zones = {
        "intel-rapl:0": ("package-0", "262143328850", "900000"),
        "intel-rapl:0:0": ("core", "262143328850", "400000"),
        "intel-rapl:1": ("package-1", "262143328850", "800000"),
        "psys-0": ("psys", "1000000", "123456"),
    }
    for zone, (name, max_uj, uj) in zones.items():
        d = root / zone
        d.mkdir(parents=True)
        (d / "name").write_text(name + "\n")
        (d / "max_energy_range_uj").write_text(max_uj + "\n")
        (d / "energy_uj").write_text(uj + "\n")
    # a zone with a corrupt declared range must be skipped, not fatal
    bad = root / "intel-rapl:2"
    bad.mkdir()
    (bad / "name").write_text("package-2\n")
    (bad / "max_energy_range_uj").write_text("garbage\n")
    (bad / "energy_uj").write_text("1\n")
    return root


def _hwmon_tree(tmp_path):
    root = tmp_path / "hwmon"
    gpu = root / "hwmon0"
    gpu.mkdir(parents=True)
    (gpu / "name").write_text("amdgpu\n")
    (gpu / "power1_input").write_text("25000000\n")      # 25 W
    cpu = root / "hwmon1"
    cpu.mkdir()
    (cpu / "name").write_text("amd_energy\n")
    (cpu / "energy1_input").write_text("123000000\n")    # 123 J
    return root


def _counter_trace(name, p_w=20.0, span=2.0, dt=0.005, wrap_range=0.0,
                   pkg="port"):
    """Constant-power cumulative counter, optionally wrapping at the
    DECLARED ``wrap_range`` joules."""
    spec_cls, trace_cls = ((SensorSpec, SensorTrace) if pkg == "port"
                           else (JSpec, JTrace))
    t = np.arange(0.0, span + dt / 2, dt)
    v = p_w * t
    if wrap_range:
        v = np.mod(v, wrap_range)
    spec = spec_cls(name=name, scope="chip", kind="energy_cum",
                    quantum=1e-6, wrap_range_j=wrap_range)
    return trace_cls(name, spec, t, t.copy(), v)


def _sim_traces(pkg):
    spec_cls, trace_cls = ((SensorSpec, SensorTrace) if pkg is ting
                           else (JSpec, JTrace))
    power = trace_cls(
        "gpu0.power", spec_cls(name="gpu0.power", scope="chip",
                               kind="power_inst"),
        np.asarray([0.0, 0.1]), np.asarray([0.0, 0.1]),
        np.asarray([50.0, 55.0]))
    return {"gpu0.energy": _counter_trace(
        "gpu0.energy", wrap_range=64.0,
        pkg="port" if pkg is ting else "ref"), "gpu0.power": power}


def _make_backend(kind, pkg, tmp_path):
    if kind == "rocm":
        return _rocm(pkg)
    if kind == "amd":
        return _amd(pkg)
    if kind == "rapl":
        return pkg.RaplBackend(root=_rapl_tree(tmp_path / pkg.__name__))
    if kind == "hwmon":
        return pkg.HwmonBackend(root=_hwmon_tree(tmp_path / pkg.__name__))
    if kind == "sim":
        return pkg.SimBackend(_sim_traces(pkg), speed=1e6)
    raise AssertionError(kind)


BACKENDS = ["rocm", "amd", "rapl", "hwmon", "sim"]


# ------------------------------------------------ backends

@pytest.mark.parametrize("kind", BACKENDS)
def test_backend_conformance(kind, tmp_path):
    """Every port adapter honours the protocol: cached discovery, specs
    with declared counter semantics, SI readings, and BackendError (not
    crashes) on unknown metrics."""
    backend = _make_backend(kind, ting, tmp_path)
    specs = backend.discover()
    assert specs and backend.available()
    assert backend.discover() == specs
    assert backend.rediscover() == specs
    for sp in specs:
        assert isinstance(sp, ting.MetricSpec)
        assert sp.source == backend.name
        assert backend.spec(sp.metric) == sp
        if sp.is_cumulative:
            assert sp.wrap_range_j > 0.0, sp.metric
            assert sp.sensor_spec().wrap_period_j \
                == pytest.approx(sp.wrap_range_j)
        r = backend.read(sp.metric)
        assert isinstance(r, ting.Reading)
        assert r.metric == sp.metric and r.source == backend.name
        assert np.isfinite(r.value)
    with pytest.raises(ting.BackendError):
        backend.read("nonexistent.metric")
    with pytest.raises(ting.BackendError):
        backend.spec("nonexistent.metric")
    backend.close()


@pytest.mark.parametrize("kind", BACKENDS)
def test_backend_declarations_and_reads_match_reference(kind, tmp_path):
    """Both packages' adapters declare the same specs (and the same
    core ``SensorSpec``) and read the same SI values from one fixture."""
    port = _make_backend(kind, ting, tmp_path)
    ref = _make_backend(kind, jing, tmp_path)
    ps, rs = port.discover(), ref.discover()
    assert [dataclasses.asdict(s) for s in ps] \
        == [dataclasses.asdict(s) for s in rs]
    for a, b in zip(ps, rs):
        assert dataclasses.asdict(a.sensor_spec()) \
            == dataclasses.asdict(b.sensor_spec())
        assert port.read(a.metric).value == ref.read(b.metric).value


def test_rocm_smi_resolution_recovered_from_counter_ratio():
    b = _rocm(ting)
    sp = b.spec("gpu0.energy")
    assert sp.resolution_j == pytest.approx(15.259e-6)
    assert sp.wrap_range_j == pytest.approx(
        (2.0 ** ACCUMULATOR_BITS) * 15.259e-6)
    assert b.read("gpu0.energy").value == pytest.approx(15.259)
    assert b.read("gpu0.power").value == pytest.approx(97.0)
    assert b.read("gpu1.power").value == pytest.approx(105.5)
    assert {sp.metric for sp in b.discover()} == {
        "gpu0.energy", "gpu1.energy", "gpu0.power", "gpu1.power"}


def test_rocm_smi_default_resolution_without_ticks():
    b = _rocm(ting, {"card0": {"Accumulated Energy (uJ)": "100.0"}}, {})
    assert b.spec("gpu0.energy").resolution_j \
        == pytest.approx(DEFAULT_RESOLUTION_UJ * 1e-6)


def test_amd_smi_resolution_verbatim_and_from_ratio():
    b = _amd(ting)
    sp = b.spec("gpu0.energy")
    assert sp.resolution_j == pytest.approx(15.259e-6)
    assert b.read("gpu0.energy").value == pytest.approx(123.5)
    assert b.read("gpu0.power").value == pytest.approx(150.0)
    doc = [{"gpu": 0, "energy": {
        "total_energy_consumption": {"value": 100.0, "unit": "J"},
        "energy_accumulator": 50}}]
    assert _amd(ting, doc, []).spec("gpu0.energy").resolution_j \
        == pytest.approx(2.0)


def test_smi_accumulator_wrap_unwraps_with_declared_period():
    period = _rocm(ting).spec("gpu0.energy").sensor_spec().wrap_period_j
    un = unwrap_counter(np.asarray([period - 1.0, 1.0]), period=period)
    assert un[1] - un[0] == pytest.approx(2.0)


def test_smi_disabled_via_env(monkeypatch):
    monkeypatch.setenv("REPRO_INGEST_DISABLE", "rocm-smi")
    assert not _rocm(ting).available()


def test_rocm_smi_non_contiguous_cards_map_to_discovery():
    energy = {"card0": {"Energy counter": "1000000",
                        "Accumulated Energy (uJ)": "15259000.0"},
              "card2": {"Energy counter": "2000000",
                        "Accumulated Energy (uJ)": "30518000.0"}}
    power = {"card2": {"Average Graphics Package Power (W)": "42.0"}}
    b = _rocm(ting, energy, power)
    assert {sp.metric for sp in b.discover()} == {
        "gpu0.energy", "gpu1.energy", "gpu1.power"}
    assert b.read("gpu1.energy").value == pytest.approx(30.518)
    assert b.read("gpu1.power").value == pytest.approx(42.0)
    with pytest.raises(ting.BackendError):
        b.read("gpu0.power")


def test_rapl_zone_naming_and_declared_wrap(tmp_path):
    root = _rapl_tree(tmp_path)
    b = ting.RaplBackend(root=root)
    metrics = {sp.metric: sp for sp in b.discover()}
    assert set(metrics) == {"cpu0.energy", "cpu0.core.energy",
                            "cpu1.energy", "psys.energy"}
    assert metrics["cpu0.energy"].wrap_range_j \
        == pytest.approx(262143.32885)
    assert b.read("cpu0.energy").value == pytest.approx(0.9)
    sp = b.spec("psys.energy")
    v0 = b.read("psys.energy").value
    (root / "psys-0" / "energy_uj").write_text("900000\n")
    v1 = b.read("psys.energy").value
    (root / "psys-0" / "energy_uj").write_text("100000\n")   # wrapped
    v2 = b.read("psys.energy").value
    un = unwrap_counter(np.asarray([v0, v1, v2]),
                        period=sp.sensor_spec().wrap_period_j)
    assert un[2] - un[1] == pytest.approx(0.2)
    assert np.all(np.diff(un) > 0)


def test_hwmon_channels_scales_and_gpu_mapping(tmp_path):
    b = ting.HwmonBackend(root=_hwmon_tree(tmp_path))
    metrics = {sp.metric: sp for sp in b.discover()}
    assert set(metrics) == {"gpu0.power", "amd_energy1.energy"}
    assert b.read("gpu0.power").value == pytest.approx(25.0)
    assert metrics["amd_energy1.energy"].wrap_range_j \
        == pytest.approx((2.0 ** 64) * 1e-6)
    assert b.read("amd_energy1.energy").value == pytest.approx(123.0)


def test_backends_unavailable_on_missing_roots(tmp_path):
    assert not ting.RaplBackend(root=tmp_path / "nope").available()
    assert not ting.HwmonBackend(root=tmp_path / "nope").available()


def test_discover_backends_reads_env_roots(tmp_path, monkeypatch):
    """``discover_backends`` keeps the backends that declare a metric:
    the sysfs roots come from the environment, as in the reference."""
    monkeypatch.setenv("REPRO_RAPL_ROOT", str(_rapl_tree(tmp_path)))
    monkeypatch.setenv("REPRO_HWMON_ROOT", str(_hwmon_tree(tmp_path)))
    got = ting.discover_backends(include=["rapl", "hwmon", "rocm-smi"],
                                 sim_traces=[_counter_trace("gpu0.e")])
    want = jing.discover_backends(
        include=["rapl", "hwmon", "rocm-smi"],
        sim_traces=[_counter_trace("gpu0.e", pkg="ref")])
    assert [b.name for b in got] == [b.name for b in want]
    assert [sp.metric for b in got for sp in b.discover()] \
        == [sp.metric for b in want for sp in b.discover()]


def test_default_backend_order_env(monkeypatch):
    monkeypatch.delenv("REPRO_INGEST_PRIORITY", raising=False)
    assert ting.default_backend_order() == jing.default_backend_order()
    monkeypatch.setenv("REPRO_INGEST_PRIORITY", "rapl , sim")
    assert ting.default_backend_order() == ["rapl", "sim"]


def test_sim_backend_replays_like_reference():
    clk = _Clock()
    port = ting.SimBackend(_sim_traces(ting), speed=2.0, clock=clk)
    ref = jing.SimBackend(_sim_traces(jing), speed=2.0, clock=clk)
    for dt in (0.0, 0.01, 0.02, 0.5, 1.0):
        clk.tick(dt)
        for m in ("gpu0.energy", "gpu0.power"):
            assert dataclasses.asdict(port.read(m)) \
                == dataclasses.asdict(ref.read(m))
        assert port.drained == ref.drained


# ------------------------------------------------ prioritized ingest

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt
        return self.t


def _fake_backend(pkg, name, metrics=("m",), clock=None, fail=False):
    """Scriptable backend of package ``pkg``: togglable failure,
    counting reads."""
    class Fake(pkg.SensorBackend):
        def _discover(self):
            return [pkg.MetricSpec(m, "energy_cum", wrap_range_j=1e3,
                                   resolution_j=1e-6, source=self.name)
                    for m in self._metrics]

        def read(self, metric):
            self.reads += 1
            if self.fail:
                raise pkg.BackendError(f"{self.name} is down")
            if metric not in self._metrics:
                raise pkg.BackendError(f"unknown {metric!r}")
            self._v += 1.0
            t = self._clock()
            return pkg.Reading(metric, t, t, self._v, self.name)

    b = Fake(clock=clock or _Clock())
    b.name, b._metrics, b.fail, b.reads, b._v = name, list(metrics), \
        fail, 0, 0.0
    return b


def _read(ing, metric, log):
    try:
        log.append(("read", dataclasses.asdict(ing.read(metric))))
    except Exception as exc:           # noqa: BLE001 - logged by type
        log.append(("raise", type(exc).__name__))


def _script(pkg, name):
    """One read script through ``pkg``'s PrioritizedIngest -> the log
    of readings/raises, then the counters and every event."""
    clk = _Clock()
    log, sink = [], []
    if name == "fallback":
        a = _fake_backend(pkg, "a", clock=clk, fail=True)
        b = _fake_backend(pkg, "b", clock=clk)
        ing = pkg.PrioritizedIngest([a, b], clock=clk)
        _read(ing, "m", log)
    elif name == "demote-retry-recover":
        a = _fake_backend(pkg, "a", clock=clk, fail=True)
        b = _fake_backend(pkg, "b", clock=clk)
        ing = pkg.PrioritizedIngest(
            [a, b], clock=clk, events=sink,
            policy=pkg.IngestPolicy(error_budget=2, retry_after_s=5.0))
        for _ in range(3):
            _read(ing, "m", log)
        log.append(("a_reads", a.reads))
        clk.tick(6.0)                   # past retry_after_s
        _read(ing, "m", log)            # still failing: re-demoted
        clk.tick(6.0)
        a.fail = False
        _read(ing, "m", log)            # recovers
        log.append(("a_reads", a.reads))
    elif name == "stale-cache":
        a = _fake_backend(pkg, "a", clock=clk)
        ing = pkg.PrioritizedIngest(
            [a], clock=clk,
            policy=pkg.IngestPolicy(stale_ttl_s=0.25, error_budget=99))
        _read(ing, "m", log)
        a.fail = True
        clk.tick(0.1)
        _read(ing, "m", log)            # cached
        clk.tick(1.0)
        _read(ing, "m", log)            # stale: unavailable
    elif name == "override":
        a = _fake_backend(pkg, "a", clock=clk)
        b = _fake_backend(pkg, "b", clock=clk)
        ing = pkg.PrioritizedIngest([a, b], priority={"m": ["b", "a"]},
                                    clock=clk)
        log.append(("providers", [x.name for x in ing.providers("m")]))
        log.append(("spec", ing.spec("m").source))
        _read(ing, "m", log)
        _read(ing, "nope", log)
    elif name == "budget-1-sink":
        a = _fake_backend(pkg, "a", clock=clk, fail=True)
        b = _fake_backend(pkg, "b", clock=clk)
        ing = pkg.PrioritizedIngest(
            [a, b], clock=clk, events=sink.append,
            policy=pkg.IngestPolicy(error_budget=1))
        _read(ing, "m", log)
        log.append(("read_all", sorted(ing.read_all())))
    else:
        raise AssertionError(name)
    events = [dataclasses.asdict(e) for e in ing.events]
    return log, ing.counters, ing.n_reads, events, \
        [dataclasses.asdict(e) for e in sink]


SCRIPTS = ["fallback", "demote-retry-recover", "stale-cache", "override",
           "budget-1-sink"]


@pytest.mark.parametrize("name", SCRIPTS)
def test_prioritized_ingest_matches_reference(name):
    """The same read script under a fake clock gives equal readings,
    raises, counters and event sequences in both packages."""
    assert _script(ting, name) == _script(jing, name)


def test_priority_demotion_retry_and_recovery_events():
    log, counters, _, events, sink = _script(ting, "demote-retry-recover")
    assert counters["a"]["demotions"] == 1
    assert counters["a"]["recoveries"] == 1
    assert [e["state_to"] for e in events] == [QUARANTINED, HEALTHY]
    assert events[0]["kind"] == "ingest" and events[0]["name"] == "a:m"
    assert "recovered" in events[1]["flags"] and sink == events
    assert [x for x in log if x[0] == "a_reads"] == [("a_reads", 2),
                                                     ("a_reads", 4)]


def test_cache_serves_last_good_until_stale():
    log, counters, _, _, _ = _script(ting, "stale-cache")
    assert log[1][0] == "read" and log[1][1]["cached"]
    assert log[1][1]["value"] == log[0][1]["value"]
    assert log[2] == ("raise", "IngestUnavailable")
    assert counters["a"]["cache_hits"] == 1


def test_provider_lookup_follows_rediscovery():
    """The port looks a metric up in an index of the cached discovery
    (the reference scans every declared metric per read): the providers
    and specs it finds are the reference's, before and after a
    ``rediscover()`` changes what a backend declares."""
    got = {}
    for key, pkg in (("port", ting), ("ref", jing)):
        clk = _Clock()
        a = _fake_backend(pkg, "a", metrics=("m", "n"), clock=clk)
        b = _fake_backend(pkg, "b", metrics=("n",), clock=clk)
        ing = pkg.PrioritizedIngest([a, b], clock=clk)
        log = [[x.name for x in ing.providers(m)] for m in ("m", "n", "o")]
        a._metrics = ["o"]               # hot-plug: a now offers o only
        log.append([x.name for x in ing.providers("m")])   # still cached
        a.rediscover()
        log += [[x.name for x in ing.providers(m)] for m in ("m", "n", "o")]
        log.append(dataclasses.asdict(ing.spec("o")))
        log.append(sorted(ing.metrics()))
        got[key] = log
    assert got["port"] == got["ref"]
    assert got["port"][4:7] == [[], ["b"], ["a"]]


def test_ingest_counters_export_like_reference():
    """``track_ingest`` through the port's registry gives the reference's
    Prometheus text.  Its scalar ``ingest_reads_total`` and the
    per-backend ``reads`` counter share one name, so ``json_snapshot``
    of such a registry raises in both packages (ROADMAP C)."""
    clk = _Clock()
    out = {}
    for key, pkg, reg in (("port", ting, HealthRegistry()),
                          ("ref", jing, JRegistry())):
        ing = pkg.PrioritizedIngest(
            [_fake_backend(pkg, "a", clock=clk, fail=True),
             _fake_backend(pkg, "b", clock=clk)], clock=clk, registry=reg)
        ing.read("m")
        with pytest.raises(AttributeError):
            reg.json_snapshot()
        out[key] = reg.prometheus_text()
    assert out["port"] == out["ref"]
    assert "ingest_reads_total" in out["port"]
    assert 'backend="a"' in out["port"]


# ------------------------------------------------ reader + async pump

def _reader_script(pkg, t_stop=False):
    clk = _Clock()
    a = _fake_backend(pkg, "a", clock=clk)
    ing = pkg.PrioritizedIngest([a], clock=clk)
    rd = pkg.BackendReader(ing, "m", t_stop=clk.t + 0.6 if t_stop
                           else None)
    out = []

    def poll():
        t, v = rd.poll(clk())
        out.append((t.tolist(), v.tolist(), rd.n_dupes,
                    rd.n_unavailable, rd.drained))

    poll()
    poll()                              # frozen clock: deduped
    clk.tick(0.5)
    poll()
    clk.tick(-0.2)                      # tool clock stepped back: kept
    poll()
    poll()                              # republished: deduped
    clk.tick(0.5)
    poll()
    a.fail = True
    clk.tick(10.0)                      # cache stale too
    poll()
    rd.stop()
    out.append(rd.drained)
    return out


@pytest.mark.parametrize("t_stop", [False, True], ids=["open", "t_stop"])
def test_backend_reader_matches_reference(t_stop):
    """Dedupe of equal timestamps, reorders forwarded, unavailable polls
    counted and the ``t_stop`` frontier, equal in both packages."""
    got = _reader_script(ting, t_stop)
    assert got == _reader_script(jing, t_stop)
    if t_stop:
        assert got[-3][-1]              # reached t_stop: drained
    else:
        assert got[1][2] == 1 and got[6][3] == 1 and not got[6][4]


class _ListReader:
    """Replays scripted (t, v) poll batches."""

    def __init__(self, batches):
        self._batches = [(np.asarray(t, np.float64),
                          np.asarray(v, np.float64))
                         for t, v in batches]

    def poll(self, now_wall):
        if self._batches:
            return self._batches.pop(0)
        return np.empty((0,)), np.empty((0,))

    @property
    def drained(self):
        return not self._batches


class _CapStream:
    """Records every block a pump hands over, valid mask included."""

    def __init__(self):
        self.calls = []

    def update(self, t, e, valid=None):
        self.calls.append((np.array(t), np.array(e),
                           None if valid is None else np.array(valid)))


TT = np.linspace(0.0, 2.0, 9)
# reader batches per row, and the polls made before the first flush
PUMP_SCRIPTS = {
    "dedupe": ([[
        ([1.0, 1.0, 2.0, 2.0, 3.0], [10.0, 10.0, 20.0, 20.0, 30.0]),
        ([3.0, 4.0], [30.0, 40.0]),     # cross-poll re-delivery
        ([5.0, 4.5], [50.0, 45.0]),     # genuine reorder: kept
    ]], 3),
    "dead-row": ([[(TT[:5], 10.0 * TT[:5]), (TT[5:], 10.0 * TT[5:])],
                  []], 1),
    "late-row": ([[(TT[:5], 10.0 * TT[:5]), (TT[5:], 10.0 * TT[5:])],
                  [(np.empty((0,)), np.empty((0,))),
                   ([1.0, 1.5, 2.0], [500.0, 505.0, 510.0])]], 1),
}


def _pump(pkg, name, chunk, stream=None):
    batches, polls = PUMP_SCRIPTS[name]
    cap = _CapStream() if stream is None else stream
    pump = pkg.AsyncFleetIngest([_ListReader(b) for b in batches], cap,
                                t0=0.0, chunk=chunk)
    for _ in range(polls):
        pump._poll_once()
    pump._flush()
    pump.stop()                         # drains what is left
    return getattr(cap, "calls", None), pump


def _blocks_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, w in zip(x, y):
            if w is None:
                assert u is None
            else:
                assert u.dtype == w.dtype
                np.testing.assert_array_equal(u, w)


@pytest.mark.parametrize("name", list(PUMP_SCRIPTS))
def test_async_ingest_blocks_match_reference(name):
    """Dedupe, replicate-last padding, the float32 cast and the masked
    zero-width placeholders of dark rows: the port's pump hands the
    same blocks to a recording stub as the reference's."""
    chunk = 8 if name == "dedupe" else 4
    got, pump = _pump(ting, name, chunk)
    want, jpump = _pump(jing, name, chunk)
    _blocks_equal(got, want)
    assert (pump.n_dupes, pump.n_chunks, pump.bounds) \
        == (jpump.n_dupes, jpump.n_chunks, jpump.bounds)
    assert got[0][0].dtype == np.float32
    if name == "dedupe":
        assert pump.n_dupes == 3
        np.testing.assert_allclose(
            got[0][0][0], [1.0, 2.0, 3.0, 4.0, 5.0, 4.5, 4.5, 4.5])
    else:                               # the dark row's first block
        assert not got[0][2][1].any() and got[0][2][0].all()


def test_async_ingest_jitter_and_readers_validated():
    with pytest.raises(AssertionError):
        ting.AsyncFleetIngest([_ListReader([])], _CapStream(), t0=0.0,
                              jitter=1.5)
    with pytest.raises(AssertionError):
        ting.AsyncFleetIngest([], _CapStream(), t0=0.0)


@pytest.mark.parametrize("name", ["dead-row", "late-row"])
def test_async_ingest_fleet_stream_energy(name):
    """Through the port's FleetStream (its fleet_attribute plain version
    on the CPU): a dead row costs exactly zero and does not stall the
    drain; a late row seeds at its first real sample (10 J, not 510)."""
    stream = FleetStream([(0.0, 3.0)], 2, wrap_period=[0.0, 0.0],
                         device=CPU)
    _pump(ting, name, 4, stream)
    totals = np.asarray(stream.totals(), np.float64)
    assert totals[0].sum() == pytest.approx(20.0)
    assert totals[1].sum() == (0.0 if name == "dead-row"
                               else pytest.approx(10.0))


def _pipes(n):
    kw = dict(grid_origin=0.0, grid_step=0.05, kind_row=[True] * n,
              wrap_period=[0.0] * n, delays=np.zeros(n), window=64,
              hop=16, tail=64)
    return (StreamingFusedPipeline([1] * n, [(0.0, 1.0), (1.0, 2.5)],
                                   device=CPU, **kw),
            JPipe([1] * n, [(0.0, 1.0), (1.0, 2.5)], **kw))


@pytest.mark.parametrize("name", ["dead-row", "late-row"])
def test_recorded_blocks_agree_through_both_pipelines(name):
    """The pump's recorded blocks (masked placeholders included) through
    the port's pipeline and the reference's agree within 1e-5."""
    calls, _ = _pump(ting, name, 4)
    port, ref = _pipes(2)
    for t, e, valid in calls:
        port.update(t, e, valid)
        ref.update(t, e, valid)
    port.finalize()
    ref.finalize()
    got, want = port.totals().numpy(), ref.totals()
    assert np.isfinite(got).all() and got[0].sum() > 0.0
    assert np.abs(got - want).max() <= E_TOL * max(np.abs(want).max(), 1)


def test_simulated_smi_reader_shutdown_conservation():
    """The port's SimulatedSMIReader + pump thread conserve counter
    energy through stop(): stream totals equal the unwrapped first->last
    counter delta."""
    from repro_torch.core import ToolSpec as TTool
    from repro_torch.core import simulate_sensor as tsim
    from repro_torch.core import square_wave as tsquare
    truth = tsquare(1.0, 2, lead_s=0.5, tail_s=0.5)
    spec = SensorSpec(name="e0", scope="chip", kind="energy_cum",
                      quantum=1e-6, wrap_bits=26)
    tr = tsim(spec, TTool(0.9e-3), truth, seed=0)
    reader = ting.SimulatedSMIReader(tr, speed=64.0)
    t0 = float(tr.t_measured[0])
    span = float(tr.t_measured[-1]) - t0
    stream = FleetStream([(0.0, span + 1.0)], 1,
                         wrap_period=[tr.spec.wrap_period_j], device=CPU)
    pump = ting.AsyncFleetIngest([reader], stream, t0, chunk=64,
                                 interval_s=1e-3).start()
    deadline = time.perf_counter() + 30.0
    while not reader.drained and time.perf_counter() < deadline:
        time.sleep(1e-3)
    pump.stop()
    assert reader.drained and pump.n_chunks >= 2
    assert pump.n_dupes > 0
    un = unwrap_counter(tr.value, period=tr.spec.wrap_period_j)
    expect = float(un[-1] - un[0])
    got = float(np.asarray(stream.totals())[0].sum())
    assert abs(got - expect) <= max(1e-3 * abs(expect), 1e-3), \
        (got, expect)


def test_simulated_smi_reader_polls_like_reference():
    truth = square_wave(0.5, 1, lead_s=0.1, tail_s=0.1)
    tr = simulate_sensor(JSpec(name="e0", scope="chip", kind="energy_cum",
                               quantum=1e-6), ToolSpec(1e-3), truth, seed=1)
    port = ting.SimulatedSMIReader(interop.trace_from_fields(
        tr.name, dataclasses.asdict(tr.spec), tr.t_read, tr.t_measured,
        tr.value), speed=4.0)
    ref = jing.SimulatedSMIReader(tr, speed=4.0)
    for now in (10.0, 10.01, 10.05, 10.05, 10.2, 11.0):
        a, b = port.poll(now), ref.poll(now)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert port.drained == ref.drained


# ------------------------------------------------ live e2e: mid-run kill

class _Killable(ting.SensorBackend):
    """Proxy over a SimBackend that dies after ``n_ok`` reads."""

    name = "sim-primary"

    def __init__(self, inner, n_ok):
        super().__init__(clock=inner._clock)
        self._inner = inner
        self._n_ok = n_ok
        self.reads = 0

    def _discover(self):
        return [dataclasses.replace(sp, source=self.name)
                for sp in self._inner.discover()]

    def read(self, metric):
        self.reads += 1
        if self.reads > self._n_ok:
            raise ting.BackendError("killed mid-run")
        return dataclasses.replace(self._inner.read(metric),
                                   source=self.name)


class _ChainedSim(ting.SimBackend):
    """SimBackend sharing a leader's replay origin, so a fallback read
    continues exactly where the dead backend stopped."""

    name = "sim-backup"

    def __init__(self, traces, leader, **kw):
        super().__init__(traces, **kw)
        self._leader = leader

    def _t_sim(self):
        if self._leader._t0_wall is not None:
            self._t0_wall = self._leader._t0_wall
        return super()._t_sim()


def test_live_backend_kill_falls_back_without_dropping_windows():
    """Killing the preferred backend mid-run falls down the priority
    list without an unavailable poll or a lost window; phase energies
    match the constant-power truth (the reference's acceptance test, on
    the port's pipeline with ``device="cpu"``)."""
    p_w, span = 20.0, 2.0
    tr = _counter_trace("gpu0.energy", p_w=p_w, span=span, dt=0.005,
                        wrap_range=15.0)       # wraps ~2x mid-capture
    inner = ting.SimBackend({"gpu0.energy": tr}, speed=8.0)
    primary = _Killable(inner, n_ok=25)
    backup = _ChainedSim({"gpu0.energy": tr}, leader=inner, speed=8.0)
    ingest = ting.PrioritizedIngest(
        [primary, backup],
        policy=ting.IngestPolicy(error_budget=1, retry_after_s=60.0,
                                 stale_ttl_s=0.05))
    res = ting.attribute_live(
        [("first", 0.0, 1.0), ("second", 1.0, 2.0)], duration_s=0.6,
        ingest=ingest, metrics=["gpu0.energy"], chunk=16,
        interval_s=2e-3, window=128, hop=64, max_lag=8, tail=64,
        settle_s=2.0, device=CPU)
    assert primary.reads > 25
    assert ingest.counters["sim-primary"]["demotions"] == 1
    assert ingest.counters["sim-backup"]["fallbacks"] > 0
    assert any(e.state_to == QUARANTINED for e in ingest.events)
    assert sum(r.n_unavailable for r in res.readers) == 0
    assert res.pump.n_chunks >= 3
    assert isinstance(res.pipe, StreamingFusedPipeline)
    assert res.totals.dtype == np.float64
    e = res.energies()
    assert abs(e["first"]["gpu0"] - p_w * 1.0) <= 1.0, e
    assert abs(e["second"]["gpu0"] - p_w * 1.0) <= 1.0, e


def test_live_two_sensor_groups_tracked():
    """Two devices of an energy counter and a power sensor each, named
    ``d{i}.energy``/``d{i}.power``: ``_group`` forms two groups of two
    and the tracked chain runs live; per-device energies match the
    constant power of each device."""
    traces = {}
    for d, p_w in enumerate((20.0, 35.0)):
        traces[f"d{d}.energy"] = _counter_trace(f"d{d}.energy", p_w=p_w,
                                                span=2.0)
        t = np.arange(0.0, 2.0025, 0.005)
        traces[f"d{d}.power"] = SensorTrace(
            f"d{d}.power", SensorSpec(name=f"d{d}.power", scope="chip",
                                      kind="power_inst"),
            t, t.copy(), np.full_like(t, p_w))
    sim = ting.SimBackend(traces, speed=8.0)
    res = ting.attribute_live(
        [("a", 0.2, 1.0), ("b", 1.0, 1.8)], duration_s=0.3,
        backends=[sim], metrics=sorted(traces), chunk=16,
        interval_s=2e-3, reference=lambda t: np.ones_like(t),
        window=128, hop=64, max_lag=8, tail=64, settle_s=2.0, device=CPU)
    assert res.groups == ["d0", "d1"]
    assert res.pipe.group_sizes == [2, 2]
    assert res.pipe.align is not None
    assert sum(r.n_unavailable for r in res.readers) == 0
    for name in ("a", "b"):
        for d, p_w in enumerate((20.0, 35.0)):
            assert res.energies()[name][f"d{d}"] \
                == pytest.approx(0.8 * p_w, rel=0.05)


def test_attribute_live_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ting.attribute_live(duration_s=0.1, backends=[
            ting.SimBackend([_counter_trace("gpu0.energy")])])


# ------------------------------------------------ LiveSampler

def test_live_sampler_ring_and_flush():
    clock = itertools.count()
    sm = LiveSampler(lambda t: 2.0 * t, interval_s=0.0,
                     timebase=lambda: float(next(clock)), max_samples=4)
    # drive the poll loop inline (no thread): emulate _run iterations
    for _ in range(7):
        t = float(next(clock))
        if len(sm.t_read) >= sm.max_samples:
            sm.t_read.popleft()
            sm.values.popleft()
            sm.dropped += 1
        sm.t_read.append(t)
        sm.values.append(2.0 * t)
    assert sm.dropped == 3 and len(sm.t_read) == 4
    t, v = sm.flush()
    assert t.shape == (4,)
    np.testing.assert_allclose(v, 2.0 * t)
    assert len(sm.t_read) == 0


def test_live_sampler_thread_keeps_the_newest_ring():
    sm = LiveSampler(lambda t: 1.0, interval_s=1e-4, max_samples=8)
    sm.start()
    deadline = time.perf_counter() + 5.0
    while sm.dropped == 0 and time.perf_counter() < deadline:
        time.sleep(1e-3)
    t, v = sm.stop()
    assert sm.dropped > 0 and len(t) == 8
    assert np.all(np.diff(t) > 0) and np.all(v == 1.0)


def test_registry_tracks_tracer_and_sampler_like_reference():
    from repro.core.tracing import LiveSampler as JSampler
    from repro.core.tracing import RegionTracer as JTracer
    out = {}
    for key, reg, tracer_cls, sampler_cls in (
            ("port", HealthRegistry(), RegionTracer, LiveSampler),
            ("ref", JRegistry(), JTracer, JSampler)):
        tr = tracer_cls(max_events=2)
        reg.track_tracer("serve", tr)
        for k in range(5):
            tr.add_region(f"r{k}", float(k), k + 0.5)
        sm = sampler_cls(lambda t: 1.0, max_samples=3)
        reg.track_sampler("node", sm)
        out[key] = (reg.json_snapshot(), reg.prometheus_text())
        evs = tr.flush()
        assert [e.name for e in evs] == ["r3", "r4"]
        assert not tr.events and tr.dropped == 3
    assert out["port"] == out["ref"]
    snap = out["port"][0]
    assert snap["tracer_events"] == {"serve": 2.0}
    assert snap["tracer_dropped_total"] == {"serve": 3.0}
    assert snap["sampler_samples"] == {"node": 0.0}
