"""PyTorch port, the windowed fused-attribution pipeline: the port (its
kernels' plain versions on the CPU) against the JAX windowed engine and
the JAX batch path on the same seeded traces, state carried across from
a JAX run, the host-side modules byte for byte, the checkpoint option,
and the options the port does not run yet (health, data quality,
metering and the registry are held against the reference in
``test_torch_health.py`` and ``test_torch_serve.py``, the scan engine
and the host mirror in ``test_torch_scan.py``)."""
import dataclasses
import warnings

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
from repro.fleet.config import resolve_config as jax_resolve_config
from repro_torch import interop
from repro_torch.fleet import pipeline as tpl
from repro_torch.fleet import (CheckpointConfig, PipelineConfig,
                               StreamConfig, TrackConfig,
                               attribute_energy_fused_streaming,
                               resolve_config)

CPU = "cpu"

# the test workers share the machine's cores: keep torch from taking them all
torch.set_num_threads(2)


def _sim_groups(n_devices, seed=0, span_s=4.5, noise=3.0):
    """The reference's test recipe: per device a wrapping energy counter
    and a noisy power sensor, distinct configured delays."""
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


def _phases(grid, n=6):
    edges = np.linspace(float(grid[0]), float(grid[-1]), n + 1)
    return [(f"p{k}", float(a), float(b))
            for k, (a, b) in enumerate(zip(edges[:-1], edges[1:]))]


def _worst(a, b):
    return max(abs(x.energy_j - y.energy_j) / max(abs(y.energy_j), 1.0)
               for ra, rb in zip(a, b) for x, y in zip(ra, rb))


@pytest.fixture(scope="module")
def case():
    from repro.align import align_and_fuse
    truth, groups = _sim_groups(4)
    fused = align_and_fuse(groups, reference=truth)
    grid = fused[0].grid
    delays = np.concatenate([fs.delays for fs in fused])
    return dict(truth=truth, groups=groups, grid=grid, delays=delays,
                phases=_phases(grid), port_groups=_port_groups(groups),
                port_truth=interop.power_from_arrays(truth.times,
                                                     truth.watts))


@pytest.mark.parametrize("chunk", [257, 512])
@pytest.mark.parametrize("tracked", [False, True])
def test_windowed_matches_jax_windowed(case, chunk, tracked):
    """Per-phase energies <= 1e-5; tracked delay histories within 1e-3
    grid steps."""
    if tracked:
        jcfg = JCfg(stream=JStream(chunk=chunk))
        want, jpipe = jax_streaming(case["groups"], case["phases"],
                                    config=jcfg, reference=case["truth"],
                                    return_pipe=True)
        got, tpipe = attribute_energy_fused_streaming(
            case["port_groups"], case["phases"],
            config=PipelineConfig(stream=StreamConfig(chunk=chunk)),
            reference=case["port_truth"], return_pipe=True, device=CPU)
        hj = np.array([h.ema for h in jpipe.delay_history])
        ht = np.array([h.ema.numpy() for h in tpipe.delay_history])
        assert hj.shape == ht.shape and len(hj) >= 4
        step = jpipe.align.step
        assert np.abs(hj - ht).max() / step <= 1e-3
        np.testing.assert_array_equal(
            [h.t_lo for h in jpipe.delay_history],
            [h.t_lo for h in tpipe.delay_history])
        for wt, wj in zip(tpipe.weights(), jpipe.weights()):
            np.testing.assert_allclose(wt.numpy(), wj, rtol=1e-5)
        np.testing.assert_allclose(tpipe.delays().numpy(),
                                   jpipe.delays(), rtol=0, atol=1e-3 * step)
    else:
        want = jax_streaming(
            case["groups"], case["phases"],
            config=JCfg(stream=JStream(chunk=chunk, grid=case["grid"]),
                        track=JTrack(delays=case["delays"])))
        got = attribute_energy_fused_streaming(
            case["port_groups"], case["phases"],
            config=PipelineConfig(
                stream=StreamConfig(chunk=chunk, grid=case["grid"]),
                track=TrackConfig(delays=case["delays"])), device=CPU)
    assert _worst(got, want) <= 1e-5


def test_self_reference_tracking_matches_jax(case):
    """No reference schedule: each device's first stream is its group's
    reference (one xcorr launch per group), as in the JAX engine."""
    phases = [("a", 0.8, 1.8), ("b", 2.0, 3.6)]
    want, jpipe = jax_streaming(case["groups"], phases,
                                config=JCfg(stream=JStream(chunk=512)),
                                return_pipe=True)
    got, tpipe = attribute_energy_fused_streaming(
        case["port_groups"], phases,
        config=PipelineConfig(stream=StreamConfig(chunk=512)),
        return_pipe=True, device=CPU)
    assert _worst(got, want) <= 1e-5
    hj = np.array([h.ema for h in jpipe.delay_history])
    ht = np.array([h.ema.numpy() for h in tpipe.delay_history])
    assert np.abs(hj - ht).max() / jpipe.align.step <= 1e-3


@pytest.mark.parametrize("chunk", [257, 512])
def test_windowed_matches_jax_batch(case, chunk):
    """The port's replay == JAX batch align_and_fuse ->
    attribute_energy_fused on the same grid and delays, <= 1e-5."""
    from repro.align import attribute_energy_fused
    want = attribute_energy_fused(case["groups"], case["phases"],
                                  grid=case["grid"], delays=case["delays"])
    got = attribute_energy_fused_streaming(
        case["port_groups"], case["phases"],
        config=PipelineConfig(
            stream=StreamConfig(chunk=chunk, grid=case["grid"]),
            track=TrackConfig(delays=case["delays"])), device=CPU)
    assert _worst(got, want) <= 1e-5


def _jax_state(pipe):
    """The JAX pipeline's carries as plain numpy (interop's schema)."""
    def tail(t):
        c = t.carry
        return None if c is None else {"t": c.t, "v": c.v,
                                       "dropped_t": c.dropped_t}
    ing, al, fu, at = pipe.ingest, pipe.align, pipe.fuse, pipe.attr
    state = {"ingest": {"t": ing.carry.t, "v": ing.carry.v,
                        "t_first": ing._t_first,
                        "unseeded": ing._unseeded,
                        "dq_late": ing.dq_late,
                        "dq_masked": ing.dq_masked},
             "align": None,
             "fuse": {"next_slot": fu.carry.next_slot, "n_k": fu.carry.n_k,
                      "ssr": fu.carry.ssr, "t_first": fu._t_first,
                      "tail": tail(fu._tail)},
             "attr": {"t_prev": at.carry.t_prev,
                      "integrals": at.carry.integrals}}
    if al is not None:
        c = al.carry
        state["align"] = {"origin": al.origin, "ring_v": c.ring_v,
                          "ring_m": c.ring_m, "next_slot": c.next_slot,
                          "last_est_slot": c.last_est_slot,
                          "delay": c.delay, "seen": c.seen,
                          "tail": tail(al._tail)}
    return state


def test_carry_across_from_jax_midway(case):
    """Run the first half of the windows in JAX, carry every stage's
    state into the port, finish there: the totals match the all-JAX run
    to 1e-5 (tracked mode, so every carry matters)."""
    groups, phases = case["groups"], case["phases"]
    flat = [tr for g in groups for tr in g]
    rows = jpl.pack_stream_rows(flat)
    step = 0.5 * jpl._min_cadence(rows)
    chunk = 257
    tail = jpl.default_tail(rows, chunk, max_lag=64, grid_step=step)
    origin = float(rows.times[:rows.n_streams, 0].astype(np.float64).min())
    truth, t0 = case["truth"], rows.t0
    windows = [(a - t0, b - t0) for _, a, b in phases]
    kw = dict(grid_origin=origin, grid_step=step, kind_row=rows.kind_row,
              reference=lambda t: truth.power_at(t + t0), track=True,
              tail=tail)
    sizes = [len(g) for g in groups]
    blocks = list(jpl.stream_row_windows(rows, chunk))
    half = len(blocks) // 2
    assert half >= 3

    full = jpl.StreamingFusedPipeline(sizes, windows, **kw)
    for t, v in blocks:
        full.update(t, v)
    want = full.finalize().totals()

    first = jpl.StreamingFusedPipeline(sizes, windows, **kw)
    for t, v in blocks[:half]:
        first.update(t, v)
    state = _jax_state(first)
    port = tpl.StreamingFusedPipeline(sizes, windows, device=CPU, **kw)
    interop.load_pipeline_state(port, state)
    # the port's own export round-trips through the same schema
    again = tpl.StreamingFusedPipeline(sizes, windows, device=CPU, **kw)
    interop.load_pipeline_state(again, interop.pipeline_state(port))
    for pipe in (port, again):
        for t, v in blocks[half:]:
            pipe.update(t, v)
        got = pipe.finalize().totals().numpy()
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
        assert rel.max() <= 1e-5, rel.max()


def test_interop_refuses_a_cast(case):
    port = tpl.StreamingFusedPipeline([2], [(0.0, 1.0)], grid_origin=0.0,
                                      grid_step=1e-3, track=False,
                                      delays=np.zeros(2), device=CPU)
    bad = {"next_slot": 0, "n_k": np.zeros(2, np.float32),
           "ssr": np.zeros(2)}
    with pytest.raises(TypeError, match="float32"):
        interop.fuse_carry(bad, port.device)


@pytest.mark.parametrize("option", [
    dict(config=PipelineConfig(stream=StreamConfig(engine="scan",
                                                   interpret=True))),
    dict(config=PipelineConfig(stream=StreamConfig(host=True,
                                                   use_kernel=False))),
    dict(config=PipelineConfig(stream=StreamConfig(use_kernel=False))),
    dict(config=PipelineConfig(stream=StreamConfig(interpret=True))),
], ids=["scan", "host", "no_kernel", "interpret"])
def test_unsupported_options_raise(case, option):
    """The Pallas knobs stay refused on either engine and with the host
    mirror (the scan engine and ``host=True`` run: ``test_torch_scan.py``)."""
    with pytest.raises(NotImplementedError):
        attribute_energy_fused_streaming(case["port_groups"],
                                         case["phases"], device=CPU,
                                         **option)


def test_checkpoint_option_runs(case, tmp_path):
    """``CheckpointConfig`` runs in the port (the kill/resume and
    cross-package cases are in ``test_torch_checkpoint.py``): a run that
    checkpoints every window publishes the last three steps and returns
    what the run without checkpoints does."""
    track = TrackConfig(track=False, delays=case["delays"])
    plain = attribute_energy_fused_streaming(
        case["port_groups"], case["phases"],
        config=PipelineConfig(track=track), device=CPU)
    got, pipe = attribute_energy_fused_streaming(
        case["port_groups"], case["phases"], config=PipelineConfig(
            track=track, checkpoint=CheckpointConfig(dir=str(tmp_path),
                                                     every=1)),
        return_pipe=True, device=CPU)
    assert [[e.energy_j for e in r] for r in got] == \
        [[e.energy_j for e in r] for r in plain]
    w = pipe.pipeline.windows
    assert w >= 3
    for d in ["shared"] + [f"group_{g:05d}" for g in range(4)]:
        assert sorted(p.name for p in (tmp_path / d).iterdir()) == [
            f"step_{s:08d}" for s in range(w - 2, w + 1)]


def test_legacy_kwargs_resolve_like_the_reference():
    legacy = {"chunk": 300, "window": 1024, "hop": 256, "tail": 400,
              "delays": None, "grid_step": 1e-3}
    with pytest.warns(DeprecationWarning, match="chunk= -> PipelineConf"):
        got = resolve_config(None, legacy, "f")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jax_resolve_config(None, legacy, "f")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(TypeError, match="unexpected"):
        resolve_config(None, {"chunks": 3}, "f")
    with pytest.raises(TypeError, match="both"):
        resolve_config(PipelineConfig(), {"chunk": 3}, "f")


def test_simulator_and_packing_byte_identical(case):
    """Same seed, same traces; same packed float32 rows and replay."""
    from repro_torch.core import SensorSpec as TSpec
    from repro_torch.core import ToolSpec as TTool
    from repro_torch.core import simulate_sensor as t_simulate
    spec = case["groups"][1][0].spec
    want = simulate_sensor(spec, ToolSpec(0.9e-3), case["truth"], seed=5)
    got = t_simulate(TSpec(**dataclasses.asdict(spec)), TTool(0.9e-3),
                     case["port_truth"], seed=5)
    for f in ("t_read", "t_measured", "value"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    flat_j = [tr for g in case["groups"] for tr in g]
    flat_t = [tr for g in case["port_groups"] for tr in g]
    rj, rt = jpl.pack_stream_rows(flat_j), tpl.pack_stream_rows(flat_t)
    for f in ("times", "values", "kind_row", "n_samples"):
        a, b = getattr(rt, f), getattr(rj, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (rt.t0, rt.n_streams, rt.names) == (rj.t0, rj.n_streams,
                                              rj.names)
    assert tpl.default_tail(rt, 300) == jpl.default_tail(rj, 300)
    for (ta, va), (tb, vb) in zip(tpl.stream_row_windows(rt, 300),
                                  jpl.stream_row_windows(rj, 300)):
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(va, vb)


def _messy_chunks(seed, f=8, c=40, n=4):
    """Chunks with reordered reads, equal-time duplicates and masked
    slots, including a row dark for the first two chunks."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.0, 1e-3, (f, c * n)), axis=1)
    swap = rng.random((f, c * n)) < 0.05
    t2 = t.copy()
    t2[:, 1:][swap[:, 1:]] = t[:, :-1][swap[:, 1:]] - 1e-4
    e = np.cumsum(rng.uniform(0.0, 0.3, (f, c * n)), axis=1)
    valid = rng.random((f, c * n)) > 0.1
    valid[3, :2 * c] = False
    return [(t2[:, k * c:(k + 1) * c].astype(np.float32),
             e[:, k * c:(k + 1) * c].astype(np.float32),
             valid[:, k * c:(k + 1) * c]) for k in range(n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_sanitize_chunk_matches_reference(seed):
    for t, e, valid in _messy_chunks(seed)[:2]:
        for vm in (None, valid):
            for carry in (None, (t[:, :1] - 1e-4, e[:, :1])):
                kw = {} if carry is None else dict(carry_t=carry[0],
                                                   carry_e=carry[1])
                wt, we, wc = jpl.sanitize_chunk(t, e, vm,
                                                return_counts=True, **kw)
                tk = {k: torch.from_numpy(np.array(x))
                      for k, x in kw.items()}
                gt, ge, gc = tpl.sanitize_chunk(
                    torch.from_numpy(t), torch.from_numpy(e),
                    None if vm is None else torch.from_numpy(vm),
                    return_counts=True, **tk)
                np.testing.assert_array_equal(gt.numpy(), wt)
                np.testing.assert_array_equal(ge.numpy(), we)
                for k in ("late", "masked"):
                    np.testing.assert_array_equal(gc[k].numpy(), wc[k])


@pytest.mark.parametrize("mode", ["sanitize", "maskfill"])
def test_ingest_stage_matches_reference_with_masks(mode):
    """Closed windows, first-edge spans and dq counters equal the
    reference's chunk by chunk, deferred seeding of a dark row included."""
    kind = np.array([True, False] * 4)
    js = jpl.IngestStage(8, mode=mode, kind_row=kind)
    ts = tpl.IngestStage(8, mode=mode, kind_row=kind, device=CPU)
    for t, e, valid in _messy_chunks(3):
        if mode == "maskfill":
            t = np.maximum.accumulate(t, axis=1)
        w = js.update(t, e, valid)
        g = ts.update(torch.from_numpy(t), torch.from_numpy(e),
                      torch.from_numpy(valid))
        np.testing.assert_array_equal(g.times.numpy(), w.times)
        np.testing.assert_array_equal(g.values.numpy(), w.values)
        np.testing.assert_array_equal(g.t_first.numpy(), w.t_first)
    np.testing.assert_array_equal(ts.dq_late.numpy(), js.dq_late)
    np.testing.assert_array_equal(ts.dq_masked.numpy(), js.dq_masked)


def test_pad_phases_matches_reference():
    for p in (1, 5, 32, 33):
        ph = np.random.default_rng(p).uniform(0, 10, (p, 2))
        np.testing.assert_array_equal(tpl.pad_phases(ph), jpl.pad_phases(ph))
    with pytest.raises(ValueError, match="at least one phase"):
        tpl.pad_phases([])
