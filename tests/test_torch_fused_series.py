"""PyTorch port, the windowed path's recorded fused series on the CPU:
``RegridFuseStage(record=True).emitted`` window by window and
``StreamingFusedPipeline(record=True).fused_series()`` against the
reference's on its streaming test recipe (``tests/test_pipeline.py``),
fixed and tracked delays, the plain versions (``device="cpu"``) and the
float64 host mirror (``host=True``); totals unchanged by recording; the
empty run and the refusal without ``record``; and the multi-host entry
with 1, 2 and 4 participants (threads over ``ThreadCollectives``, the
reference's 5 ragged groups and chunk 193): every device's series the
same bits under every count, and 1e-5 of the reference's single-host
series."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from multihost.simdata import shared_grid_and_phases, sim_groups
from repro.core import ToolSpec, simulate_sensor, square_wave
from repro.core.measurement_model import SensorSpec
from repro.distributed import multihost as jmh
from repro.fleet import packing as jpack
from repro.fleet import pipeline as jpl
from repro_torch import interop
from repro_torch.distributed import multihost as tmh
from repro_torch.fleet import packing as tpack
from repro_torch.fleet import pipeline as tpl

torch.set_num_threads(2)

TOL = 1e-5                  # of the largest watts
CHUNK = 257
_CACHE = {}


def _sim_groups(n_devices, seed=0, span_s=4.5, noise=3.0):
    """The reference's streaming test recipe (``tests/test_pipeline.py``):
    per device a wrapping energy counter and a noisy power sensor,
    distinct configured delays."""
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


def _port_groups(groups):
    return [[interop.trace_from_fields(tr.name, dataclasses.asdict(tr.spec),
                                       tr.t_read, tr.t_measured, tr.value)
             for tr in g] for g in groups]


def _case():
    if "case" not in _CACHE:
        from repro.align import align_and_fuse
        truth, groups = _sim_groups(3)
        fused = align_and_fuse(groups, reference=truth)
        grid = fused[0].grid
        edges = np.linspace(float(grid[0]), float(grid[-1]), 7)
        _CACHE["case"] = dict(
            truth=truth, groups=groups, grid=grid,
            delays=np.concatenate([fs.delays for fs in fused]),
            phases=[(f"p{k}", float(a), float(b))
                    for k, (a, b) in enumerate(zip(edges[:-1], edges[1:]))],
            port_groups=_port_groups(groups),
            port_truth=interop.power_from_arrays(truth.times, truth.watts))
    return _CACHE["case"]


def _drive(port, kind, *, host=False, record=True, n_windows=None):
    """The streaming entry's steps (pack, pipeline, replay windows,
    finalize) in the port (``port``) or the reference, with ``record``
    -> the pipeline.  ``kind``: "fixed" (the batch fit's delays) or
    "tracked" (against the truth); ``n_windows`` stops the replay early
    (0: the pipeline as built)."""
    c = _case()
    pl = tpl if port else jpl
    groups = c["port_groups"] if port else c["groups"]
    rows = pl.pack_stream_rows([tr for g in groups for tr in g])
    cadence = pl._min_cadence(rows)
    grid = np.asarray(c["grid"], np.float64)
    step = float(np.median(np.diff(grid)))
    delays = c["delays"] if kind == "fixed" else None
    truth = c["port_truth"] if port else c["truth"]
    ref = (None if kind == "fixed" else
           (lambda t, _r=truth, _t0=rows.t0: _r.power_at(t + _t0)))
    tail = pl.default_tail(rows, CHUNK, delays=delays, max_lag=64,
                           grid_step=step, cadence=cadence)
    kw = dict(device="cpu") if port else {}
    pipe = pl.StreamingFusedPipeline(
        [len(g) for g in groups],
        [(a - rows.t0, b - rows.t0) for _, a, b in c["phases"]],
        grid_origin=float(grid[0]) - rows.t0, grid_step=step,
        kind_row=rows.kind_row, delays=delays, reference=ref,
        track=kind == "tracked", tail=tail, record=record, host=host, **kw)
    if n_windows == 0:
        return pipe
    for w, (t_blk, v_blk) in enumerate(
            pl.stream_row_windows(rows, CHUNK, cadence=cadence), start=1):
        pipe.update(t_blk, v_blk)
        if w == n_windows:
            return pipe
    pipe.finalize(float(grid[-1]) - rows.t0)
    return pipe


def _pipes(kind, host):
    key = (kind, host)
    if key not in _CACHE:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            _CACHE[key] = (_drive(True, kind, host=host),
                           _drive(False, kind, host=host))
    return _CACHE[key]


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("host", [False, True], ids=["cpu", "host"])
def test_recorded_windows_match_the_reference_stage(host):
    """Fixed delays: the port's stage records the reference's windows, one
    for one: the same ``lo``, the same float64 grid, the same masks, and
    values within 1e-5 of the largest."""
    port, ref = _pipes("fixed", host)
    got, want = port.fuse.emitted, ref.fuse.emitted
    assert len(got) == len(want) >= 4
    top = max(np.abs(np.asarray(w.values)).max() for w in want)
    for g, w in zip(got, want):
        assert g.lo == w.lo
        np.testing.assert_array_equal(g.grid.numpy(), np.asarray(w.grid))
        np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask))
        err = np.abs(g.values.double().numpy()
                     - np.asarray(w.values, np.float64)).max()
        assert err <= TOL * top


@pytest.mark.parametrize("host", [False, True], ids=["cpu", "host"])
@pytest.mark.parametrize("kind", ["fixed", "tracked"])
def test_fused_series_matches_the_reference(kind, host):
    """``fused_series()``: (grid, watts, mask) as host numpy (float64,
    float64, bool), one row a device, the grid and masks equal to the
    reference's and the watts within 1e-5 of the largest."""
    port, ref = _pipes(kind, host)
    grid, watts, mask = port.fused_series()
    wg, ww, wm = ref.fused_series()
    assert grid.dtype == np.float64 and watts.dtype == np.float64
    assert mask.dtype == bool
    assert watts.shape == mask.shape == (3, grid.shape[0])
    np.testing.assert_array_equal(grid, wg)
    np.testing.assert_array_equal(mask, wm)
    assert mask.any(axis=1).all()
    assert _rel(watts, ww) <= TOL


@pytest.mark.parametrize("kind", ["fixed", "tracked"])
def test_recording_leaves_the_totals_bit_identical(kind):
    """``record`` keeps windows and changes no arithmetic: totals
    ``torch.equal`` with and without it; without it nothing is kept."""
    with_rec = _pipes(kind, False)[0]
    without = _drive(True, kind, record=False)
    assert torch.equal(with_rec.totals(), without.totals())
    assert without.fuse.emitted == [] and with_rec.fuse.emitted


def test_empty_run_and_refusal():
    """Before any window: the reference's empty shapes ((0,), (D, 0),
    (D, 0) bool); without ``record=True``: ValueError.  ``reset()``
    forgets the recorded windows, as the reference's does."""
    pipe = _drive(True, "fixed", n_windows=0)
    grid, watts, mask = pipe.fused_series()
    want = _drive(False, "fixed", n_windows=0).fused_series()
    assert grid.shape == want[0].shape == (0,)
    assert watts.shape == want[1].shape == (3, 0)
    assert mask.shape == want[2].shape == (3, 0) and mask.dtype == bool
    with pytest.raises(ValueError, match="record=True"):
        _drive(True, "fixed", record=False, n_windows=0).fused_series()
    part = _drive(True, "fixed", n_windows=3)
    assert part.fuse.emitted
    part.reset()
    assert part.fuse.emitted == [] and part.fused_series()[0].shape == (0,)


# ------------------------------------------------------------ multi-host

MH_DEVICES, MH_CHUNK = 5, 193


def _mh_fleet():
    if "mh" not in _CACHE:
        truth, groups, delays = sim_groups(MH_DEVICES, span_s=1.6)
        grid, phases = shared_grid_and_phases(groups)
        _CACHE["mh"] = dict(groups=groups, port_groups=_port_groups(groups),
                            delays=delays, grid=grid, phases=phases,
                            sizes=[len(g) for g in groups])
    return _CACHE["mh"]


def _mh_config(mod, f, sh):
    return mod.PipelineConfig(
        stream=mod.StreamConfig(chunk=MH_CHUNK, grid=f["grid"]),
        track=mod.TrackConfig(track=False,
                              delays=sh.take_rows(f["delays"])))


def _port_host(coll, f):
    from repro_torch.fleet import config
    sh = tpack.assign_groups(f["sizes"], coll.num_processes,
                             coll.process_id)
    _, pipe = tmh.attribute_energy_fused_multihost(
        [f["port_groups"][g] for g in sh.group_ids], f["phases"], shard=sh,
        collectives=coll, config=_mh_config(config, f, sh), record=True,
        return_pipe=True, device="cpu")
    grid, watts, mask = pipe.fused_series()
    return {int(g): (watts[j], mask[j]) for j, g in enumerate(sh.group_ids)}, \
        grid.shape[0]


def _ref_single_host(f):
    from repro.fleet import config
    tc = jmh.ThreadCollectives(1)
    sh = jpack.assign_groups(f["sizes"], 1, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        _, pipe = jmh.attribute_energy_fused_multihost(
            f["groups"], f["phases"], shard=sh,
            collectives=tc.participant(0), config=_mh_config(config, f, sh),
            record=True, return_pipe=True)
    return pipe.fused_series()


def test_fused_series_equal_across_participant_counts():
    """1, 2 and 4 participants (5 ragged groups, chunk 193): the same
    slot count on every host, every device's watts and mask
    ``np.array_equal`` across the counts (a device's fold depends on its
    own group alone), and the 2-participant series within 1e-5 of the
    reference's single-host series, masks equal."""
    f = _mh_fleet()
    runs = {}
    for n in (1, 2, 4):
        out = tmh.run_threads(_port_host, n, args=(f,))
        slots = {g for _, g in out}
        assert len(slots) == 1
        series = {}
        for s, _ in out:
            series.update(s)
        assert sorted(series) == list(range(MH_DEVICES))
        runs[n] = (slots.pop(), series)
    base_slots, base = runs[1]
    for n, (slots, series) in runs.items():
        assert slots == base_slots
        for d in range(MH_DEVICES):
            np.testing.assert_array_equal(series[d][0], base[d][0])
            np.testing.assert_array_equal(series[d][1], base[d][1])
    _, ww, wm = _ref_single_host(f)
    two = runs[2][1]
    watts = np.stack([two[d][0] for d in range(MH_DEVICES)])
    mask = np.stack([two[d][1] for d in range(MH_DEVICES)])
    np.testing.assert_array_equal(mask, wm)
    assert _rel(watts, ww) <= TOL
