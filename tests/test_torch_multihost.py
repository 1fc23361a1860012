"""PyTorch port, multi-host attribution (``repro_torch.distributed``):
the reduce frame byte for byte against the reference's, the shard types
field for field, the fleet energies and delays ``np.array_equal`` across
1-4 simulated hosts and any host<-group assignment (fixed delays and
tracked) and within 1e-5 of the reference's multi-host entry and its
batch oracle, the health stage's decisions across counts and against the
reference, elastic kill-and-resume under another process count (and from
a checkpoint the reference's hosts wrote), the three routed entry points,
the refusals, and the spawn harness over ``TCPStore`` with its failure
semantics.  Hosts are threads (``ThreadCollectives``) except in the
spawn tests; everything runs on the CPU."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import torch_multihost_workers as workers
from multihost.simdata import (energy_matrix, shared_grid_and_phases,
                               sim_groups)
from repro.distributed import compression as jcomp
from repro.distributed import multihost as jmh
from repro.fleet import packing as jpack
from repro_torch import interop
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import multihost as tmh
from repro_torch.fleet import packing as tpack

CPU = "cpu"
E_TOL = 1e-5
CHUNK = 257

torch.set_num_threads(2)

_CACHE = {}


def _port_groups(groups):
    return [[interop.trace_from_fields(tr.name, dataclasses.asdict(tr.spec),
                                       tr.t_read, tr.t_measured, tr.value)
             for tr in g] for g in groups]


def _fleet(n_devices=4, faults=None):
    key = ("fleet", n_devices, None if faults is None else
           tuple(sorted(faults)))
    if key not in _CACHE:
        truth, groups, delays = sim_groups(n_devices, span_s=1.6,
                                           faults=faults)
        grid, phases = shared_grid_and_phases(groups, n_phases=4)
        _CACHE[key] = dict(truth=truth, groups=groups, delays=delays,
                           grid=grid, phases=phases,
                           port_groups=_port_groups(groups),
                           port_truth=interop.power_from_arrays(
                               truth.times, truth.watts),
                           sizes=[len(g) for g in groups])
    return _CACHE[key]


def _config(mod, f, shard, kind, **extra):
    """The run's ``PipelineConfig`` in package ``mod``'s config module:
    ``kind`` "fixed" (this host's rows' configured delays) or "tracked"
    (against the truth)."""
    t = (mod.TrackConfig(track=False, delays=shard.take_rows(f["delays"]))
         if kind == "fixed" else
         mod.TrackConfig(track=True, window=512, hop=128))
    ck = extra.pop("checkpoint", None)
    return mod.PipelineConfig(
        stream=mod.StreamConfig(chunk=CHUNK, grid=f["grid"]), track=t,
        checkpoint=ck if ck is not None else mod.CheckpointConfig(),
        **extra)


def _port_host(coll, f, kind, assignment=None, on_window=None,
               return_pipe=False, **extra):
    from repro_torch.fleet import config
    sh = (tpack.assign_groups(f["sizes"], coll.num_processes,
                              coll.process_id) if assignment is None
          else tpack.shard_from_assignment(f["sizes"], assignment,
                                           coll.process_id,
                                           coll.num_processes))
    res, pipe = tmh.attribute_energy_fused_multihost(
        [f["port_groups"][g] for g in sh.group_ids], f["phases"],
        shard=sh, collectives=coll, config=_config(config, f, sh, kind,
                                                   **extra),
        reference=f["port_truth"] if kind == "tracked" else None,
        on_window=on_window, return_pipe=True, device=CPU)
    out = (energy_matrix(res), pipe.fleet_delays(), sh,
           None if pipe.align is None
           else pipe.delays().numpy())
    return out + (pipe,) if return_pipe else out


def _ref_host(coll, f, kind, **extra):
    from repro.fleet import config
    sh = jpack.assign_groups(f["sizes"], coll.num_processes,
                             coll.process_id)
    res, pipe = jmh.attribute_energy_fused_multihost(
        [f["groups"][g] for g in sh.group_ids], f["phases"], shard=sh,
        collectives=coll, config=_config(config, f, sh, kind, **extra),
        reference=f["truth"] if kind == "tracked" else None,
        return_pipe=True)
    return energy_matrix(res), pipe.fleet_delays(), pipe


def _ref_threads(fn, n, *args, **kw):
    """The reference's hosts as threads over its own ThreadCollectives."""
    import threading
    tc = jmh.ThreadCollectives(n)
    out, errors = [None] * n, []

    def run(i):
        try:
            out[i] = fn(tc.participant(i), *args, **kw)
        except BaseException as exc:          # noqa: BLE001
            errors.append(exc)
            tc.barrier.abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if errors:
        raise errors[0]
    return out


def _runs(kind, counts=(1, 2, 3, 4)):
    key = ("runs", kind)
    if key not in _CACHE:
        f = _fleet()
        _CACHE[key] = {n: tmh.run_threads(_port_host, n, args=(f, kind))
                       for n in counts}
    return _CACHE[key]


def _ref_run(kind, n=2):
    key = ("ref", kind, n)
    if key not in _CACHE:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            _CACHE[key] = _ref_threads(_ref_host, n, _fleet(), kind)
    return _CACHE[key]


def _close(got, want, tol=E_TOL):
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert float(err.max()) <= tol, float(err.max())


# ---------------------------------------------------------- wire format

_VECS = {
    "empty": np.zeros((0,)),
    "all-zero": np.zeros((37,)),
    "one": np.eye(1, 50, 17)[0] * -3.25,
    "sparse": np.where(np.arange(200) % 23 == 4, np.arange(200) * 0.5,
                       0.0),
    "dense": np.random.default_rng(0).normal(size=64),
    "inf-nan": np.array([0.0, np.inf, 0.0, 0.0, -np.inf, np.nan, 0.0,
                         5e-324, -0.0, 1e308]),
}


@pytest.mark.parametrize("scalar", [0.0, -1.5, np.inf, -np.inf])
@pytest.mark.parametrize("name", sorted(_VECS))
def test_reduce_frame_bytes_equal_the_reference_and_cross_decode(name,
                                                                 scalar):
    v = _VECS[name]
    frame = tcomp.encode_reduce_frame(scalar, v)
    assert frame == jcomp.encode_reduce_frame(scalar, v)
    for dec in (tcomp.decode_reduce_frame, jcomp.decode_reduce_frame):
        s, got = dec(frame)
        assert s == scalar
        want = np.where(v == 0.0, 0.0, v)     # zeros' signs are not kept
        assert got.tobytes() == want.tobytes()
    assert len(frame) >= tcomp.MIN_FRAME_BYTES
    with pytest.raises(ValueError):
        tcomp.decode_reduce_frame(frame[:5])
    with pytest.raises(ValueError):
        tcomp.decode_reduce_frame(b"XX" + frame[2:])


def test_framed_reduce_folds_in_process_order_and_counts_its_bytes():
    def host(coll):
        v = np.zeros((12,))
        v[3 * coll.process_id:3 * coll.process_id + 3] = \
            coll.process_id + np.array([0.1, 0.2, 0.3])
        s, summed = coll.allreduce_framed(10.0 - coll.process_id, v)
        return s, summed, coll.wire_stats

    out = tmh.run_threads(host, 4)
    want = np.concatenate([i + np.array([0.1, 0.2, 0.3])
                           for i in range(4)])
    for s, summed, ws in out:
        assert s == 7.0 and summed.tobytes() == want.tobytes()
        assert ws.frames == 1 and ws.raw_bytes == 8 * 13
        assert ws.ratio == ws.raw_bytes / ws.payload_bytes


# ---------------------------------------------------------- shard types

@pytest.mark.parametrize("sizes,n_hosts", [((2, 2, 2, 2), 2),
                                           ((3, 1, 2, 2, 4), 3),
                                           ((2,) * 7, 4), ((1,), 1)])
def test_shard_types_equal_the_reference(sizes, n_hosts):
    rng = np.random.default_rng(len(sizes))
    assignment = np.arange(len(sizes)) % n_hosts
    rng.shuffle(assignment)
    for host in range(n_hosts):
        for mk_t, mk_j, args in (
                (tpack.assign_groups, jpack.assign_groups,
                 (sizes, n_hosts, host)),
                (tpack.shard_from_assignment, jpack.shard_from_assignment,
                 (sizes, assignment, host))):
            t, j = mk_t(*args), mk_j(*args)
            assert (t.host, t.n_hosts, t.global_group_sizes,
                    t.group_ids) == (j.host, j.n_hosts,
                                     j.global_group_sizes, j.group_ids)
            assert t.local_group_sizes == j.local_group_sizes
            assert t.n_local_streams == j.n_local_streams
            np.testing.assert_array_equal(t.row_offsets, j.row_offsets)
            np.testing.assert_array_equal(t.row_ids, j.row_ids)
            per_row = np.arange(sum(sizes)) * 1.5
            np.testing.assert_array_equal(t.take_rows(per_row),
                                          j.take_rows(per_row))
    with pytest.raises(ValueError, match="owns no device groups"):
        tpack.assign_groups(sizes, len(sizes) + 1, len(sizes))


# ------------------------------------------- invariance and the oracles

@pytest.mark.parametrize("kind", ["fixed", "tracked"])
def test_fleet_results_equal_across_host_counts(kind):
    """1-4 hosts: every host's energies and fleet delays are
    ``np.array_equal`` to every other's and to one host's; a host's
    fleet delays at its rows equal its own tracker's bit for bit."""
    runs = _runs(kind)
    e1, d1 = runs[1][0][0], runs[1][0][1]
    for n, hosts in runs.items():
        for e, d, sh, local in hosts:
            np.testing.assert_array_equal(e, e1)
            assert e.shape == (4, 4) and np.isfinite(e).all()
            if kind == "tracked":
                np.testing.assert_array_equal(d, d1)
                np.testing.assert_array_equal(d[sh.row_ids], local)
            else:
                assert d is None


@pytest.mark.parametrize("kind", ["fixed", "tracked"])
def test_fleet_results_match_the_reference_and_the_batch_oracle(kind):
    """Within 1e-5 of the reference's multi-host entry on the same
    shards (fleet delays to 1e-3 grid steps: float32 scores), and the
    fleet's total within 1e-5 of the reference's batch oracle."""
    from repro.align import attribute_energy_fused
    f = _fleet()
    port = _runs(kind)[2]
    ref = _ref_run(kind)
    for (e, d, _, _), (je, jd, _) in zip(port, ref):
        _close(e, je)
        if kind == "tracked":
            step = float(np.median(np.diff(f["grid"])))
            assert np.abs(d - jd).max() <= 1e-3 * step
    if kind == "fixed":
        batch = energy_matrix(attribute_energy_fused(
            f["groups"], f["phases"], grid=f["grid"], delays=f["delays"]))
        tot = float(port[0][0].sum())
        assert abs(tot - float(batch.sum())) <= E_TOL * abs(float(
            batch.sum()))


pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402


@given(st.lists(st.integers(0, 2), min_size=4, max_size=4)
       .filter(lambda a: len(set(a)) == max(a) + 1 and max(a) >= 1),
       st.sampled_from(["fixed", "tracked"]))
@settings(max_examples=6, deadline=None)
def test_any_assignment_gives_the_same_fleet_result(assignment, kind):
    f = _fleet()
    want_e, want_d = _runs(kind)[1][0][:2]
    hosts = tmh.run_threads(_port_host, max(assignment) + 1,
                            args=(f, kind, assignment))
    for e, d, _, _ in hosts:
        np.testing.assert_array_equal(e, want_e)
        if kind == "tracked":
            np.testing.assert_array_equal(d, want_d)


# ------------------------------------------------------------- health

_HEALTH_KW = dict(suspect_after=1, quarantine_after=1, recover_after=1,
                  min_slots=8, bias_limit_w=15.0, rms_limit_w=60.0)


def _transitions(stage):
    return tuple((e.window, float(e.t), e.name, e.state_from, e.state_to,
                  tuple(e.flags)) for e in stage.events)


def test_health_decisions_equal_across_counts_and_the_reference():
    """One stuck power sensor on a ragged 3-device fleet: events, states,
    names and energies identical at 1, 2 and 3 hosts, and the events and
    states equal to the reference's hosts'."""
    from repro.core import FaultSpec as JFault
    from repro.health import HealthConfig as JHealth
    from repro_torch.health import HealthConfig
    f = _fleet(3, faults={"d1_power": JFault("stuck", 1.0)})
    seen = []
    for n in (1, 2, 3):
        hosts = tmh.run_threads(
            lambda coll: _port_host(coll, f, "fixed", return_pipe=True,
                                    health=HealthConfig(**_HEALTH_KW)), n)
        for e, _, _, _, pipe in hosts:
            hs = pipe.health_stage
            seen.append((e, _transitions(hs), hs.state.tolist(),
                         list(hs.names), hs.windows))
    e0, tr0, st0, names0, w0 = seen[0]
    for e, tr, st_, names, w in seen[1:]:
        np.testing.assert_array_equal(e, e0)
        assert (tr, st_, names, w) == (tr0, st0, names0, w0)
    assert st0[names0.index("d1_power")] == 2          # QUARANTINED
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = _ref_threads(_ref_host, 2, f, "fixed",
                           health=JHealth(**_HEALTH_KW))
    for je, _, jpipe in ref:
        js = jpipe.health_stage
        assert _transitions(js) == tr0
        assert js.state.tolist() == st0 and list(js.names) == names0
        _close(e0, je)


# ------------------------------------------------------------- elastic

class _Kill(Exception):
    pass


def _kill_after(w_kill):
    def hook(pipe, w):
        if w == w_kill:
            raise _Kill
    return hook


@pytest.mark.parametrize("kind,n_save,n_resume", [("fixed", 2, 3),
                                                  ("tracked", 3, 1)])
def test_elastic_resume_under_another_count_is_bit_identical(
        tmp_path, kind, n_save, n_resume):
    """Checkpoint every 2 windows, all hosts killed after window 3, the
    run resumed on another host count: ``np.array_equal`` to the
    uninterrupted run."""
    from repro_torch.fleet import config
    f = _fleet()
    ck = config.CheckpointConfig(dir=str(tmp_path), every=2)
    with pytest.raises(_Kill):
        tmh.run_threads(lambda coll: _port_host(
            coll, f, kind, checkpoint=ck, on_window=_kill_after(3)), n_save)
    resume = config.CheckpointConfig(dir=str(tmp_path), every=2,
                                     resume=True)
    hosts = tmh.run_threads(
        lambda coll: _port_host(coll, f, kind, checkpoint=resume),
        n_resume)
    want_e, want_d = _runs(kind)[1][0][:2]
    for e, d, _, _ in hosts:
        np.testing.assert_array_equal(e, want_e)
        if kind == "tracked":
            np.testing.assert_array_equal(d, want_d)


def test_a_checkpoint_the_reference_hosts_wrote_resumes_in_the_port(
        tmp_path):
    """The reference's 2 hosts checkpoint every 2 windows and die after
    window 3; the port resumes on 3 hosts within 1e-5 of the reference's
    uninterrupted run."""
    from repro.fleet import config as jcfg
    from repro_torch.fleet import config as tcfg
    f = _fleet()

    def killed(coll):
        sh = jpack.assign_groups(f["sizes"], coll.num_processes,
                                 coll.process_id)
        return jmh.attribute_energy_fused_multihost(
            [f["groups"][g] for g in sh.group_ids], f["phases"], shard=sh,
            collectives=coll, config=_config(
                jcfg, f, sh, "fixed",
                checkpoint=jcfg.CheckpointConfig(dir=str(tmp_path),
                                                 every=2)),
            on_window=_kill_after(3))

    with pytest.raises(_Kill):
        _ref_threads(killed, 2)
    hosts = tmh.run_threads(lambda coll: _port_host(
        coll, f, "fixed", checkpoint=tcfg.CheckpointConfig(
            dir=str(tmp_path), every=2, resume=True)), 3)
    want = _ref_run("fixed")[0][0]
    for e, _, _, _ in hosts:
        _close(e, want)


# ------------------------------------------------------ routed entries

def test_routed_entries_equal_their_single_host_results():
    """``attribute_energy_fused(streaming=True)``,
    ``fused_fleet_energize`` and ``attribute_phases(fuse=True,
    streaming=True)`` with ``shard``/``collectives`` agree with the same
    call without them (1e-5; the fleet entries ``np.array_equal``)."""
    from repro_torch import fleet, hpl
    from repro_torch.core import RegionTracer
    from repro_torch.fleet import PipelineConfig, StreamConfig, TrackConfig
    f = _fleet()
    cfg = PipelineConfig(stream=StreamConfig(chunk=CHUNK, grid=f["grid"]),
                         track=TrackConfig(track=False,
                                           delays=f["delays"]))
    single = energy_matrix(fleet.attribute_energy_fused(
        f["port_groups"], f["phases"], streaming=True, config=cfg,
        device=CPU))

    def aef(coll):
        sh = tpack.assign_groups(f["sizes"], coll.num_processes,
                                 coll.process_id)
        local = PipelineConfig(stream=cfg.stream, track=TrackConfig(
            track=False, delays=sh.take_rows(f["delays"])))
        return energy_matrix(fleet.attribute_energy_fused(
            [f["port_groups"][g] for g in sh.group_ids], f["phases"],
            streaming=True, config=local, shard=sh, collectives=coll,
            device=CPU))

    for e in tmh.run_threads(aef, 2):
        np.testing.assert_array_equal(e, single)

    tracer = RegionTracer()
    for name, a, b in (("hpl_factorize", 0.0, 0.4), ("hpl_solve", 0.4, 0.6),
                       ("hpl_verify", 0.6, 0.7)):
        tracer.add_region(name, a, b)
    hcfg = PipelineConfig(stream=StreamConfig(chunk=512),
                          track=TrackConfig(window=512, hop=128))
    want = energy_matrix(hpl.fused_fleet_energize(
        tracer, 3, streaming=True, config=hcfg, device=CPU))

    def ffe(coll):
        sh = tpack.assign_groups([3] * 3, coll.num_processes,
                                 coll.process_id)
        return energy_matrix(hpl.fused_fleet_energize(
            tracer, 3, config=hcfg, shard=sh, collectives=coll,
            device=CPU))

    for e in tmh.run_threads(ffe, 2):
        _close(e, want)


def test_serve_attribute_phases_routes_multihost():
    from test_torch_serve import _served_fabric
    from repro_torch.align import group_traces_by_device
    from repro_torch.fleet import PipelineConfig, TrackConfig
    _, _, eng, port_traces, lead = _served_fabric()
    cfg = PipelineConfig(track=TrackConfig(track=False))
    want = eng.attribute_phases(port_traces, t_shift=lead, fuse=True,
                                streaming=True, config=cfg)
    by_dev = group_traces_by_device(port_traces)
    names = list(by_dev)
    sizes = [len(g) for g in by_dev.values()]

    def host(coll):
        # this host's engine reads only its own devices' sensors
        sh = tpack.assign_groups(sizes, coll.num_processes,
                                 coll.process_id)
        mine = [id(tr) for g in sh.group_ids for tr in by_dev[names[g]]]
        local = {k: tr for k, tr in port_traces.items() if id(tr) in mine}
        return sh, eng.attribute_phases(
            local, t_shift=lead, fuse=True, streaming=True, config=cfg,
            shard=sh, collectives=coll)

    got = {}
    for sh, rows in tmh.run_threads(host, len(sizes)):
        assert list(rows) == [names[g] for g in sh.group_ids]
        got.update(rows)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(np.array([p.energy_j for p in got[k]]),
               np.array([p.energy_j for p in want[k]]))


# ------------------------------------------------------------ refusals

@pytest.mark.parametrize("what", ["host", "scan", "min_corr"])
def test_unsynchronizable_options_raise(what):
    from repro_torch.fleet import config
    from repro_torch.fleet.pipeline import AlignTrackStage
    f = _fleet()
    sh = tpack.assign_groups(f["sizes"], 1, 0)
    coll = tmh.ThreadCollectives(1).participant(0)
    if what == "min_corr":
        with pytest.raises(ValueError, match="min_corr"):
            AlignTrackStage(8, grid_step=1e-3, groups=[2] * 4,
                            min_corr=0.0, collectives=coll, shard=sh)
        return
    stream = (config.StreamConfig(chunk=CHUNK, host=True) if what == "host"
              else config.StreamConfig(chunk=CHUNK, engine="scan"))
    with pytest.raises(ValueError, match="host=True|windowed"):
        tmh.attribute_energy_fused_multihost(
            f["port_groups"], f["phases"], shard=sh, collectives=coll,
            config=config.PipelineConfig(stream=stream), device=CPU)


def test_a_group_owned_twice_raises():
    from repro_torch.fleet import config
    f = _fleet()

    def host(coll):
        sh = tpack.HostShard(coll.process_id, 2, tuple(f["sizes"]),
                             (0, 1, 2, 3) if coll.process_id == 0
                             else (3,))
        return tmh.attribute_energy_fused_multihost(
            [f["port_groups"][g] for g in sh.group_ids], f["phases"],
            shard=sh, collectives=coll,
            config=_config(config, f, sh, "fixed"), device=CPU)

    with pytest.raises(ValueError, match="owned by two hosts"):
        tmh.run_threads(host, 2)


# ---------------------------------------------------- spawned processes

def test_spawned_hosts_over_tcpstore_collectives_then_parity():
    """2 spawned processes over a TCPStore worker 0 hosts: every
    collective's answer, then the fleet result ``np.array_equal`` to the
    same fleet on threads here (tracked)."""
    out = tmh.run_multihost(workers.collectives_roundtrip, 2,
                            timeout_s=120)
    vec = np.array([0.25, -0.5, 1.25, -1.5])
    for pid, (gathered, lo, hi, tot, (s, summed), frames) in enumerate(out):
        assert gathered == [b"\x00", b"\x01"]
        assert (lo, hi, tot) == (0.0, 1.0, 2.0)
        assert s == 1.0 and summed.tobytes() == vec.tobytes()
        assert frames == 1
    got = tmh.run_multihost(workers.attribute, 2, args=(5, None, True),
                            timeout_s=180)
    want = tmh.run_threads(workers.attribute, 3, args=(5, None, True))
    for e, d in got:
        np.testing.assert_array_equal(e, want[0][0])
        np.testing.assert_array_equal(d, want[0][1])


def test_spawn_harness_raises_a_worker_exception():
    with pytest.raises(tmh.WorkerFailed) as ei:
        tmh.run_multihost(workers.raise_on_1, 2, timeout_s=120)
    assert ei.value.process_id == 1
    assert "AssertionError" in ei.value.detail
    assert "boom-on-proc-1" in ei.value.detail


def test_spawn_harness_raises_a_worker_exit_code():
    with pytest.raises(tmh.WorkerFailed) as ei:
        tmh.run_multihost(workers.exit_3_on_0, 2, timeout_s=120)
    assert ei.value.process_id == 0
    assert "code 3" in ei.value.detail


def test_spawn_harness_timeout_kills_and_reaps():
    import multiprocessing as mp
    before = {p.pid for p in mp.active_children()}
    with pytest.raises(tmh.MultihostTimeout, match="killed and reaped"):
        tmh.run_multihost(workers.hang, 2, timeout_s=8)
    left = [p for p in mp.active_children() if p.pid not in before]
    assert not left, left


def test_a_collective_times_out_instead_of_hanging():
    coll = tmh.ThreadCollectives(2, timeout_s=0.5).participant(0)
    import threading
    with pytest.raises(threading.BrokenBarrierError):
        coll.allreduce_min(1.0)


def test_cpu_scores_of_a_row_do_not_depend_on_its_neighbours():
    """The tracker's CPU scorer (``rows_alone``): a row scored alone is
    ``torch.equal`` to the same row within any block, and every score is
    within 1e-5 of the reference's ``ref.py``."""
    import jax.numpy as jnp
    from repro.kernels.xcorr_align.ref import xcorr_scores_ref as jref
    from repro_torch.kernels.xcorr_align.ops import xcorr_scores
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(21, 700)).astype(np.float32))
    m = torch.as_tensor((rng.uniform(size=(21, 700)) > 0.2)
                        .astype(np.float32))
    bank = torch.as_tensor(rng.normal(size=(9, 700)).astype(np.float32))
    full = xcorr_scores(x, m, bank, rows_alone=True)
    for a, b in ((0, 1), (5, 13), (3, 21), (20, 21)):
        torch.testing.assert_close(
            xcorr_scores(x[a:b], m[a:b], bank, rows_alone=True),
            full[a:b], rtol=0, atol=0)
    want = np.asarray(jref(jnp.asarray(x.numpy()), jnp.asarray(m.numpy()),
                           jnp.asarray(bank.numpy())))
    assert np.abs(full.numpy() - want).max() <= 1e-5
