"""Multi-host fleet layer: the fleet's rows split over processes (port of
``repro/distributed/multihost.py``).

The paper attributes energy on up to 512 GPUs and 480 APUs, a scale that
only exists across hosts.  Here every process ("host"):

  * packs ONLY the sensors of the device groups it owns
    (``fleet.packing.assign_groups`` / ``shard_from_assignment``; the
    global row ids ride in the ``HostShard``),
  * runs the windowed stage chain on its own card, unchanged: every
    kernel is row-local, so the heavy work needs nothing from the others,
  * exchanges over ``HostCollectives`` only what is global: the packing
    origins, the emit frontier (all-reduced min every window, so every
    host emits the same grid slots), the tracker's ring origin and fill
    frontier with each hop's (lag, weight) pairs framed onto the
    frontier reduce and folded into one shared fleet EMA, the health
    stage's statistics on the same frame, and at the end the
    per-(device, pattern, phase, stream) integrals and fusion statistics
    (gathered once, placed identically on every host).

The collectives carry a few hundred bytes of host float64 a window, so
they are not device collectives: ``CoordinatorCollectives`` rides a
``torch.distributed.TCPStore`` (its key-value store stands in for the
reference's coordination service; process 0 hosts it, and no process
group or NCCL is needed) and ``ThreadCollectives`` simulates N hosts as
threads of one process.  ``run_multihost`` spawns N worker processes
around a store, with a deadline.

Determinism contract: whole device groups live on one host; the
frontier all-reduce pins the emission schedule; every reduction inside
a stage runs in an order that depends on the reduced length alone
(``core.reduce``, the xcorr row scores); the framed sums are a
left fold in process-id order, exact because each element is non-zero
on one host only; the end-of-run merge is pure placement.  So the
fleet-wide energies and delays are bit-identical for ANY host<-group
assignment and ANY process count.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import threading
import time
import traceback

import numpy as np

from repro_torch.distributed.compression import (WireStats,
                                                 decode_reduce_frame,
                                                 encode_reduce_frame)

DEFAULT_TIMEOUT_S = 120.0


# ---------------------------------------------------------------------------
# Host-side collectives
# ---------------------------------------------------------------------------

class HostCollectives:
    """Blocking collectives over tiny host arrays (base class).

    Implementations provide ``_exchange`` (every participant's payload,
    in process-id order); ``allgather_bytes`` and the numeric reductions
    are built on it, always reducing in process-id order so every
    participant computes bit-identical results.  Every call is
    COLLECTIVE: all participants reach it in lockstep, or the group
    waits until the timeout raises.  ``wire_stats`` counts the framed
    reduces' posted bytes against their dense size; ``seconds`` the
    wall time spent inside collectives.
    """

    process_id: int = 0
    num_processes: int = 1

    @property
    def wire_stats(self) -> WireStats:
        ws = getattr(self, "_wire_stats", None)
        if ws is None:
            ws = self._wire_stats = WireStats()
        return ws

    @property
    def seconds(self) -> float:
        """Wall seconds spent inside collectives so far."""
        return getattr(self, "_seconds", 0.0)

    @property
    def round_trips(self) -> int:
        """Collectives that exchanged a message so far (one process
        exchanges none)."""
        return getattr(self, "_round_trips", 0)

    def allgather_bytes(self, payload: bytes) -> list:
        """Every participant's ``payload``, in process-id order."""
        t0 = time.perf_counter()
        try:
            return self._exchange(bytes(payload))
        finally:
            self._seconds = self.seconds + time.perf_counter() - t0
            self._round_trips = self.round_trips + 1

    def _exchange(self, payload: bytes) -> list:
        raise NotImplementedError

    def barrier(self):
        if self.num_processes > 1:
            self.allgather_bytes(b"B")

    def allreduce(self, x, op: str = "sum") -> np.ndarray:
        arr = np.atleast_1d(np.asarray(x, np.float64))
        if self.num_processes == 1:
            return arr.copy()
        parts = self.allgather_bytes(arr.tobytes())
        stack = np.stack([np.frombuffer(p, np.float64).reshape(arr.shape)
                          for p in parts])
        return {"sum": np.sum, "min": np.min,
                "max": np.max}[op](stack, axis=0)

    def allreduce_min(self, x: float) -> float:
        return float(self.allreduce([float(x)], "min")[0])

    def allreduce_max(self, x: float) -> float:
        return float(self.allreduce([float(x)], "max")[0])

    def allreduce_sum(self, x: float) -> float:
        return float(self.allreduce([float(x)], "sum")[0])

    def allreduce_framed(self, scalar: float, vec, *,
                         scalar_op: str = "min"):
        """One round trip: a scalar (min or max) plus a float64 vector
        summed as a LEFT FOLD IN PROCESS-ID ORDER, so every participant
        adds ``v_0 + v_1 + ... + v_{P-1}`` in the same sequence; where
        each element is non-zero on exactly one participant the sum is
        exact, hence also independent of the process count.  The frame
        on the wire is ``compression.encode_reduce_frame`` (non-zero
        values raw float64).  Returns ``(scalar, vec)``."""
        if scalar_op not in ("min", "max"):
            raise ValueError(f"scalar_op {scalar_op!r}: min or max")
        v = np.asarray(vec, np.float64).reshape(-1)
        payload = encode_reduce_frame(float(scalar), v)
        self.wire_stats.record(len(payload), 8 * (1 + v.size))
        if self.num_processes == 1:
            return float(scalar), v.copy()
        rows = [decode_reduce_frame(p)
                for p in self.allgather_bytes(payload)]
        if any(r[1].size != v.size for r in rows):
            raise ValueError("framed reduce: ragged frames (participants "
                             "disagree on the fleet width)")
        s, acc = rows[0][0], rows[0][1].copy()
        red = min if scalar_op == "min" else max
        for rs, rv in rows[1:]:
            s = red(s, float(rs))
            acc += rv
        return float(s), acc


class CoordinatorCollectives(HostCollectives):
    """HostCollectives over a ``torch.distributed.TCPStore``.

    Collective g posts each participant's payload under
    ``{namespace}/g{g}/p{i}`` and reads every participant's; a
    participant that has read generation g knows every peer has read
    generation g-1 (each posted g after it), so it deletes its own g-1
    key then and the store holds at most two generations.  A read that
    waits longer than ``timeout_s`` raises ``TimeoutError``.  ``close``
    ends the run: the clients report done and the host (process 0) waits
    for all of them before its store may go away.
    """

    def __init__(self, store, process_id: int, num_processes: int, *,
                 namespace: str = "repro_mh",
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self._store = store
        self.process_id = int(process_id)
        self.num_processes = int(num_processes)
        self._ns = namespace
        self.timeout_s = float(timeout_s)
        self._gen = 0
        store.set_timeout(datetime.timedelta(seconds=self.timeout_s))

    @property
    def port(self) -> int:
        """The store's TCP port (the one the OS picked for port 0)."""
        return int(self._store.port)

    def _key(self, gen: int, i: int) -> str:
        return f"{self._ns}/g{gen}/p{i}"

    def _get(self, key: str) -> bytes:
        import torch.distributed as dist
        try:
            return self._store.get(key)
        except dist.DistStoreError as exc:
            raise TimeoutError(
                f"host collective: process {self.process_id} waited "
                f"{self.timeout_s:g} s for {key!r}") from exc

    def _exchange(self, payload: bytes) -> list:
        if self.num_processes == 1:
            return [payload]
        g = self._gen
        self._gen += 1
        self._store.set(self._key(g, self.process_id), payload)
        out = [self._get(self._key(g, i))
               for i in range(self.num_processes)]
        if g:
            self._store.delete_key(self._key(g - 1, self.process_id))
        return out

    def close(self):
        """End of the run (collective): the clients count themselves
        done; process 0 waits (up to the timeout) until every client has,
        so no client still reads from the store when it goes away."""
        if self._store is None:
            return
        if self.num_processes > 1:
            key = f"{self._ns}/closed"
            if self.process_id != 0:
                self._store.add(key, 1)
            else:
                deadline = time.monotonic() + self.timeout_s
                while self._store.add(key, 0) < self.num_processes - 1:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"host collective: {self.num_processes - 1} "
                            f"clients did not close within "
                            f"{self.timeout_s:g} s")
                    time.sleep(0.01)
        self._store = None


class _ThreadParticipant(HostCollectives):
    def __init__(self, group: "ThreadCollectives", i: int):
        self._group = group
        self.process_id = i
        self.num_processes = group.n

    def _exchange(self, payload: bytes) -> list:
        g = self._group
        if g.n == 1:
            return [payload]
        g.slots[self.process_id] = payload
        g.barrier.wait(g.timeout_s)        # everyone posted
        out = list(g.slots)
        g.barrier.wait(g.timeout_s)        # everyone read (reuse-safe)
        return out


class ThreadCollectives:
    """N in-process participants simulating N hosts: ``participant(i)``
    hands thread i its HostCollectives view (a ``threading.Barrier``
    underneath, so the lockstep contract holds as across processes; a
    wait past ``timeout_s`` raises ``threading.BrokenBarrierError``)."""

    def __init__(self, n: int, *, timeout_s: float = DEFAULT_TIMEOUT_S):
        self.n = int(n)
        self.timeout_s = timeout_s
        self.barrier = threading.Barrier(self.n)
        self.slots = [None] * self.n

    def participant(self, i: int) -> _ThreadParticipant:
        return _ThreadParticipant(self, i)


def run_threads(fn, n: int, *, args=(), timeout_s: float = 300.0) -> list:
    """``fn(collectives, *args)`` on ``n`` threads, one simulated host
    each, over ``ThreadCollectives``; the results in process-id order.
    A thread's exception breaks the barrier for its peers and is raised
    here; a run past ``timeout_s`` raises ``TimeoutError``."""
    tc = ThreadCollectives(n, timeout_s=timeout_s)
    results = [None] * n
    errors = []

    def worker(i):
        try:
            results[i] = fn(tc.participant(i), *args)
        except BaseException as exc:          # noqa: BLE001 - re-raised
            errors.append((i, exc))
            tc.barrier.abort()                # unblock the peers

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout_s
    for t in threads:
        t.join(max(deadline - time.monotonic(), 0.0))
    if any(t.is_alive() for t in threads):
        tc.barrier.abort()
        raise TimeoutError(f"{n} simulated hosts ran past {timeout_s:g} s")
    if errors:
        first = [e for e in errors
                 if not isinstance(e[1], threading.BrokenBarrierError)]
        raise (first or errors)[0][1]
    return results


# ---------------------------------------------------------------------------
# Process bootstrap
# ---------------------------------------------------------------------------

def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, *, timeout_s: float = DEFAULT_TIMEOUT_S,
                   namespace: str = "repro_mh") -> CoordinatorCollectives:
    """Join (process 0: host) the store at ``coordinator_address``
    ("host:port") and return the collectives over it.

    Unset arguments come from ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``, as ``torch.distributed``'s env://
    start-up reads them.  Port 0 on process 0 binds a port the OS picks
    (``collectives.port``), which the other processes must then be told.
    """
    import torch.distributed as dist
    if coordinator_address is None:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    host, _, port = str(coordinator_address).rpartition(":")
    n, pid = int(num_processes), int(process_id)
    if not 0 <= pid < n:
        raise ValueError(f"process_id {pid} outside [0, {n})")
    store = dist.TCPStore(host, int(port), n, pid == 0,
                          timeout=datetime.timedelta(seconds=timeout_s),
                          wait_for_workers=False)
    return CoordinatorCollectives(store, pid, n, namespace=namespace,
                                  timeout_s=timeout_s)


class MultihostTimeout(RuntimeError):
    """A spawned run exceeded its deadline; every worker was killed and
    reaped."""


class WorkerFailed(RuntimeError):
    """A spawned worker raised or died; carries its traceback or exit
    code."""

    def __init__(self, process_id: int, detail: str):
        super().__init__(f"multihost worker {process_id} failed:\n{detail}")
        self.process_id = process_id
        self.detail = detail


def _spawned(fn, args, i: int, n: int, addr_q, conn, threads: int,
             timeout_s: float):
    """Worker bootstrap: join the store (worker 0 hosts it on a port the
    OS picks and hands it to the others), run ``fn(collectives, *args)``,
    send the result, close the collectives."""
    try:
        import torch
        torch.set_num_threads(threads)
        if i == 0:
            coll = init_multihost("127.0.0.1:0", n, 0, timeout_s=timeout_s)
            for _ in range(n - 1):
                addr_q.put(coll.port)
        else:
            coll = init_multihost(f"127.0.0.1:{addr_q.get(True, timeout_s)}",
                                  n, i, timeout_s=timeout_s)
        result = fn(coll, *args)
        conn.send(("ok", result))
        coll.close()
    except BaseException:                     # noqa: BLE001 - reported
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def _reap(procs):
    """Terminate, then kill, then join every worker (no zombies)."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def run_multihost(fn, n_procs: int, *, args=(), timeout_s: float = 300.0,
                  threads: int = 1,
                  collective_timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """``fn(collectives, *args)`` in ``n_procs`` spawned processes over a
    ``TCPStore`` that worker 0 hosts; the results in process-id order.

    ``fn`` is a module-level (picklable) function; each worker sets
    ``torch.set_num_threads(threads)`` first.  The first worker to raise
    or to exit without a result fails the run at once: the others are
    killed and reaped and ``WorkerFailed`` carries its traceback or exit
    code.  Past ``timeout_s`` every worker is killed and reaped and
    ``MultihostTimeout`` raised.  Spawn, never fork: a parent that
    touched CUDA must not fork.
    """
    ctx = mp.get_context("spawn")
    addr_q = ctx.Queue()
    procs, conns = [], []
    try:
        for i in range(n_procs):
            recv_end, send_end = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_spawned,
                            args=(fn, tuple(args), i, n_procs, addr_q,
                                  send_end, threads, collective_timeout_s),
                            daemon=True, name=f"mh-worker-{i}")
            p.start()
            send_end.close()            # the parent's copy: EOF surfaces
            procs.append(p)
            conns.append(recv_end)
        deadline = time.monotonic() + timeout_s
        results = [None] * n_procs
        pending = set(range(n_procs))
        while pending:
            for i in sorted(pending):
                c = conns[i]
                if not c.poll(0):
                    if procs[i].is_alive():
                        continue
                    procs[i].join(1)
                    if not c.poll(0.2):
                        raise WorkerFailed(i, f"worker exited (code "
                                              f"{procs[i].exitcode}) "
                                              f"without a result")
                try:
                    status, payload = c.recv()
                except EOFError:
                    procs[i].join(1)
                    raise WorkerFailed(i, f"worker exited (code "
                                          f"{procs[i].exitcode}) "
                                          f"without a result") from None
                if status != "ok":
                    raise WorkerFailed(i, payload)
                results[i] = payload
                pending.discard(i)
            if pending and time.monotonic() > deadline:
                raise MultihostTimeout(
                    f"multihost run ({n_procs} workers) timed out after "
                    f"{timeout_s:g} s; workers killed and reaped")
            if pending:
                time.sleep(0.02)
        for p in procs:
            p.join(10)
        return results
    finally:
        _reap(procs)
        addr_q.close()
        addr_q.join_thread()


# ---------------------------------------------------------------------------
# The multi-host fused-attribution entry point
# ---------------------------------------------------------------------------

def attribute_energy_fused_multihost(local_groups, phases, *, shard,
                                     collectives, config=None,
                                     reference=None, corrections=None,
                                     return_pipe: bool = False,
                                     registry=None, on_window=None,
                                     device=None, **legacy):
    """Fleet-wide fused per-phase energy, rows split over hosts.

    The multi-host counterpart of
    ``fleet.pipeline.attribute_energy_fused_streaming``: every host calls
    it with ONLY the trace groups it owns (``local_groups``, in
    ``shard.group_ids`` order) plus its ``shard``/``collectives``; every
    host returns the SAME fleet-wide result, one ``[PhaseEnergy]`` per
    GLOBAL device group.  ``config`` is a ``fleet.config.PipelineConfig``
    (the flat legacy kwargs resolve with a ``DeprecationWarning``); the
    engine is always the windowed one (``engine="scan"`` raises).
    device: None means CUDA (each process its ``cuda:0`` unless given
    another); ``"cpu"`` runs the plain versions.

    Every origin the float32 packing depends on (t0, the counters'
    origin, the output grid, the replay span and cadence) is all-reduced
    before packing, so each host's rows are bit-identical to a
    single-host pack of the whole fleet.  ``delays`` are this host's
    rows' fixed delays; ``grid``/``phases`` are global.  Tracking
    (``track=True``) synchronizes the tracker over the collectives
    (``pipe.fleet_delays()`` is the shared vector).  ``health`` composes
    the health stage, its statistics riding the frontier frame; sensor
    names are all-gathered once.  ``CheckpointConfig(dir=, every=K)``
    writes per-GLOBAL-group checkpoints; ``resume=True`` reloads the
    newest one complete across all groups, under any process count and
    assignment, and skips the windows it folded (firing no collective,
    so the fleet stays in lockstep).  ``on_window(pipe, w)`` fires after
    window ``w`` (1-based).
    """
    from repro_torch.fleet.config import resolve_config
    from repro_torch.fleet.pipeline import (StreamingFusedPipeline,
                                            _host_device, _min_cadence,
                                            _phase_rows, _unsupported,
                                            default_tail, pack_stream_rows,
                                            stream_row_windows)
    cfg = resolve_config(config, legacy, "attribute_energy_fused_multihost")
    _unsupported(cfg)
    if cfg.stream.engine != "windowed":
        raise ValueError("multi-host attribution drives the windowed "
                         "engine only (engine='scan' is single-host)")
    host = cfg.stream.host
    dev = _host_device(device, host)
    chunk = cfg.stream.chunk
    grid, grid_step = cfg.stream.grid, cfg.stream.grid_step
    dtype, var_floor = cfg.stream.dtype, cfg.stream.var_floor
    use_t_measured = cfg.stream.use_t_measured
    track, delays = cfg.track.track, cfg.track.delays
    max_lag, tail = cfg.track.max_lag, cfg.track.tail
    ckpt_dir, every = cfg.checkpoint.dir, cfg.checkpoint.every
    groups = [list(g) for g in local_groups]
    if len(groups) != len(shard.group_ids):
        raise ValueError(f"{len(groups)} local groups for "
                         f"{len(shard.group_ids)} owned group ids")
    for g, gid in zip(groups, shard.group_ids):
        if len(g) != shard.global_group_sizes[gid]:
            raise ValueError(f"group {gid}: {len(g)} traces != declared "
                             f"{shard.global_group_sizes[gid]}")
    flat = [tr for g in groups for tr in g]

    def _starts(trs):
        return [float((tr.t_measured if use_t_measured
                       else tr.t_read)[0]) for tr in trs]

    t0 = collectives.allreduce_min(min(_starts(flat)))
    cum_starts = _starts([tr for tr in flat if tr.spec.is_cumulative])
    cum_t0 = collectives.allreduce_min(min(cum_starts) if cum_starts
                                       else np.inf)
    rows = pack_stream_rows(flat, corrections=corrections,
                            use_t_measured=use_t_measured, dtype=dtype,
                            t0=t0, cum_t0=(None if np.isinf(cum_t0)
                                           else cum_t0))
    n = rows.n_streams
    cadence = collectives.allreduce_min(_min_cadence(rows))
    if grid is not None:
        grid = np.asarray(grid, np.float64)
        grid_step = float(np.median(np.diff(grid)))
        origin = float(grid[0]) - rows.t0
        t_end = float(grid[-1]) - rows.t0
    else:
        if grid_step is None:
            grid_step = 0.5 * cadence
        origin = collectives.allreduce_min(
            float(rows.times[:n, 0].astype(np.float64).min()))
        t_end = None
    if tail is None:
        d_ref = None
        if delays is not None:
            d = np.asarray(delays, np.float64)
            # the frontier trails the fleet-wide most-delayed stream
            d_ref = [collectives.allreduce_min(float(d.min())),
                     collectives.allreduce_max(float(d.max()))]
        tail = default_tail(rows, chunk, delays=d_ref, max_lag=max_lag,
                            grid_step=grid_step, cadence=cadence)
    ref = None
    if reference is not None:
        if hasattr(reference, "power_at"):
            ref = lambda t, _r=reference: _r.power_at(t + t0)  # noqa: E731
        else:
            ref = reference
    n_global = len(shard.global_group_sizes)
    if not phases:
        empty = [[] for _ in range(n_global)]
        return (empty, None) if return_pipe else empty
    windows = [(a - rows.t0, b - rows.t0) for _, a, b in phases]
    health_names = None
    if cfg.health:
        # one small pickle all-gather, so every host labels the same
        # global rows with the same sensor names
        sizes = [int(s) for s in shard.global_group_sizes]
        off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        health_names = [f"s{i}" for i in range(int(off[-1]))]
        blob = pickle.dumps((tuple(int(g) for g in shard.group_ids),
                             [tr.name for tr in flat]))
        for part in collectives.allgather_bytes(blob):
            gids, names = pickle.loads(part)
            k = 0
            for gid in gids:
                for j in range(sizes[gid]):
                    health_names[int(off[gid]) + j] = names[k]
                    k += 1
    pipe = StreamingFusedPipeline(
        shard.local_group_sizes, windows, grid_origin=origin,
        grid_step=grid_step, kind_row=rows.kind_row, delays=delays,
        reference=ref, track=track, window=cfg.track.window,
        hop=cfg.track.hop, max_lag=max_lag, ema=cfg.track.ema, tail=tail,
        var_floor=var_floor, collectives=collectives, shard=shard,
        dtype=dtype, health=cfg.health, registry=registry,
        health_names=health_names, dq_policy=cfg.dq, device=dev,
        host=host)
    span = (collectives.allreduce_min(
                float(rows.times[:n, 0].astype(np.float64).min())),
            collectives.allreduce_max(
                float(rows.times[:n, -1].astype(np.float64).max())))
    start_w = 0
    if cfg.checkpoint.resume:
        if ckpt_dir is None:
            raise ValueError("resume=True needs a checkpoint dir")
        try:
            start_w = pipe.restore(ckpt_dir)
        except FileNotFoundError:
            start_w = 0      # cold start, the same on every host: the
            #                  step is resolved from the shared dirs
    for w, (t_blk, v_blk) in enumerate(
            stream_row_windows(rows, chunk, span=span, cadence=cadence),
            start=1):
        if w <= start_w:
            continue   # folded before the restore: no collective fires
            #            here and every host skips the same count
        pipe.update(t_blk, v_blk)
        if ckpt_dir is not None and every and w % every == 0:
            pipe.checkpoint(ckpt_dir)
        if on_window is not None:
            on_window(pipe, w)
    pipe.finalize(t_end)
    out = _phase_rows(phases, pipe.totals().cpu().numpy())
    return (out, pipe) if return_pipe else out
