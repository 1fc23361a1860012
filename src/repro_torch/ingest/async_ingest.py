"""Async fleet ingest: polling reader threads -> streaming pipeline
(port of ``repro/ingest/async_ingest.py``).

The same pump drives every source behind the reader protocol —
``SimulatedSMIReader`` (recorded-trace replay), ``BackendReader`` (real
counters through :class:`PrioritizedIngest`), or anything else with
``poll(now) -> (t, v)`` + ``drained`` — into a streaming stage's
``update``.  For the port's ``StreamingFusedPipeline`` that call moves
the block to the pipeline's device and launches its kernels from the
pump thread (CUDA work may be queued from any host thread).

Two properties of the ingest boundary:

  * duplicate publications are DEDUPED at the ingest boundary: a
    sample whose timestamp equals its row's running max is dropped
    and counted (``n_dupes``) — under coarse sensor clocks the
    busy-poll otherwise re-delivers the same publication every
    interval — while strictly-decreasing timestamps (genuine
    reorders) pass through to the pipeline's ``late``/``reordered``
    dq counters;
  * the poll loop jitters its sleep (``jitter`` fraction of
    ``interval_s``) so a fleet of ingest threads does not phase-lock
    onto the sensor refresh clock (the aliasing failure mode of §V-A).

Rows that have not yet produced a single sample (a metric whose every
provider is failing — the degraded world ``PrioritizedIngest`` exists
for) never block the fleet: flushes proceed on the live rows' cadence
and the dark row's columns go out as MASKED zero-width placeholders,
so the stage defers that row's seed until its first real sample and a
dead metric costs exactly zero energy instead of the whole capture.
"""
from __future__ import annotations

import threading
import time

import numpy as np
# imported here, not at the pump's construction: numpy loads its random
# module lazily, and that first load (~15 ms) would fall between the
# capture's priming reads and the pump's first poll
from numpy.random import default_rng

DEFAULT_CHUNK = 64      # ingest flush width (columns per update)


class SimulatedSMIReader:
    """rocm-smi / amd-smi poll idiom: each ``poll`` returns the samples
    a monitoring loop would have read since the last call, replaying a
    recorded SensorTrace against the wall clock at ``speed``x."""

    def __init__(self, trace, speed: float = 8.0):
        self._tr = trace
        self._speed = speed
        self._i = 0
        self._t0_wall = None

    def poll(self, now_wall: float):
        """-> (t_measured, value) arrays of newly visible samples."""
        if self._t0_wall is None:
            self._t0_wall = now_wall
        t_sim = float(self._tr.t_read[0]) \
            + (now_wall - self._t0_wall) * self._speed
        j = int(np.searchsorted(self._tr.t_read, t_sim, side="right"))
        lo, self._i = self._i, max(j, self._i)
        return self._tr.t_measured[lo:self._i], self._tr.value[lo:self._i]

    @property
    def drained(self) -> bool:
        return self._i >= len(self._tr)


class AsyncFleetIngest:
    """LiveSampler-style polling thread feeding a streaming attributor.

    A dedicated thread polls every reader at a jittered cadence,
    buffers per-row samples, and flushes fixed-width (fleet, chunk)
    blocks into ``stream.update`` — a ``FleetStream`` (counter chunks)
    or a ``StreamingFusedPipeline`` (mixed multi-sensor chunks); rows
    short of a full chunk pad by replicating their last sample
    (zero-width intervals — exactly zero energy, the packing
    subsystem's convention), which also keeps every row's wall-clock
    span aligned — the contract the streaming regrid frontier relies
    on.  Rows with no samples at all yet flush as masked zero-width
    placeholders (see the module docstring).  ``stop()`` drains the
    buffers and joins the thread.
    """

    def __init__(self, readers, stream, t0: float,
                 chunk: int = DEFAULT_CHUNK, interval_s: float = 2e-3,
                 jitter: float = 0.25, seed: int = 0):
        self._readers = list(readers)
        assert self._readers, "AsyncFleetIngest needs >= 1 reader"
        self._stream = stream
        self._t0 = t0
        self._chunk = chunk
        self._interval = interval_s
        assert 0.0 <= jitter < 1.0, jitter
        self._jitter = float(jitter)
        self._rng = default_rng(seed)
        self._stop = threading.Event()
        self._thread = None
        self._buf = [([], []) for _ in readers]      # (times, energies)
        self._last = [None] * len(readers)           # carry (t, e)
        # last ACCEPTED timestamp per row — the dedupe frontier
        self._last_t = np.full((len(readers),), -np.inf)
        self.n_polls = 0
        self.n_chunks = 0
        self.n_dupes = 0
        self.bounds = [None] * len(readers)  # (t_first, e_first, t, e)

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            self._poll_once()
            # flush on the live rows' cadence — a row with no samples
            # yet must not stall the fleet (its buffers stay empty and
            # its columns flush as masked placeholders)
            if max(len(b[0]) for b in self._buf) >= self._chunk:
                self._flush()
            if all(r.drained for r in self._readers):
                break
            wait = self._interval
            if self._jitter:
                # de-phase the poll clock from the sensor refresh clock
                wait *= 1.0 + self._jitter * float(
                    self._rng.uniform(-1.0, 1.0))
            self._stop.wait(wait)

    def _poll_once(self):
        now = time.perf_counter()
        self.n_polls += 1
        for i, r in enumerate(self._readers):
            tm, val = r.poll(now)
            if len(tm) == 0:
                continue
            # ingest-boundary dedupe: a sample equal to its row's
            # running max is a republication and is dropped.  Within
            # the poll batch the running max keeps the FIRST sample of
            # each republished timestamp; across polls the row
            # frontier drops the re-deliveries a coarse clock
            # produces.  Decreasing timestamps (genuine reorders) pass
            # through — the pipeline's sanitize/dq accounting owns
            # those.
            tm = np.asarray(tm, np.float64)
            val = np.asarray(val)
            prev = np.concatenate(([self._last_t[i]], tm[:-1]))
            keep = tm != np.maximum.accumulate(prev)
            if not keep.all():
                self.n_dupes += int((~keep).sum())
                tm, val = tm[keep], val[keep]
                if len(tm) == 0:
                    continue
            self._last_t[i] = max(self._last_t[i], float(tm.max()))
            self._buf[i][0].extend(tm - self._t0)
            self._buf[i][1].extend(val)
            self._last[i] = (self._buf[i][0][-1], self._buf[i][1][-1])
            first = self.bounds[i][:2] if self.bounds[i] \
                else (tm[0] - self._t0, val[0])
            self.bounds[i] = (*first, tm[-1] - self._t0, val[-1])

    def _flush(self):
        f = len(self._readers)
        t_blk = np.zeros((f, self._chunk), np.float64)
        e_blk = np.zeros((f, self._chunk), np.float64)
        valid = np.ones((f, self._chunk), bool)
        for i, (ts, es) in enumerate(self._buf):
            k = min(len(ts), self._chunk)
            t_blk[i, :k] = ts[:k]
            e_blk[i, :k] = es[:k]
            del ts[:k], es[:k]
            if k < self._chunk:              # replicate-last padding
                if k:
                    lt, le = t_blk[i, k - 1], e_blk[i, k - 1]
                elif self._last[i] is not None:
                    # no new samples this flush: hold the carried last
                    lt, le = self._last[i]
                else:
                    # row has never sampled: zero-width placeholders
                    # at t0, MASKED so the ingest stage defers the
                    # row's seed to its first real sample (no
                    # fabricated counter delta when it comes alive)
                    # and its dq `masked` counter records the gap
                    lt, le = 0.0, 0.0
                    valid[i] = False
                t_blk[i, k:] = lt
                e_blk[i, k:] = le
        t32, e32 = t_blk.astype(np.float32), e_blk.astype(np.float32)
        if valid.all():
            self._stream.update(t32, e32)
        else:
            self._stream.update(t32, e32, valid)
        self.n_chunks += 1

    def stop(self):
        """Signal, join, drain remaining buffers -> the stream."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self._poll_once()                    # anything left in the replay
        while any(len(b[0]) for b in self._buf):
            self._flush()
        return self
