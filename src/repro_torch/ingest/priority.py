"""PrioritizedIngest: best-available backend per metric, degrading
gracefully (port of ``repro/ingest/priority.py``).

The paper's methodology needs every scope it can get — on-chip SMI
counters, off-chip PM/RAPL, hwmon — but production tools disappear,
time out, or lose permission mid-run.  This layer stacks backends in
priority order per metric and keeps reads flowing:

  * per-metric priority: the first backend (global order, or a
    per-metric override) that declares a metric owns it;
  * per-backend error budgets: ``error_budget`` consecutive failures
    demote a (backend, metric) pair for ``retry_after_s`` — reads fall
    down the priority list instead of blocking on a dead tool;
  * cached last-good reads: when every backend fails, the last good
    reading is served (marked ``cached=True``) while it is younger
    than ``stale_ttl_s`` — a transient drop never tears a hole in the
    stream — after which :class:`IngestUnavailable` is raised;
  * health wiring: demotions/recoveries emit typed
    :class:`~repro_torch.health.events.HealthEvent` records (the same stream
    the fleet-health stage uses) and per-backend counters export
    through ``HealthRegistry.track_ingest``.

``BackendReader`` adapts one metric to the ``poll``/``drained``
protocol ``AsyncFleetIngest`` pumps, so real counters flow through
Ingest -> Reconstruct -> AlignTrack -> Fuse -> PhaseAttribute
unchanged.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from repro_torch.ingest.backend import BackendError, Reading


class IngestUnavailable(BackendError):
    """Every backend failed and the cache is stale (or empty)."""


@dataclasses.dataclass(frozen=True)
class IngestPolicy:
    """Degradation knobs for :class:`PrioritizedIngest`."""
    stale_ttl_s: float = 0.25      # serve cached last-good up to this age
    error_budget: int = 3          # consecutive failures before demotion
    retry_after_s: float = 5.0     # demoted (backend, metric) retry delay

    def __post_init__(self):
        assert self.stale_ttl_s >= 0.0, self.stale_ttl_s
        assert self.error_budget >= 1, self.error_budget
        assert self.retry_after_s >= 0.0, self.retry_after_s


def default_backend_order():
    """Backend priority from ``REPRO_INGEST_PRIORITY`` (comma list of
    backend names; default: the real tools before the simulator)."""
    raw = os.environ.get("REPRO_INGEST_PRIORITY",
                         "rocm-smi,amd-smi,rapl,hwmon,sim")
    return [s.strip() for s in raw.split(",") if s.strip()]


class PrioritizedIngest:
    """Priority-stacked, cache-backed, budgeted multi-backend reader.

    backends: priority-ordered list (first = preferred); ``priority``
    optionally overrides the order per metric (exact name or prefix
    before the first ``.``) with a list of backend names.  ``events``
    is an optional sink (list or callable) for HealthEvents on top of
    the bounded internal ``self.events`` buffer.
    """

    def __init__(self, backends, *, policy: IngestPolicy = None,
                 priority: dict = None, events=None, registry=None,
                 clock=time.perf_counter, max_events: int = 1024):
        self.backends = list(backends)
        assert self.backends, "PrioritizedIngest needs >= 1 backend"
        names = [b.name for b in self.backends]
        assert len(set(names)) == len(names), \
            f"duplicate backend names: {names}"
        self.policy = policy or IngestPolicy()
        self.priority = dict(priority or {})
        self._clock = clock
        self.events = []
        self._max_events = int(max_events)
        self._events_sink = events
        # (backend, metric) failure streaks and demoted-until deadlines
        self._streak = {}
        self._down_until = {}
        self._cache = {}               # metric -> Reading (last good)
        self.n_reads = 0
        self.counters = {n: {"reads": 0, "errors": 0, "fallbacks": 0,
                             "cache_hits": 0, "demotions": 0,
                             "recoveries": 0} for n in names}
        if registry is not None:
            registry.track_ingest("ingest", self)

    # -- capability map --------------------------------------------------

    def providers(self, metric: str) -> list:
        """Backends declaring ``metric``, in effective priority order."""
        order = self.priority.get(metric) \
            or self.priority.get(metric.partition(".")[0])
        backends = self.backends
        if order:
            by_name = {b.name: b for b in self.backends}
            backends = [by_name[n] for n in order if n in by_name]
        return [b for b in backends if b.declares(metric)]

    def metrics(self) -> dict:
        """{metric: [MetricSpec, ...]} across backends, priority order;
        the first entry is the preferred backend's declaration."""
        out = {}
        for b in self.backends:
            for sp in b.discover():
                out.setdefault(sp.metric, [])
        for metric in out:
            for b in self.providers(metric):
                out[metric].append(b.spec(metric))
        return {m: sps for m, sps in out.items() if sps}

    def spec(self, metric: str):
        """The preferred provider's declared semantics for ``metric``."""
        for b in self.providers(metric):
            return b.spec(metric)
        raise IngestUnavailable(f"no backend provides {metric!r}")

    # -- health wiring ---------------------------------------------------

    def _emit(self, event) -> None:
        self.events.append(event)
        if len(self.events) > self._max_events:
            del self.events[:len(self.events) - self._max_events]
        sink = self._events_sink
        if callable(sink):
            sink(event)
        elif sink is not None:
            sink.append(event)

    def _transition(self, backend, metric, *, down, detail):
        from repro_torch.health.events import HEALTHY, QUARANTINED, HealthEvent
        self._emit(HealthEvent(
            kind="ingest", window=self.n_reads, t=self._clock(),
            sensor=-1, name=f"{backend.name}:{metric}",
            state_from=HEALTHY if down else QUARANTINED,
            state_to=QUARANTINED if down else HEALTHY,
            flags=("read_error",) if down else ("recovered",),
            detail=detail))

    # -- reads -----------------------------------------------------------

    def read(self, metric: str) -> Reading:
        """Best-available read with fallback; raises
        :class:`IngestUnavailable` only when every provider failed AND
        the cached last-good reading is older than ``stale_ttl_s``."""
        self.n_reads += 1
        now = self._clock()
        providers = self.providers(metric)
        if not providers:
            raise IngestUnavailable(f"no backend provides {metric!r}")
        errors = []
        for rank, b in enumerate(providers):
            key = (b.name, metric)
            until = self._down_until.get(key, 0.0)
            if until > now and rank < len(providers) - 1:
                continue               # demoted; last provider always
                #                        gets a shot (nothing below it)
            c = self.counters[b.name]
            try:
                r = b.read(metric)
            except BackendError as exc:
                c["errors"] += 1
                streak = self._streak.get(key, 0) + 1
                self._streak[key] = streak
                if streak >= self.policy.error_budget:
                    # (re)demote on every at-budget failure, but emit
                    # the transition only when crossing the budget
                    self._down_until[key] = \
                        now + self.policy.retry_after_s
                    if streak == self.policy.error_budget:
                        c["demotions"] += 1
                        self._transition(b, metric, down=True,
                                         detail={"error": str(exc)[:200],
                                                 "streak": streak})
                errors.append(f"{b.name}: {exc}")
                continue
            c["reads"] += 1
            if rank > 0:
                c["fallbacks"] += 1
            if self._streak.pop(key, 0) >= self.policy.error_budget:
                self._down_until.pop(key, None)
                c["recoveries"] += 1
                self._transition(b, metric, down=False,
                                 detail={"rank": rank})
            self._cache[metric] = r
            return r
        cached = self._cache.get(metric)
        if cached is not None \
                and now - cached.t_read <= self.policy.stale_ttl_s:
            self.counters[cached.source]["cache_hits"] += 1
            return dataclasses.replace(cached, cached=True)
        raise IngestUnavailable(
            f"{metric}: every provider failed ({'; '.join(errors)}) "
            f"and the cache is "
            f"{'empty' if cached is None else 'stale'}")

    def read_all(self) -> dict:
        """{metric: Reading} for every known metric that produced one."""
        out = {}
        for metric in self.metrics():
            try:
                out[metric] = self.read(metric)
            except IngestUnavailable:
                pass
        return out


class BackendReader:
    """Adapt one PrioritizedIngest metric to the ``AsyncFleetIngest``
    poll protocol (``poll(now) -> (t, v) arrays``, ``drained``).

    Each poll performs one prioritized read; duplicate publications
    (same ``t_measured`` as the previously forwarded sample — coarse
    sensor clocks, cached reads) are dropped HERE, at the ingest
    boundary, while strictly-decreasing timestamps (genuine reorders)
    pass through to the pipeline's dq counters.  ``duration_s``
    bounds the live capture (None = until ``stop()``).
    """

    def __init__(self, ingest: PrioritizedIngest, metric: str, *,
                 duration_s: float = None, t_stop: float = None):
        self.ingest = ingest
        self.metric = metric
        self.duration_s = duration_s
        self._t_stop = t_stop
        self._t_start = None
        self._prev_tm = np.nan     # last forwarded t_measured (dedupe)
        self._last_tm = -np.inf    # max forwarded (t_stop frontier)
        self._stopped = False
        self.n_dupes = 0
        self.n_unavailable = 0

    def stop(self) -> None:
        self._stopped = True

    def poll(self, now_wall: float):
        if self._t_start is None:
            self._t_start = now_wall
        empty = (np.empty((0,), np.float64),) * 2
        if self.drained:
            return empty
        try:
            r = self.ingest.read(self.metric)
        except IngestUnavailable:
            self.n_unavailable += 1
            return empty
        if r.t_measured == self._prev_tm:
            self.n_dupes += 1          # duplicate publication: dedupe
            return empty
        self._prev_tm = r.t_measured
        self._last_tm = max(self._last_tm, r.t_measured)
        return (np.asarray([r.t_measured], np.float64),
                np.asarray([r.value], np.float64))

    @property
    def drained(self) -> bool:
        if self._stopped:
            return True
        if self._t_stop is not None and self._last_tm >= self._t_stop:
            return True
        if self.duration_s is not None and self._t_start is not None:
            return (time.perf_counter() - self._t_start
                    >= self.duration_s)
        return False
