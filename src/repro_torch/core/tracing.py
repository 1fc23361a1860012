"""Region tracing — the Score-P analogue (port of
``repro/core/tracing.py``).

``RegionTracer`` records host-timestamped, nested application regions in
a unified timebase (``time.perf_counter_ns``).  ``LiveSampler`` is the
APAPI analogue: a dedicated thread polling a sensor so instrumentation
never blocks application threads.  Both buffers are bounded for long
runs: ``max_events`` / ``max_samples`` keep only the newest entries (a
ring — the OLDEST entry is dropped and counted in ``.dropped``); drain
them with ``flush()``.  ``health.HealthRegistry.track_tracer`` /
``track_sampler`` export the depth and drop counters.

Host-only, as in the reference: a region's end is the host clock when
the ``with`` block exits.  Code that times device work inside a region
waits for the device before leaving it (the solvers in ``repro_torch.hpl``
call ``torch.cuda.synchronize`` there).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class RegionEvent:
    name: str
    t_start: float       # seconds, unified timebase
    t_end: float
    depth: int
    device: int = -1     # -1 = host region
    step: int = -1
    slot: int = -1       # -1 = engine-global (serve: batch slot id)


class RegionTracer:
    """Nested region recording with a unified monotonic timebase.

    max_events: ring capacity; None (default) keeps every event.  When
    the ring is full each append evicts the oldest event and increments
    ``dropped``.
    """

    def __init__(self, timebase: Optional[Callable[[], float]] = None,
                 max_events: Optional[int] = None):
        self._now = timebase or (lambda: time.perf_counter_ns() * 1e-9)
        self.max_events = max_events
        self.events: collections.deque = collections.deque()
        self.dropped = 0
        self._stack: list = []
        self.t0 = self._now()

    def _append(self, ev: RegionEvent) -> None:
        if (self.max_events is not None
                and len(self.events) >= self.max_events):
            self.events.popleft()
            self.dropped += 1
        self.events.append(ev)

    def now(self) -> float:
        return self._now() - self.t0

    @contextlib.contextmanager
    def region(self, name: str, *, device: int = -1, step: int = -1,
               slot: int = -1):
        t_s = self.now()
        self._stack.append(name)
        try:
            yield
        finally:
            depth = len(self._stack) - 1
            self._stack.pop()
            self._append(RegionEvent(name, t_s, self.now(), depth,
                                     device, step, slot))

    def add_region(self, name, t_start, t_end, *, depth=0, device=-1,
                   step=-1, slot=-1):
        """Record an externally-timed region (e.g. replayed traces)."""
        self._append(
            RegionEvent(name, t_start, t_end, depth, device, step, slot))

    def flush(self) -> list:
        """Drain and return the buffered events (oldest first); the
        cumulative ``dropped`` counter is left untouched."""
        out = list(self.events)
        self.events.clear()
        return out

    def phases(self, *, depth: Optional[int] = None, name=None,
               slot: Optional[int] = None):
        """(name, t_start, t_end) tuples, sorted by start time;
        ``slot=`` filters to one serve-engine batch slot."""
        evs = list(self.events)
        if depth is not None:
            evs = [e for e in evs if e.depth == depth]
        if name is not None:
            evs = [e for e in evs if e.name == name]
        if slot is not None:
            evs = [e for e in evs if e.slot == slot]
        return sorted(((e.name, e.t_start, e.t_end) for e in evs),
                      key=lambda x: x[1])

    def to_arrays(self):
        names = sorted({e.name for e in self.events})
        name_id = {n: i for i, n in enumerate(names)}
        ev = sorted(self.events, key=lambda e: e.t_start)
        return {
            "names": names,
            "name_id": np.asarray([name_id[e.name] for e in ev], np.int32),
            "t_start": np.asarray([e.t_start for e in ev], np.float64),
            "t_end": np.asarray([e.t_end for e in ev], np.float64),
            "depth": np.asarray([e.depth for e in ev], np.int32),
            "device": np.asarray([e.device for e in ev], np.int32),
            "step": np.asarray([e.step for e in ev], np.int32),
            "slot": np.asarray([e.slot for e in ev], np.int32),
        }


class LiveSampler:
    """Dedicated sampling thread (APAPI analogue): polls ``read_fn`` at a
    requested cadence, recording (t_read, value) without touching the
    application thread.

    max_samples: ring capacity; None keeps everything.  A full ring
    evicts the oldest sample per poll (counted in ``dropped``) so the
    buffer always holds the newest window; drain with ``flush()``.
    """

    def __init__(self, read_fn: Callable[[float], float],
                 interval_s: float = 1e-3,
                 timebase: Optional[Callable[[], float]] = None,
                 max_samples: Optional[int] = None):
        self._read = read_fn
        self._interval = interval_s
        self._now = timebase or (lambda: time.perf_counter_ns() * 1e-9)
        self._stop = threading.Event()
        self._thread = None
        self.max_samples = max_samples
        self.t_read: collections.deque = collections.deque()
        self.values: collections.deque = collections.deque()
        self.dropped = 0

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        nxt = self._now()
        while not self._stop.is_set():
            t = self._now()
            if (self.max_samples is not None
                    and len(self.t_read) >= self.max_samples):
                self.t_read.popleft()
                self.values.popleft()
                self.dropped += 1
            self.t_read.append(t)
            self.values.append(self._read(t))
            nxt += self._interval
            delay = nxt - self._now()
            if delay > 0:
                self._stop.wait(delay)
            else:
                nxt = self._now()     # fell behind: resync (observed gap)

    def flush(self):
        """Drain and return (t_read, values) arrays for the buffered
        samples; the cumulative ``dropped`` counter keeps counting.
        Safe against the sampler thread: only the front of the deques
        is consumed while the thread appends at the back."""
        n = min(len(self.t_read), len(self.values))
        t = [self.t_read.popleft() for _ in range(n)]
        v = [self.values.popleft() for _ in range(n)]
        return (np.asarray(t, np.float64), np.asarray(v, np.float64))

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        return (np.asarray(self.t_read, np.float64),
                np.asarray(self.values, np.float64))
