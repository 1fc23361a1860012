"""Region tracing — the Score-P analogue (port of ``RegionEvent`` and
``RegionTracer`` from ``repro/core/tracing.py``).

``RegionTracer`` records host-timestamped, nested application regions in
a unified timebase (``time.perf_counter_ns``).  The buffer is bounded for
long runs: ``max_events`` keeps only the newest entries (a ring — the
OLDEST entry is dropped and counted in ``.dropped``); drain it with
``flush()``.

Host-only, as in the reference: a region's end is the host clock when
the ``with`` block exits.  Code that times device work inside a region
waits for the device before leaving it (the solvers in ``repro_torch.hpl``
call ``torch.cuda.synchronize`` there).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
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
