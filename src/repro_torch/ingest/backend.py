"""Real-sensor ingest: the ``SensorBackend`` protocol (port of
``repro/ingest/backend.py``).

The attribution stack consumes ``(t, value)`` streams and *declared*
counter semantics — it never guesses a wrap range or a resolution.  A
backend is any object that can say what it offers (``discover`` →
:class:`MetricSpec`, including cumulative-counter wrap range and
resolution in SI units) and produce one :class:`Reading` per metric on
demand.  Concrete adapters:

  ``RocmSmiBackend`` / ``AmdSmiBackend``  (repro.ingest.rocm)
      subprocess adapters over the AMD SMI tools: energy accumulator
      (64-bit ticks x counter resolution) + average package power.
  ``RaplBackend``  (repro.ingest.rapl)
      Linux ``/sys/class/powercap`` energy_uj counters, wrapping at the
      kernel-declared ``max_energy_range_uj``.
  ``HwmonBackend``  (repro.ingest.hwmon)
      ``/sys/class/hwmon`` ``energy*_input`` (uJ) / ``power*_input``
      (uW) files.
  ``SimBackend``  (repro.ingest.sim)
      the repo's sensor-fabric simulator behind the same protocol, so
      the simulated path is just another backend.

``PrioritizedIngest`` (repro.ingest.priority) stacks backends per
metric with graceful degradation; ``AsyncFleetIngest``
(repro.ingest.async_ingest) pumps any of it into the streaming
pipeline's ``IngestStage``.
"""
from __future__ import annotations

import dataclasses
import time


class BackendError(RuntimeError):
    """A backend read (or discovery) failed; callers may fall back."""


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One metric a backend offers, with DECLARED counter semantics.

    Values returned by ``read`` are always SI — joules for
    ``energy_cum`` metrics, watts for ``power_inst`` — whatever the
    native unit (uJ files, accumulator ticks) was.  ``wrap_range_j``
    is the period of a cumulative counter in joules (0 = never wraps):
    the kernel-declared ``max_energy_range_uj`` for RAPL, ``2**64 x
    resolution`` for the SMI energy accumulator.  ``resolution_j`` is
    the counter's quantum in joules when the backend knows it (the SMI
    tools report it as ``Counter Resolution``), else 0.  The pipeline
    consumes these fields verbatim — the ingest-backend invariant is
    that wrap ranges are declared here, never inferred downstream.
    """
    metric: str                    # canonical name, e.g. "gpu0.energy"
    kind: str                      # "energy_cum" | "power_inst"
    wrap_range_j: float = 0.0      # cumulative wrap period (J); 0 = none
    resolution_j: float = 0.0      # counter quantum (J); 0 = unknown
    update_interval_s: float = 1e-3   # native refresh estimate
    source: str = ""               # backend name that declared it

    def __post_init__(self):
        assert self.kind in ("energy_cum", "power_inst"), self.kind

    @property
    def is_cumulative(self) -> bool:
        return self.kind == "energy_cum"

    def sensor_spec(self):
        """The core ``SensorSpec`` equivalent (declared wrap carried
        through ``wrap_range_j`` — see ``core.measurement_model``)."""
        from repro_torch.core.measurement_model import SensorSpec
        return SensorSpec(
            self.metric, "node", self.kind,
            production_interval_s=self.update_interval_s,
            quantum=self.resolution_j or 1.0,
            wrap_range_j=self.wrap_range_j)


@dataclasses.dataclass(frozen=True)
class Reading:
    """One sample: what ``SensorBackend.read`` returned for a metric."""
    metric: str
    t_read: float                  # host clock at the read (s)
    t_measured: float              # sensor-reported time, or t_read
    value: float                   # J (energy_cum) or W (power_inst)
    source: str                    # backend that produced it
    cached: bool = False           # served from the last-good cache


class SensorBackend:
    """Informal protocol + shared plumbing for ingest backends.

    Subclasses implement ``_discover() -> [MetricSpec]`` and
    ``read(metric) -> Reading`` (raising :class:`BackendError` on any
    failure).  ``available()`` is discovery-driven by default: a
    backend with no readable metrics is unavailable.  Discovery is
    cached; ``rediscover()`` drops the cache (hotplug, tool upgrade).
    """

    name = "base"

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._specs = None
        self._index, self._index_of = {}, None

    # -- capability discovery -------------------------------------------

    def discover(self) -> list:
        if self._specs is None:
            try:
                self._specs = list(self._discover())
            except BackendError:
                self._specs = []
        return list(self._specs)

    def rediscover(self) -> list:
        self._specs = None
        return self.discover()

    def available(self) -> bool:
        return bool(self.discover())

    def _by_metric(self) -> dict:
        """{metric: first declaring MetricSpec} of the cached discovery,
        rebuilt whenever discovery is redone: a per-read lookup that does
        not scan every declared metric (a fleet's poll reads each of its
        N metrics once)."""
        if self._specs is None:
            self.discover()
        if self._index_of is not self._specs:
            index = {}
            for sp in self._specs:
                index.setdefault(sp.metric, sp)
            self._index, self._index_of = index, self._specs
        return self._index

    def declares(self, metric: str) -> bool:
        return metric in self._by_metric()

    def spec(self, metric: str) -> MetricSpec:
        sp = self._by_metric().get(metric)
        if sp is None:
            raise BackendError(f"{self.name}: unknown metric {metric!r}")
        return sp

    # -- reads ----------------------------------------------------------

    def _discover(self):
        raise NotImplementedError

    def read(self, metric: str) -> Reading:
        raise NotImplementedError

    def close(self) -> None:
        """Release tool/file handles; reads after close may fail."""

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"
