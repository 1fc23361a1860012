"""SimBackend: the sensor-fabric simulator behind the backend protocol
(port of ``repro/ingest/sim.py``).

Wraps recorded :class:`~repro_torch.core.sensors.SensorTrace` streams (e.g.
``NodeFabric.sample_all``) and replays them against the host clock at
``speed``x — each ``read`` returns the newest sample a real tool would
have seen by now, exactly the ``SimulatedSMIReader`` poll idiom.  With
this adapter the simulated path is just another backend: the same
``PrioritizedIngest`` -> ``AsyncFleetIngest`` -> streaming-pipeline
wiring drives simulation, CI fixtures, and real counters.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.ingest.backend import (BackendError, MetricSpec,
                                        Reading, SensorBackend)


class SimBackend(SensorBackend):
    """Replay recorded SensorTraces as a live backend.

    traces: {metric_name: SensorTrace} or a list (trace names become
    metric names).  The declared counter semantics come from each
    trace's ``SensorSpec`` — wrap range and quantum included — so the
    pipeline treats simulated counters exactly like RAPL/SMI ones.
    """

    name = "sim"

    def __init__(self, traces, *, speed: float = 8.0,
                 clock=time.perf_counter):
        super().__init__(clock=clock)
        if not isinstance(traces, dict):
            traces = {tr.name: tr for tr in traces}
        self._traces = dict(traces)
        self.speed = float(speed)
        self._t0_wall = None
        self._t0_sim = min(float(tr.t_read[0])
                           for tr in self._traces.values()) \
            if self._traces else 0.0

    def _discover(self):
        specs = []
        for metric, tr in self._traces.items():
            specs.append(MetricSpec(
                metric, tr.spec.kind if tr.spec.is_cumulative
                else "power_inst",
                wrap_range_j=tr.spec.wrap_period_j,
                resolution_j=tr.spec.quantum,
                update_interval_s=tr.spec.production_interval_s,
                source=self.name))
        return specs

    def _t_sim(self) -> float:
        now = self._clock()
        if self._t0_wall is None:
            self._t0_wall = now
        return self._t0_sim + (now - self._t0_wall) * self.speed

    def read(self, metric: str) -> Reading:
        tr = self._traces.get(metric)
        if tr is None:
            raise BackendError(f"sim: unknown metric {metric!r}")
        t_sim = self._t_sim()
        j = int(np.searchsorted(tr.t_read, t_sim, side="right")) - 1
        if j < 0:
            raise BackendError(f"sim: {metric} has no sample at "
                               f"t={t_sim:.6f} yet")
        return Reading(metric, self._clock(),
                       float(tr.t_measured[j]), float(tr.value[j]),
                       self.name)

    @property
    def drained(self) -> bool:
        """True once the replay clock passed every trace's last read."""
        t_sim = self._t_sim()
        return all(t_sim >= float(tr.t_read[-1])
                   for tr in self._traces.values())
