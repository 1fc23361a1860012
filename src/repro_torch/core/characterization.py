"""Blind sensor characterization from square-wave observations
(§III-A1, §V-A; port of ``repro/core/characterization.py``, host numpy).

Given only a SensorTrace (what a practitioner sees) and the workload's known
phase schedule (which the practitioner controls), estimate:

  * update interval   — production & observation cadences (paper Fig. 4),
  * delay t_d         — onset lag after a true edge,
  * response time t_r — 10–90% rise,
  * recovery time t_f — 90–10% fall.

These estimates feed the confidence-window formalism (Eq. 1) and are tested
against the simulator's configured ground truth.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.reconstruction import (PowerSeries,
                                             delta_e_over_delta_t,
                                             power_trace_series)
from repro_torch.core.sensors import SensorTrace


@dataclasses.dataclass
class UpdateIntervalStats:
    """The three cadences of Fig. 4 (left/middle/right columns)."""
    measured_deltas: np.ndarray     # Δ t_measured of *changed* samples
    publish_deltas: np.ndarray      # Δ t_measured over all refreshes seen
    observed_deltas: np.ndarray     # Δ t_read (tool observation cadence)

    def summary(self):
        def s(x):
            return {} if len(x) == 0 else {
                "median": float(np.median(x)), "p10": float(
                    np.percentile(x, 10)), "p90": float(np.percentile(x, 90)),
                "mean": float(np.mean(x))}
        return {"measured": s(self.measured_deltas),
                "published": s(self.publish_deltas),
                "observed": s(self.observed_deltas)}


def update_intervals(trace: SensorTrace) -> UpdateIntervalStats:
    ch = trace.changed_mask()
    tm_changed = trace.t_measured[ch]
    val = trace.value[ch]
    value_changed = np.concatenate([[True], np.diff(val) != 0])
    return UpdateIntervalStats(
        measured_deltas=np.diff(tm_changed[value_changed]),
        publish_deltas=np.diff(tm_changed),
        observed_deltas=np.diff(trace.t_read),
    )


@dataclasses.dataclass
class StepResponse:
    delay_s: float            # t_d: edge -> first observable movement
    rise_s: float             # t_r: 10% -> 90%
    fall_s: float             # t_f: 90% -> 10%
    idle_w: float
    active_w: float
    n_edges_used: int


def _crossing_time(t, v, level, start_idx, rising):
    """First time v crosses `level` at/after start_idx (linear interp)."""
    seg = v[start_idx:]
    if rising:
        hits = np.nonzero(seg >= level)[0]
    else:
        hits = np.nonzero(seg <= level)[0]
    if len(hits) == 0:
        return None
    i = start_idx + hits[0]
    if i == 0 or v[i] == v[i - 1]:
        return t[i]
    frac = (level - v[i - 1]) / (v[i] - v[i - 1])
    return t[i - 1] + frac * (t[i] - t[i - 1])


def step_response(series: PowerSeries, edges_up, edges_down,
                  *, settle_frac=0.25) -> StepResponse:
    """Median delay/rise/fall over all square-wave edges.

    edges_up/edges_down: true workload transition times (known schedule).
    """
    t, v = series.t, series.watts
    period = np.median(np.diff(edges_up)) if len(edges_up) > 1 else \
        (edges_down[0] - edges_up[0]) * 2
    half = period / 2.0
    idle = np.percentile(v, 5)
    active = np.percentile(v, 95)
    lo = idle + 0.10 * (active - idle)
    hi = idle + 0.90 * (active - idle)

    delays, rises, falls = [], [], []
    for e in edges_up:
        i0 = np.searchsorted(t, e)
        if i0 >= len(t):
            continue
        t10 = _crossing_time(t, v, lo, i0, rising=True)
        t90 = _crossing_time(t, v, hi, i0, rising=True)
        if t10 is None or t90 is None or t90 - e > half * 2:
            continue
        delays.append(max(t10 - e, 0.0))
        rises.append(max(t90 - t10, 0.0))
    for e in edges_down:
        i0 = np.searchsorted(t, e)
        if i0 >= len(t):
            continue
        t90 = _crossing_time(t, v, hi, i0, rising=False)
        t10 = _crossing_time(t, v, lo, i0, rising=False)
        if t10 is None or t90 is None or t10 - e > half * 2:
            continue
        falls.append(max(t10 - t90, 0.0))

    med = lambda x: float(np.median(x)) if x else float("nan")  # noqa: E731
    return StepResponse(
        delay_s=med(delays), rise_s=med(rises), fall_s=med(falls),
        idle_w=float(idle), active_w=float(active),
        n_edges_used=min(len(delays), len(falls)) or len(delays))


def characterize_sensor(trace: SensorTrace, edges_up, edges_down):
    """Full characterization record for one sensor under a square wave."""
    if trace.spec.is_cumulative:
        series = delta_e_over_delta_t(trace)
    else:
        series = power_trace_series(trace)
    return {
        "sensor": trace.name,
        "kind": trace.spec.kind,
        "update_intervals": update_intervals(trace).summary(),
        "step_response": dataclasses.asdict(
            step_response(series, edges_up, edges_down)),
        "lag_read_vs_measured_s": float(
            np.median(trace.t_read - trace.t_measured)),
    }
