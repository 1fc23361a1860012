"""Reconstructed power series, counter unwrapping and the per-trace
dE/dt (port of ``repro/core/reconstruction.py``): host-side numpy, the
per-trace oracle of the batched device path (``fleet.fleet_reconstruct``),
plus the boxcar inversion and the many-series resample."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.sensors import SensorTrace


@dataclasses.dataclass
class PowerSeries:
    """Reconstructed instantaneous power: P[i] holds on (t[i], t[i+1]]."""
    t: np.ndarray          # (n,) sample times (right edge of each interval)
    watts: np.ndarray      # (n,)
    source: str = ""

    def resample(self, grid):
        """Previous-sample-and-hold onto a uniform grid."""
        idx = np.clip(np.searchsorted(self.t, grid, side="left"),
                      0, len(self.t) - 1)
        return PowerSeries(np.asarray(grid), self.watts[idx], self.source)

    def energy_between(self, t_a, t_b):
        """Integrate the sample-and-hold power over [t_a, t_b]."""
        edges = np.concatenate([[self.t[0]], self.t])
        seg = np.diff(edges)
        cum = np.concatenate([[0.0], np.cumsum(self.watts * seg)])

        def cum_at(t):
            tc = np.clip(t, edges[0], edges[-1])
            i = np.clip(np.searchsorted(edges, tc, side="right") - 1,
                        0, len(seg) - 1)
            return cum[i] + self.watts[i] * (tc - edges[i])

        return cum_at(np.asarray(t_b)) - cum_at(np.asarray(t_a))


def unwrap_counter(values, wrap_bits=0, quantum=1.0, *, period=None):
    """Undo cumulative-counter wraparound.

    The wrap period is DECLARED by the caller — either explicitly via
    ``period`` (value units) or as ``2**wrap_bits * quantum`` ticks —
    never inferred from the observed deltas.
    """
    if period is None:
        period = (2.0 ** wrap_bits) * quantum if wrap_bits else 0.0
    if not period:
        return np.asarray(values, np.float64)
    v = np.asarray(values, np.float64)
    jumps = np.diff(v) < -0.5 * period
    wraps = np.concatenate([[0.0], np.cumsum(jumps.astype(np.float64))])
    return v + wraps * period


def delta_e_over_delta_t(trace: SensorTrace, *, use_t_measured=True,
                         min_dt=None) -> PowerSeries:
    """The paper's reconstruction, from a cumulative-energy SensorTrace:
    repeated publications are dropped, the counter unwrapped with its
    declared period, reordered timestamps dropped; ``min_dt`` coalesces
    samples closer than that to bound quantization noise."""
    assert trace.spec.is_cumulative, f"{trace.name} is not an energy counter"
    ch = trace.changed_mask()
    t = (trace.t_measured if use_t_measured else trace.t_read)[ch]
    e = unwrap_counter(trace.value[ch], period=trace.spec.wrap_period_j)
    keep = np.concatenate([[True], np.diff(t) > 0])
    t, e = t[keep], e[keep]
    if min_dt:
        sel = [0]
        last = t[0]
        for i in range(1, len(t)):
            if t[i] - last >= min_dt:
                sel.append(i)
                last = t[i]
        t, e = t[np.asarray(sel)], e[np.asarray(sel)]
    dt = np.diff(t)
    de = np.diff(e)
    return PowerSeries(t[1:], de / dt, source=trace.name)


def power_trace_series(trace: SensorTrace, *, use_t_measured=True,
                       dedupe=True) -> PowerSeries:
    """A (possibly filtered) power sensor as a PowerSeries, deduplicated."""
    ch = trace.changed_mask() if dedupe else np.ones(len(trace), bool)
    t = (trace.t_measured if use_t_measured else trace.t_read)[ch]
    keep = np.concatenate([[True], np.diff(t) > 0])
    return PowerSeries(t[keep], trace.value[ch][keep], source=trace.name)


def invert_moving_average(series: PowerSeries, window_s) -> PowerSeries:
    """Exact inversion of a boxcar moving average on a uniform grid.

    If y_t = mean(x over [t-w, t]) on a grid of step h with k = w/h
    samples, then x_t = k·y_t − k·y_{t−1} + x_{t−k}: this undoes vendor
    filtering when only the averaged power field is exposed.
    """
    h = np.median(np.diff(series.t))
    k = max(int(round(window_s / h)), 1)
    if k == 1:
        return series
    grid = series.t[0] + h * np.arange(len(series.t))
    y = series.resample(grid).watts
    x = np.copy(y)
    # bootstrap assuming a zero-initialized (cold) filter: for t < k,
    # k*y_t = sum_{0..t} x  =>  x_t = k*(y_t - y_{t-1})
    x[0] = k * y[0]
    for i in range(1, min(k, len(y))):
        x[i] = k * (y[i] - y[i - 1])
    for i in range(k, len(y)):
        x[i] = k * y[i] - k * y[i - 1] + x[i - k]
    return PowerSeries(grid, x, source=series.source + ":deconv")


def align_series(series_list, grid):
    """Resample many PowerSeries onto one grid -> (names, matrix)."""
    names = [s.source for s in series_list]
    mat = np.stack([s.resample(grid).watts for s in series_list])
    return names, mat
