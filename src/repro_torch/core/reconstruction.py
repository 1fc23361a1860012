"""Reconstructed power series and counter unwrapping (port of
``PowerSeries`` and ``unwrap_counter`` from
``repro/core/reconstruction.py``): host-side numpy."""
from __future__ import annotations

import dataclasses

import numpy as np


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
