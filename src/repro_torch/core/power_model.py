"""Ground-truth power process for the sensor fabric (port of
``repro/core/power_model.py``: the piecewise truth, the square wave and
the roofline-occupancy model that maps traced phases to watts).

The occupancy model: at the bottleneck time T = max(terms), each unit's
duty cycle is term/T, and chip power is

    P = P_idle + (P_tdp - P_idle) * clip(w_mxu*c + w_hbm*m + w_ici*x, 0, 1)

Host-side numpy: the truth schedule is a handful of segments, evaluated
on the host for the delay tracker's reference and for ground-truth
energies; nothing here runs on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.measurement_model import CHIP_IDLE_W, CHIP_TDP_W

W_MXU, W_HBM, W_ICI = 0.62, 0.33, 0.05


@dataclasses.dataclass
class PiecewisePower:
    """Right-open segments [t[i], t[i+1]) with constant power w[i]."""
    times: np.ndarray      # (n+1,) segment boundaries, seconds
    watts: np.ndarray      # (n,)

    def __post_init__(self):
        self.times = np.asarray(self.times, np.float64)
        self.watts = np.asarray(self.watts, np.float64)
        assert self.times.ndim == 1 and len(self.times) == len(self.watts) + 1
        assert np.all(np.diff(self.times) > 0), "segments must be increasing"

    @property
    def t0(self):
        return float(self.times[0])

    @property
    def t1(self):
        return float(self.times[-1])

    def power_at(self, t):
        """Instantaneous power, vectorized; clamps outside the domain."""
        t = np.asarray(t, np.float64)
        idx = np.clip(np.searchsorted(self.times, t, side="right") - 1,
                      0, len(self.watts) - 1)
        return self.watts[idx]

    def energy_between(self, t_a, t_b):
        """Exact integral of the piecewise-constant power on [t_a, t_b]."""
        t_a = np.asarray(t_a, np.float64)
        t_b = np.asarray(t_b, np.float64)
        edges = self.times
        cum = np.concatenate([[0.0], np.cumsum(self.watts
                                               * np.diff(edges))])

        def cum_at(t):
            tc = np.clip(t, edges[0], edges[-1])
            idx = np.clip(np.searchsorted(edges, tc, side="right") - 1,
                          0, len(self.watts) - 1)
            return cum[idx] + self.watts[idx] * (tc - edges[idx])

        return cum_at(t_b) - cum_at(t_a)

    def average_power(self, t_a, t_b):
        return self.energy_between(t_a, t_b) / np.maximum(t_b - t_a, 1e-12)


def square_wave(period_s, n_cycles, *, duty=0.5, p_idle=CHIP_IDLE_W,
                p_active=CHIP_TDP_W, t_start=0.0, lead_s=1.0, tail_s=1.0):
    """The paper's characterization workload (§IV-B): idle/active square
    wave with equal (or ``duty``) halves, MPI-synchronized across devices."""
    times = [t_start]
    watts = []
    if lead_s > 0:
        times.append(t_start + lead_s)
        watts.append(p_idle)
    t = times[-1]
    for _ in range(n_cycles):
        times.append(t + duty * period_s)
        watts.append(p_active)
        times.append(t + period_s)
        watts.append(p_idle)
        t += period_s
    if tail_s > 0:
        times.append(t + tail_s)
        watts.append(p_idle)
    return PiecewisePower(np.asarray(times), np.asarray(watts))


def occupancy_power(compute_s, memory_s, collective_s, *,
                    p_idle=CHIP_IDLE_W, p_tdp=CHIP_TDP_W):
    """Chip watts for a phase with the given roofline terms."""
    t = max(compute_s, memory_s, collective_s, 1e-12)
    occ = (W_MXU * compute_s / t + W_HBM * memory_s / t
           + W_ICI * collective_s / t)
    return float(p_idle + (p_tdp - p_idle) * min(max(occ, 0.0), 1.0))


def phase_power(phases, roofline_by_phase, *, p_idle=CHIP_IDLE_W,
                p_tdp=CHIP_TDP_W, default_power=None):
    """Build a PiecewisePower from traced phases.

    phases: list of (name, t_start_s, t_end_s), non-overlapping, sorted.
    roofline_by_phase: name -> (compute_s, memory_s, collective_s) or
        explicit {"watts": W}.
    """
    default_power = p_idle if default_power is None else default_power
    times = []
    watts = []
    cursor = None
    for name, ts, te in phases:
        if cursor is None:
            times.append(ts)
        elif ts > cursor + 1e-9:
            times.append(ts)
            watts.append(default_power)      # inter-phase gap = idle
        spec = roofline_by_phase.get(name)
        if spec is None:
            w = default_power
        elif isinstance(spec, dict):
            w = float(spec["watts"])
        else:
            w = occupancy_power(*spec, p_idle=p_idle, p_tdp=p_tdp)
        times.append(te)
        watts.append(w)
        cursor = te
    return PiecewisePower(np.asarray(times), np.asarray(watts))
