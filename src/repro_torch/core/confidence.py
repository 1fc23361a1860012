"""Confidence-window formalism for reliable steady-state attribution
(Eq. 1; port of ``repro/core/confidence.py``, host numpy).

    W_conf = [t_s + t_d + t_r,  t_e − t_d − t_f]

Within W_conf the reported power approximates steady state; outside it,
measurements are dominated by sensor transition effects.  Phases shorter
than t_d + t_r + t_f have an EMPTY confidence window and must be attributed
via ΔE/Δt energy integration instead (the paper's motivation for §III-A2).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.characterization import StepResponse
from repro_torch.core.reconstruction import PowerSeries


@dataclasses.dataclass(frozen=True)
class ConfidenceWindow:
    t_lo: float
    t_hi: float

    @property
    def empty(self) -> bool:
        return not (self.t_hi > self.t_lo)

    @property
    def width(self) -> float:
        return max(self.t_hi - self.t_lo, 0.0)


def confidence_window(t_s, t_e, resp: StepResponse) -> ConfidenceWindow:
    # A sensor that never resolved a full transition (NaN rise/fall) cannot
    # attribute ANY phase at steady state -> empty window (conservative).
    if np.isnan(resp.rise_s) and np.isnan(resp.fall_s) \
            and np.isnan(resp.delay_s):
        return ConfidenceWindow(t_e, t_s)
    t_d = 0.0 if np.isnan(resp.delay_s) else resp.delay_s
    t_r = 0.0 if np.isnan(resp.rise_s) else resp.rise_s
    t_f = 0.0 if np.isnan(resp.fall_s) else resp.fall_s
    return ConfidenceWindow(t_s + t_d + t_r, t_e - t_d - t_f)


def min_attributable_phase_s(resp: StepResponse) -> float:
    """Shortest phase with a non-empty confidence window."""
    t_d = 0.0 if np.isnan(resp.delay_s) else resp.delay_s
    t_r = 0.0 if np.isnan(resp.rise_s) else resp.rise_s
    t_f = 0.0 if np.isnan(resp.fall_s) else resp.fall_s
    return 2 * t_d + t_r + t_f


@dataclasses.dataclass
class SteadyStateStats:
    window: ConfidenceWindow
    mean_w: float
    std_w: float
    n_samples: int
    reliable: bool


def steady_state(series: PowerSeries, t_s, t_e, resp: StepResponse,
                 *, min_samples=2) -> SteadyStateStats:
    """Steady-state power of a phase, restricted to its confidence window."""
    win = confidence_window(t_s, t_e, resp)
    if win.empty:
        return SteadyStateStats(win, float("nan"), float("nan"), 0, False)
    m = (series.t >= win.t_lo) & (series.t <= win.t_hi)
    n = int(np.sum(m))
    if n < min_samples:
        return SteadyStateStats(win, float("nan"), float("nan"), n, False)
    vals = series.watts[m]
    return SteadyStateStats(win, float(np.mean(vals)), float(np.std(vals)),
                            n, True)
