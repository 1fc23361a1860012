"""Aliasing analysis (§III-A1c, §V-A3, Fig. 6 and Fig. 10; port of
``repro/core/aliasing.py``, host numpy).

Two stacked aliasing layers, per the paper:
  1. sensor-production Nyquist — a 1 ms counter cannot resolve >500 Hz power
     activity;
  2. tool-observation downsampling — instrumentation overhead widens the
     effective detection interval beyond the sensor's own cadence.

Plus firmware low-pass filtering, which *shifts the apparent aliasing cutoff
to longer periods* by suppressing short transitions (why the paper bases
Fig. 6 on ΔE/Δt rather than vendor-averaged power).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.reconstruction import PowerSeries


@dataclasses.dataclass
class TransitionDetection:
    period_s: float
    error_rate: float          # fraction of half-periods mis-detected
    n_halves: int


def transition_detection_error(series: PowerSeries, edges,
                               *, t_end=None) -> TransitionDetection:
    """Paper Fig. 6 metric.  A half-period is detected if at least one
    sample inside it lies on the correct side of the run mean ('a sensor is
    considered to have recorded an active state when the measurement exceeds
    the average power for that node')."""
    edges = np.asarray(edges, np.float64)
    mean = float(np.mean(series.watts))
    n_err = 0
    n_tot = 0
    t_stop = t_end if t_end is not None else edges[-1]
    for i in range(len(edges) - 1):
        a, b = edges[i], min(edges[i + 1], t_stop)
        active = (i % 2 == 0)          # edges alternate active/idle starts
        m = (series.t > a) & (series.t <= b)
        n_tot += 1
        if not np.any(m):
            n_err += 1
            continue
        vals = series.watts[m]
        hit = np.any(vals > mean) if active else np.any(vals < mean)
        if not hit:
            n_err += 1
    period = float(np.median(np.diff(edges)) * 2)
    return TransitionDetection(period, n_err / max(n_tot, 1), n_tot)


def nyquist_limit_hz(update_interval_s: float) -> float:
    return 0.5 / update_interval_s


@dataclasses.dataclass
class SpectrumAnalysis:
    freqs_hz: np.ndarray
    psd: np.ndarray
    peak_hz: float
    true_hz: float
    folded: bool
    noise_floor_ratio: float   # broadband noise vs peak (folding artifact)


def fft_analysis(series: PowerSeries, true_freq_hz,
                 *, grid_hz=None) -> SpectrumAnalysis:
    """Fig. 10: without aliasing the square wave's fundamental appears at
    its true frequency; undersampled, the peak folds to a lower frequency
    and broadband noise rises across the spectrum."""
    dt = np.median(np.diff(series.t))
    fs = 1.0 / dt if grid_hz is None else grid_hz
    grid = np.arange(series.t[0], series.t[-1], 1.0 / fs)
    x = series.resample(grid).watts
    x = x - np.mean(x)
    n = len(x)
    win = np.hanning(n)
    spec = np.abs(np.fft.rfft(x * win)) ** 2
    freqs = np.fft.rfftfreq(n, 1.0 / fs)
    if len(spec) > 1:
        spec[0] = 0.0
    peak = float(freqs[int(np.argmax(spec))]) if len(spec) else 0.0
    psum = float(np.max(spec)) if len(spec) else 1.0
    # broadband floor: median non-peak energy relative to the peak
    floor = float(np.median(spec) / max(psum, 1e-30))
    folded = abs(peak - true_freq_hz) > 0.25 * true_freq_hz
    return SpectrumAnalysis(freqs, spec, peak, true_freq_hz, folded, floor)


def aliasing_sweep(make_series, periods_s):
    """Run transition detection across square-wave periods -> Fig. 6 curve.

    make_series: period_s -> (PowerSeries, edges array).
    """
    out = []
    for p in periods_s:
        series, edges = make_series(p)
        out.append(transition_detection_error(series, edges))
    return out
