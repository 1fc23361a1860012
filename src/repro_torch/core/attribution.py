"""Phase-level power/energy attribution (port of ``PhaseEnergy``,
``attribute_energy``, ``attribute_energy_many`` and
``split_energy_savings`` from ``repro/core/attribution.py``).

  * energy counters: exact dE between phase boundaries (interpolated on
    the unwrapped cumulative counter);
  * power sensors: sample-and-hold integration of the reported series;
  * offsets (NIC rail) removed via ``core.calibration`` before
    attribution.

``attribute_energy`` is the per-trace host path (numpy), the parity
oracle of the batched device path that ``attribute_energy_many`` takes
for counters (``fleet.attribute_energy_fleet``).  The reference's
steady-state confidence windows (``resp=``, from ``characterization`` and
``confidence``) are not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.calibration import apply_corrections
from repro_torch.core.reconstruction import (power_trace_series,
                                             unwrap_counter)
from repro_torch.core.sensors import SensorTrace


@dataclasses.dataclass
class PhaseEnergy:
    phase: str
    t_start: float
    t_end: float
    energy_j: float
    mean_power_w: float
    steady: object = None     # steady-state stats (not produced by the port)


def _cum_energy_at(trace: SensorTrace, times):
    """Unwrapped cumulative energy, linearly interpolated at `times`."""
    ch = trace.changed_mask()
    t = trace.t_measured[ch]
    e = unwrap_counter(trace.value[ch], period=trace.spec.wrap_period_j)
    keep = np.concatenate([[True], np.diff(t) > 0])
    return np.interp(times, t[keep], e[keep])


def attribute_energy(trace: SensorTrace, phases, *, resp=None,
                     corrections=None) -> list:
    """Per-phase energy from one sensor (host numpy).

    phases: [(name, t_start, t_end)] in the unified timebase.
    """
    if resp is not None:
        raise NotImplementedError(
            "repro_torch's attribute_energy does not support resp= "
            "(steady-state confidence windows) yet")
    trace = apply_corrections(trace, corrections)
    out = []
    if trace.spec.is_cumulative:
        ts = np.asarray([p[1] for p in phases])
        te = np.asarray([p[2] for p in phases])
        e0 = _cum_energy_at(trace, ts)
        e1 = _cum_energy_at(trace, te)
        for (name, a, b), ea, eb in zip(phases, e0, e1):
            dur = max(b - a, 1e-12)
            out.append(PhaseEnergy(name, a, b, float(eb - ea),
                                   float((eb - ea) / dur)))
        return out
    series = power_trace_series(trace)
    for name, a, b in phases:
        e = float(series.energy_between(a, b))
        out.append(PhaseEnergy(name, a, b, e, e / max(b - a, 1e-12)))
    return out


def attribute_energy_many(traces, phases, *, corrections=None,
                          use_fleet: bool = True, chunk: int = 1024,
                          interpret=None, device=None) -> list:
    """Per-phase energy for MANY traces -> one [PhaseEnergy] list each.

    Cumulative-energy traces go through the batched fleet path on
    ``device`` (None means CUDA; ``fleet.attribute_energy_fleet``);
    power sensors and ``use_fleet=False`` take the per-trace host loop,
    which stays the parity oracle.
    """
    traces = list(traces)
    if not use_fleet:
        return [attribute_energy(tr, phases, corrections=corrections)
                for tr in traces]
    from repro_torch.fleet.api import attribute_energy_fleet
    cum = [i for i, tr in enumerate(traces) if tr.spec.is_cumulative]
    out = [None] * len(traces)
    if cum:
        rows = attribute_energy_fleet([traces[i] for i in cum], phases,
                                      corrections=corrections, chunk=chunk,
                                      interpret=interpret, device=device)
        for i, row in zip(cum, rows):
            out[i] = row
    for i, tr in enumerate(traces):
        if out[i] is None:
            out[i] = attribute_energy(tr, phases, corrections=corrections)
    return out


def split_energy_savings(full: list, mixed: list) -> dict:
    """The paper's headline decomposition (§V-B): how much of the energy
    saving comes from reduced time-to-solution vs lower instantaneous
    power.

        E = P_avg * T;  E_f/E_m = (P_f/P_m) * (T_f/T_m)
    """
    ef = sum(p.energy_j for p in full)
    em = sum(p.energy_j for p in mixed)
    tf = sum(p.t_end - p.t_start for p in full)
    tm = sum(p.t_end - p.t_start for p in mixed)
    pf, pm = ef / max(tf, 1e-12), em / max(tm, 1e-12)
    return {
        "energy_full_j": ef, "energy_mixed_j": em,
        "saving_frac": 1.0 - em / max(ef, 1e-12),
        "time_full_s": tf, "time_mixed_s": tm,
        "time_ratio": tm / max(tf, 1e-12),
        "power_full_w": pf, "power_mixed_w": pm,
        "power_ratio": pm / max(pf, 1e-12),
    }
