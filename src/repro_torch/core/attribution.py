"""Phase-level power/energy attribution (port of
``repro/core/attribution.py``).

  * energy counters: exact dE between phase boundaries (interpolated on
    the unwrapped cumulative counter);
  * power sensors: sample-and-hold integration of the reported series,
    with steady-state stats inside each phase's confidence window
    (``resp=``, Eq. 1);
  * offsets (NIC rail) removed via ``core.calibration`` before
    attribution.

``attribute_energy`` is the per-trace host path (numpy), the parity
oracle of the batched device paths that ``attribute_energy_many`` and
``stacked_node_power`` take for counters (``fleet.api``).

Invariant: phase energies + gap energies == total counter delta
(``energy_conservation_residual``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.calibration import apply_corrections
from repro_torch.core.characterization import StepResponse
from repro_torch.core.confidence import SteadyStateStats, steady_state
from repro_torch.core.reconstruction import (delta_e_over_delta_t,
                                             power_trace_series,
                                             unwrap_counter)
from repro_torch.core.sensors import SensorTrace


@dataclasses.dataclass
class PhaseEnergy:
    phase: str
    t_start: float
    t_end: float
    energy_j: float
    mean_power_w: float
    steady: SteadyStateStats = None


def _cum_energy_at(trace: SensorTrace, times):
    """Unwrapped cumulative energy, linearly interpolated at `times`."""
    ch = trace.changed_mask()
    t = trace.t_measured[ch]
    e = unwrap_counter(trace.value[ch], period=trace.spec.wrap_period_j)
    keep = np.concatenate([[True], np.diff(t) > 0])
    return np.interp(times, t[keep], e[keep])


def attribute_energy(trace: SensorTrace, phases, *,
                     resp: StepResponse = None, corrections=None) -> list:
    """Per-phase energy from one sensor (host numpy).

    phases: [(name, t_start, t_end)] in the unified timebase.
    resp: the sensor's step response; power sensors then carry each
    phase's steady-state stats over its confidence window.
    """
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
        st = steady_state(series, a, b, resp) if resp is not None else None
        out.append(PhaseEnergy(name, a, b, e, e / max(b - a, 1e-12), st))
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


def attribute_power_series(trace: SensorTrace, phases,
                           *, corrections=None) -> dict:
    """Reconstructed (ΔE/Δt) power per phase — stacked plots
    (Fig. 7/8)."""
    trace = apply_corrections(trace, corrections)
    series = (delta_e_over_delta_t(trace) if trace.spec.is_cumulative
              else power_trace_series(trace))
    per_phase = {}
    for name, a, b in phases:
        m = (series.t >= a) & (series.t <= b)
        per_phase.setdefault(name, []).append(
            (series.t[m], series.watts[m]))
    return per_phase


def energy_conservation_residual(trace: SensorTrace, phases) -> float:
    """|Σ phase ΔE + Σ gap ΔE − total ΔE| / total ΔE over the phase
    span."""
    spans = sorted([(a, b) for _, a, b in phases])
    t_lo, t_hi = spans[0][0], max(b for _, b in spans)
    segs = []
    cursor = t_lo
    for a, b in spans:
        if a > cursor:
            segs.append((cursor, a))
        segs.append((a, max(b, cursor)))
        cursor = max(cursor, b)
    ts = np.asarray([s[0] for s in segs])
    te = np.asarray([s[1] for s in segs])
    parts = _cum_energy_at(trace, te) - _cum_energy_at(trace, ts)
    total = _cum_energy_at(trace, np.asarray([t_hi]))[0] \
        - _cum_energy_at(trace, np.asarray([t_lo]))[0]
    return abs(float(np.sum(parts) - total)) / max(abs(total), 1e-12)


def stacked_node_power(traces: dict, grid, *, corrections=None,
                       use_fleet: bool = True, device=None) -> dict:
    """Per-component power matrix on a common grid (Fig. 7/8 stacked view).

    Returns {"grid": grid, components: {name: watts}} with chips from
    ΔE/Δt-reconstructed on-chip counters and CPU/memory from PM sensors.
    All chip counters reconstruct in one batched ``fleet_power_series``
    call on ``device`` (None means CUDA); pass ``use_fleet=False`` for
    the per-trace host path (parity oracle).
    """
    comps = {}
    chip_traces = []
    for name, tr in traces.items():
        if tr.spec.is_cumulative and tr.name.startswith("chip"):
            if use_fleet:
                chip_traces.append(tr)
                continue
            s = delta_e_over_delta_t(apply_corrections(tr, corrections))
        elif tr.name in ("pm_cpu_power", "pm_memory_power"):
            s = power_trace_series(apply_corrections(tr, corrections))
        else:
            continue
        comps[name] = s.resample(grid).watts
    if chip_traces:
        from repro_torch.fleet.api import fleet_power_series
        for tr, s in zip(chip_traces,
                         fleet_power_series(chip_traces,
                                            corrections=corrections,
                                            device=device)):
            comps[tr.name] = s.resample(grid).watts
    return {"grid": np.asarray(grid), "components": comps}


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
