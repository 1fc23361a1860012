"""Offset/slope sensor corrections (§III-A1e, Appendix B); the port's
copy of ``repro/core/calibration.py``, host-side numpy.

The paper's concrete case: on Portage, the Cassini NIC shares the 48 V rail
with APUs 0 and 2, adding a ~30±2 W static offset to their PM counters,
estimated under network-quiet idle and subtracted during attribution.  The
PM-vs-on-chip upstream slope (+5–10% on Frontier, ~1% on Portage) is
likewise estimated from steady-state windows.

``estimate_static_offsets`` performs exactly the paper's App-B procedure:
compare idle-window PM readings per accelerator against the on-chip
ΔE/Δt-derived power, per node, and report the per-accelerator offset.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.reconstruction import delta_e_over_delta_t, \
    power_trace_series
from repro_torch.core.sensors import SensorTrace


@dataclasses.dataclass(frozen=True)
class Corrections:
    offsets_w: dict            # sensor name -> static offset to subtract
    slopes: dict               # sensor name -> divide-by slope (PM upstream)

    def offset_for(self, name):
        return self.offsets_w.get(name, 0.0)

    def slope_for(self, name):
        return self.slopes.get(name, 1.0)


def apply_corrections(trace: SensorTrace, corrections) -> SensorTrace:
    if corrections is None:
        return trace
    off = corrections.offset_for(trace.name)
    slope = corrections.slope_for(trace.name)
    if off == 0.0 and slope == 1.0:
        return trace
    val = trace.value
    if trace.spec.is_cumulative:
        # energy counters: offset integrates over elapsed time
        t = trace.t_measured - trace.t_measured[0]
        val = (val - off * t) / slope
    else:
        val = (val - off) / slope
    return SensorTrace(trace.name, trace.spec, trace.t_read,
                       trace.t_measured, val)


def estimate_static_offsets(pm_traces: dict, chip_energy_traces: dict,
                            idle_windows, *, match=lambda pm: pm.replace(
                                "pm_accel", "chip").replace("_power",
                                                            "_energy")):
    """App-B procedure: per-accelerator PM static offset under idle.

    pm_traces: {"pm_accel{i}_power": SensorTrace}
    chip_energy_traces: {"chip{i}_energy": SensorTrace}
    idle_windows: [(t_lo, t_hi)] network-quiet idle intervals.
    Returns ({pm_name: offset_w}, details).
    """
    offsets = {}
    details = {}
    for pm_name, pm in pm_traces.items():
        chip_name = match(pm_name)
        chip = chip_energy_traces.get(chip_name)
        if chip is None:
            continue
        pm_series = power_trace_series(pm)
        chip_series = delta_e_over_delta_t(chip)
        diffs = []
        for (a, b) in idle_windows:
            mp = (pm_series.t >= a) & (pm_series.t <= b)
            mc = (chip_series.t >= a) & (chip_series.t <= b)
            if mp.sum() < 1 or mc.sum() < 2:
                continue
            diffs.append(np.mean(pm_series.watts[mp])
                         - np.mean(chip_series.watts[mc]))
        if not diffs:
            continue
        med = float(np.median(diffs))
        offsets[pm_name] = med
        details[pm_name] = {"n_windows": len(diffs),
                            "spread_w": float(np.std(diffs))}
    return offsets, details


def estimate_upstream_slope(pm_trace, chip_energy_trace, steady_windows,
                            *, offset_w=0.0):
    """PM/on-chip steady-state ratio (the 5–10% upstream factor)."""
    pm = power_trace_series(pm_trace)
    chip = delta_e_over_delta_t(chip_energy_trace)
    ratios = []
    for (a, b) in steady_windows:
        mp = (pm.t >= a) & (pm.t <= b)
        mc = (chip.t >= a) & (chip.t <= b)
        if mp.sum() < 1 or mc.sum() < 2:
            continue
        denom = np.mean(chip.watts[mc])
        if denom > 1.0:
            ratios.append((np.mean(pm.watts[mp]) - offset_w) / denom)
    return float(np.median(ratios)) if ratios else float("nan")


def nic_rail_corrections(chips_on_nic_rail=(0, 2), nic_w=30.0,
                         pm_slope=1.07) -> Corrections:
    """The paper's fixed correction set for EX255a-style packaging."""
    offsets = {f"pm_accel{c}_power": nic_w for c in chips_on_nic_rail}
    offsets.update({f"pm_accel{c}_energy": nic_w
                    for c in chips_on_nic_rail})
    slopes = {}
    for c in range(4):
        slopes[f"pm_accel{c}_power"] = pm_slope
        slopes[f"pm_accel{c}_energy"] = pm_slope
    return Corrections(offsets, slopes)
