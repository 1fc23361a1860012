"""Sensor-fabric simulator (port of ``repro/core/sensors.py``: the three
stages, ``simulate_sensor``, fault injection and the per-node
``NodeFabric``).

The randomness is numpy ``default_rng`` seeded exactly as the reference
seeds it, so both packages produce bit-identical traces from one seed.
Host-side numpy: this is the data source, not the device path.
"""
from __future__ import annotations

import dataclasses
import re
import zlib

import numpy as np

from repro_torch.core.measurement_model import (DDR_W, HOST_CPU_W, NIC_W,
                                                SensorSpec, ToolSpec,
                                                default_node_sensors)
from repro_torch.core.power_model import PiecewisePower


@dataclasses.dataclass
class SensorTrace:
    """One sampled stream: what the instrumentation layer recorded."""
    name: str
    spec: SensorSpec
    t_read: np.ndarray        # tool-side timestamps (s)
    t_measured: np.ndarray    # sensor-reported timestamps (s)
    value: np.ndarray         # J (cumulative) or W

    def __len__(self):
        return len(self.t_read)

    def changed_mask(self):
        """True where the published value actually refreshed."""
        ch = np.ones(len(self.value), bool)
        ch[1:] = self.t_measured[1:] != self.t_measured[:-1]
        return ch


def _jittered_grid(t0, t1, interval, jitter, rng):
    n = int((t1 - t0) / interval) + 2
    steps = interval + rng.normal(0.0, jitter, n)
    steps = np.maximum(steps, interval * 0.25)
    t = t0 + np.cumsum(steps)
    return t[t < t1]


def produce(spec: SensorSpec, truth: PiecewisePower, rng) -> tuple:
    """Stage 1: (t_measured, value) at the sensor's own cadence.

    ``spec.delay_s`` is a fixed sensing latency (the sample stamped ``tm``
    reflects the state at ``tm - delay_s``); ``spec.drift_ppm`` stretches
    the reported clock linearly from the run start.
    """
    t0, t1 = truth.t0, truth.t1
    tm = _jittered_grid(t0, t1, spec.production_interval_s,
                        spec.production_jitter_s, rng)
    te = np.maximum(tm - spec.delay_s, t0) if spec.delay_s else tm
    if spec.drift_ppm:
        tm = tm + (tm - t0) * (spec.drift_ppm * 1e-6)
    if spec.kind == "energy_cum":
        e = truth.energy_between(t0, te) * spec.scale \
            + spec.offset_w * (te - t0)
        ticks = np.floor(e / spec.quantum)
        if spec.wrap_bits:
            ticks = np.mod(ticks, 2.0 ** spec.wrap_bits)
        val = ticks * spec.quantum
    else:
        if spec.filter_kind == "ma" and spec.filter_window_s > 0:
            w = spec.filter_window_s
            val = truth.energy_between(np.maximum(te - w, t0), te) \
                / np.maximum(te - np.maximum(te - w, t0), 1e-9)
        elif spec.filter_kind == "iir" and spec.filter_window_s > 0:
            tau = spec.filter_window_s
            seg = truth.average_power(
                np.concatenate([[t0], te[:-1]]), te)
            val = np.empty_like(seg)
            y = truth.power_at(t0)
            prev_t = t0
            for i, (t, p) in enumerate(zip(te, seg)):
                a = np.exp(-max(t - prev_t, 0.0) / tau)
                y = a * y + (1 - a) * p
                val[i] = y
                prev_t = t
        else:
            val = truth.power_at(te)
        val = val * spec.scale + spec.offset_w
        if spec.noise_w:
            val = val + rng.normal(0.0, spec.noise_w, len(val))
        if spec.quantum:
            val = np.round(val / spec.quantum) * spec.quantum
    t_reported = tm + rng.normal(0.0, spec.timestamp_jitter_s, len(tm))
    return t_reported, val


def publish(spec: SensorSpec, tm, val, t0, t1, rng) -> tuple:
    """Stage 2: driver refresh — the latest produced sample at each
    publication instant; returns (t_pub, t_measured_pub, value_pub)."""
    tp = _jittered_grid(t0, t1, spec.driver_refresh_s,
                        spec.driver_jitter_s, rng)
    idx = np.searchsorted(tm, tp, side="right") - 1
    keep = idx >= 0
    return tp[keep], tm[idx[keep]], val[idx[keep]]


def sample(spec: SensorSpec, tool: ToolSpec, tp, tmp, vp, t0, t1,
           rng) -> SensorTrace:
    """Stage 3: tool reads — latest publication at each read instant."""
    eff = tool.sample_interval_s \
        + tool.overhead_s_per_read * tool.n_sensors_polled
    tr = _jittered_grid(t0, t1, eff, tool.sample_jitter_s, rng)
    if tool.drop_prob > 0:
        tr = tr[rng.random(len(tr)) > tool.drop_prob]
    idx = np.searchsorted(tp, tr, side="right") - 1
    keep = idx >= 0
    tr = tr[keep]
    idx = idx[keep]
    return SensorTrace(spec.name, spec, tr, tmp[idx], vp[idx])


def simulate_sensor(spec: SensorSpec, tool: ToolSpec,
                    truth: PiecewisePower, seed=0) -> SensorTrace:
    # stable per-sensor stream (python hash() is process-salted)
    rng = np.random.default_rng(
        (zlib.crc32(spec.name.encode()) ^ seed) & 0x7FFFFFFF)
    tm, val = produce(spec, truth, rng)
    tp, tmp, vp = publish(spec, tm, val, truth.t0, truth.t1, rng)
    return sample(spec, tool, tp, tmp, vp, truth.t0, truth.t1, rng)


# ---------------------------------------------------------------------------
# Fault injection: deterministic post-hoc trace corruption for the
# fleet-health tests (stuck counters, dropout bursts, step drift).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injected sensor fault over [t_start, t_end).

    kind: ``"stuck"`` freezes the published VALUE at the last pre-fault
    sample while timestamps keep refreshing — a hung counter behind a
    live driver; ``"dropout"`` removes every tool read in the window —
    a dead endpoint (the downstream hold-resample then serves stale
    data, which the health stage sees as a zero-refresh window);
    ``"step_drift"`` adds ``magnitude_w`` watts (instant-power sensors)
    or the equivalent accumulated joules (cumulative counters) from
    ``t_start`` on — a calibration step.  Injection is a pure function
    of the clean trace, so a multi-host fleet re-simulating the same
    (spec, seed, fault) gets bit-identical faulty rows on every host.
    """
    kind: str                  # "stuck" | "dropout" | "step_drift"
    t_start: float
    t_end: float = float("inf")
    magnitude_w: float = 0.0


def inject_fault(trace: SensorTrace, fault: FaultSpec) -> SensorTrace:
    """Return a new ``SensorTrace`` with the fault applied."""
    tm = np.asarray(trace.t_measured, np.float64)
    if fault.kind == "dropout":
        tr = np.asarray(trace.t_read, np.float64)
        keep = (tr < fault.t_start) | (tr >= fault.t_end)
        return SensorTrace(trace.name, trace.spec,
                           trace.t_read[keep], trace.t_measured[keep],
                           trace.value[keep])
    tm = tm.copy()
    val = np.asarray(trace.value).astype(np.float64, copy=True)
    in_f = (tm >= fault.t_start) & (tm < fault.t_end)
    if fault.kind == "stuck":
        if in_f.any():
            j = int(np.argmax(in_f))   # first in-fault sample
            val[in_f] = val[max(j - 1, 0)]
    elif fault.kind == "step_drift":
        if trace.spec.is_cumulative:
            dt = np.clip(np.minimum(tm, fault.t_end) - fault.t_start,
                         0.0, None)
            val = val + fault.magnitude_w * dt
        else:
            val = val + fault.magnitude_w * in_f
    else:
        raise ValueError(f"unknown fault kind: {fault.kind!r}")
    return SensorTrace(trace.name, trace.spec, trace.t_read, tm, val)


# ---------------------------------------------------------------------------
# Node fabric: per-chip truths composed into tray/node-scope sensors.
# ---------------------------------------------------------------------------

def _merge_sum(pps, extra_const=0.0):
    times = np.unique(np.concatenate([p.times for p in pps]))
    mids = (times[:-1] + times[1:]) / 2.0
    watts = sum(p.power_at(mids) for p in pps) + extra_const
    return PiecewisePower(times, watts)


@dataclasses.dataclass
class NodeFabric:
    """One node: 4 chips with their own power truths + host components.

    ``cpu_activity`` scales host-CPU dynamic power with mean chip activity
    (data feeding, launch overhead): CPU/memory/NIC form a mostly-static
    baseline under GPU-bound load.
    """
    chip_truths: list                      # [PiecewisePower] * n_chips
    node_id: int = 0
    cpu_idle_w: float = HOST_CPU_W * 0.45
    cpu_activity: float = 0.15
    ddr_w: float = DDR_W
    n_nics: int = 2

    def truth_for(self, spec: SensorSpec) -> PiecewisePower:
        name = spec.name
        if name.startswith("chip") or name.startswith("pm_accel"):
            chip = int(re.search(r"(?:chip|accel)(\d+)", name).group(1))
            return self.chip_truths[chip]
        if name == "pm_cpu_power":
            total = _merge_sum(self.chip_truths)
            act = (total.watts - total.watts.min()) \
                / max(total.watts.max() - total.watts.min(), 1.0)
            return PiecewisePower(
                total.times,
                self.cpu_idle_w + self.cpu_activity * HOST_CPU_W * act)
        if name == "pm_memory_power":
            t = self.chip_truths[0]
            return PiecewisePower(np.asarray([t.t0, t.t1]),
                                  np.asarray([self.ddr_w]))
        if name == "pm_node_power":
            cpu = self.truth_for(SensorSpec("pm_cpu_power", "node",
                                            "power_inst"))
            nic = self.n_nics * NIC_W
            return _merge_sum(self.chip_truths + [cpu],
                              extra_const=self.ddr_w + nic)
        raise KeyError(name)

    def sample_all(self, tool: ToolSpec = None, seed=0,
                   sensors=None) -> dict:
        """{name: SensorTrace} for every sensor of the node; each
        sensor's stream is seeded with ``seed * 1000003 + node_id``, as
        the reference seeds it."""
        tool = tool or ToolSpec()
        sensors = sensors or default_node_sensors(len(self.chip_truths))
        tool = dataclasses.replace(tool, n_sensors_polled=len(sensors))
        out = {}
        for spec in sensors:
            truth = self.truth_for(spec)
            out[spec.name] = simulate_sensor(
                spec, tool, truth, seed=seed * 1000003 + self.node_id)
        return out
