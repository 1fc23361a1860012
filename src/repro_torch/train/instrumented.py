"""Instrumented training: the paper's attribution methodology wrapped
around a real training loop (port of ``repro/train/instrumented.py``).

Every phase (data / step / eval / checkpoint) is a traced region with REAL
host timestamps; after the run the phase schedule drives the roofline power
model to synthesize the node's sensor fabric over the same timeline, and
the attribution stack maps energy back to the phases — the honest
CPU-container instantiation (DESIGN.md §2): real timing + modeled power,
with the attribution code identical to what real telemetry would feed.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.attribution import attribute_energy
from repro_torch.core.measurement_model import CHIP_IDLE_W, ToolSpec
from repro_torch.core.power_model import occupancy_power, phase_power
from repro_torch.core.sensors import NodeFabric
from repro_torch.core.tracing import RegionTracer
from repro_torch.core.trace_format import save_trace
from repro_torch.device import wait


@dataclasses.dataclass
class InstrumentedRun:
    tracer: RegionTracer
    traces: dict                 # sensor name -> SensorTrace
    phases: list                 # (name, t_s, t_e)
    metrics_log: list


PHASE_OCCUPANCY = {
    # (compute_s, memory_s, collective_s) RELATIVE weights per phase kind —
    # replaced by real roofline terms when a dry-run record is supplied.
    "train_step": (1.0, 0.55, 0.15),
    "prefill": (1.0, 0.5, 0.1),
    "decode": (0.15, 1.0, 0.1),
    "eval_step": (0.8, 0.5, 0.1),
    "data": (0.0, 0.05, 0.0),
    "checkpoint": (0.0, 0.3, 0.0),
    "admission": (0.0, 0.05, 0.0),
}


def phase_watts(name, roofline_record=None):
    if roofline_record is not None and name in ("train_step", "prefill",
                                                "decode"):
        t = roofline_record["roofline"]
        return occupancy_power(t["compute_s"], t["memory_s"],
                               t["collective_s"])
    occ = PHASE_OCCUPANCY.get(name)
    if occ is None:
        return CHIP_IDLE_W
    return occupancy_power(*occ)


def run_instrumented_training(train_one_step, n_steps, next_batch, *,
                              tracer=None, ckpt_every=0, save_fn=None,
                              n_chips=4, roofline_record=None,
                              tool=None, seed=0, metrics_cb=None):
    """Run a real training loop with traced phases, then synthesize the
    sensor fabric over the recorded timeline."""
    tracer = tracer or RegionTracer()
    metrics_log = []
    state = None
    for step in range(n_steps):
        with tracer.region("data", step=step):
            batch = next_batch(step)
        with tracer.region("train_step", step=step):
            state, metrics = train_one_step(state, batch, step)
            first = next(iter(metrics.values()))
            if isinstance(first, torch.Tensor):
                wait(first.device)
        # the step's one host read: every metric, once the step is done
        metrics_log.append({k: float(v) for k, v in metrics.items()})
        if metrics_cb:
            metrics_cb(step, metrics_log[-1])
        if ckpt_every and save_fn and (step + 1) % ckpt_every == 0:
            with tracer.region("checkpoint", step=step):
                save_fn(state, step + 1)

    phases = tracer.phases(depth=0)
    watts = {name: {"watts": phase_watts(name, roofline_record)}
             for name, _, _ in phases}
    lead = 0.05
    shifted = [(n, a + lead, b + lead) for n, a, b in phases]
    truth = phase_power(
        [("__lead__", 0.0, lead)] + shifted,
        {**watts, "__lead__": {"watts": CHIP_IDLE_W}})
    fabric = NodeFabric(chip_truths=[truth] * n_chips)
    traces = fabric.sample_all(tool or ToolSpec(), seed=seed)
    # report phases in the shifted (sensor) timebase
    return InstrumentedRun(tracer, traces, shifted, metrics_log), state


def attribution_report(run: InstrumentedRun, *, sensor="chip0_energy",
                       corrections=None):
    """Per-phase-name energy totals + the full per-phase list."""
    per_phase = attribute_energy(run.traces[sensor], run.phases,
                                 corrections=corrections)
    by_name = {}
    for p in per_phase:
        agg = by_name.setdefault(p.phase, {"energy_j": 0.0, "time_s": 0.0,
                                           "n": 0})
        agg["energy_j"] += p.energy_j
        agg["time_s"] += p.t_end - p.t_start
        agg["n"] += 1
    for v in by_name.values():
        v["mean_power_w"] = v["energy_j"] / max(v["time_s"], 1e-12)
    return by_name, per_phase


def save_run(path, run: InstrumentedRun, meta=None):
    save_trace(path, run.tracer, run.traces, meta=meta or {})
