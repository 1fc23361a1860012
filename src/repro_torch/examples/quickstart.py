"""Quickstart: the paper's methodology in 60 lines (port of
``examples/quickstart.py``).

Square-wave workload -> three-stage sensor fabric -> blind characterization
-> ΔE/Δt reconstruction vs the firmware-averaged power counter.  The
sensor fabric, the characterization and ΔE/Δt are the host numpy core in
both packages (``repro_torch.core``): no kernel runs here, and the device
is resolved as every entry point resolves it (the card, unless the caller
asks for the CPU).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import (NodeFabric, ToolSpec, characterize_sensor,
                              delta_e_over_delta_t, power_trace_series,
                              square_wave)
from repro_torch.device import resolve_device

SENSORS = ("chip0_energy", "chip0_power_avg", "chip0_power_inst",
           "pm_accel0_power")


def main(device=None, *, seed: int = 0) -> dict:
    """Print the reference's report -> {"characterization": {sensor:
    {observed_interval_s, delay_s, rise_s, fall_s}}, "derived_w",
    "averaged_w"}."""
    resolve_device(device)
    # 1 s idle / 1 s active square wave (paper Fig. 5), 4 chips per node
    truth = square_wave(period_s=2.0, n_cycles=5, lead_s=2.0, tail_s=2.0)
    fabric = NodeFabric(chip_truths=[truth] * 4)
    traces = fabric.sample_all(ToolSpec(sample_interval_s=1e-3), seed=seed)

    edges_up = truth.times[1:-1:2]
    edges_down = truth.times[2:-1:2]

    print("== sensor characterization (blind, from observations only) ==")
    chars = {}
    for name in SENSORS:
        rec = characterize_sensor(traces[name], edges_up, edges_down)
        sr = rec["step_response"]
        ui = rec["update_intervals"]["observed"]
        chars[name] = {"observed_interval_s": float(ui["median"]),
                       "delay_s": float(sr["delay_s"]),
                       "rise_s": float(sr["rise_s"]),
                       "fall_s": float(sr["fall_s"])}
        print(f"{name:20s} observed-interval={ui['median']*1e3:6.2f} ms  "
              f"delay={sr['delay_s']*1e3:7.1f} ms  "
              f"rise={sr['rise_s']*1e3:7.1f} ms"
              f"  fall={sr['fall_s']*1e3:7.1f} ms")

    print("\n== ΔE/Δt beats the averaged power counter ==")
    derived = delta_e_over_delta_t(traces["chip0_energy"])
    averaged = power_trace_series(traces["chip0_power_avg"])
    active = (derived.t > 4.2) & (derived.t < 4.9)    # inside an active phase
    active_avg = (averaged.t > 4.2) & (averaged.t < 4.9)
    derived_w = float(np.mean(derived.watts[active]))
    averaged_w = float(np.mean(averaged.watts[active_avg]))
    print("truth active power:        215.0 W")
    print(f"ΔE/Δt steady estimate:     {derived_w:7.1f} W")
    print(f"averaged-counter estimate: "
          f"{averaged_w:7.1f} W"
          f"   <- smoothed by the undocumented firmware filter")
    return {"characterization": chars, "derived_w": derived_w,
            "averaged_w": averaged_w}


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
