#!/usr/bin/env python3
"""B4's live calls against float64, on the CPU: which scorer is off.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/live_b4_float64.py

Runs ``repro_torch.ingest.attribute_live(device="cpu")`` on two captures
and records the inputs of every lag-bank call the live tracker makes
(``xcorr_align``'s wrapper, which runs its plain version on the CPU):

  fixture   the reference's tracked live fixture
            (``tests/test_torch_ingest.py::test_live_two_sensor_groups_
            tracked``: two devices of a counter and a power sensor at
            constant power, tracked against a constant reference);
  square    ``chip_smoke.py``'s live recipe (a wrapping counter and a
            noisy power sensor a device against the square wave, its
            ``LIVE`` geometry) at a few devices, replayed at --speed.

Each call is scored three ways on the same inputs: the port's plain
version (``repro_torch/kernels/xcorr_align/ref.py``, float32), the
reference's (``src/repro/kernels/xcorr_align/ref.py``, float32 jnp) and
float64 (the reference's formula in numpy).  Per capture it prints the
worst |score - float64| of each float32 scorer, how many calls each
matched float64 exactly, and for those calls their valid samples and
whether the bank was all zero (a constant reference) or every stream was
constant over its valid samples.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _record(run):
    """Run ``run`` with every B4 call's inputs kept -> (result, calls)."""
    import repro_torch.kernels.xcorr_align.ops as xops
    kernel = xops.xcorr_align_kernel
    calls = []

    def keep(x, m, bank, *, n_lags):
        calls.append(tuple(t.clone() for t in (x, m, bank)) + (n_lags,))
        return kernel(x, m, bank, n_lags=n_lags)

    xops.xcorr_align_kernel = keep
    try:
        return run(), calls
    finally:
        xops.xcorr_align_kernel = kernel


def fixture_capture():
    """The reference's tracked live fixture on the port."""
    from repro_torch import ingest as ting
    from repro_torch.core import SensorSpec, SensorTrace
    traces = {}
    for d, p_w in enumerate((20.0, 35.0)):
        t = np.arange(0.0, 2.0025, 0.005)
        spec = SensorSpec(name=f"d{d}.energy", scope="chip",
                          kind="energy_cum", quantum=1e-6)
        traces[f"d{d}.energy"] = SensorTrace(f"d{d}.energy", spec, t,
                                             t.copy(), p_w * t)
        traces[f"d{d}.power"] = SensorTrace(
            f"d{d}.power", SensorSpec(name=f"d{d}.power", scope="chip",
                                      kind="power_inst"),
            t, t.copy(), np.full_like(t, p_w))
    sim = ting.SimBackend(traces, speed=8.0)
    return _record(lambda: ting.attribute_live(
        [("a", 0.2, 1.0), ("b", 1.0, 1.8)], duration_s=0.3,
        backends=[sim], metrics=sorted(traces), chunk=16,
        interval_s=2e-3, reference=lambda t: np.ones_like(t),
        window=128, hop=64, max_lag=8, tail=64, settle_s=2.0,
        device="cpu"))


def square_capture(devices: int, span_s: float, speed: float, seed: int):
    """``chip_smoke.py``'s live recipe at ``devices`` devices."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch import ingest as ting
    truth, groups, _ = chip_smoke.sim_groups(devices, span_s, seed)
    phases = chip_smoke.phases_of(truth)
    traces = {}
    for d, (energy, power) in enumerate(groups):
        traces[f"d{d}.energy"] = energy
        traces[f"d{d}.power"] = power
    t0 = max(float(tr.t_read[0]) for tr in traces.values())
    sim = ting.SimBackend(traces, speed=speed)
    sim._t0_sim = t0
    live_phases = [(n, a - t0, b - t0) for n, a, b in phases]
    duration = max(float(tr.t_read[-1]) for tr in traces.values()) - t0
    return _record(lambda: ting.attribute_live(
        live_phases, duration_s=duration / speed, backends=[sim],
        metrics=sorted(traces),
        reference=lambda t: truth.power_at(t + t0), settle_s=2.0,
        device="cpu", **chip_smoke.LIVE))


def score(calls):
    """Per call: (port plain err, reference err, valid samples, bank all
    zero, every stream constant over its valid samples) against float64."""
    import jax.numpy as jnp
    import torch
    from repro.kernels.xcorr_align.ref import (
        xcorr_scores_ref as jax_scores)
    from repro_torch.kernels.xcorr_align.ref import (
        xcorr_scores_ref as port_scores)
    out = []
    for x, m, bank, n_lags in calls:
        x32, m32, b32 = (a.to(torch.float32) for a in (x, m, bank))
        exact = jax_scores(x32.double().numpy(), m32.double().numpy(),
                           b32.double().numpy(), xp=np)[:, :n_lags]
        port = port_scores(x32, m32, b32).numpy()[:, :n_lags]
        ref = np.asarray(jax_scores(jnp.asarray(x32.numpy()),
                                    jnp.asarray(m32.numpy()),
                                    jnp.asarray(b32.numpy())))[:, :n_lags]
        xm = np.where(m32.numpy() > 0, x32.numpy(), np.nan)
        with np.errstate(all="ignore"):
            flat = bool(np.all(np.nan_to_num(np.nanmax(xm, axis=1)
                                             - np.nanmin(xm, axis=1)) == 0))
        out.append(dict(port=float(np.abs(port - exact).max()),
                        ref=float(np.abs(ref - exact).max()),
                        valid=int(m32.sum()), rows=int(x32.shape[0]),
                        zero_bank=bool((b32[:n_lags] == 0).all()),
                        flat_streams=flat))
    return out


def report(label, rows):
    n = len(rows)
    port_exact = [r for r in rows if r["port"] == 0.0]
    ref_exact = [r for r in rows if r["ref"] == 0.0]
    print(f"{label}: {n} B4 calls; worst |score - float64|: port plain "
          f"{max(r['port'] for r in rows):.3e}, reference "
          f"{max(r['ref'] for r in rows):.3e}; calls over 1e-5: port "
          f"{sum(r['port'] > 1e-5 for r in rows)}, reference "
          f"{sum(r['ref'] > 1e-5 for r in rows)}")
    print(f"{label}: equal to float64: port plain {len(port_exact)}, "
          f"reference {len(ref_exact)}, both "
          f"{sum(r['port'] == 0.0 and r['ref'] == 0.0 for r in rows)}")
    for r in port_exact + [r for r in ref_exact if r not in port_exact]:
        print(f"  exact call: {r['valid']} valid samples over {r['rows']} "
              f"rows; bank all zero {r['zero_bank']}; every stream "
              f"constant {r['flat_streams']}")
    worst = sorted(rows, key=lambda r: -r["port"])[:3]
    for r in worst:
        print(f"  worst call: port {r['port']:.3e}, reference "
              f"{r['ref']:.3e}, {r['valid']} valid samples")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--span", type=float, default=4.0)
    ap.add_argument("--speed", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(2)
    _, calls = fixture_capture()
    report("fixture", score(calls))
    _, calls = square_capture(args.devices, args.span, args.speed,
                              args.seed)
    report(f"square ({args.devices} devices, {args.span} s, speed "
           f"{args.speed})", score(calls))
    return 0


if __name__ == "__main__":
    sys.exit(main())
