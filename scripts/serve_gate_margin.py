"""The serving cells' ``attribute_phases`` gate against the run's length.

``chip_smoke.py`` gates each served model's chip counters' total energy
over the engine's phases at 1% of the synthetic truth.  This replays a
serving-shaped timeline (admission, prefill and decode segments, the
occupancy model's power) of each given length through the counter path
(``core.attribute_energy_many``) on the node fabric ``chip_smoke.py``
builds (``launch.serve.serve_traces``: seed 0, a 0.05 s idle lead-in),
and prints per length each chip's total error against the truth that
counter read (``chip_smoke.counter_truth``: the phases clipped to the
span of its reads, shifted by its delay; what the gate holds) and
against the whole run's truth (the gate before), beside how far the
chip's simulated read grid ends before the truth does.  Either package
runs it, on the CPU:

    PYTHONPATH=src python scripts/serve_gate_margin.py --package repro
    PYTHONPATH=src python scripts/serve_gate_margin.py --package repro_torch
"""
import argparse
import importlib
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import serve_total_errors  # noqa: E402

LEAD_S = 0.05               # chip_smoke.SERVE_LEAD
# one admission round, seconds: the shape of the 8-layer hybrid's
# timeline in chip_smoke.py on the H100 (16 prefills in ~0.35 s, decode
# segments of up to 16 steps in ~1.5 s)
ROUND = (("admission", 0.001), ("prefill", 0.02), ("decode", 0.1))


def timeline(span: float):
    """Rounds of ROUND up to ``span`` seconds, the last decode cut."""
    t, out = 0.0, []
    while t < span - 1e-9:
        for name, dur in ROUND:
            b = min(t + dur, span)
            if b - t > 1e-6:
                out.append((name, t, b))
            t = b
    return out


def fabric(pkg: str, phases):
    """(traces, shifted phases, truth) as ``launch.serve.serve_traces``
    builds them, from package ``pkg``'s own core."""
    core = importlib.import_module(f"{pkg}.core")
    pm = importlib.import_module(f"{pkg}.core.power_model")
    mm = importlib.import_module(f"{pkg}.core.measurement_model")
    occ = {"admission": (0.0, 0.05, 0.0), "prefill": (1.0, 0.5, 0.1),
           "decode": (0.15, 1.0, 0.1)}       # launch/serve.py OCC
    shifted = [(n, a + LEAD_S, b + LEAD_S) for n, a, b in phases]
    watts = {n: {"watts": pm.occupancy_power(*occ.get(n, (0, 0.1, 0)))}
             for n, _, _ in shifted}
    truth = pm.phase_power([("__lead__", 0.0, LEAD_S)] + shifted,
                           {**watts, "__lead__": {"watts": mm.CHIP_IDLE_W}})
    traces = core.NodeFabric(chip_truths=[truth] * 4).sample_all(
        core.ToolSpec(), seed=0)
    return traces, shifted, truth


def gate_errors(pkg: str, phases) -> dict:
    attribution = importlib.import_module(f"{pkg}.core.attribution")
    traces, shifted, truth = fabric(pkg, phases)
    names = sorted(n for n in traces if n.startswith("chip")
                   and n.endswith("_energy"))
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    rows = attribution.attribute_energy_many([traces[n] for n in names],
                                             shifted, **kw)
    seen, run = serve_total_errors(dict(zip(names, rows)), traces, shifted,
                                   truth)
    return {n: {"err": seen[n], "err_run": run[n],
                "grid_short_ms": (truth.t1 - float(traces[n].t_read[-1]))
                * 1e3}
            for n in names}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", default="repro_torch",
                    choices=("repro", "repro_torch"))
    ap.add_argument("--spans", default="1.6:2.4:0.02",
                    help="start:stop:step run lengths in seconds")
    args = ap.parse_args(argv)
    if args.package == "repro_torch":
        import torch
        torch.set_num_threads(2)
    lo, hi, step = (float(x) for x in args.spans.split(":"))
    runs = [timeline(s) for s in np.arange(lo, hi + step / 2, step)]
    worst = {"err": [], "err_run": []}
    for phases in runs:
        res = gate_errors(args.package, phases)
        for k, w in worst.items():
            w.append(max(r[k] for r in res.values()))
        print(json.dumps({"span_s": round(phases[-1][2] - phases[0][1], 4),
                          **{n: {k: round(v, 6) for k, v in r.items()}
                             for n, r in res.items()}}))
    print(json.dumps({"package": args.package, "runs": len(runs),
                      **{f"worst_{k}": max(w) for k, w in worst.items()},
                      **{f"over_gate_{k}": int(sum(x > 0.01 for x in w))
                         for k, w in worst.items()}}))


if __name__ == "__main__":
    main()
