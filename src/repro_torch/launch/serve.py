"""Serving driver: batched requests against any ported arch (reduced),
with phase-level power/energy attribution of the serving timeline (port
of ``repro/launch/serve.py``; ``--device`` picks the card or the CPU).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      --requests 12 --max-new 16 [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_arch, reduced as reduce_cfg
from repro_torch.core import (NodeFabric, ToolSpec, attribute_energy,
                              phase_power)
from repro_torch.core.measurement_model import CHIP_IDLE_W
from repro_torch.core.power_model import occupancy_power
from repro_torch.models import Model
from repro_torch.serve.engine import Request, ServeEngine

OCC = {"admission": (0.0, 0.05, 0.0), "prefill": (1.0, 0.5, 0.1),
       "decode": (0.15, 1.0, 0.1)}


def serve_traces(phases, lead=0.05, n_chips=4, seed=0):
    """A node fabric whose chips draw the occupancy model's power over
    the engine's depth-0 ``phases`` (shifted by ``lead`` seconds of idle
    lead-in), sampled by the default tool -> (traces, shifted phases,
    truth)."""
    shifted = [(n, a + lead, b + lead) for n, a, b in phases]
    watts = {n: {"watts": occupancy_power(*OCC.get(n, (0, 0.1, 0)))}
             for n, _, _ in shifted}
    truth = phase_power([("__lead__", 0.0, lead)] + shifted,
                        {**watts, "__lead__": {"watts": CHIP_IDLE_W}})
    traces = NodeFabric(chip_truths=[truth] * n_chips).sample_all(
        ToolSpec(), seed=seed)
    return traces, shifted, truth


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = reduce_cfg(get_arch(args.arch))
    model = Model(cfg)
    params = model.init(0, device=args.device)
    engine = ServeEngine(model, params, batch_slots=args.slots,
                         max_len=args.max_len, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               6 + i % 9),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    results = engine.run(reqs)
    n_tokens = sum(len(v) for v in results.values())
    print(f"served {len(results)} requests, {n_tokens} tokens")

    traces, shifted, _ = serve_traces(engine.tracer.phases(depth=0))
    agg = {}
    for p in attribute_energy(traces["chip0_energy"], shifted):
        a = agg.setdefault(p.phase, [0.0, 0.0])
        a[0] += p.energy_j
        a[1] += p.t_end - p.t_start
    print("\nper-phase serving energy (chip0 ΔE/Δt):")
    total_e = sum(a[0] for a in agg.values())
    for name, (e, t) in sorted(agg.items()):
        print(f"  {name:10s} {e:9.2f} J ({100*e/max(total_e,1e-9):4.1f}%)"
              f"  {t:7.3f} s  {e/max(t,1e-9):7.1f} W")
    if n_tokens:
        print(f"\nenergy per generated token: {total_e/n_tokens:.2f} J")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
