#!/usr/bin/env python3
"""The serving phases of ``chip_smoke.py`` alone, on one card.

    python3 scripts/serve_probe.py [--seed 0]

Builds the kernels, holds B9 (``flash_attention``) and B10
(``selective_scan``) against their plain versions at the serving shapes
and times them (``chip_smoke.check_serve_kernels``, B9 at the zoo's
shapes too), then serves each configuration of ``chip_smoke.serve_configs``
(``chip_smoke.run_serving``: llama3.2-3b at full size, the 8-layer
Jamba-width hybrid and moonshot-v1-16b-a3b at full size) with every
gate of the full script.
A quick check of the serving path, and a second sample of its numbers:
the last line is one JSON object with the kernels' records (the card's
SM clock, draw and temperature read before and after each kernel's
timings, seconds after the build) and each configuration's summary.
Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("serve_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"kernels built in {build.timed_build():.1f} s")
    records = cs.check_serve_kernels(torch.device("cuda"), args.seed)
    serving = {}
    for label, cfg, cuts in cs.serve_configs():
        serving[label] = cs.run_serving(label, cfg, cuts, args.seed)[0]
    kernels = {k: dict(cs.kernel_entry(v), clocks_before=v["clocks_before"],
                       clocks_after=v["clocks_after"])
               for k, v in records.items()}
    print(json.dumps({"kernels": kernels,
                      "serving": serving}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
