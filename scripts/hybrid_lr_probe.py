"""The hybrid of ``chip_smoke.py`` phase 15b (Jamba 1.5 Large's widths,
8 layers, dense FFN, bf16 masters, Adafactor, remat) trained for a few
steps at several base learning rates of the launcher's cosine schedule
(``schedule_for(name, base_lr, total=1000)``: a 10-step warmup), on one
card, from the same seeded weights and data each time.  Prints the card
(``nvidia-smi``), then one JSON line a rate: the losses and gradient
norms of each step.

    python3 scripts/hybrid_lr_probe.py [--lrs 3e-3,1e-3,3e-4] [--steps 8]

Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lrs", default="3e-3,1e-3,3e-4")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("hybrid_lr_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import Model
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import optimizer_for, schedule_for
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cfg, _ = cs.hybrid_train_config()
    model = Model(cfg)
    data = SyntheticLM(DataConfig(cfg.vocab_size, cs.HYBRID_SEQ,
                                  cs.HYBRID_BATCH, seed=args.seed))
    for lr in (float(x) for x in args.lrs.split(",")):
        cs.free_card()
        params = model.init(args.seed, device="cuda")
        opt = optimizer_for(cfg)
        state = opt.init(params)
        step = make_train_step(model, opt, schedule_for(
            cfg.name, base_lr=lr, total=1000))
        losses, norms = [], []
        for i in range(args.steps):
            batch = {k: torch.as_tensor(v, device="cuda")
                     for k, v in data.batch(i).items()}
            params, state, m = step(params, state, batch, i)
            losses.append(float(m["loss"]))
            norms.append(float(m["gnorm"]))
        print(json.dumps({"base_lr": lr, "arch": cfg.name,
                          "tokens_per_step": cs.HYBRID_SEQ
                          * cs.HYBRID_BATCH, "losses": losses,
                          "grad_norms": norms}))
        del params, state, step
    return 0


if __name__ == "__main__":
    sys.exit(main())
