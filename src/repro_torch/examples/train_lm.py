"""End-to-end driver: train a transformer LM with full instrumentation,
checkpointing and per-phase power/energy attribution (port of
``examples/train_lm.py``).

Default is a fast demo config; ``--full`` trains a ~100M-param llama-style
model for a few hundred steps.  The step runs on the device (the card
unless ``--device`` says otherwise); a checkpoint in ``--ckpt-dir`` is
resumed from.

  PYTHONPATH=src python -m repro_torch.examples.train_lm            # demo
  PYTHONPATH=src python -m repro_torch.examples.train_lm --full     # ~100M
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

import torch

from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.interop import (model_params_from_arrays,
                                 optimizer_state_from_arrays)
from repro_torch.models import Model
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.instrumented import (attribution_report,
                                            run_instrumented_training)
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import optimizer_for, schedule_for

CKPT_EVERY = 25


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")


def config(full: bool, compute_dtype=None):
    base = ARCHS["llama3.2-3b"]
    if full:     # ~100M params
        cfg = dataclasses.replace(
            base, name="llama-100m", num_layers=12, d_model=768,
            num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
            vocab_size=32_000, remat=False)
    else:
        cfg = dataclasses.replace(
            base, name="llama-demo", num_layers=4, d_model=256,
            num_heads=8, num_kv_heads=4, head_dim=32, d_ff=512,
            vocab_size=4096, remat=False)
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    return cfg


def main(device=None, *, full: bool = False, steps: int = 0,
         ckpt_dir=None, params=None, compute_dtype=None, batch=None,
         seq=None, seed: int = 0) -> dict:
    """Train, print the reference's report and return {"n_params",
    "steps", "start", "losses" (one a step run), "by_name" (energy,
    seconds and watts a phase name), "phases" (the run's tracer,
    ``to_arrays()``)}.  ``params``: the starting parameters (copied,
    not trained in place), else drawn from ``seed``; ``batch``/``seq``
    override the demo's 8 x 128 tokens.  Raises ``AssertionError`` when
    the last loss is not below the first (the reference's exit code 1)."""
    dev = resolve_device(device)
    ckpt_dir = default_ckpt_dir() if ckpt_dir is None else str(ckpt_dir)
    cfg = config(full, compute_dtype)
    steps = steps or (300 if full else 40)
    d_batch, d_seq = (8, 256) if full else (8, 128)
    batch, seq = batch or d_batch, seq or d_seq

    model = Model(cfg)
    if params is None:
        params = model.init(seed, device=dev)
    else:
        params = tree_map(lambda t: t.detach().to(dev, copy=True), params)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"{cfg.name}: {n_params/1e6:.1f}M params, {steps} steps")

    opt = optimizer_for(cfg)
    state = (params, opt.init(params))
    lr_fn = schedule_for(cfg.name, base_lr=3e-3, total=steps * 2)
    step_fn = make_train_step(model, opt, lr_fn)
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq, batch, seed=0))

    start = 0
    if latest_step(ckpt_dir) is not None:
        (p, o), start, _ = restore_checkpoint(ckpt_dir, state)
        kind = "adafactor" if "slots" in state[1] else "adamw"
        p = model_params_from_arrays(p, cfg, device=dev)
        state = (p, optimizer_state_from_arrays(o, p, kind, device=dev))
        print(f"resumed from checkpoint step {start}")

    def next_batch(step):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in data.batch(start + step).items()}

    def train_one(st, batch, step):
        p, o = st if st is not None else state
        p, o, metrics = step_fn(p, o, batch, start + step)
        return (p, o), metrics

    run, _ = run_instrumented_training(
        train_one, steps - start, next_batch,
        ckpt_every=CKPT_EVERY,
        save_fn=lambda st, s: save_checkpoint(ckpt_dir, start + s, st),
        metrics_cb=lambda s, m: print(
            f"  step {start+s:4d}  loss {m['loss']:.4f}")
        if s % 20 == 0 else None)

    losses = [m["loss"] for m in run.metrics_log]
    improved = losses[-1] < losses[0]
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({'improved' if improved else 'NO IMPROVEMENT'})")

    by_name, _ = attribution_report(run)
    print("\nper-phase energy attribution (chip0 ΔE/Δt):")
    for name, agg in sorted(by_name.items()):
        print(f"  {name:12s} {agg['energy_j']:10.1f} J  "
              f"{agg['time_s']:8.2f} s  {agg['mean_power_w']:7.1f} W")
    if not improved:
        raise AssertionError(f"loss did not improve: {losses[0]} -> "
                             f"{losses[-1]}")
    return {"n_params": n_params, "steps": steps, "start": start,
            "losses": losses, "by_name": by_name,
            "phases": run.tracer.to_arrays()}


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: "
                    "$TMPDIR/repro_torch_train_lm)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    try:
        main(args.device, full=args.full, steps=args.steps,
             ckpt_dir=args.ckpt_dir)
    except AssertionError:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(cli())
