"""End-to-end training launcher (port of ``repro/launch/train.py``).

Trains a ported arch (reduced by default) for a few steps with every
phase traced, then reports per-phase energy from the attribution stack
(the paper's §V-B workflow).  The same flags and output as the
reference's; it runs on the card, or where ``main(device=...)`` says
(the tests pass ``device="cpu"``).

Usage::

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --steps 50 --reduced --ckpt-dir /tmp/ckpt --out results/train.npz
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_arch, reduced as reduce_cfg
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.interop import (model_params_from_arrays,
                                 optimizer_state_from_arrays)
from repro_torch.models import Model
from repro_torch.models.layers import tree_leaves
from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.instrumented import (attribution_report,
                                            run_instrumented_training,
                                            save_run)
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import optimizer_for, schedule_for


def build(arch_name, *, use_reduced=True, seq_len=64, batch=8, seed=0,
          device=None):
    """-> (cfg, model, (params, opt_state), step_fn, data): float32
    masters drawn from ``seed`` on ``device`` (None means CUDA), the
    arch's optimizer and the reference launcher's schedule (base lr
    3e-3 over 1000 steps)."""
    dev = resolve_device(device)
    cfg = get_arch(arch_name)
    if use_reduced:
        cfg = reduce_cfg(cfg)
    model = Model(cfg)
    params = model.init(seed, device=dev)
    opt = optimizer_for(cfg)
    opt_state = opt.init(params)
    lr_fn = schedule_for(cfg.name, base_lr=3e-3, total=1000)
    step_fn = make_train_step(model, opt, lr_fn)
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq_len, batch, seed=seed))
    return cfg, model, (params, opt_state), step_fn, data


def main(argv=None, *, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg, model, state0, step_fn, data = build(
        args.arch, seq_len=args.seq_len, batch=args.batch, device=dev)
    print(f"arch={cfg.name} params="
          f"{sum(x.numel() for x in tree_leaves(state0[0]))/1e6:.2f}M")

    start_step = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        (params, opt_state), start_step, _ = restore_checkpoint(
            args.ckpt_dir, state0)
        kind = "adafactor" if "slots" in state0[1] else "adamw"
        state0 = (model_params_from_arrays(params, cfg, device=dev),
                  optimizer_state_from_arrays(opt_state, state0[0], kind,
                                              device=dev))
        print(f"resumed from step {start_step}")

    def next_batch(step):
        b = data.batch(start_step + step)
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

    def train_one(state, batch, step):
        params, opt_state = state if state is not None else state0
        params, opt_state, metrics = step_fn(params, opt_state, batch,
                                             start_step + step)
        return (params, opt_state), metrics

    save_fn = None
    if args.ckpt_dir:
        def save_fn(state, step):   # noqa: F811
            save_checkpoint(args.ckpt_dir, start_step + step, state)

    run, state = run_instrumented_training(
        train_one, args.steps, next_batch,
        ckpt_every=args.ckpt_every if args.ckpt_dir else 0,
        save_fn=save_fn,
        metrics_cb=lambda s, m: print(
            f"step {start_step + s:4d} loss {m['loss']:.4f} "
            f"lr {m['lr']:.2e}") if s % 5 == 0 else None)

    by_name, _ = attribution_report(run)
    print("\nper-phase attribution (chip0, ΔE/Δt):")
    for name, agg in sorted(by_name.items()):
        print(f"  {name:12s} {agg['energy_j']:10.2f} J "
              f"{agg['time_s']:8.3f} s  {agg['mean_power_w']:7.1f} W")
    losses = [m["loss"] for m in run.metrics_log]
    print(f"\nloss: {losses[0]:.4f} -> {losses[-1]:.4f}")
    if args.out:
        save_run(args.out, run, meta={"arch": cfg.name,
                                      "steps": args.steps})
        print("trace saved to", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
