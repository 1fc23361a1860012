"""Fault tolerance demo: checkpoint/restart with injected failures and
straggler detection (port of ``examples/fault_tolerance_demo.py``).  The
train step runs on the device (the card unless ``--device`` says
otherwise).

  PYTHONPATH=src python -m repro_torch.examples.fault_tolerance_demo \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import (RestartPolicy,
                                                     StragglerMonitor,
                                                     TrainingFault,
                                                     run_with_restarts)
from repro_torch.interop import (model_params_from_arrays,
                                 optimizer_state_from_arrays)
from repro_torch.models import Model
from repro_torch.models.layers import tree_map
from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import optimizer_for, schedule_for

FAIL_AT = {7: "node_failure", 15: "nan_loss"}
SLOW_HOST = 3


def main(device=None, *, params=None, compute_dtype=None,
         n_steps: int = 25, seed: int = 0) -> dict:
    """Train reduced llama3.2-3b under ``run_with_restarts`` with a node
    failure injected at step 7 and a NaN loss at step 15, then run the
    straggler monitor over 8 simulated hosts; print the reference's
    report -> {"step", "faults", "events" (without their wall times),
    "evicted" [(host, ewma_s, mads)]}.  ``params``: the starting
    parameters (copied at every fresh start), else drawn from ``seed``.
    Raises unless both faults were recovered and host 3, and no other,
    was evicted."""
    dev = resolve_device(device)
    cfg = reduced(ARCHS["llama3.2-3b"])
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    model = Model(cfg)
    opt = optimizer_for(cfg)
    step_fn = make_train_step(model, opt,
                              schedule_for(cfg.name, 1e-3, 1000))
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4, seed=0))
    ckpt = tempfile.mkdtemp(prefix="repro_torch_ft_")
    kind = "adafactor" if cfg.optimizer == "adafactor" else "adamw"

    def make_state():
        if params is None:
            p = model.init(seed, device=dev)
        else:
            p = tree_map(lambda t: t.detach().to(dev, copy=True), params)
        return (p, opt.init(p)), 0

    injected = set()

    def train_one(state, step):
        if step in FAIL_AT and step not in injected:
            injected.add(step)
            raise TrainingFault(FAIL_AT[step], f"injected at step {step}")
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch(step).items()}
        p, o = state
        p, o, m = step_fn(p, o, batch, step)
        return (p, o), m

    def save_fn(state, step):
        save_checkpoint(ckpt, step, state, keep=2)

    def restore_fn():
        if latest_step(ckpt) is None:
            return None
        template = make_state()[0]
        (p, o), step, _ = restore_checkpoint(ckpt, template)
        p = model_params_from_arrays(p, cfg, device=dev)
        return (p, optimizer_state_from_arrays(o, p, kind, device=dev)), \
            step

    try:
        state, step, events = run_with_restarts(
            make_state, train_one, n_steps=n_steps, save_fn=save_fn,
            restore_fn=restore_fn, policy=RestartPolicy(max_restarts=5),
            ckpt_every=5,
            on_event=lambda k, kw: print(f"  [{k}] {kw}"))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    faults = sum(1 for e in events if e['kind'] == 'fault')
    print(f"completed {step} steps with {faults} faults recovered")

    print("\nstraggler detection over 8 simulated hosts:")
    evicted = []

    def on_straggler(h, t, d):
        evicted.append((h, t, d))
        print(f"  EVICT host {h}: ewma {t*1e3:.1f} ms ({d:.1f} MADs slow)")
    mon = StragglerMonitor(8, threshold=4.0, patience=2,
                           on_straggler=on_straggler)
    rng = np.random.default_rng(0)
    for s in range(10):
        times = list(0.100 + rng.normal(0, 0.002, 8))
        if s >= 4:
            times[SLOW_HOST] += 0.08  # host 3 degrades (e.g. thermal)
        mon.observe(times)
    if faults != len(FAIL_AT) or step != n_steps:
        raise AssertionError(f"{faults} faults recovered by step {step}, "
                             f"expected {len(FAIL_AT)} by {n_steps}")
    if [h for h, _, _ in evicted] != [SLOW_HOST]:
        raise AssertionError(f"evicted {evicted}, expected host "
                             f"{SLOW_HOST} alone")
    return {"step": step, "faults": faults,
            "events": [{k: v for k, v in e.items() if k != "t"}
                       for e in events],
            "evicted": evicted}


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
