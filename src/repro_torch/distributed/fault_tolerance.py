"""Fault tolerance: failure detection, restart policy, straggler mitigation
(port of ``repro/distributed/fault_tolerance.py``: pure Python, kept as
its own copy).

Checkpoint/restart is the recovery primitive (train/checkpoint.py); this
module adds the control plane a 1000+-node run needs:

  * :class:`StragglerMonitor` — per-step EWMA + MAD outlier detection over
    per-host step times; policy hook decides (log | re-shard | evict).
  * :class:`RestartPolicy` — bounded restarts with backoff; distinguishes
    deterministic faults (NaN loss — roll back AND skip the bad data batch)
    from transient faults (node loss — plain roll back).
  * :func:`run_with_restarts` — the supervision loop used by the examples
    and tested with injected failures.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional


def _median(values) -> float:
    """True median: average of the two middle elements for even n.

    The previous upper-element shortcut (``sorted(x)[n // 2]``) biased
    both the center and the MAD high on even host counts, inflating
    deviation scores for every host below the upper-middle element.
    """
    s = sorted(values)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


@dataclasses.dataclass
class StragglerVerdict:
    host: int
    step_time_s: float
    ewma_s: float
    deviation_mads: float
    is_straggler: bool


class StragglerMonitor:
    """EWMA/MAD detector over per-host step times.

    On real pods, hosts report step times through the coordinator;
    the detector flags hosts slower than ``threshold`` MADs for
    ``patience`` consecutive steps (transient DVFS/ECC blips are ignored,
    persistent slow hosts trigger the policy hook — the standard
    mitigation ladder is log -> alert -> checkpoint-and-evict).
    """

    def __init__(self, n_hosts: int, *, alpha=0.2, threshold=5.0,
                 patience=3, on_straggler: Optional[Callable] = None):
        self.n_hosts = n_hosts
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self.on_straggler = on_straggler
        self._ewma = [None] * n_hosts
        self._strikes = [0] * n_hosts
        self.flagged: set = set()

    def observe(self, step_times_s) -> list:
        assert len(step_times_s) == self.n_hosts
        med = _median(step_times_s)
        mad = _median(abs(t - med) for t in step_times_s)
        mad = max(mad, 1e-4 * max(med, 1e-9), 1e-9)
        verdicts = []
        for h, t in enumerate(step_times_s):
            self._ewma[h] = t if self._ewma[h] is None else \
                self.alpha * t + (1 - self.alpha) * self._ewma[h]
            dev = (self._ewma[h] - med) / mad
            slow = dev > self.threshold
            self._strikes[h] = self._strikes[h] + 1 if slow else 0
            is_straggler = self._strikes[h] >= self.patience
            if is_straggler and h not in self.flagged:
                self.flagged.add(h)
                if self.on_straggler:
                    self.on_straggler(h, self._ewma[h], dev)
            verdicts.append(StragglerVerdict(h, t, self._ewma[h], dev,
                                             is_straggler))
        return verdicts


class TrainingFault(RuntimeError):
    def __init__(self, kind, msg=""):
        super().__init__(f"{kind}: {msg}")
        self.kind = kind          # "node_failure" | "nan_loss" | ...


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 10
    backoff_s: float = 0.0        # 0 in tests; seconds on real clusters
    backoff_factor: float = 2.0
    backoff_max_s: float = 300.0  # cap: 2**attempt is unbounded otherwise
    skip_batch_on_nan: bool = True
    # a long campaign with occasional transient faults must not trip
    # max_restarts when every fault recovered cleanly: after this many
    # consecutive clean steps the restart counter resets to zero
    # (0 disables decay)
    reset_after_steps: int = 100

    def backoff(self, attempt: int) -> float:
        return min(self.backoff_s * (self.backoff_factor ** attempt),
                   self.backoff_max_s)


def run_with_restarts(make_state, train_one_step, *, n_steps,
                      save_fn, restore_fn, policy: RestartPolicy = None,
                      ckpt_every=10, on_event=None):
    """Supervision loop: step, checkpoint, recover.

    make_state() -> (state, start_step)  (restore_fn handles resume)
    train_one_step(state, step) -> (state, metrics)   may raise
    save_fn(state, step); restore_fn() -> (state, step) or None.
    """
    policy = policy or RestartPolicy()
    events = []

    def emit(kind, **kw):
        events.append({"kind": kind, "t": time.time(), **kw})
        if on_event:
            on_event(kind, kw)

    restarts = 0
    clean_steps = 0
    skip_steps: set = set()
    restored = restore_fn()
    state, step = restored if restored else make_state()
    while step < n_steps:
        try:
            if step in skip_steps:
                emit("skip_batch", step=step)
                step += 1
                continue
            state, metrics = train_one_step(state, step)
            loss = metrics.get("loss")
            if loss is not None and not math.isfinite(float(loss)):
                raise TrainingFault("nan_loss", f"step {step}")
            step += 1
            clean_steps += 1
            if (restarts and policy.reset_after_steps
                    and clean_steps >= policy.reset_after_steps):
                restarts = 0
                emit("restart_budget_reset", step=step)
            if step % ckpt_every == 0:
                save_fn(state, step)
                emit("checkpoint", step=step)
        except TrainingFault as e:
            restarts += 1
            clean_steps = 0
            emit("fault", step=step, fault=e.kind, restart=restarts)
            if restarts > policy.max_restarts:
                raise
            if e.kind == "nan_loss" and policy.skip_batch_on_nan:
                skip_steps.add(step)
            wait = policy.backoff(restarts - 1)
            if wait:
                time.sleep(wait)
            restored = restore_fn()
            state, step = restored if restored else make_state()
            emit("restart", resume_step=step)
    return state, step, events
