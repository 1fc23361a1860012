"""How far the live capture's CPU replay lands from its card replay, with
this tree's ``xcorr_align`` (B4) and with another tree's, on one CUDA
card.

    mkdir -p build/ab_old
    git archive <commit> src/repro_torch/csrc | tar -x -C build/ab_old
    python3 scripts/live_replay_parity.py --against build/ab_old [--captures 4]

Each capture is ``chip_smoke.live_capture`` on the attribution cell's
512-device data (``--seed``): the pump's blocks are recorded as
``chip_smoke.run_live`` records them.  They are replayed through a fresh
pipeline on the CPU (every kernel's plain version) and on the card twice,
once with this tree's kernels and once with the other tree's B4 (its C
entry called as ``scripts/kernel_ab.py`` calls it; the other kernels
this tree's).  For each card side it prints the worst relative
difference of the phase totals from the CPU's (what ``run_live`` gated
before it gave the CPU the card's B4 scores).  Every B4 call of the card replay is recorded, and its
inputs are scored again by both kernels, by the plain version on the
CPU and in float64.  For each side it prints B4's worst error against
the CPU scores and against float64, and what the tracker's
``peak_to_delay`` makes of the scores: the worst delay difference from
the CPU's estimate, in lag steps, the rows whose argmax lag differs, and
the rows accepted on one side of ``min_corr`` and not on the other.
Then the gate ``chip_smoke.run_live`` holds: the CPU replay given this
tree's B4 scores from a card replay and the two replays' B4 inputs
(``PARITY_TOL`` each), with those scores' distance from float64 and
from the plain version (printed there, not gated).  The last line is one JSON object.
Needs a CUDA card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, required=True,
                    help="a tree holding src/repro_torch/csrc")
    ap.add_argument("--captures", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("live_replay_parity: no CUDA device", file=sys.stderr)
        return 1
    for sub in ("src", "", "scripts"):
        sys.path.insert(0, str(ROOT / sub))
    import chip_smoke as cs
    import kernel_ab as ab
    import repro_torch.kernels.xcorr_align.ops as xops
    from repro_torch.align.delay import peak_to_delay
    from repro_torch.kernels import build
    from repro_torch.kernels.xcorr_align import xcorr_scores_ref
    n_other = ab.xcorr_entry_args(args.against)
    if n_other not in (ab.XCORR_OLD_ARGS, ab.xcorr_entry_args(ROOT)):
        ap.error(f"the other tree's xcorr_align_launch takes {n_other} "
                 f"arguments")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    build.timed_build()
    other = ctypes.CDLL(str(ab.build_other(args.against, build,
                                           [ab.SOURCES["b4"]])))
    this_kernel = xops.xcorr_align_kernel

    def other_kernel(x, m, bank, *, n_lags, rows_alone=False):
        # on the card a row's scores never depend on the rows beside it
        if n_other == ab.XCORR_OLD_ARGS:
            return ab.old_xcorr(other, x, m, bank, n_lags)
        with ab.using(other, build):
            return this_kernel(x, m, bank, n_lags=n_lags)

    calls = []

    def recording(x, m, bank, *, n_lags, rows_alone=False):
        calls.append((x.clone(), m.clone(), bank.clone(), n_lags))
        return this_kernel(x, m, bank, n_lags=n_lags, rows_alone=rows_alone)

    truth, groups, _ = cs.sim_groups(cs.DEVICES, cs.SPAN_S, args.seed)
    phases = cs.phases_of(truth)
    min_corr = None
    result = []
    for k in range(args.captures):
        cap = cs.live_capture(groups, truth, phases)
        cpu = cs.live_replay(cap, "cpu").totals().numpy()
        denom = np.maximum(np.abs(cpu), 1.0)
        rel = {}
        calls.clear()
        for side, fn in (("this", recording), ("other", other_kernel)):
            xops.xcorr_align_kernel = fn
            try:
                pipe = cs.live_replay(cap, None)
            finally:
                xops.xcorr_align_kernel = this_kernel
            rel[side] = float(np.max(np.abs(pipe.totals().cpu().numpy()
                                            - cpu) / denom))
            min_corr = pipe.align.min_corr
        # run_live's gate: the CPU replay given the card's B4 scores
        b4 = []
        card = cs.live_replay(cap, None, b4).totals().cpu().numpy()
        sub = cs.live_replay(cap, "cpu", b4).totals().numpy()
        in_rel, err, err64 = cs.live_b4_parity(cap, b4)
        gate = dict(cpu_rel=float(np.max(np.abs(sub - card)
                                         / np.maximum(np.abs(card), 1.0))),
                    b4_input_rel=in_rel, b4_vs_plain=err,
                    b4_vs_float64=err64)
        worst = {s: dict(vs_cpu=0.0, vs_float64=0.0, delay_steps=0.0,
                         argmax_rows=0, min_corr_rows=0)
                 for s in ("this", "other", "cpu")}
        for x, m, bank, n_lags in calls:
            max_lag = (n_lags - 1) // 2
            ref = xcorr_scores_ref(x.cpu(), m.cpu(), bank.cpu())[:, :n_lags]
            exact = xcorr_scores_ref(x.double(), m.double(),
                                     bank.double())[:, :n_lags].cpu()
            scores = {"this": this_kernel(x, m, bank, n_lags=n_lags),
                      "other": other_kernel(x, m, bank, n_lags=n_lags)}
            scores = {s: v[:, :n_lags].cpu() for s, v in scores.items()}
            scores["cpu"] = ref
            est_cpu = peak_to_delay(ref, 1.0, max_lag)
            for s, v in scores.items():
                est = peak_to_delay(v, 1.0, max_lag)
                w = worst[s]
                w["vs_cpu"] = max(w["vs_cpu"], (v - ref).abs().max().item())
                w["vs_float64"] = max(w["vs_float64"], (
                    v.double() - exact).abs().max().item())
                w["delay_steps"] = max(w["delay_steps"], (
                    est.lag_steps - est_cpu.lag_steps).abs().max().item())
                w["argmax_rows"] += int((v.argmax(1) != ref.argmax(1)).sum())
                w["min_corr_rows"] += int(((est.peak_corr >= min_corr)
                                           != (est_cpu.peak_corr >= min_corr)
                                           ).sum())
        shape = tuple(calls[0][0].shape) if calls else None
        row = dict(capture=k, b4_calls=len(calls), b4_shape=shape,
                   totals_rel_vs_cpu=rel, b4=worst, run_live_gate=gate)
        result.append(row)
        print(f"capture {k}: {len(calls)} B4 calls at {shape}; totals vs "
              f"the CPU's, worst rel: {rel}; B4: {worst}; run_live's gate "
              f"(CPU given the card's B4 scores; inputs): {gate}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
