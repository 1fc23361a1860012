"""Serve a small model with batched requests + phase-level attribution
(port of ``examples/serve_demo.py``).

Four attribution paths over the same serving run:
  1. synchronous fleet: all chip counters through one batched ΔE/Δt call,
  2. async ingest: rocm-smi-style reader threads feeding FleetStream
     chunks ONLINE with a conservation check on shutdown,
  3. fused: every sensor observing each chip time-aligned and
     inverse-variance fused (repro_torch.align) before attribution —
     batch, and replayed through the streaming stage pipeline
     (``attribute_phases(fuse=True, streaming=True)``),
  4. streaming fused ONLINE: multi-sensor reader threads (counter +
     filtered power per chip) feeding ``StreamingFusedPipeline`` —
     delays tracked on sliding windows while the run streams.
The model serves and every path attributes on the device (the card
unless the caller asks for the CPU).

  PYTHONPATH=src python -m repro_torch.examples.serve_demo [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import get_arch, reduced
from repro_torch.core import NodeFabric, ToolSpec, phase_power
from repro_torch.core.measurement_model import CHIP_IDLE_W
from repro_torch.core.power_model import occupancy_power
from repro_torch.core.reconstruction import unwrap_counter
from repro_torch.device import resolve_device
from repro_torch.fleet import FleetStream, StreamingFusedPipeline
from repro_torch.fleet.config import PipelineConfig, StreamConfig
from repro_torch.ingest import AsyncFleetIngest, SimulatedSMIReader
from repro_torch.models import Model
from repro_torch.models.layers import tree_map
from repro_torch.serve.engine import Request, ServeEngine

OCC = {"admission": (0.0, 0.05, 0.0), "prefill": (1.0, 0.5, 0.1),
       "decode": (0.15, 1.0, 0.1)}

CHUNK = 64          # ingest flush width (columns per FleetStream.update)
LEAD = 0.05         # idle lead-in of the synthesized node, seconds


def config(compute_dtype=None):
    """reduced llama3.2-3b, in ``compute_dtype`` where one is given."""
    cfg = reduced(get_arch("llama3.2-3b"))
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    return cfg


def _drain(readers, sink, t0):
    ingest = AsyncFleetIngest(readers, sink, t0).start()
    while not all(r.drained for r in readers):
        time.sleep(0.01)
    ingest.stop()
    return ingest


def _energies(rows) -> dict:
    return {k: [p.energy_j for p in row] for k, row in rows.items()}


def main(device=None, *, params=None, compute_dtype=None,
         n_requests: int = 10, max_new: int = 12, seed: int = 0) -> dict:
    """Serve ``n_requests`` requests on reduced llama3.2-3b (``params``:
    its parameters, moved to the device, else drawn from ``seed``) and
    attribute the run four
    ways, printing the reference's report.  Returns the tokens, every
    printed energy, the run's depth-0 ``phases`` and its tracer and slot
    schedule (``phases_arrays``, ``segments``), so that the same timeline
    can be attributed again elsewhere.  Raises if the async ingest's
    totals break conservation."""
    dev = resolve_device(device)
    cfg = config(compute_dtype)
    model = Model(cfg)
    if params is None:
        params = model.init(seed, device=dev)
    else:
        params = tree_map(lambda t: t.to(dev), params)
    engine = ServeEngine(model, params, batch_slots=4, max_len=64,
                         device=dev)

    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 8 + 2 * i),
                    max_new_tokens=max_new)
            for i in range(n_requests)]
    results = engine.run(reqs)
    print(f"served {len(results)} requests; "
          f"sample output tokens: {results[0][:8]}")

    phases = engine.tracer.phases(depth=0)
    lead = LEAD
    shifted = [(n, a + lead, b + lead) for n, a, b in phases]
    watts = {n: {"watts": occupancy_power(*OCC.get(n, (0, 0.1, 0)))}
             for n, _, _ in shifted}
    truth = phase_power([("__lead__", 0.0, lead)] + shifted,
                        {**watts, "__lead__": {"watts": CHIP_IDLE_W}})
    fabric = NodeFabric(chip_truths=[truth] * 4)
    traces = fabric.sample_all(ToolSpec(), seed=seed)
    # attribute ALL on-chip counters through one batched fleet call,
    # shifting the tracer timebase onto the synthesized fabric's lead-in
    # (pm_accel*_energy tray counters measure the same chips upstream —
    # including them would double-count)
    chip_traces = {n: tr for n, tr in traces.items()
                   if tr.spec.is_cumulative and n.startswith("chip")}
    per_trace = engine.attribute_phases(chip_traces, t_shift=lead)
    agg = {}
    for pe in per_trace.values():
        for p in pe:
            a = agg.setdefault(p.phase, [0.0, 0.0])
            a[0] += p.energy_j
            a[1] += p.t_end - p.t_start
    print("\nper-phase serving energy (all chips, fleet ΔE/Δt):")
    for name, (e, t) in sorted(agg.items()):
        print(f"  {name:10s} {e:9.2f} J  {t:7.3f} s  {e/max(t,1e-9):7.1f} W")

    # ---- async ingest: reader threads -> FleetStream, online ----------
    chip_list = list(chip_traces.values())
    t0 = min(float(tr.t_measured[0]) for tr in chip_list)
    span = max(float(tr.t_measured[-1]) for tr in chip_list) - t0
    windows = [(a + lead - t0, b + lead - t0) for _, a, b in phases]
    windows.append((0.0, span))              # full span: conservation
    stream = FleetStream(windows, len(chip_list),
                         wrap_period=[  # backend-DECLARED wrap period
                             tr.spec.wrap_period_j
                             for tr in chip_list], device=dev)
    ingest = _drain([SimulatedSMIReader(tr) for tr in chip_list], stream,
                    t0)
    totals = stream.totals()
    print(f"\nasync ingest: {ingest.n_polls} polls -> {ingest.n_chunks} "
          f"chunks of {CHUNK} (O(fleet x chunk) device memory)")
    agg_async = {}
    for (name, _, _), e in zip(phases, totals[:, :len(phases)].sum(axis=0)):
        agg_async[name] = agg_async.get(name, 0.0) + float(e)
    for name, e in sorted(agg_async.items()):
        print(f"  {name:10s} {e:9.2f} J (async)")
    # conservation on shutdown: per stream, the attributed full-span
    # energy must equal the counter's unwrapped ΔE over what was ingested
    for i, tr in enumerate(chip_list):
        tf, ef, tl, el = ingest.bounds[i]
        de = float(np.diff(unwrap_counter(
            np.asarray([ef, el]),
            period=tr.spec.wrap_period_j))[0]) \
            if tr.spec.wrap_period_j else el - ef
        got = float(totals[i, len(phases)])
        if not abs(got - de) <= 2e-3 * max(abs(de), 1.0) + 0.5:
            raise AssertionError(f"async ingest conservation: {tr.name} "
                                 f"attributed {got} J, counter ΔE {de} J")
    print("  conservation: async totals == unwrapped counter ΔE ✓")

    # ---- fused attribution: every sensor per chip, time-aligned -------
    # (a slow sensor whose first read falls after a short run's end has
    # nothing to fuse, and is left out; the reference assumes a run long
    # enough for every sensor to read)
    traces = {n: tr for n, tr in traces.items() if len(tr.t_read)}
    fused_rows = engine.attribute_phases(traces, t_shift=lead, fuse=True,
                                         reference=truth)
    print("\nper-phase serving energy (cross-sensor FUSED, per device):")
    for dev_name, row in fused_rows.items():
        line = "  ".join(f"{p.phase} {p.energy_j:7.2f} J" for p in row)
        print(f"  {dev_name}: {line}")

    # ---- per-request energy bills (continuous-batching metering) ------
    report = engine.attribute_requests(traces, t_shift=lead,
                                       reference=truth, track=False)
    print("\nper-request energy (token-weighted occupancy split):")
    for r in report.requests:
        print(f"  rid {r.rid}: {r.energy_j:8.2f} J over {r.tokens:3d} "
              f"tokens = {r.j_per_token:6.2f} J/tok  "
              f"(TTFT {r.ttft_s * 1e3:6.1f} ms)")
    pct = report.percentiles()["j_per_request"]
    print(f"  p50/p90/p99 J/request: {pct['p50']:.1f} / {pct['p90']:.1f}"
          f" / {pct['p99']:.1f}")

    # same numbers through the streaming stage pipeline (replayed in
    # chunks, O(fleet x chunk) memory, delays tracked on windows)
    fused_stream = engine.attribute_phases(
        traces, t_shift=lead, fuse=True, reference=truth,
        streaming=True, config=PipelineConfig(
            stream=StreamConfig(chunk=512)))
    print("per-phase serving energy (FUSED, streaming replay):")
    for dev_name, row in fused_stream.items():
        line = "  ".join(f"{p.phase} {p.energy_j:7.2f} J" for p in row)
        print(f"  {dev_name}: {line}")

    # ---- streaming fused ONLINE: multi-sensor async ingest ------------
    # one reader per SENSOR (counter + IIR power per chip), all feeding
    # the full Ingest->Reconstruct->AlignTrack->Regrid/Fuse->PhaseAttr
    # chain while the replay clock runs
    wanted = [(f"chip{i}_energy", f"chip{i}_power_inst")
              for i in range(4)]
    flat = [traces[n] for pair in wanted for n in pair]
    t0f = min(float(tr.t_measured[0]) for tr in flat)
    cad = np.median(np.diff(flat[0].t_measured))
    pipe = StreamingFusedPipeline(
        [2] * 4, [(a + lead - t0f, b + lead - t0f) for _, a, b in phases],
        grid_origin=0.0, grid_step=0.5 * float(cad),
        kind_row=[tr.spec.is_cumulative for tr in flat],
        wrap_period=[tr.spec.wrap_period_j for tr in flat],
        reference=lambda t: truth.power_at(t + t0f),
        window=2048, hop=512, max_lag=256, tail=1024, device=dev)
    online = _drain([SimulatedSMIReader(tr) for tr in flat], pipe, t0f)
    pipe.finalize()
    online_totals = pipe.totals().cpu().numpy()
    print(f"\nstreaming fused ONLINE ({online.n_polls} polls -> "
          f"{online.n_chunks} chunks, {len(pipe.delay_history)} delay "
          f"re-estimates):")
    for d in range(4):
        line = "  ".join(f"{n} {e:7.2f} J"
                         for (n, _, _), e in zip(phases, online_totals[d]))
        print(f"  device{d}: {line}")
    delays = pipe.delays().cpu().tolist()
    d_ms = ", ".join(f"{x * 1e3:+.2f}" for x in delays)
    print(f"  tracked delays (ms): {d_ms}")
    return {
        "tokens": results, "phases": phases,
        "phases_arrays": engine.tracer.to_arrays(),
        "segments": [dataclasses.asdict(s) for s in engine.segments],
        "lead": lead,
        "counters": _energies(per_trace),
        "per_phase": {k: tuple(v) for k, v in agg.items()},
        "async": {"polls": ingest.n_polls, "chunks": ingest.n_chunks,
                  "per_phase": agg_async,
                  "totals": np.asarray(totals, np.float64)},
        "fused": _energies(fused_rows),
        "requests": [{"rid": r.rid, "energy_j": r.energy_j,
                      "tokens": r.tokens, "j_per_token": r.j_per_token,
                      "ttft_s": r.ttft_s} for r in report.requests],
        "j_per_request": pct,
        "fused_streaming": _energies(fused_stream),
        "online": {"polls": online.n_polls, "chunks": online.n_chunks,
                   "delay_estimates": len(pipe.delay_history),
                   "totals": online_totals,
                   "delays_s": delays},
    }


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
