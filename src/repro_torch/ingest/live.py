"""Live capture: real counters -> the streaming attribution pipeline on
the device (port of ``repro/ingest/live.py``).

``attribute_live`` is the end-to-end wire-up: discover backends, stack
them behind :class:`PrioritizedIngest`, adapt each chosen metric to a
:class:`BackendReader`, pump them with :class:`AsyncFleetIngest`, and
drive the full Ingest -> Reconstruct -> AlignTrack -> Regrid/Fuse ->
PhaseAttribute chain online — the same stages, carries, and
determinism rules as the simulated path, with every counter's wrap
period coming from the backend's DECLARED semantics.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.ingest.async_ingest import AsyncFleetIngest
from repro_torch.ingest.priority import (BackendReader,
                                         IngestUnavailable,
                                         PrioritizedIngest,
                                         default_backend_order)


def discover_backends(*, include=None, sim_traces=None):
    """Instantiate every real backend that discovers >= 1 metric.

    include: restrict to these backend names (default: the
    ``REPRO_INGEST_PRIORITY`` order).  ``sim_traces`` appends a
    :class:`~repro_torch.ingest.sim.SimBackend` replaying the given traces —
    the usual CI fallback when the host has no readable counters.
    """
    from repro_torch.ingest.hwmon import HwmonBackend
    from repro_torch.ingest.rapl import RaplBackend
    from repro_torch.ingest.rocm import AmdSmiBackend, RocmSmiBackend
    from repro_torch.ingest.sim import SimBackend
    factories = {"rocm-smi": RocmSmiBackend, "amd-smi": AmdSmiBackend,
                 "rapl": RaplBackend, "hwmon": HwmonBackend}
    order = list(include) if include is not None \
        else default_backend_order()
    out = []
    for name in order:
        if name == "sim":
            continue
        fac = factories.get(name)
        if fac is None:
            continue
        b = fac()
        if b.discover():
            out.append(b)
    if sim_traces is not None:
        out.append(SimBackend(sim_traces))
    return out


@dataclasses.dataclass
class LiveResult:
    """One live capture: per-group per-phase energies + provenance."""
    phases: list               # [(name, a, b)] in capture time
    groups: list               # group labels (metric stems), row order
    metrics: list              # flat metric names, pipeline row order
    totals: np.ndarray         # (n_groups, n_phases) joules, host float64
    t0: float                  # capture origin on the backend clock
    pipe: object               # the finalized StreamingFusedPipeline
    ingest: PrioritizedIngest  # counters/events for the capture
    readers: list              # BackendReaders (dedupe/unavail stats)
    pump: AsyncFleetIngest     # poll/chunk/dupe stats

    def energies(self) -> dict:
        """{phase_name: {group: joules}}"""
        return {name: {g: float(self.totals[i, j])
                       for i, g in enumerate(self.groups)}
                for j, (name, _, _) in enumerate(self.phases)}


def _group(metrics, specs):
    """Contiguous device groups from metric stems (text before the
    first '.'), preserving first-seen stem order."""
    order = []
    by_stem = {}
    for m, sp in zip(metrics, specs):
        stem = m.partition(".")[0]
        if stem not in by_stem:
            by_stem[stem] = []
            order.append(stem)
        by_stem[stem].append((m, sp))
    flat = [pair for stem in order for pair in by_stem[stem]]
    return ([m for m, _ in flat], [sp for _, sp in flat],
            order, [len(by_stem[s]) for s in order])


def _prewarm(make_pipe, n: int, chunk: int, grid_step: float,
             window: int) -> None:
    """Pay the pipeline's first-call costs on a throwaway pipeline.

    The first ``update``/``finalize`` of a fresh pipeline on the card
    loads the kernel library (building it when the sources changed) and
    pays each kernel's first launch — a stall that can cost the start
    of a live capture.  Driving an identically-shaped pipeline over
    synthetic ramps does that before the capture starts.  It is not a
    fallback: a kernel that fails to build or launch raises here.
    """
    w = make_pipe()
    n_chunks = max(window // max(chunk, 1), 1) + 2
    for it in range(n_chunks):
        t_blk = ((np.arange(chunk) + it * chunk)[None, :]
                 * grid_step * np.ones((n, 1)))
        e_blk = t_blk + 1.0            # 1 W ramp / 1 W flat power
        w.update(t_blk.astype(np.float32), e_blk.astype(np.float32))
    w.finalize()


def attribute_live(phases=None, *, duration_s: float = None,
                   ingest: PrioritizedIngest = None, backends=None,
                   metrics=None, chunk: int = 32,
                   interval_s: float = 2e-3, grid_step: float = None,
                   reference=None, window: int = 256, hop: int = 128,
                   max_lag: int = 16, tail: int = 128, policy=None,
                   events=None, registry=None, health=None,
                   dq_policy=None, warmup: bool = True,
                   settle_s: float = 10.0, device=None) -> LiveResult:
    """Attribute live counter reads to phases, end to end.

    phases: [(name, a, b)] in seconds since capture start (default:
    one ``capture`` phase spanning ``duration_s``).  Backends are
    discovered when neither ``ingest`` nor ``backends`` is given;
    metrics default to every cumulative-energy counter the stack
    declares (all metrics when none are cumulative).  ``reference``
    (a callable t->watts in capture time) enables delay tracking;
    without one delays are frozen at zero.  ``warmup`` pays the
    pipeline's first-call costs before the first read so capture start
    is not lost to them.  device: None means CUDA (raises without a
    card); pass "cpu" for the plain PyTorch versions of the kernels.
    """
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    if phases is None:
        assert duration_s is not None, \
            "attribute_live needs phases or duration_s"
        phases = [("capture", 0.0, float(duration_s))]
    phases = [(str(n), float(a), float(b)) for n, a, b in phases]
    if duration_s is None:
        duration_s = max(b for _, _, b in phases)
    if ingest is None:
        if backends is None:
            backends = discover_backends()
        if not backends:
            raise IngestUnavailable(
                "no ingest backend discovered any metric on this host")
        ingest = PrioritizedIngest(backends, policy=policy,
                                   events=events, registry=registry)
    declared = ingest.metrics()
    if metrics is None:
        metrics = sorted(m for m, sps in declared.items()
                         if sps[0].is_cumulative)
        if not metrics:
            metrics = sorted(declared)
    if not metrics:
        raise IngestUnavailable("no metrics to capture")
    specs = [ingest.spec(m) for m in metrics]
    metrics, specs, groups, group_sizes = _group(metrics, specs)

    if grid_step is None:
        grid_step = float(interval_s)
    n = len(metrics)
    from repro_torch.fleet.pipeline import StreamingFusedPipeline

    def _make_pipe(reg=None):
        return StreamingFusedPipeline(
            group_sizes, [(a, b) for _, a, b in phases],
            grid_origin=0.0, grid_step=float(grid_step),
            kind_row=[sp.is_cumulative for sp in specs],
            wrap_period=[sp.wrap_range_j if sp.is_cumulative else 0.0
                         for sp in specs],
            reference=reference,
            delays=None if reference is not None else np.zeros((n,)),
            window=window, hop=hop, max_lag=max_lag, tail=tail,
            health=health, health_names=list(metrics),
            registry=reg, dq_policy=dq_policy, device=dev)

    if warmup:
        _prewarm(_make_pipe, n, chunk, float(grid_step), window)
    pipe = _make_pipe(registry)

    # prime: one read per metric proves the stack is live and pins the
    # capture origin on the backend clock (AFTER warmup — replay-style
    # backends start their clock on first read)
    primed = [ingest.read(m) for m in metrics]
    t0 = min(r.t_measured for r in primed)

    readers = [BackendReader(ingest, m, duration_s=float(duration_s))
               for m in metrics]
    pump = AsyncFleetIngest(readers, pipe, t0, chunk=chunk,
                            interval_s=interval_s).start()
    deadline = time.perf_counter() + float(duration_s) + settle_s
    while not all(r.drained for r in readers) \
            and time.perf_counter() < deadline:
        time.sleep(min(0.01, interval_s))
    for r in readers:
        r.stop()
    pump.stop()
    pipe.finalize()
    return LiveResult(phases=phases, groups=groups, metrics=metrics,
                      totals=pipe.totals().cpu().numpy(),
                      t0=t0, pipe=pipe, ingest=ingest,
                      readers=readers, pump=pump)
