"""Continuous-batching serve engine (port of ``repro/serve/engine.py``).

``ServeEngine`` runs continuous batching: a slot scheduler admits queued
requests into free batch slots mid-decode and evicts finished ones, the
per-slot KV cache is allocated once and reused across requests (each
admission prefills a fresh batch-1 cache and writes its slot row), one
masked decode step advances every active slot at its own position, and
generated token ids accumulate in a device-side buffer drained once per
flush interval (``host_transfers`` counts the drains).

Every phase lands on the ``RegionTracer`` twice: engine-global depth-0
regions (admission/prefill/decode, the attribution phases) and
slot-scoped depth-1 regions carrying the slot id and request id.  The
engine also records a ``SlotSegment`` schedule, one entry per
constant-occupancy interval with timestamps identical to the depth-0
regions; ``attribute_requests`` splits fused energy over that schedule
through the fleet pipeline's ``MeteringStage`` (per-request bills that
conserve against ``attribute_phases`` totals).  A ``HealthRegistry``
given as ``registry=`` exports the scheduler gauges and the rolling
J/request percentiles.

``FixedBatchEngine`` keeps the serve-to-completion baseline.  On the
card, each admission's prefill runs the ``flash_attention`` kernel in
every attention layer and the ``selective_scan`` kernel in every Mamba
layer.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.tracing import RegionTracer
from repro_torch.device import resolve_device, wait
from repro_torch.fleet.pipeline import SlotSegment
from repro_torch.models import Model
from repro_torch.serve.metering import (RequestEnergy, RequestEnergyReport,
                                        RollingPercentiles)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (prompt_len,)
    max_new_tokens: int
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    arrival_s: float = 0.0      # offset from run() start (load gen)
    user: str = ""              # per-user aggregation key
    t_arrival: float = math.nan     # tracer timebase, set by run()
    t_admitted: float = math.nan
    t_first: float = math.nan       # prefill done (first token computed)
    t_done: float = math.nan

    @property
    def ttft_s(self) -> float:
        return self.t_first - self.t_arrival

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_arrival


def _masked_step(model: Model, params, cache, tok, pos, active, buf, w):
    """One decode step over ALL slots: per-slot positions, inactive slots
    pinned to token 0 at position 0 (their cache rows are rewritten at
    the next admission, so the garbage write is never read), and the new
    token written into column ``w`` of the device-side token buffer."""
    cur = torch.where(active, pos + w, 0)
    tok_c = torch.where(active, tok, 0)
    logits, cache = model.decode_step(
        params, {"tokens": tok_c[:, None], "positions": cur[:, None]},
        cache, cur)
    nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
    nxt = torch.where(active, nxt, 0)
    buf[:, w] = nxt
    return nxt, cache, buf


def _scatter_slot(big, small, slot: int):
    """Copy a batch-1 cache (nested dict, batch on axis 1) into slot row
    ``slot`` of the persistent slot-batched cache, in place."""
    for key, val in small.items():
        if isinstance(val, dict):
            _scatter_slot(big[key], val, slot)
        else:
            big[key][:, slot] = val[:, 0]


_UNSET = object()      # legacy-kwarg sentinel (see fleet.config)


def _explicit(**kw) -> dict:
    """The kwargs the caller actually passed (sentinel-filtered)."""
    return {k: v for k, v in kw.items() if v is not _UNSET}


def _engine_device(params, device) -> torch.device:
    """The engine's device (None means CUDA); the parameters must be
    there already."""
    dev = resolve_device(device)
    where = params["embed"].device
    if where.type != dev.type:
        raise ValueError(f"the parameters are on {where}, the engine on "
                         f"{dev}: pass the device Model.init used")
    return where


class _AttributionMixin:
    """Shared phase-level energy attribution (both engines record the
    same depth-0 admission/prefill/decode phases)."""

    def attribute_phases(self, traces, *, corrections=None, depth=0,
                         t_shift=0.0, use_fleet=True, config=None,
                         chunk=_UNSET, fuse=False, reference=None,
                         streaming=False, track=_UNSET, delays=_UNSET,
                         shard=None, collectives=None, engine=_UNSET,
                         health=_UNSET, registry=None):
        """Per-phase energy for the engine's recorded serving phases.

        traces: {name: SensorTrace} (e.g. ``NodeFabric.sample_all``) or a
        trace list.  ``t_shift`` maps the tracer timebase into the sensor
        timebase.  The counters batch through the port's fleet path
        (``core.attribution.attribute_energy_many``) on the engine's
        device; returns {trace_name: [PhaseEnergy]} for dict input, or a
        list of [PhaseEnergy] rows for list input.  ``fuse=True`` (dict
        input) groups the traces by device, aligns and fuses every
        sensor observing each device and attributes on the fused streams
        (the batch ``align.attribute_energy_fused``, or the windowed
        pipeline with ``streaming=True``); returns {device:
        [PhaseEnergy]}.  ``health`` (streaming only) composes the
        ``health.SensorHealthStage`` into the pipeline (True or a
        ``HealthConfig``); ``registry`` (a ``HealthRegistry``, defaulting
        to the engine's own) collects the health and pipeline metrics.
        ``shard`` + ``collectives`` (streaming only) extend that pipeline
        over processes: this engine's traces are the local device groups
        the ``HostShard`` describes, and the dict covers the local
        devices with fleet-consistent energies, tracking synchronized
        over the collectives (``distributed.multihost``).
        """
        reg = registry if registry is not None else self.registry
        phases = [(n, a + t_shift, b + t_shift)
                  for n, a, b in self.tracer.phases(depth=depth)]
        legacy = _explicit(chunk=chunk, track=track, delays=delays,
                           engine=engine, health=health)
        if fuse:
            if not isinstance(traces, dict):
                raise TypeError("fuse=True groups by sensor name and needs "
                                "dict input")
            from repro_torch.align import (attribute_energy_fused,
                                           group_traces_by_device)
            groups = group_traces_by_device(traces)
            if collectives is not None:
                if not streaming:
                    raise ValueError("multi-host attribution runs the "
                                     "streaming pipeline")
                from repro_torch.distributed.multihost import (
                    attribute_energy_fused_multihost)
                all_rows = attribute_energy_fused_multihost(
                    list(groups.values()), phases, shard=shard,
                    collectives=collectives, config=config,
                    corrections=corrections, reference=reference,
                    registry=reg, device=self.device, **legacy)
                rows = [all_rows[g] for g in shard.group_ids]
            elif streaming:
                from repro_torch.fleet.pipeline import (
                    attribute_energy_fused_streaming)
                rows = attribute_energy_fused_streaming(
                    list(groups.values()), phases, config=config,
                    corrections=corrections, reference=reference,
                    registry=reg, device=self.device, **legacy)
            else:
                if config is not None:
                    raise ValueError("config= drives the streaming "
                                     "pipeline — pass streaming=True")
                rows = attribute_energy_fused(
                    list(groups.values()), phases,
                    corrections=corrections, reference=reference,
                    delays=legacy.get("delays"), device=self.device)
            return dict(zip(groups.keys(), rows))
        from repro_torch.core.attribution import attribute_energy_many
        as_dict = isinstance(traces, dict)
        trs = list(traces.values()) if as_dict else list(traces)
        rows = attribute_energy_many(trs, phases, corrections=corrections,
                                     use_fleet=use_fleet,
                                     chunk=legacy.get("chunk", 1024),
                                     device=self.device)
        if as_dict:
            return dict(zip(traces.keys(), rows))
        return rows


class ServeEngine(_AttributionMixin):
    """Continuous-batching engine: slot admission/eviction mid-decode,
    persistent per-slot cache reuse, masked decode, device-side token
    buffers, slot-scoped tracing and a metering schedule.

    flush_interval: decode steps per device->host token drain (ONE
    transfer per segment; also the admission cadence).
    prefill_bucket: round prompt lengths up to a multiple (left-padded;
    the pad tokens are attended over, as in the reference); 1 keeps
    exact lengths.  registry: a ``health.HealthRegistry`` that exports
    the tracer buffer, the scheduler gauges and the rolling J/request
    percentiles.  device: None means CUDA; ``params`` must be there.
    """

    def __init__(self, model: Model, params, *, batch_slots=4,
                 max_len=512, tracer: Optional[RegionTracer] = None,
                 greedy=True, registry=None, flush_interval=16,
                 prefill_bucket=1, device=None):
        if not greedy:
            raise NotImplementedError("only greedy decoding is supported")
        self.device = _engine_device(params, device)
        self.registry = registry
        self.model = model
        self.params = params
        self.slots = int(batch_slots)
        self.max_len = int(max_len)
        self.tracer = tracer or RegionTracer()
        self.flush_interval = max(int(flush_interval), 1)
        self.prefill_bucket = max(int(prefill_bucket), 1)
        # persistent slot-batched cache — allocated ONCE, reused across
        # requests (admission rewrites one slot row)
        self.cache = model.init_cache(self.slots, self.max_len,
                                      device=self.device)
        zeros = torch.zeros((self.slots,), dtype=torch.int32,
                            device=self.device)
        self._nxt = zeros.clone()
        self._pend = zeros.clone()
        self._buf = torch.zeros((self.slots, self.flush_interval),
                                dtype=torch.int32, device=self.device)
        self.host_transfers = 0
        self.requests_served = 0
        self.tokens_emitted = 0
        self.segments: list = []        # SlotSegment metering schedule
        # gauges / counters (exported via HealthRegistry.track_serve)
        self.queue_depth = 0
        self.active_slots = 0
        self.meter_rolling = RollingPercentiles()
        self._requests: dict = {}
        if registry is not None:
            registry.track_tracer("serve", self.tracer)
            registry.track_serve("serve", self)

    # -- plumbing ---------------------------------------------------------

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        self.host_transfers += 1
        return t.cpu().numpy()

    def _idle_until(self, t_target: float) -> None:
        dt = t_target - self.tracer.now()
        if dt > 0:
            time.sleep(dt)

    # -- scheduler --------------------------------------------------------

    def _admit(self, slot: int, r: Request) -> int:
        """Prefill ``r`` on a fresh batch-1 cache and write it into
        ``slot``; returns the (bucketed) prompt length."""
        t0 = self.tracer.now()
        plen = len(r.prompt)
        lb = -(-plen // self.prefill_bucket) * self.prefill_bucket
        toks = np.zeros((1, lb), np.int32)
        toks[0, lb - plen:] = np.asarray(r.prompt, np.int32)  # left-pad
        t1 = self.tracer.now()
        self.tracer.add_region("admission", t0, t1, depth=0)
        self.tracer.add_region("admission", t0, t1, depth=1,
                               slot=slot, step=r.rid)
        self.segments.append(
            SlotSegment(t0, t1, (r.rid,), (1.0,), "admission"))
        logits, c1 = self.model.prefill(
            self.params, {"tokens": torch.as_tensor(toks,
                                                    device=self.device)},
            self.model.init_cache(1, self.max_len, device=self.device))
        nxt0 = torch.argmax(logits[0, -1]).to(torch.int32)
        _scatter_slot(self.cache, c1, slot)
        self._nxt[slot] = nxt0
        self._pend[slot] = nxt0
        wait(self.device)
        t2 = self.tracer.now()
        self.tracer.add_region("prefill", t1, t2, depth=0)
        self.tracer.add_region("prefill", t1, t2, depth=1,
                               slot=slot, step=r.rid)
        self.segments.append(
            SlotSegment(t1, t2, (r.rid,), (float(lb),), "prefill"))
        r.t_admitted = t0
        r.t_first = t2
        return lb

    def _decode_segment(self, k, slot_req, pos, remaining, active,
                        pend_fresh, results):
        """Run ``k`` masked decode steps, then drain the device token
        buffer (plus pending prefill tokens) in ONE host transfer;
        evict finished slots."""
        t0 = self.tracer.now()
        act = torch.as_tensor(active, device=self.device)
        posd = torch.as_tensor(pos, device=self.device)
        tok, buf = self._nxt, self._buf
        for t in range(k):
            tok, self.cache, buf = _masked_step(
                self.model, self.params, self.cache, tok, posd, act, buf, t)
        self._nxt, self._buf = tok, buf
        toks = self._to_host(torch.cat([self._pend[:, None], buf], dim=1))
        t1 = self.tracer.now()
        if k:
            self.tracer.add_region("decode", t0, t1, depth=0)
            rids, weights = [], []
            for i in np.nonzero(active)[0]:
                r = slot_req[i]
                self.tracer.add_region("decode", t0, t1, depth=1,
                                       slot=int(i), step=r.rid)
                rids.append(r.rid)
                weights.append(float(k))
            self.segments.append(
                SlotSegment(t0, t1, tuple(rids), tuple(weights),
                            "decode"))
        for i in np.nonzero(active)[0]:
            r = slot_req[i]
            start = 0 if pend_fresh[i] else 1
            new = [int(x) for x in toks[i, start:1 + k]]
            pend_fresh[i] = False
            r.generated.extend(new)
            self.tokens_emitted += len(new)
            pos[i] += k
            remaining[i] -= k
            if remaining[i] <= 0:               # evict: slot freed
                r.done = True
                r.t_done = t1
                results[r.rid] = r.generated
                active[i] = False
                slot_req[i] = None
                self.requests_served += 1

    def run(self, requests, *, respect_arrivals=False):
        """Serve ``requests`` with continuous batching; returns
        {rid: generated}.  ``respect_arrivals=True`` holds each request
        back until ``arrival_s`` seconds after this call started (open-
        loop load, e.g. from ``serve.loadgen.poisson_requests``);
        otherwise everything is queued immediately in input order.
        """
        results: dict = {}
        reqs = list(requests)
        t_run0 = self.tracer.now()
        for r in reqs:
            r.t_arrival = t_run0 + (r.arrival_s if respect_arrivals
                                    else 0.0)
            self._requests[r.rid] = r
        if respect_arrivals:
            reqs.sort(key=lambda r: (r.arrival_s, r.rid))
        queue = collections.deque(reqs)
        slot_req = [None] * self.slots
        pos = np.zeros((self.slots,), np.int64)
        remaining = np.zeros((self.slots,), np.int64)
        active = np.zeros((self.slots,), bool)
        pend_fresh = np.zeros((self.slots,), bool)
        while queue or active.any():
            free = [i for i in range(self.slots) if not active[i]]
            fi = 0
            while queue and fi < len(free):
                r = queue[0]
                if respect_arrivals and r.t_arrival > self.tracer.now():
                    if active.any():
                        break           # keep decoding while we wait
                    self._idle_until(r.t_arrival)
                queue.popleft()
                if r.max_new_tokens <= 0:
                    r.done = True
                    results[r.rid] = r.generated
                    continue
                i = free[fi]
                fi += 1
                lb = self._admit(i, r)
                slot_req[i] = r
                pos[i] = lb
                remaining[i] = r.max_new_tokens - 1   # 1 pending token
                active[i] = True
                pend_fresh[i] = True
            self.queue_depth = len(queue)
            self.active_slots = int(active.sum())
            if not active.any():
                continue
            k = int(min(self.flush_interval, remaining[active].min()))
            self._decode_segment(k, slot_req, pos, remaining, active,
                                 pend_fresh, results)
            self.active_slots = int(active.sum())
        self.queue_depth = 0
        self.active_slots = 0
        return results

    def slot_schedule(self) -> list:
        """The recorded ``SlotSegment`` schedule (metering input)."""
        return list(self.segments)

    # -- per-request energy ----------------------------------------------

    def attribute_requests(self, traces, *, corrections=None,
                           t_shift=0.0, config=None, chunk=_UNSET,
                           reference=None, track=_UNSET,
                           delays=_UNSET, health=_UNSET,
                           registry=None) -> RequestEnergyReport:
        """Split fused phase energy across requests -> energy bills.

        Runs the windowed fused pipeline on the engine's device with the
        slot-segment schedule composed as a ``MeteringStage``: each
        segment's energy is divided across its concurrently-active
        requests by token-weighted occupancy.  Returns a
        ``RequestEnergyReport`` (J/request, J/token, percentiles,
        per-user aggregates); the rolling J/request percentiles update
        the engine's registry gauges, and the report is appended to the
        ``REPRO_METER_LOG_DIR`` JSONL artifact when that is set.
        Per-request energies sum to the ``attribute_phases(fuse=True,
        streaming=True)`` totals within 1e-5 (the segments tile the
        depth-0 phases exactly).
        """
        if not isinstance(traces, dict):
            raise TypeError("per-request metering fuses by device and "
                            "needs dict input")
        from repro_torch.align import group_traces_by_device
        from repro_torch.fleet.config import resolve_config
        from repro_torch.fleet.pipeline import (
            attribute_energy_fused_streaming)
        reg = registry if registry is not None else self.registry
        phases = [(n, a + t_shift, b + t_shift)
                  for n, a, b in self.tracer.phases(depth=0)]
        segs = [s.shifted(t_shift) for s in self.segments]
        cfg = resolve_config(config,
                             _explicit(chunk=chunk, track=track,
                                       delays=delays, health=health),
                             "attribute_requests")
        groups = group_traces_by_device(traces)
        _, pipe = attribute_energy_fused_streaming(
            list(groups.values()), phases, corrections=corrections,
            reference=reference, config=cfg, registry=reg, meter=segs,
            return_pipe=True, device=self.device)
        energies = pipe.request_energies()
        entries = []
        for rid in sorted(energies):
            e = energies[rid]
            ej = float(np.sum(e))
            r = self._requests.get(rid)
            tokens = ((len(r.prompt) + len(r.generated))
                      if r is not None else 0)
            entries.append(RequestEnergy(
                rid=rid, energy_j=ej,
                energy_by_device=[float(x) for x in e], tokens=tokens,
                j_per_token=ej / max(tokens, 1),
                user=r.user if r is not None else "",
                ttft_s=r.ttft_s if r is not None else math.nan,
                latency_s=r.latency_s if r is not None else math.nan))
        report = RequestEnergyReport(
            entries, pipe.meter_stage.segment_totals())
        for re_ in report.requests:
            self.meter_rolling.add(re_.energy_j)
        report.maybe_write_jsonl()
        return report


class FixedBatchEngine(_AttributionMixin):
    """The serve-to-completion baseline: fixed batches, the cache
    re-initialized per batch, dummy padding slots zero-masked, and the
    decoded tokens drained from a device-side buffer once per
    ``flush_interval`` steps (``host_transfers`` counts the drains).
    registry: a ``health.HealthRegistry`` that exports the tracer
    buffer."""

    def __init__(self, model: Model, params, *, batch_slots=4,
                 max_len=512, tracer: Optional[RegionTracer] = None,
                 greedy=True, registry=None, flush_interval=16,
                 device=None):
        if not greedy:
            raise NotImplementedError("only greedy decoding is supported")
        self.device = _engine_device(params, device)
        self.model = model
        self.params = params
        self.slots = int(batch_slots)
        self.max_len = int(max_len)
        self.tracer = tracer or RegionTracer()
        self.registry = registry
        self.flush_interval = max(int(flush_interval), 1)
        if registry is not None:
            registry.track_tracer("serve", self.tracer)
        self.cache = model.init_cache(self.slots, self.max_len,
                                      device=self.device)
        self.host_transfers = 0
        self.requests_served = 0
        self.tokens_emitted = 0

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        self.host_transfers += 1
        return t.cpu().numpy()

    def _pad_prompts(self, reqs):
        """(slots, plen) tokens + (slots,) real-row mask; dummy rows
        are all-zero, NOT clones of ``batch[0]``."""
        plen = max(len(r.prompt) for r in reqs)
        toks = np.zeros((self.slots, plen), np.int32)
        mask = np.zeros((self.slots,), bool)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt):] = r.prompt   # left-pad
            mask[i] = True
        return torch.as_tensor(toks, device=self.device), plen, mask

    def run(self, requests):
        """Serve a list of requests (<= slots at a time), batched."""
        results: dict = {}
        queue = list(requests)
        t_run0 = self.tracer.now()
        for r in queue:
            r.t_arrival = t_run0
        while queue:
            batch = queue[:self.slots]
            queue = queue[self.slots:]
            with self.tracer.region("admission"):
                toks, plen, mask = self._pad_prompts(batch)
                self.cache = self.model.init_cache(
                    self.slots, self.max_len, device=self.device)
            with self.tracer.region("prefill"):
                logits, self.cache = self.model.prefill(
                    self.params, {"tokens": toks}, self.cache)
                wait(self.device)
            t_first = self.tracer.now()
            for r in batch:
                r.t_first = t_first
            act = torch.as_tensor(mask, device=self.device)
            pos = plen
            nxt = torch.where(act, torch.argmax(logits[:, -1], dim=-1)
                              .to(torch.int32), 0)
            max_new = max(r.max_new_tokens for r in batch)
            all_toks: list = []
            with self.tracer.region("decode"):
                dev_buf = [nxt]           # includes the prefill token
                for _t in range(1, max_new):
                    logits, self.cache = self.model.decode_step(
                        self.params, {"tokens": nxt[:, None]},
                        self.cache, pos)
                    nxt = torch.where(act, torch.argmax(logits[:, 0],
                                                        dim=-1)
                                      .to(torch.int32), 0)
                    pos += 1
                    dev_buf.append(nxt)
                    if len(dev_buf) >= self.flush_interval:
                        all_toks.append(
                            self._to_host(torch.stack(dev_buf, dim=1)))
                        dev_buf = []
                if dev_buf:
                    all_toks.append(
                        self._to_host(torch.stack(dev_buf, dim=1)))
            flat = (np.concatenate(all_toks, axis=1) if all_toks
                    else np.zeros((self.slots, 0), np.int32))
            t_done = self.tracer.now()
            for i, r in enumerate(batch):
                r.generated.extend(
                    int(x) for x in flat[i, :r.max_new_tokens])
                r.done = True
                r.t_done = t_done
                results[r.rid] = r.generated
                self.tokens_emitted += len(r.generated)
                self.requests_served += 1
        return results
