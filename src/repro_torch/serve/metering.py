"""Per-request / per-user energy accounting for the serve engine (the
port's copy of ``repro/serve/metering.py``; numpy only).

The fleet pipeline's ``MeteringStage`` splits every fused slot-segment
energy across the requests concurrently active in it (token-weighted
occupancy, float64 left folds — see ``fleet.pipeline.MeteringStage``
for the determinism rule).
This module turns that raw ``{rid: (n_devices,) J}`` map into the
billing-facing API: J/request, J/token, rolling percentiles, per-user
aggregates and the JSONL artifact trail (``REPRO_METER_LOG_DIR``,
mirroring the health-event artifact).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import os

import numpy as np

METER_LOG_ENV = "REPRO_METER_LOG_DIR"


@dataclasses.dataclass
class RequestEnergy:
    """Energy bill for one served request."""
    rid: int
    energy_j: float                 # summed over devices
    energy_by_device: list          # per-device joules
    tokens: int                     # prompt + generated (weighted work)
    j_per_token: float
    user: str = ""
    ttft_s: float = math.nan        # arrival -> first token
    latency_s: float = math.nan     # arrival -> eviction

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class RollingPercentiles:
    """Bounded window of the newest samples with percentile queries —
    the 'rolling p50/p90/p99 J/request' gauges for 24/7 serving."""

    def __init__(self, window: int = 512):
        self._buf: collections.deque = collections.deque(maxlen=window)

    def add(self, value: float) -> None:
        self._buf.append(float(value))

    def extend(self, values) -> None:
        for v in values:
            self.add(v)

    def __len__(self) -> int:
        return len(self._buf)

    def percentile(self, q: float) -> float:
        if not self._buf:
            return math.nan
        return float(np.percentile(np.asarray(self._buf, np.float64), q))

    def summary(self, qs=(50, 90, 99)) -> dict:
        return {f"p{int(q)}": self.percentile(q) for q in qs}


class RequestEnergyReport:
    """Finalized per-request energies for one attribution run.

    requests: list of :class:`RequestEnergy` (sorted by rid).
    segment_totals: (n_devices, n_segments) fused joules per slot
    segment — the conservation reference (requests sum to it by
    construction).
    """

    def __init__(self, requests, segment_totals):
        self.requests = sorted(requests, key=lambda r: r.rid)
        self.segment_totals = np.asarray(segment_totals, np.float64)

    def __len__(self) -> int:
        return len(self.requests)

    def by_rid(self) -> dict:
        return {r.rid: r for r in self.requests}

    @property
    def total_j(self) -> float:
        return float(sum(r.energy_j for r in self.requests))

    def total_by_device(self) -> np.ndarray:
        d = self.segment_totals.shape[0]
        out = np.zeros((d,), np.float64)
        for r in self.requests:
            out += np.asarray(r.energy_by_device, np.float64)
        return out

    def per_user(self) -> dict:
        """{user: {energy_j, tokens, requests, j_per_token}}."""
        out: dict = {}
        for r in self.requests:
            u = out.setdefault(r.user, {"energy_j": 0.0, "tokens": 0,
                                        "requests": 0})
            u["energy_j"] += r.energy_j
            u["tokens"] += r.tokens
            u["requests"] += 1
        for u in out.values():
            u["j_per_token"] = u["energy_j"] / max(u["tokens"], 1)
        return out

    def percentiles(self, qs=(50, 90, 99)) -> dict:
        """{"j_per_request": {p50: ...}, "j_per_token": {...}}."""
        req = np.asarray([r.energy_j for r in self.requests], np.float64)
        tok = np.asarray([r.j_per_token for r in self.requests],
                         np.float64)
        out = {}
        for key, vals in (("j_per_request", req), ("j_per_token", tok)):
            out[key] = {f"p{int(q)}": (float(np.percentile(vals, q))
                                       if len(vals) else math.nan)
                        for q in qs}
        return out

    def conservation_rel_err(self, phase_totals) -> float:
        """Max per-device relative gap between the sum of per-request
        energies and the fused phase totals ((D, P) array or the summed
        (D,) vector) — the 1e-5 conservation oracle."""
        ph = np.asarray(phase_totals, np.float64)
        if ph.ndim == 2:
            ph = ph.sum(axis=1)
        req = self.total_by_device()
        scale = np.maximum(np.abs(ph), 1e-30)
        return float(np.max(np.abs(req - ph) / scale))

    # -- artifact trail ---------------------------------------------------

    def write_jsonl(self, path) -> int:
        """Append one JSON line per request; returns the count."""
        n = 0
        with open(path, "a", encoding="utf-8") as fh:
            for r in self.requests:
                fh.write(json.dumps(r.to_json(), sort_keys=True) + "\n")
                n += 1
        return n

    def maybe_write_jsonl(self):
        """If ``REPRO_METER_LOG_DIR`` is set, append this report as
        JSON lines (one file per process — the CI artifact alongside
        the health-event trail); returns the path or None."""
        d = os.environ.get(METER_LOG_ENV)
        if not d or not self.requests:
            return None
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"request-energies-{os.getpid()}.jsonl")
        self.write_jsonl(path)
        return path
