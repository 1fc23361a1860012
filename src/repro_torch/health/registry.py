"""Telemetry export: a pull-based metrics registry (port of
``repro/health/registry.py``; host Python, duck-typed over its sources).

``HealthRegistry`` aggregates metric *sources* — callables returning
lists of :class:`Metric` — plus ad-hoc pushed counters/gauges, and
renders them as Prometheus-style text exposition or a JSON snapshot.
Sources are pulled at export time, so registering one costs nothing on
the pipeline hot path; the health stage, the stream pipeline's stage
timers, the framed-reduce wire stats and the tracing buffers all
register here.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Metric:
    """One exported metric: a scalar or a {label_value: value} map."""
    name: str
    value: object              # float | dict[str, float]
    kind: str = "gauge"        # "gauge" | "counter"
    help: str = ""
    label: str = "id"          # label KEY used for dict values


def _fmt(v) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


class HealthRegistry:
    """Named metric sources -> Prometheus text / JSON snapshots."""

    def __init__(self, namespace: str = "repro"):
        self.namespace = namespace
        self._sources: dict = {}
        self._gauges: dict = {}
        self._counters: dict = {}

    # -- wiring ----------------------------------------------------------

    def register_source(self, name: str, fn) -> None:
        """fn() -> list[Metric]; re-registering a name replaces it."""
        self._sources[name] = fn

    def unregister_source(self, name: str) -> None:
        self._sources.pop(name, None)

    def inc(self, name: str, amount: float = 1.0) -> None:
        self._counters[name] = self._counters.get(name, 0.0) + amount

    def set_gauge(self, name: str, value: float) -> None:
        self._gauges[name] = float(value)

    def track_tracer(self, name: str, tracer) -> None:
        """Expose a ``core.tracing.RegionTracer`` buffer + drop count."""
        def _fn(nm=name, tr=tracer):
            return [
                Metric("tracer_events", {nm: float(len(tr.events))},
                       label="tracer"),
                Metric("tracer_dropped_total", {nm: float(tr.dropped)},
                       kind="counter", label="tracer"),
            ]
        self.register_source(f"tracer:{name}", _fn)

    def track_sampler(self, name: str, sampler) -> None:
        """Expose a live sampler's buffer + drop count (anything with
        ``t_read`` and ``dropped``)."""
        def _fn(nm=name, sm=sampler):
            return [
                Metric("sampler_samples", {nm: float(len(sm.t_read))},
                       label="sampler"),
                Metric("sampler_dropped_total", {nm: float(sm.dropped)},
                       kind="counter", label="sampler"),
            ]
        self.register_source(f"sampler:{name}", _fn)

    def track_serve(self, name: str, engine) -> None:
        """Expose a ``serve.ServeEngine``'s scheduler gauges plus the
        rolling per-request energy percentiles (metering gauges)."""
        def _fn(eng=engine):
            out = [
                Metric("serve_requests_total",
                       float(eng.requests_served), kind="counter"),
                Metric("serve_tokens_total",
                       float(eng.tokens_emitted), kind="counter"),
                Metric("serve_host_transfers_total",
                       float(eng.host_transfers), kind="counter"),
                Metric("serve_queue_depth", float(eng.queue_depth)),
                Metric("serve_active_slots", float(eng.active_slots)),
            ]
            roll = getattr(eng, "meter_rolling", None)
            if roll is not None and len(roll):
                out.append(Metric(
                    "meter_j_per_request", roll.summary(),
                    help="rolling per-request energy percentiles (J)",
                    label="q"))
            return out
        self.register_source(f"serve:{name}", _fn)

    def track_ingest(self, name: str, ingest) -> None:
        """Expose a prioritized ingest's per-backend
        counters (reads, errors, fallbacks, cache hits, demotions,
        recoveries) plus the total-read counter."""
        def _fn(nm=name, ing=ingest):
            out = [Metric("ingest_reads_total", float(ing.n_reads),
                          kind="counter")]
            keys = sorted({k for c in ing.counters.values() for k in c})
            for key in keys:
                out.append(Metric(
                    f"ingest_{key}_total",
                    {b: float(c.get(key, 0.0))
                     for b, c in sorted(ing.counters.items())},
                    kind="counter", label="backend"))
            return out
        self.register_source(f"ingest:{name}", _fn)

    def track_collectives(self, collectives) -> None:
        """Expose the framed-reduce wire stats (bytes posted vs dense)."""
        def _fn(co=collectives):
            ws = co.wire_stats
            if dataclasses.is_dataclass(ws):
                ws = dataclasses.asdict(ws)
            return [Metric(f"wire_{k}", float(v), kind="counter")
                    for k, v in sorted(ws.items())]
        self.register_source("wire", _fn)

    # -- export ----------------------------------------------------------

    def collect(self) -> list:
        out = []
        for name in sorted(self._sources):
            out.extend(self._sources[name]())
        for k in sorted(self._gauges):
            out.append(Metric(k, self._gauges[k]))
        for k in sorted(self._counters):
            out.append(Metric(k, self._counters[k], kind="counter"))
        return out

    def json_snapshot(self) -> dict:
        """{metric: value | {label_value: value}} over all sources."""
        snap: dict = {}
        for m in self.collect():
            if isinstance(m.value, dict):
                d = snap.setdefault(m.name, {})
                d.update({str(k): float(v) for k, v in m.value.items()})
            else:
                snap[m.name] = float(m.value)
        return snap

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (namespaced metric names,
        one labelled sample per dict entry)."""
        lines: list = []
        seen: set = set()
        for m in self.collect():
            full = f"{self.namespace}_{m.name}"
            if full not in seen:
                seen.add(full)
                if m.help:
                    lines.append(f"# HELP {full} {m.help}")
                lines.append(f"# TYPE {full} {m.kind}")
            if isinstance(m.value, dict):
                for k in sorted(m.value):
                    lv = (str(k).replace("\\", "\\\\")
                          .replace('"', '\\"'))
                    lines.append(f'{full}{{{m.label}="{lv}"}} '
                                 f'{_fmt(m.value[k])}')
            else:
                lines.append(f"{full} {_fmt(m.value)}")
        return "\n".join(lines) + "\n"
