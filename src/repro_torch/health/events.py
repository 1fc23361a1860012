"""Typed fleet-health events (port of ``repro/health/events.py``).

The streaming :class:`~repro_torch.health.stage.SensorHealthStage` emits
one :class:`HealthEvent` per sensor state-machine transition (and one per
auto-recalibration suggestion).  Events are plain frozen dataclasses so
tests compare them structurally, and serialize to JSON lines for the CI
artifact trail (`REPRO_HEALTH_LOG_DIR`).
"""
from __future__ import annotations

import dataclasses
import json

# per-sensor state machine codes (ordering matters: fusion includes a
# sensor exactly while its state is <= SUSPECT)
HEALTHY, SUSPECT, QUARANTINED, RECOVERING = 0, 1, 2, 3
STATE_NAMES = ("healthy", "suspect", "quarantined", "recovering")


@dataclasses.dataclass(frozen=True)
class HealthEvent:
    """One sensor health transition or repair suggestion.

    ``window`` is the fold index (number of all-reduced stat folds so
    far) and ``t`` the last grid time of the window whose statistics
    triggered the event — both identical on every host, so event
    streams can be compared bitwise across process counts.
    """
    kind: str                  # "transition" | "recalibrate"
    window: int                # fold index at emission
    t: float                   # last grid time of the folded window
    sensor: int                # GLOBAL fleet row id
    name: str                  # sensor name (or "s<row>" fallback)
    state_from: int
    state_to: int
    flags: tuple = ()          # diagnostic flags active at the fold
    detail: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["state_from"] = STATE_NAMES[self.state_from]
        d["state_to"] = STATE_NAMES[self.state_to]
        d["flags"] = list(self.flags)
        return d


def write_events_jsonl(events, path) -> int:
    """Append ``events`` to ``path`` as JSON lines; returns the count."""
    n = 0
    with open(path, "a", encoding="utf-8") as fh:
        for ev in events:
            fh.write(json.dumps(ev.to_json(), sort_keys=True) + "\n")
            n += 1
    return n
