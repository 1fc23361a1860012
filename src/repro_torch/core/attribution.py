"""Per-phase energy result type (port of ``PhaseEnergy`` from
``repro/core/attribution.py``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PhaseEnergy:
    phase: str
    t_start: float
    t_end: float
    energy_j: float
    mean_power_w: float
    steady: object = None     # steady-state stats (not produced by the port)
