"""Linux RAPL adapter: ``/sys/class/powercap`` energy counters (port of
``repro/ingest/rapl.py``).

Every powercap zone with an ``energy_uj`` file is a cumulative energy
counter in microjoules whose wrap period the kernel DECLARES in the
sibling ``max_energy_range_uj`` file — the off-chip analogue of the
paper's Cray PM cumulative counters, and the canonical example of the
ingest-backend invariant: the adapter reads the declared range and
puts it on the :class:`MetricSpec`; nothing downstream ever infers it
from observed deltas.

Zone naming: top-level ``package-N`` domains become ``cpuN.energy``;
subzones (core/uncore/dram) become ``cpuN.<domain>.energy``; non-Intel
zone names (``psys``, amd_energy's ``socket``) keep their reported
name.  ``REPRO_RAPL_ROOT`` overrides the sysfs root (tests point it at
a fixture tree).
"""
from __future__ import annotations

import os
import time
from pathlib import Path

from repro_torch.ingest.backend import (BackendError, MetricSpec,
                                        Reading, SensorBackend)

DEFAULT_ROOT = "/sys/class/powercap"


def _read_text(path: Path) -> str:
    try:
        return path.read_text().strip()
    except OSError as exc:
        raise BackendError(f"rapl: cannot read {path}: {exc}") from exc


class RaplBackend(SensorBackend):
    """``/sys/class/powercap`` cumulative-energy zones."""

    name = "rapl"

    def __init__(self, *, root=None, clock=time.perf_counter):
        super().__init__(clock=clock)
        self.root = Path(root or os.environ.get("REPRO_RAPL_ROOT")
                         or DEFAULT_ROOT)
        self._paths = {}               # metric -> zone dir

    def _zones(self):
        """Yield (zone_dir, depth) for every readable energy zone."""
        if not self.root.is_dir():
            raise BackendError(f"rapl: no {self.root}")
        for top in sorted(self.root.iterdir()):
            # powercap lists zones flat (intel-rapl:0, intel-rapl:0:1);
            # depth is the number of sub-ids after the first
            if not (top / "energy_uj").exists():
                continue
            ids = top.name.split(":")[1:]
            yield top, max(len(ids) - 1, 0)

    def _discover(self):
        self._paths = {}
        specs = []
        parents = {}                    # zone-id prefix -> metric stem
        for zone, depth in self._zones():
            try:
                name = _read_text(zone / "name")
                max_uj = float(_read_text(zone / "max_energy_range_uj"))
                _read_text(zone / "energy_uj")   # permission probe
            except (BackendError, ValueError):
                continue                # unreadable zone: skip, not fail
            ids = zone.name.split(":")[1:]
            if name.startswith("package-"):
                stem = f"cpu{name[8:]}"
                parents[ids[0] if ids else name] = stem
                metric = f"{stem}.energy"
            elif depth > 0 and ids and ids[0] in parents:
                metric = f"{parents[ids[0]]}.{name}.energy"
            else:
                metric = f"{name}.energy"
            self._paths[metric] = zone
            specs.append(MetricSpec(
                metric, "energy_cum",
                wrap_range_j=max_uj * 1e-6,     # kernel-declared wrap
                resolution_j=1e-6,              # file granularity (uJ)
                update_interval_s=1e-3, source=self.name))
        return specs

    def read(self, metric: str) -> Reading:
        if metric not in self._paths:
            self.discover()
        zone = self._paths.get(metric)
        if zone is None:
            raise BackendError(f"rapl: unknown metric {metric!r}")
        uj = float(_read_text(zone / "energy_uj"))
        t = self._clock()
        return Reading(metric, t, t, uj * 1e-6, self.name)
