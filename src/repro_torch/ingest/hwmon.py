"""Linux hwmon adapter: ``/sys/class/hwmon`` power/energy files (port
of ``repro/ingest/hwmon.py``).

hwmon chips expose instantaneous power as ``power*_input`` (uW) and —
for a few drivers (amd_energy, some BMCs) — cumulative energy as
``energy*_input`` (uJ).  hwmon declares no wrap range, so energy
metrics conservatively declare the 64-bit uJ ceiling the kernel ABI
implies (values are reported as unsigned 64-bit microjoule counts);
power metrics have no wrap by nature.

Chips named ``amdgpu`` map to the canonical ``gpu<i>.power`` metrics
(discovery order = instance order), making hwmon a genuine fallback
for the SMI tools' power path; every other chip keeps its reported
name: ``<chip><instance>.power0`` etc.  ``REPRO_HWMON_ROOT`` overrides
the sysfs root for tests.
"""
from __future__ import annotations

import os
import re
import time
from pathlib import Path

from repro_torch.ingest.backend import (BackendError, MetricSpec,
                                        Reading, SensorBackend)

DEFAULT_ROOT = "/sys/class/hwmon"
# the hwmon energy ABI is an unsigned 64-bit microjoule counter
HWMON_ENERGY_WRAP_J = (2.0 ** 64) * 1e-6


def _read_text(path: Path) -> str:
    try:
        return path.read_text().strip()
    except OSError as exc:
        raise BackendError(f"hwmon: cannot read {path}: {exc}") from exc


class HwmonBackend(SensorBackend):
    """``/sys/class/hwmon`` power (uW) / energy (uJ) channels."""

    name = "hwmon"

    def __init__(self, *, root=None, clock=time.perf_counter):
        super().__init__(clock=clock)
        self.root = Path(root or os.environ.get("REPRO_HWMON_ROOT")
                         or DEFAULT_ROOT)
        self._files = {}               # metric -> (path, scale)

    def _chips(self):
        if not self.root.is_dir():
            raise BackendError(f"hwmon: no {self.root}")
        for chip in sorted(self.root.iterdir(),
                           key=lambda p: (len(p.name), p.name)):
            try:
                name = _read_text(chip / "name")
            except BackendError:
                continue
            yield chip, name

    def _discover(self):
        self._files = {}
        specs = []
        n_gpu = 0
        for chip, name in self._chips():
            is_gpu = name == "amdgpu"
            stem = f"gpu{n_gpu}" if is_gpu \
                else f"{name}{chip.name.replace('hwmon', '')}"
            if is_gpu:
                n_gpu += 1
            for f in sorted(chip.iterdir()):
                m = re.fullmatch(r"(power|energy)(\d+)_input", f.name)
                if not m:
                    continue
                kind, ch = m.group(1), int(m.group(2))
                try:
                    _read_text(f)       # permission/driver probe
                except BackendError:
                    continue
                if kind == "power":
                    metric = f"{stem}.power" if is_gpu and ch == 1 \
                        else f"{stem}.power{ch}"
                    spec = MetricSpec(metric, "power_inst",
                                      update_interval_s=1e-3,
                                      source=self.name)
                    scale = 1e-6        # uW -> W
                else:
                    metric = f"{stem}.energy" if ch == 1 \
                        else f"{stem}.energy{ch}"
                    spec = MetricSpec(metric, "energy_cum",
                                      wrap_range_j=HWMON_ENERGY_WRAP_J,
                                      resolution_j=1e-6,
                                      update_interval_s=1e-3,
                                      source=self.name)
                    scale = 1e-6        # uJ -> J
                self._files[metric] = (f, scale)
                specs.append(spec)
        return specs

    def read(self, metric: str) -> Reading:
        if metric not in self._files:
            self.discover()
        entry = self._files.get(metric)
        if entry is None:
            raise BackendError(f"hwmon: unknown metric {metric!r}")
        path, scale = entry
        val = float(_read_text(path)) * scale
        t = self._clock()
        return Reading(metric, t, t, val, self.name)
