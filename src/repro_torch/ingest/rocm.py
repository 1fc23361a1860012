"""rocm-smi / amd-smi subprocess adapters (port of
``repro/ingest/rocm.py``).

Both tools expose the on-chip 64-bit energy accumulator the paper's
§II on-chip scope starts from: a tick counter at a fixed counter
resolution (~15.259 uJ/tick on MI-series parts) plus an averaged
package power.  The adapters shell out per read (one metric, one
invocation — the tools are stateless), parse the JSON output, and
declare the accumulator semantics (``wrap_range_j = 2**64 x
resolution``, ``resolution_j``) on the :class:`MetricSpec` so the
pipeline unwraps with the tool-declared period instead of guessing.

Configuration is environment-driven, like the tools themselves:

  ``REPRO_ROCM_SMI`` / ``REPRO_AMD_SMI``   explicit tool path (else
                                            ``$PATH`` auto-detection)
  ``REPRO_SMI_TIMEOUT_S``                   per-invocation timeout
  ``REPRO_INGEST_DISABLE``                  comma list of backend names
                                            to force-unavailable

A ``runner(argv, timeout_s) -> stdout`` callable can be injected for
tests (fake-subprocess fixtures) — the default wraps ``subprocess``.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import time

from repro_torch.ingest.backend import (BackendError, MetricSpec,
                                        Reading, SensorBackend)

# MI-series energy-accumulator tick size; used only when the tool
# output carries no derivable resolution (older rocm-smi reports both
# the raw counter and the accumulated uJ, from which the true
# resolution is recovered per card).
DEFAULT_RESOLUTION_UJ = 15.259
ACCUMULATOR_BITS = 64


def _timeout_s() -> float:
    try:
        return float(os.environ.get("REPRO_SMI_TIMEOUT_S", "5.0"))
    except ValueError:
        return 5.0


def _disabled(name: str) -> bool:
    raw = os.environ.get("REPRO_INGEST_DISABLE", "")
    return name in {s.strip() for s in raw.split(",") if s.strip()}


def subprocess_runner(argv, timeout_s: float) -> str:
    """Default runner: one tool invocation -> stdout (BackendError on
    missing tool, non-zero exit, or timeout)."""
    try:
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=timeout_s)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise BackendError(f"{argv[0]}: {exc}") from exc
    if proc.returncode != 0:
        raise BackendError(
            f"{argv[0]} exited {proc.returncode}: "
            f"{(proc.stderr or proc.stdout).strip()[:200]}")
    return proc.stdout


def _parse_float(raw):
    try:
        return float(raw)
    except (TypeError, ValueError):
        raise BackendError(f"unparseable numeric field: {raw!r}")


class _SmiBackend(SensorBackend):
    """Shared subprocess/tool-detection plumbing for the SMI tools."""

    tool = None                 # executable name on $PATH
    env_var = None              # explicit-path override

    def __init__(self, *, tool_path=None, runner=None,
                 clock=time.perf_counter):
        super().__init__(clock=clock)
        self._runner = runner or subprocess_runner
        self._path = tool_path or os.environ.get(self.env_var) \
            or shutil.which(self.tool)

    def tool_path(self):
        if _disabled(self.name):
            raise BackendError(f"{self.name}: disabled via "
                               f"REPRO_INGEST_DISABLE")
        if not self._path:
            raise BackendError(f"{self.name}: {self.tool} not found "
                               f"(set {self.env_var} or install it)")
        return self._path

    def _run(self, *args) -> str:
        return self._runner([self.tool_path(), *args], _timeout_s())

    def _json(self, *args):
        out = self._run(*args)
        try:
            return json.loads(out)
        except json.JSONDecodeError as exc:
            raise BackendError(
                f"{self.name}: bad JSON from {args}: {exc}") from exc


class RocmSmiBackend(_SmiBackend):
    """``rocm-smi`` adapter: per-card energy accumulator + package power.

    ``--showenergycounter`` reports both the raw tick counter
    (``Energy counter``) and the scaled ``Accumulated Energy (uJ)``;
    their ratio recovers the per-card counter resolution, which the
    MetricSpec declares together with the 64-bit wrap range.
    """

    name = "rocm-smi"
    tool = "rocm-smi"
    env_var = "REPRO_ROCM_SMI"

    _ENERGY = "Accumulated Energy (uJ)"
    _COUNTER = "Energy counter"
    _POWER_KEYS = ("Average Graphics Package Power (W)",
                   "Current Socket Graphics Package Power (W)")

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        # metric -> rocm-smi card key, recorded at discovery: the tool
        # may report non-contiguous cards (card0, card2), so the gpu{i}
        # enumeration index cannot be mapped back to a card name
        self._card_for = {}

    @staticmethod
    def _cards(doc):
        return sorted((k for k in doc if k.startswith("card")),
                      key=lambda c: int(c[4:]))

    def _resolution_j(self, fields) -> float:
        acc_uj = fields.get(self._ENERGY)
        ticks = fields.get(self._COUNTER)
        if acc_uj is not None and ticks is not None:
            t = _parse_float(ticks)
            if t > 0:
                return _parse_float(acc_uj) * 1e-6 / t
        return DEFAULT_RESOLUTION_UJ * 1e-6

    def _discover(self):
        doc = self._json("--showenergycounter", "--json")
        try:
            pdoc = self._json("--showpower", "--json")
        except BackendError:
            pdoc = {}
        # one card -> gpu index map across both documents: card keys
        # may be non-contiguous (card0, card2), so gpu{i} is the rank
        # in card order, remembered per metric for read()
        gpu_of = {card: i
                  for i, card in enumerate(self._cards({**pdoc, **doc}))}
        specs = []
        card_for = {}
        for card in self._cards(doc):
            res = self._resolution_j(doc[card])
            metric = f"gpu{gpu_of[card]}.energy"
            card_for[metric] = card
            specs.append(MetricSpec(
                metric, "energy_cum",
                wrap_range_j=(2.0 ** ACCUMULATOR_BITS) * res,
                resolution_j=res, update_interval_s=1e-3,
                source=self.name))
        for card in self._cards(pdoc):
            if any(k in pdoc[card] for k in self._POWER_KEYS):
                metric = f"gpu{gpu_of[card]}.power"
                card_for[metric] = card
                specs.append(MetricSpec(
                    metric, "power_inst",
                    update_interval_s=1e-3, source=self.name))
        self._card_for = card_for
        return specs

    def read(self, metric: str) -> Reading:
        _, _, kind = metric.partition(".")
        self.discover()
        card = self._card_for.get(metric)
        if card is None:
            raise BackendError(f"{self.name}: unknown metric {metric!r}")
        if kind == "energy":
            doc = self._json("--showenergycounter", "--json")
            t = self._clock()
            fields = doc.get(card)
            if not fields or self._ENERGY not in fields:
                raise BackendError(
                    f"{self.name}: {card} has no energy counter")
            val = _parse_float(fields[self._ENERGY]) * 1e-6
            return Reading(metric, t, t, val, self.name)
        if kind == "power":
            doc = self._json("--showpower", "--json")
            t = self._clock()
            fields = doc.get(card) or {}
            for key in self._POWER_KEYS:
                if key in fields:
                    return Reading(metric, t, t,
                                   _parse_float(fields[key]), self.name)
            raise BackendError(f"{self.name}: {card} reports no power")
        raise BackendError(f"{self.name}: unknown metric {metric!r}")


class AmdSmiBackend(_SmiBackend):
    """``amd-smi`` adapter (the rocm-smi successor).

    ``amd-smi metric --energy --json`` reports
    ``total_energy_consumption`` in joules and, on recent builds, the
    raw ``energy_accumulator`` ticks plus the explicit
    ``counter_resolution`` — declared verbatim on the MetricSpec.
    """

    name = "amd-smi"
    tool = "amd-smi"
    env_var = "REPRO_AMD_SMI"

    @staticmethod
    def _gpus(doc):
        if not isinstance(doc, list):
            raise BackendError("amd-smi: expected a JSON list")
        return sorted(doc, key=lambda d: int(d.get("gpu", 0)))

    @staticmethod
    def _value(node, unit_scale=1.0):
        if isinstance(node, dict):
            node = node.get("value")
        return _parse_float(node) * unit_scale

    def _resolution_j(self, energy) -> float:
        res = energy.get("counter_resolution")
        if res is not None:
            unit = (res.get("unit", "uJ")
                    if isinstance(res, dict) else "uJ")
            scale = 1e-6 if unit.lower() in ("uj", "µj") else 1.0
            return self._value(res, scale)
        acc = energy.get("energy_accumulator")
        tot = energy.get("total_energy_consumption")
        if acc is not None and tot is not None:
            t = self._value(acc)
            if t > 0:
                return self._value(tot) / t
        return DEFAULT_RESOLUTION_UJ * 1e-6

    def _discover(self):
        doc = self._gpus(self._json("metric", "--energy", "--json"))
        specs = []
        for entry in doc:
            i = int(entry.get("gpu", 0))
            energy = entry.get("energy") or {}
            if "total_energy_consumption" not in energy:
                continue
            res = self._resolution_j(energy)
            specs.append(MetricSpec(
                f"gpu{i}.energy", "energy_cum",
                wrap_range_j=(2.0 ** ACCUMULATOR_BITS) * res,
                resolution_j=res, update_interval_s=1e-3,
                source=self.name))
        try:
            pdoc = self._gpus(self._json("metric", "--power", "--json"))
        except BackendError:
            pdoc = []
        for entry in pdoc:
            i = int(entry.get("gpu", 0))
            if "socket_power" in (entry.get("power") or {}):
                specs.append(MetricSpec(
                    f"gpu{i}.power", "power_inst",
                    update_interval_s=1e-3, source=self.name))
        return specs

    def read(self, metric: str) -> Reading:
        dev, _, kind = metric.partition(".")
        if not dev.startswith("gpu"):
            raise BackendError(f"{self.name}: unknown metric {metric!r}")
        idx = int(dev[3:])
        if kind == "energy":
            doc = self._gpus(self._json("metric", "--energy", "--json"))
            t = self._clock()
            for entry in doc:
                if int(entry.get("gpu", 0)) == idx:
                    energy = entry.get("energy") or {}
                    if "total_energy_consumption" not in energy:
                        break
                    return Reading(
                        metric, t, t,
                        self._value(energy["total_energy_consumption"]),
                        self.name)
            raise BackendError(f"{self.name}: gpu{idx} has no energy")
        if kind == "power":
            doc = self._gpus(self._json("metric", "--power", "--json"))
            t = self._clock()
            for entry in doc:
                if int(entry.get("gpu", 0)) == idx:
                    power = entry.get("power") or {}
                    if "socket_power" not in power:
                        break
                    return Reading(metric, t, t,
                                   self._value(power["socket_power"]),
                                   self.name)
            raise BackendError(f"{self.name}: gpu{idx} reports no power")
        raise BackendError(f"{self.name}: unknown metric {metric!r}")
