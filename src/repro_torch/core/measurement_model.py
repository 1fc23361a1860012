"""The paper's three-stage asynchronous measurement model (§II-A, Fig. 1).

The port's own copy of ``repro/core/measurement_model.py`` (pure
Python, no device code).

Stage 1 — *sensor production*: the sensor measures on its own internal
cadence with its own timestamps (``t_measured``), possibly integrating or
filtering (energy accumulation, moving-average power).
Stage 2 — *driver publication*: the OS/driver refreshes a published value at
its own cadence; reads between refreshes see the cached value.
Stage 3 — *tool sampling*: the instrumentation polls at a requested cadence
with jitter/overhead and records ``t_read``.

Reads NEVER trigger measurements; the observable lag is
``Δt = t_read − t_measured``.  Every quantity here is an explicit,
test-recoverable parameter of :class:`SensorSpec`.
"""
from __future__ import annotations

import dataclasses

# Simulated hardware constants for the TPU-v5e-like node (DESIGN.md §2).
# The paper's equivalents: MI250X TDP 560 W / MI300A cap 550 W; Cray PM
# +5-10% upstream;  NIC +30 W static on shared-rail accelerators.
CHIP_TDP_W = 215.0
CHIP_IDLE_W = 55.0
HOST_CPU_W = 280.0          # per tray (4 chips)
DDR_W = 60.0                # per tray
NIC_W = 30.0                # per NIC; chips 0 and 2 share the NIC rail
PM_UPSTREAM_FACTOR = 1.07   # PM measures pre-VRM: ~7% above on-chip
ENERGY_WRAP_BITS = 44       # cumulative energy counter wraps (uJ ticks)


@dataclasses.dataclass(frozen=True)
class SensorSpec:
    """One sensor's full signal-chain description."""
    name: str
    scope: str                    # "chip" | "tray" | "node"
    kind: str                     # "energy_cum" | "power_avg" | "power_inst"
    # stage 1: production
    production_interval_s: float = 1e-3
    production_jitter_s: float = 5e-5
    timestamp_jitter_s: float = 2e-5
    filter_kind: str = "none"     # "none" | "ma" (moving avg) | "iir"
    filter_window_s: float = 0.0  # MA window or IIR time-constant
    # fixed sensing latency: the value published at t_measured reflects
    # the physical state delay_s EARLIER (firmware aggregation windows,
    # ADC conversion, telemetry transport).  Invisible in the trace
    # itself — the alignment subsystem (repro.align) blind-estimates it
    # from square-wave cross-correlation and tests recover this value.
    delay_s: float = 0.0
    # linear sensor-clock drift in parts-per-million: the reported
    # t_measured runs FAST by drift_ppm, so a feature at true time T
    # carries timestamp T + (T - t0) * drift_ppm * 1e-6 — the stream's
    # effective lag against the schedule GROWS linearly during the run
    # (total lag(t) = delay_s + (t - t0) * drift_ppm * 1e-6).  A batch
    # whole-trace estimate can only see the mid-run average; the online
    # AlignTrack stage (fleet.pipeline) follows it window by window.
    drift_ppm: float = 0.0
    quantum: float = 1.0          # value quantization (uJ for energy, W)
    wrap_bits: int = 0            # cumulative counters wrap at 2**bits
    # declared wrap range in value units (e.g. RAPL max_energy_range_uj
    # scaled to J): set when the source DECLARES an arbitrary wrap
    # period instead of a power-of-two tick count.  Overrides
    # 2**wrap_bits * quantum; consumers must use ``wrap_period_j``.
    wrap_range_j: float = 0.0
    # stage 2: driver publication
    driver_refresh_s: float = 1e-3
    driver_jitter_s: float = 5e-5
    # systematic calibration effects
    scale: float = 1.0            # e.g. PM upstream factor
    offset_w: float = 0.0         # e.g. NIC rail share
    noise_w: float = 0.0          # gaussian read noise (power sensors)

    @property
    def is_cumulative(self) -> bool:
        return self.kind == "energy_cum"

    @property
    def wrap_period_j(self) -> float:
        """Counter wrap period in value units (0.0 = no wrap).

        The ingest-backend invariant: this is always DECLARED — either
        directly (``wrap_range_j``, e.g. RAPL's max_energy_range_uj)
        or as ticks x quantum (``2**wrap_bits * quantum``, e.g. the
        rocm-smi 64-bit accumulator) — never inferred from data.
        """
        if self.wrap_range_j > 0.0:
            return self.wrap_range_j
        if self.wrap_bits:
            return (2.0 ** self.wrap_bits) * self.quantum
        return 0.0


@dataclasses.dataclass(frozen=True)
class ToolSpec:
    """Stage 3: the instrumentation layer's sampling behaviour."""
    sample_interval_s: float = 1e-3
    sample_jitter_s: float = 2e-4       # per-read jitter (Score-P/PAPI cost)
    # per-sensor read cost; calibrated so 24 polled sensors stretch the
    # effective cadence to ~1.3 ms and the aliasing onset lands near the
    # paper's ~4 ms MI250X measurement (§V-A3)
    overhead_s_per_read: float = 1.2e-5
    drop_prob: float = 0.0              # occasional missed reads
    n_sensors_polled: int = 1           # polling many sensors widens t_read


# ---------------------------------------------------------------------------
# Sensor presets mirroring the paper's inventory (Tables I-IV), TPU-adapted.
# ---------------------------------------------------------------------------

def chip_energy_sensor(chip: int) -> SensorSpec:
    """On-chip cumulative energy counter — rocm-smi ``energy_count``
    analogue: 1 ms refresh, uJ quantum, wraps, no filtering."""
    return SensorSpec(
        name=f"chip{chip}_energy", scope="chip", kind="energy_cum",
        production_interval_s=1e-3, filter_kind="none",
        quantum=1e-6, wrap_bits=ENERGY_WRAP_BITS, driver_refresh_s=1e-3)


def chip_power_avg_sensor(chip: int, window_s: float = 1.5) -> SensorSpec:
    """On-chip averaged power — MI250X ``power_average`` analogue: the
    undocumented firmware moving average (paper measured multi-second
    settling; we model a 1.5 s MA window, blind-estimated by tests)."""
    return SensorSpec(
        name=f"chip{chip}_power_avg", scope="chip", kind="power_avg",
        production_interval_s=1e-3, filter_kind="ma",
        filter_window_s=window_s, quantum=1e-6, driver_refresh_s=1e-3)


def chip_power_inst_sensor(chip: int, tau_s: float = 0.5) -> SensorSpec:
    """MI300A ``current_socket_power`` analogue: lighter IIR smoothing
    (~0.5 s to settle idle->TDP per the paper), 1 ms cadence."""
    return SensorSpec(
        name=f"chip{chip}_power_inst", scope="chip", kind="power_inst",
        production_interval_s=1e-3, filter_kind="iir",
        filter_window_s=tau_s / 3.0,   # IIR tau; 10-90% rise ~ 2.2*tau
        quantum=1e-6, driver_refresh_s=1e-3)


def pm_chip_sensor(chip: int, on_nic_rail: bool) -> SensorSpec:
    """Tray PM per-accelerator counter — Cray PM ``accel[i]_power``
    analogue: 100 ms sysfs refresh, upstream of VRMs (+7%), NIC rail
    offset on chips 0/2 (paper App. B: +30 W)."""
    return SensorSpec(
        name=f"pm_accel{chip}_power", scope="tray", kind="power_inst",
        production_interval_s=100e-3, production_jitter_s=8e-3,
        filter_kind="iir", filter_window_s=20e-3, quantum=1.0,
        driver_refresh_s=100e-3, driver_jitter_s=5e-3,
        scale=PM_UPSTREAM_FACTOR,
        offset_w=NIC_W if on_nic_rail else 0.0, noise_w=0.5)


def pm_node_sensors() -> list:
    """Node-level PM counters (power + cpu + memory), 100 ms refresh."""
    out = []
    for nm, scope in (("pm_node_power", "node"), ("pm_cpu_power", "node"),
                      ("pm_memory_power", "node")):
        out.append(SensorSpec(
            name=nm, scope=scope, kind="power_inst",
            production_interval_s=100e-3, production_jitter_s=8e-3,
            filter_kind="iir", filter_window_s=20e-3, quantum=1.0,
            driver_refresh_s=100e-3, driver_jitter_s=5e-3,
            scale=PM_UPSTREAM_FACTOR, noise_w=1.0))
    return out


def pm_energy_sensor(chip: int, on_nic_rail: bool) -> SensorSpec:
    """Tray PM cumulative energy (J), 100 ms refresh."""
    return SensorSpec(
        name=f"pm_accel{chip}_energy", scope="tray", kind="energy_cum",
        production_interval_s=100e-3, production_jitter_s=8e-3,
        quantum=1.0, wrap_bits=0, driver_refresh_s=100e-3,
        scale=PM_UPSTREAM_FACTOR, offset_w=NIC_W if on_nic_rail else 0.0)


def default_node_sensors(chips_per_node: int = 4) -> list:
    """The full per-node sensor inventory (paper Fig. 9 analogue)."""
    sensors = []
    for c in range(chips_per_node):
        on_nic = c in (0, 2)
        sensors += [
            chip_energy_sensor(c),
            chip_power_avg_sensor(c),
            chip_power_inst_sensor(c),
            pm_chip_sensor(c, on_nic),
            pm_energy_sensor(c, on_nic),
        ]
    sensors += pm_node_sensors()
    return sensors


def expected_lag_s(sensor: SensorSpec, tool: ToolSpec) -> float:
    """First-order model of Δt = t_read − t_measured (uniform phases):
    half a production interval + half a driver refresh + half a tool
    interval + per-read overhead."""
    return (0.5 * sensor.production_interval_s
            + 0.5 * sensor.driver_refresh_s
            + 0.5 * tool.sample_interval_s
            + tool.overhead_s_per_read * tool.n_sensors_polled)
