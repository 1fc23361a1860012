"""Typed configuration for the streaming attribution entry points.

One frozen dataclass per concern replaces the ~22 keyword arguments
the streaming API had accreted:

  * :class:`StreamConfig` — chunking, output grid, dtype, engine and
    execution knobs;
  * :class:`TrackConfig` — the AlignTrack window geometry and EMA;
  * :class:`CheckpointConfig` — elastic carry checkpoints;
  * :class:`PipelineConfig` — the bundle, plus the existing
    ``HealthConfig`` and ``DataQualityPolicy`` objects.

Every entry point accepts ``config=`` (a :class:`PipelineConfig`, or
a single section which is auto-wrapped).  The legacy flat kwargs keep
working through :func:`resolve_config` — same defaults, same
semantics, bit-identical results — but emit a ``DeprecationWarning``
naming the replacement field.  Mixing ``config=`` with legacy kwargs
is an error: there is exactly one source of truth per call.

The port's copy of ``repro/fleet/config.py``.  The port's entry point
reads every field and raises ``NotImplementedError`` for the
Pallas-specific ``interpret``/``use_kernel`` knobs.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Chunking, output grid and execution engine."""
    chunk: int = 1024            # replay window width (columns)
    grid: object = None          # absolute output grid (pins parity)
    grid_step: float = None      # grid step (default: half cadence)
    dtype: object = np.float32   # device dtype for the packed rows
    engine: str = "windowed"     # "windowed" (oracle) | "scan" (fast)
    var_floor: float = 0.25      # fusion variance floor (W^2)
    use_t_measured: bool = True  # sensor timestamps vs read times
    interpret: bool = None       # Pallas interpret-mode override
    use_kernel: bool = None      # force/forbid the fused kernels
    host: bool = False           # host (numpy) execution


@dataclasses.dataclass(frozen=True)
class TrackConfig:
    """Online delay tracking (AlignTrack) geometry."""
    track: bool = None           # None = auto (track iff no delays)
    delays: object = None        # frozen per-row delays (seconds)
    window: int = 2048           # correlation window (grid samples)
    hop: int = 512               # re-estimation hop
    max_lag: int = 64            # search half-range (grid samples)
    ema: float = 0.5             # estimate smoothing factor
    tail: int = None             # carry tail (None = derived)


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Elastic carry checkpoints (windowed engine)."""
    dir: str = None              # checkpoint directory (None = off)
    every: int = 0               # checkpoint every K replay windows
    resume: bool = False         # reload the newest complete one


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The full streaming-pipeline configuration bundle."""
    stream: StreamConfig = StreamConfig()
    track: TrackConfig = TrackConfig()
    checkpoint: CheckpointConfig = CheckpointConfig()
    health: object = None        # health.HealthConfig | True | None
    dq: object = None            # pipeline.DataQualityPolicy | None


# legacy kwarg -> (section, field); section None = PipelineConfig root
LEGACY_FIELDS = {
    "chunk": ("stream", "chunk"),
    "grid": ("stream", "grid"),
    "grid_step": ("stream", "grid_step"),
    "dtype": ("stream", "dtype"),
    "engine": ("stream", "engine"),
    "var_floor": ("stream", "var_floor"),
    "use_t_measured": ("stream", "use_t_measured"),
    "interpret": ("stream", "interpret"),
    "use_kernel": ("stream", "use_kernel"),
    "host": ("stream", "host"),
    "track": ("track", "track"),
    "delays": ("track", "delays"),
    "window": ("track", "window"),
    "hop": ("track", "hop"),
    "max_lag": ("track", "max_lag"),
    "ema": ("track", "ema"),
    "tail": ("track", "tail"),
    "checkpoint_dir": ("checkpoint", "dir"),
    "checkpoint_every": ("checkpoint", "every"),
    "resume": ("checkpoint", "resume"),
    "health": (None, "health"),
    "dq_policy": (None, "dq"),
}


def _coerce(config) -> PipelineConfig:
    if config is None:
        return PipelineConfig()
    if isinstance(config, PipelineConfig):
        return config
    if isinstance(config, StreamConfig):
        return PipelineConfig(stream=config)
    if isinstance(config, TrackConfig):
        return PipelineConfig(track=config)
    if isinstance(config, CheckpointConfig):
        return PipelineConfig(checkpoint=config)
    raise TypeError(f"config must be a PipelineConfig (or one section),"
                    f" got {type(config).__name__}")


def resolve_config(config, legacy: dict, caller: str) -> PipelineConfig:
    """One PipelineConfig from ``config=`` or flat legacy kwargs.

    ``legacy`` holds the EXPLICITLY-passed flat kwargs (the entry
    point's ``**legacy`` catch-all, or sentinel-filtered named args).
    Unknown names raise TypeError like any bad kwarg; known ones emit
    a DeprecationWarning naming the replacement config field and are
    folded onto the defaults — so a legacy call resolves to exactly
    the PipelineConfig the equivalent ``config=`` call passes.
    """
    legacy = dict(legacy or {})
    unknown = sorted(set(legacy) - set(LEGACY_FIELDS))
    if unknown:
        raise TypeError(f"{caller}() got unexpected keyword argument(s)"
                        f" {', '.join(map(repr, unknown))}")
    if not legacy:
        return _coerce(config)
    if config is not None:
        raise TypeError(
            f"{caller}() got both config= and legacy keyword(s) "
            f"{sorted(legacy)}; pass one or the other")
    def _path(sec, fld):
        return f"PipelineConfig.{sec}.{fld}" if sec \
            else f"PipelineConfig.{fld}"

    hints = ", ".join(f"{k}= -> {_path(*LEGACY_FIELDS[k])}"
                      for k in sorted(legacy))
    warnings.warn(
        f"{caller}(): flat keyword arguments are deprecated; pass "
        f"config=PipelineConfig(...) instead ({hints})",
        DeprecationWarning, stacklevel=3)
    sections = {"stream": {}, "track": {}, "checkpoint": {}, None: {}}
    for k, v in legacy.items():
        sec, fld = LEGACY_FIELDS[k]
        sections[sec][fld] = v
    return PipelineConfig(
        stream=StreamConfig(**sections["stream"]),
        track=TrackConfig(**sections["track"]),
        checkpoint=CheckpointConfig(**sections["checkpoint"]),
        **sections[None])
