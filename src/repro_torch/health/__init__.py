"""Fleet health on the device path (port of ``repro.health``): typed
events and the per-sensor state codes (``events``), the streaming
diagnostics stage with its deterministic quarantine mask (``stage``),
and the pull-based metrics registry with Prometheus/JSON export
(``registry``)."""
from repro_torch.health.events import (            # noqa: F401
    HEALTHY, SUSPECT, QUARANTINED, RECOVERING, STATE_NAMES,
    HealthEvent, write_events_jsonl)
from repro_torch.health.stage import (             # noqa: F401
    N_STATS, HealthConfig, SensorHealthStage)
from repro_torch.health.registry import (          # noqa: F401
    HealthRegistry, Metric)
