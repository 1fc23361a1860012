"""Serving: the continuous-batching engine, its fixed-batch baseline,
Poisson load generation and the per-request energy report types (port
of ``repro.serve``)."""
from repro_torch.serve.engine import (                 # noqa: F401
    FixedBatchEngine, Request, ServeEngine)
from repro_torch.serve.loadgen import poisson_requests  # noqa: F401
from repro_torch.serve.metering import (               # noqa: F401
    METER_LOG_ENV, RequestEnergy, RequestEnergyReport,
    RollingPercentiles)
