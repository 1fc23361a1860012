"""Real-sensor ingest (port of ``repro.ingest``): backends, priority
fallback, async pump.

The backend protocol (:class:`SensorBackend`) wraps each counter
source — rocm-smi / amd-smi subprocesses, RAPL ``/sys/class/powercap``
zones, hwmon channels, or the sensor-fabric simulator — behind
capability discovery and declared counter semantics (wrap range,
resolution).  :class:`PrioritizedIngest` stacks them with graceful
degradation; :class:`AsyncFleetIngest` pumps readers into the port's
streaming pipeline on the device; :func:`attribute_live` is the
end-to-end wire-up.  Everything above the pipeline is host Python.
"""
from repro_torch.ingest.async_ingest import (AsyncFleetIngest,
                                             SimulatedSMIReader)
from repro_torch.ingest.backend import (BackendError, MetricSpec,
                                        Reading, SensorBackend)
from repro_torch.ingest.hwmon import HwmonBackend
from repro_torch.ingest.live import (LiveResult, attribute_live,
                                     discover_backends)
from repro_torch.ingest.priority import (BackendReader, IngestPolicy,
                                         IngestUnavailable,
                                         PrioritizedIngest,
                                         default_backend_order)
from repro_torch.ingest.rapl import RaplBackend
from repro_torch.ingest.rocm import AmdSmiBackend, RocmSmiBackend
from repro_torch.ingest.sim import SimBackend

__all__ = [
    "AmdSmiBackend", "AsyncFleetIngest", "BackendError",
    "BackendReader", "HwmonBackend", "IngestPolicy",
    "IngestUnavailable", "LiveResult", "MetricSpec",
    "PrioritizedIngest", "RaplBackend", "Reading", "RocmSmiBackend",
    "SensorBackend", "SimBackend", "SimulatedSMIReader",
    "attribute_live", "default_backend_order", "discover_backends",
]
