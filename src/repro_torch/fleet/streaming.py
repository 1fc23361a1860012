"""Streaming, chunked per-phase energy accumulation on the device (port of
``repro/fleet/streaming.py``).

Two pre-built two-stage pipelines over the stage layer
(``fleet/pipeline.py``):

  StreamingPhaseAccumulator  reconstructed power chunks -> per-phase
                             energy: Ingest(maskfill) -> PhaseIntegrate
                             (``phase_integrate`` kernel)
  FleetStream                raw cumulative-counter chunks:
                             Ingest(sanitize) -> CounterAttribute
                             (``fleet_attribute`` kernel: dE/dt and
                             integration in one pass)

Each ``update`` sees one (fleet, chunk) window plus a one-column carry,
so device memory stays O(fleet x chunk + fleet x phases) however long
the run.  A duplicate read republishes the previous (t, E) pair: a
zero-width interval, exactly zero energy.  Reordered reads are repaired
by the Ingest stage on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import refuse_unported, resolve_device
from repro_torch.fleet.pipeline import (CounterAttributeStage, IngestStage,
                                        PhaseIntegrateStage, StreamPipeline,
                                        _torch_dtype)


def _as_device(times, values, valid, dtype, device):
    t = torch.as_tensor(times, dtype=dtype, device=device).contiguous()
    v = torch.as_tensor(values, dtype=dtype, device=device).contiguous()
    if valid is not None:
        valid = torch.as_tensor(valid, dtype=torch.bool, device=device)
    return t, v, valid


class StreamingPhaseAccumulator:
    """Online E[stream, phase] from chunked sample-and-hold power streams.

    Feed (times, watts[, valid]) chunks (numpy or tensors) of any width;
    the carry column closes the hold interval across the chunk boundary.
    ``device=None`` means CUDA.
    """

    def __init__(self, phases, n_streams: int, *, dtype=np.float32,
                 device=None, interpret=None, use_kernel=None):
        refuse_unported("StreamingPhaseAccumulator", interpret=interpret,
                        use_kernel=use_kernel)
        self.device = dev = resolve_device(device)
        self._dtype = _torch_dtype(dtype)
        self._integrate = PhaseIntegrateStage(phases, n_streams,
                                              dtype=dtype, device=dev)
        self._pipe = StreamPipeline(IngestStage(n_streams, mode="maskfill",
                                                device=dev),
                                    self._integrate)
        self.phases = self._integrate.phases
        self.n_phases = self._integrate.n_phases

    def update(self, times, watts, valid=None):
        self._pipe.update(*_as_device(times, watts, valid, self._dtype,
                                      self.device))
        return self

    def totals(self):
        """(n_streams, n_phases) accumulated joules (host numpy)."""
        return self._integrate.totals()


class FleetStream:
    """Online fleet attribution straight from cumulative-counter chunks.

    State per stream: the last (t, E) sample plus the (F, P) energy
    accumulator; reconstruction and integration run fused through the
    ``fleet_attribute`` kernel per chunk.  ``device=None`` means CUDA;
    ``mesh`` (None, the default, a ``Mesh`` or ``"auto"``) row-shards
    the kernel as ``CounterAttributeStage`` does.
    """

    def __init__(self, phases, n_streams: int, wrap_period=None, *,
                 dtype=np.float32, device=None, interpret=None,
                 use_kernel=None, mesh=None):
        refuse_unported("FleetStream", interpret=interpret,
                        use_kernel=use_kernel)
        self.device = dev = resolve_device(device)
        self._dtype = _torch_dtype(dtype)
        self._attr = CounterAttributeStage(phases, n_streams, wrap_period,
                                           dtype=dtype, device=dev,
                                           mesh=mesh)
        self.mesh = self._attr.mesh
        self._pipe = StreamPipeline(IngestStage(n_streams, mode="sanitize",
                                                device=dev),
                                    self._attr)
        self.phases = self._attr.phases
        self.n_phases = self._attr.n_phases

    def reset(self):
        """Zero the accumulator and the carry for a fresh run."""
        self._pipe.reset()
        return self

    def update(self, times, energy, valid=None):
        self._pipe.update(*_as_device(times, energy, valid, self._dtype,
                                      self.device))
        return self

    def totals(self):
        """(n_streams, n_phases) accumulated joules (host numpy)."""
        return self._attr.totals()
