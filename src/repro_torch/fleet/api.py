"""Trace-level fleet entry points on the device (port of
``repro/fleet/api.py``).

``fleet_power_series`` is the batched dE/dt of many cumulative-energy
traces (``power_reconstruct_fleet``); ``attribute_energy_fleet`` their
per-phase energy in streamed chunks (``FleetStream``, the
``fleet_attribute`` kernel); ``attribute_energy_fused`` the per-phase
energy of each device's fused cross-sensor stream, by the batch path or
(``streaming=True``) the windowed pipeline.  Every entry point runs on
``device`` (None means CUDA).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.calibration import apply_corrections
from repro_torch.device import refuse_unported, resolve_device
from repro_torch.fleet.packing import pack_traces, unpack_series
from repro_torch.fleet.reconstruct import fleet_reconstruct
from repro_torch.fleet.streaming import FleetStream


def _counters_only(traces):
    for tr in traces:
        if not tr.spec.is_cumulative:
            raise ValueError(f"{tr.name} is not an energy counter (fleet "
                             f"dE/dt path)")


def fleet_power_series(traces, *, use_t_measured: bool = True,
                       interpret=None, use_kernel=None, corrections=None,
                       dtype=np.float32, device=None):
    """Batched dE/dt for many cumulative-energy traces -> [PowerSeries].

    One pack on the host and one fused kernel launch, any trace count
    and lengths.  ``corrections`` (``core.calibration``) apply to each
    trace on the host before packing.  ``interpret=True`` and
    ``use_kernel=False`` are not ported.
    """
    refuse_unported("fleet_power_series", interpret=interpret,
                    use_kernel=use_kernel)
    traces = [apply_corrections(tr, corrections) for tr in traces]
    _counters_only(traces)
    packed = pack_traces(traces, use_t_measured=use_t_measured, dtype=dtype)
    power, times, valid = fleet_reconstruct(packed, device=device)
    return unpack_series(packed, power, times, valid)


def attribute_energy_fleet(traces, phases, *, corrections=None,
                           chunk: int = 1024, interpret=None,
                           use_kernel=None, dtype=np.float32, device=None):
    """Per-phase energy for many cumulative traces in streamed chunks.

    phases: [(name, t_start, t_end)] absolute seconds.  Returns one
    ``[PhaseEnergy]`` list per trace.  ``corrections`` apply to each
    trace on the host before packing.  The packed block is uploaded once
    and fed to ``FleetStream`` in ``chunk``-column windows.
    """
    from repro_torch.core.attribution import PhaseEnergy
    refuse_unported("attribute_energy_fleet", interpret=interpret,
                    use_kernel=use_kernel)
    traces = [apply_corrections(tr, corrections) for tr in traces]
    dev = resolve_device(device)
    if not phases:
        return [[] for _ in traces]
    _counters_only(traces)
    packed = pack_traces(traces, dtype=dtype)
    # packed times are rebased to the fleet origin; shift windows to match
    windows = [(a - packed.t0, b - packed.t0) for _, a, b in phases]
    stream = FleetStream(windows, packed.shape[0],
                         wrap_period=packed.wrap_period, dtype=dtype,
                         device=dev)
    times = torch.as_tensor(packed.times, device=dev)
    energy = torch.as_tensor(packed.energy, device=dev)
    s = packed.shape[1]
    for lo in range(0, s, chunk):
        hi = min(lo + chunk, s)
        stream.update(times[:, lo:hi], energy[:, lo:hi])
    totals = stream.totals()
    out = []
    for i in range(packed.n_traces):
        row = []
        for (name, a, b), e in zip(phases, totals[i]):
            dur = max(b - a, 1e-12)
            row.append(PhaseEnergy(name, a, b, float(e), float(e / dur)))
        out.append(row)
    return out


def attribute_energy_fused(trace_groups, phases, *, streaming=False,
                           config=None, device=None, collectives=None,
                           shard=None, **kw):
    """Per-phase energy on the FUSED cross-sensor stream of each device.

    trace_groups: [[SensorTrace, ...], ...], all sensors observing one
    device per group.  The batch path (``repro_torch.align``) estimates
    per-sensor delays, regrids onto one timeline and inverse-variance
    fuses before integrating; see ``align.align_and_fuse`` for its
    keywords.  ``streaming=True`` runs the windowed pipeline
    (``fleet.pipeline.attribute_energy_fused_streaming``) with its own
    ``config=``; given the batch run's grid and fixed delays the two agree
    to <= 1e-5.  Multi-host ``collectives``/``shard`` are not ported.
    Returns one ``[PhaseEnergy]`` per group.
    """
    refuse_unported("attribute_energy_fused", collectives=collectives,
                    shard=shard)
    if streaming:
        from repro_torch.fleet.pipeline import (
            attribute_energy_fused_streaming)
        return attribute_energy_fused_streaming(
            trace_groups, phases, config=config, device=device, **kw)
    if config is not None:
        raise TypeError("config= drives the streaming pipeline — pass "
                        "streaming=True (the batch align path keeps its "
                        "own keyword surface)")
    from repro_torch.align.fusion import attribute_energy_fused as _fused
    return _fused(trace_groups, phases, device=device, **kw)
