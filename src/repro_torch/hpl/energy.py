"""Mixed-precision energy accounting over simulated fleets (§V-B; port of
``repro/hpl/energy.py``).

Synthesizes the node sensor fabric over a traced HPL/HPG timeline (host
numpy, seeded as the reference seeds it) and attributes per-phase
energy — for ONE node (``energize``, the host parity path) or for MANY
nodes at once on the device: ``fleet_energize`` on each node's chip0
energy counter (``fleet.attribute_energy_fleet``),
``fused_fleet_energize`` on each node's fused chip0 sensor group (the
batch align path, or the windowed pipeline with ``streaming=True``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.attribution import (attribute_energy,
                                          attribute_energy_many,
                                          split_energy_savings)
from repro_torch.core.calibration import nic_rail_corrections
from repro_torch.core.measurement_model import CHIP_IDLE_W, ToolSpec
from repro_torch.core.power_model import occupancy_power, phase_power
from repro_torch.core.sensors import NodeFabric
from repro_torch.core.tracing import RegionTracer
from repro_torch.device import refuse_unported, resolve_device

_UNSET = object()      # legacy-kwarg sentinel (see fleet.config)

# phase -> roofline occupancy (compute, memory, collective)
OCC = {
    "hpl_factorize": (1.0, 0.45, 0.1), "mxp_factorize": (1.0, 0.5, 0.1),
    "hpl_solve": (0.3, 1.0, 0.0), "mxp_refine": (0.3, 1.0, 0.0),
    "hpl_verify": (0.5, 1.0, 0.0),
    "hpg_setup": (0.0, 0.5, 0.0), "hpg_krylov": (0.25, 1.0, 0.1),
    "hpg_finalize": (0.1, 0.8, 0.0),
}


def phases_and_truth(tracer: RegionTracer, *, lead: float = 0.05):
    """Traced phases -> (shifted phases, per-chip ground-truth power)."""
    phases = tracer.phases(depth=0)
    shifted = [(n, a + lead, b + lead) for n, a, b in phases]
    watts = {n: {"watts": occupancy_power(*OCC.get(n, (0, 0.1, 0)))}
             for n, _, _ in shifted}
    truth = phase_power([("__lead__", 0.0, lead)] + shifted,
                        {**watts, "__lead__": {"watts": CHIP_IDLE_W}})
    return shifted, truth


def energize(tracer: RegionTracer, n_chips=4, seed=0, *, device=None):
    """One node, host path: synthesize the fabric and attribute chip0.

    The attribution is the per-trace host numpy path, the parity oracle
    of ``fleet_energize``; ``device`` (None means CUDA) is resolved like
    every entry point's, so a run without a card fails here too unless it
    asks for the CPU."""
    resolve_device(device)
    shifted, truth = phases_and_truth(tracer)
    fabric = NodeFabric(chip_truths=[truth] * n_chips)
    traces = fabric.sample_all(ToolSpec(), seed=seed)
    return attribute_energy(traces["chip0_energy"], shifted)


def fleet_energize(tracer: RegionTracer, n_nodes, *, n_chips=4, seed0=0,
                   use_fleet=True, chunk=2048, device=None):
    """Per-node phase energies for a whole fleet in one batched pipeline.

    Simulates ``n_nodes`` sensor fabrics over the traced timeline and
    attributes every node's chip0 energy counter together on ``device``
    (None means CUDA) — the batched replacement for ``[energize(tracer,
    seed=k) for k in range(n_nodes)]``, which stays the parity oracle
    (``use_fleet=False``).  Returns one [PhaseEnergy] per node.
    """
    dev = resolve_device(device)
    shifted, truth = phases_and_truth(tracer)
    traces = []
    for node in range(n_nodes):
        # node_id stays 0 so the per-sensor RNG stream is exactly the
        # oracle's (sample_all seeds with seed*1000003 + node_id)
        fabric = NodeFabric(chip_truths=[truth] * n_chips)
        traces.append(fabric.sample_all(
            ToolSpec(), seed=seed0 + node)["chip0_energy"])
    return attribute_energy_many(traces, shifted, use_fleet=use_fleet,
                                 chunk=chunk, device=dev)


def fused_fleet_energize(tracer: RegionTracer, n_nodes, *, n_chips=4,
                         seed0=0, sensors_per_chip=3, config=None,
                         interpret=_UNSET, streaming=False,
                         track=_UNSET, chunk=_UNSET, shard=None,
                         collectives=None, engine=_UNSET, device=None):
    """Per-node phase energies from FUSED cross-sensor streams.

    Where ``fleet_energize`` trusts chip0's energy counter alone, this
    aligns and inverse-variance-fuses chip0's whole sensor group per node
    (on-chip counter + on-chip filtered power + off-chip PM, NIC offsets
    and upstream slope calibrated out with ``nic_rail_corrections``) in
    ONE batched call across all nodes on ``device`` (None means CUDA),
    then attributes on the fused power.  ``streaming=True`` runs the same
    accounting through the windowed pipeline (``fleet.pipeline``) with
    its ``config``; the flat ``chunk``/``track``/``engine``/``interpret``
    kwargs resolve as in the reference (deprecated).  Multi-host
    ``shard``/``collectives`` are not ported.  Returns one [PhaseEnergy]
    per node.
    """
    refuse_unported("fused_fleet_energize", shard=shard,
                    collectives=collectives)
    from repro_torch.fleet.config import resolve_config
    dev = resolve_device(device)
    legacy = {k: v for k, v in dict(track=track, chunk=chunk,
                                    engine=engine,
                                    interpret=interpret).items()
              if v is not _UNSET}
    shifted, truth = phases_and_truth(tracer)
    # default 3: on-chip counter + on-chip power + off-chip PM — one
    # stream per scope (the two pm_accel0 views of the same tray PM only
    # join at sensors_per_chip >= 4, to avoid double-weighting the
    # off-chip scope)
    wanted = ["chip0_energy", "chip0_power_inst", "pm_accel0_power",
              "pm_accel0_energy", "chip0_power_avg"][:max(sensors_per_chip,
                                                          1)]
    groups = []
    for node in range(n_nodes):
        fabric = NodeFabric(chip_truths=[truth] * n_chips)
        traces = fabric.sample_all(ToolSpec(), seed=seed0 + node)
        groups.append([traces[n] for n in wanted])
    if streaming:
        from repro_torch.fleet.pipeline import (
            attribute_energy_fused_streaming)
        return attribute_energy_fused_streaming(
            groups, shifted, reference=truth,
            corrections=nic_rail_corrections(),
            config=resolve_config(config, legacy, "fused_fleet_energize"),
            device=dev)
    if config is not None:
        raise TypeError("config= drives the streaming pipeline — pass "
                        "streaming=True")
    from repro_torch.align.fusion import attribute_energy_fused
    return attribute_energy_fused(groups, shifted, reference=truth,
                                  corrections=nic_rail_corrections(),
                                  interpret=legacy.get("interpret"),
                                  device=dev)


def mxp_energy_report(full_tracer: RegionTracer, mxp_tracer: RegionTracer,
                      n_nodes, *, use_fleet=True, use_fused=False,
                      device=None) -> dict:
    """§V-B2 table: fleet-wide full- vs mixed-precision energy accounting.

    Attributes both runs across ``n_nodes`` simulated nodes through the
    fleet path on ``device`` (None means CUDA) and decomposes the saving
    into time-to-solution vs power.  ``use_fused=True`` accounts on
    cross-sensor fused streams (``fused_fleet_energize``) instead of the
    single chip0 counter.
    """
    if use_fused:
        pe_full = fused_fleet_energize(full_tracer, n_nodes, device=device)
        pe_mxp = fused_fleet_energize(mxp_tracer, n_nodes, device=device)
    else:
        pe_full = fleet_energize(full_tracer, n_nodes, use_fleet=use_fleet,
                                 device=device)
        pe_mxp = fleet_energize(mxp_tracer, n_nodes, use_fleet=use_fleet,
                                device=device)
    return savings_report(pe_full, pe_mxp)


def savings_report(pe_full, pe_mxp) -> dict:
    """``mxp_energy_report``'s table from the two runs' per-node phase
    energies: mean and spread of the node totals, the saving, and node
    0's time-vs-power decomposition."""
    e_full = [sum(p.energy_j for p in row) for row in pe_full]
    e_mxp = [sum(p.energy_j for p in row) for row in pe_mxp]
    dec = split_energy_savings(pe_full[0], pe_mxp[0])
    return {
        "full_j": (float(np.mean(e_full)), float(np.std(e_full))),
        "mxp_j": (float(np.mean(e_mxp)), float(np.std(e_mxp))),
        "saving": 1.0 - float(np.mean(e_mxp)) / float(np.mean(e_full)),
        "decomposition": dec,
        "per_node_full_j": e_full, "per_node_mxp_j": e_mxp,
    }
