"""Worker functions that ``tests/test_torch_multihost.py`` spawns through
``repro_torch.distributed.multihost.run_multihost``.

A spawned worker imports the module of its function; this one imports
the port only (nothing of JAX or the reference), so a worker's imports
are the port's, and each worker simulates its own groups from the seed,
as a real host reads only its own sensors.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

SPAN_S = 1.6
CHUNK = 257


def sim_groups(n_devices: int, seed: int = 0, span_s: float = SPAN_S):
    """The multihost tests' fleet (``tests/multihost/simdata.py``'s
    recipe) through the port's own simulator: per device a wrapping
    energy counter and a noisy power sensor with distinct delays."""
    from repro_torch.core import (SensorSpec, ToolSpec, simulate_sensor,
                                  square_wave)
    truth = square_wave(span_s / 4.0, 3, lead_s=span_s / 8,
                        tail_s=span_s / 8)
    tool = ToolSpec(0.9e-3)
    groups, delays = [], []
    for d in range(n_devices):
        specs = [
            SensorSpec(name=f"d{d}_energy", scope="chip",
                       kind="energy_cum", quantum=1e-6, wrap_bits=26,
                       delay_s=0.004 * (d % 5)),
            SensorSpec(name=f"d{d}_power", scope="chip",
                       kind="power_inst", noise_w=3.0, quantum=1e-6,
                       delay_s=0.011 + 0.003 * (d % 3)),
        ]
        groups.append([simulate_sensor(sp, tool, truth,
                                       seed=seed + 31 * d + i)
                       for i, sp in enumerate(specs)])
        delays += [sp.delay_s for sp in specs]
    return truth, groups, np.asarray(delays, np.float64)


def attribute(coll, n_devices: int, assignment=None, track=False):
    """One host's share of the fleet through the multi-host entry on the
    CPU -> (fleet energies, fleet delays or None)."""
    from repro_torch.distributed.multihost import (
        attribute_energy_fused_multihost)
    from repro_torch.fleet import (PipelineConfig, StreamConfig,
                                   TrackConfig, assign_groups,
                                   shard_from_assignment)
    truth, groups, delays = sim_groups(n_devices)
    sizes = [len(g) for g in groups]
    sh = (assign_groups(sizes, coll.num_processes, coll.process_id)
          if assignment is None else
          shard_from_assignment(sizes, assignment, coll.process_id,
                                coll.num_processes))
    t = TrackConfig(track=True, window=512, hop=128) if track else \
        TrackConfig(track=False, delays=sh.take_rows(delays))
    res, pipe = attribute_energy_fused_multihost(
        [groups[g] for g in sh.group_ids], phases_of(truth), shard=sh,
        collectives=coll, reference=truth if track else None,
        config=PipelineConfig(stream=StreamConfig(chunk=CHUNK), track=t),
        return_pipe=True, device="cpu")
    return (np.array([[p.energy_j for p in row] for row in res]),
            pipe.fleet_delays())


def phases_of(truth, n: int = 4):
    edges = np.linspace(truth.t0 + 0.02, truth.t1 - 0.02, n + 1)
    return [(f"p{k}", float(a), float(b))
            for k, (a, b) in enumerate(zip(edges[:-1], edges[1:]))]


def collectives_roundtrip(coll):
    """Every collective once -> what this host saw."""
    pid, n = coll.process_id, coll.num_processes
    vec = np.zeros((2 * n,))
    vec[2 * pid:2 * pid + 2] = [pid + 0.25, -(pid + 0.5)]
    framed = coll.allreduce_framed(float(pid), vec, scalar_op="max")
    coll.barrier()
    return (coll.allgather_bytes(bytes([pid])), coll.allreduce_min(pid),
            coll.allreduce_max(pid), coll.allreduce_sum(pid + 0.5),
            framed, coll.wire_stats.frames)


def leaked_imports(coll):
    """A small multi-host run, then the modules of JAX or the reference
    this worker holds (none expected)."""
    attribute(coll, 3)
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def raise_on_1(coll):
    assert coll.process_id != 1, "boom-on-proc-1"
    coll.barrier()
    return "ok"


def exit_3_on_0(coll):
    if coll.process_id == 0:
        os._exit(3)
    coll.barrier()
    return "survived"


def hang(coll):
    time.sleep(600)
