"""Ragged-trace packing (port of ``repro/fleet/packing.py``: packing,
``unpack_series`` and the multi-host shard types ``HostShard``,
``assign_groups`` and ``shard_from_assignment``).

Host-side numpy: a straight memcpy of the traces into padded
(fleet, samples) arrays, identical to the reference's bytes, so both
packages hand their pipelines the same float32 rows.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.reconstruction import PowerSeries, unwrap_counter

# the fleet row tile: rows are padded to a multiple of this, and the
# delay tracker pins its xcorr row tile to it (a row's score must not
# depend on how many rows are scored together)
ROW_ALIGN = 8


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass
class PackedFleet:
    """Padded fleet of sensor streams + per-row metadata.

    energy/times: (F, S) with F a multiple of ROW_ALIGN; rows beyond
    ``n_traces`` are all-padding, and each row's tail replicates its last
    sample.  Counters are unwrapped in float64 and rebased (energy by the
    row's first sample, time by one fleet-wide ``t0``) before the cast,
    so ``wrap_period`` is 0 for every packed row.
    """
    energy: np.ndarray        # (F, S) cumulative J, rebased per row
    times: np.ndarray         # (F, S) t_measured (or t_read), minus t0
    n_samples: np.ndarray     # (F,) raw length per row
    wrap_period: np.ndarray   # (F,) float
    names: list               # len n_traces
    n_traces: int
    t0: float = 0.0           # fleet-wide time origin
    e0: np.ndarray = None     # (F,) per-row energy baselines (float64)

    @property
    def shape(self):
        return self.energy.shape

    @property
    def valid(self):
        """(F, S) bool: slot j of row i is one of its raw reads."""
        return np.arange(self.shape[1])[None, :] < self.n_samples[:, None]


@dataclasses.dataclass(frozen=True)
class HostShard:
    """One host's slice of a multi-host fleet, in GLOBAL coordinates.

    The fleet is split by DEVICE GROUP (all sensors observing one device
    stay together), so every group's fusion statistics, coverage
    patterns and phase integrals are computed entirely on its owning
    host and the end-of-run merge is pure placement.  Each host packs
    ONLY its own sensors; the global ids place its rows back into the
    fleet-wide result.
    """
    host: int                   # this process's index
    n_hosts: int
    global_group_sizes: tuple   # sensors per device, EVERY device
    group_ids: tuple            # global device indices owned by this host

    def __post_init__(self):
        if not 0 <= self.host < self.n_hosts:
            raise ValueError(f"host {self.host} outside [0, "
                             f"{self.n_hosts})")
        if len(self.group_ids) == 0:
            raise ValueError(
                f"host {self.host} owns no device groups "
                f"({self.n_hosts} hosts over "
                f"{len(self.global_group_sizes)} groups) — use fewer hosts")

    @property
    def local_group_sizes(self) -> list:
        return [self.global_group_sizes[g] for g in self.group_ids]

    @property
    def n_local_streams(self) -> int:
        return int(sum(self.local_group_sizes))

    @property
    def row_offsets(self) -> np.ndarray:
        """(n_groups + 1,) global row offset of every device group."""
        return np.concatenate(
            [[0], np.cumsum(self.global_group_sizes)]).astype(np.int64)

    @property
    def row_ids(self) -> np.ndarray:
        """(n_local_streams,) global row index of every local row."""
        off = self.row_offsets
        return np.concatenate(
            [np.arange(off[g], off[g + 1]) for g in self.group_ids])

    def take_rows(self, per_row):
        """Select this host's rows from a fleet-wide per-row array."""
        return np.asarray(per_row)[self.row_ids]


def assign_groups(group_sizes, n_hosts: int, host: int) -> HostShard:
    """Contiguous balanced device-group assignment (the default split):
    ``np.array_split`` over group indices, so the first
    ``n_groups % n_hosts`` hosts take one extra group; raises when a
    host would own nothing."""
    sizes = tuple(int(s) for s in group_sizes)
    ids = np.array_split(np.arange(len(sizes)), n_hosts)[host]
    return HostShard(host=host, n_hosts=n_hosts,
                     global_group_sizes=sizes,
                     group_ids=tuple(int(g) for g in ids))


def shard_from_assignment(group_sizes, assignment, host: int,
                          n_hosts: int = None) -> HostShard:
    """HostShard for an ARBITRARY host<-group map (``assignment[g]`` is
    the owning host of group g)."""
    a = np.asarray(assignment, np.int64)
    if n_hosts is None:
        n_hosts = int(a.max()) + 1
    return HostShard(host=host, n_hosts=n_hosts,
                     global_group_sizes=tuple(int(s) for s in group_sizes),
                     group_ids=tuple(int(g)
                                     for g in np.nonzero(a == host)[0]))


def pack_traces(traces, *, use_t_measured: bool = True,
                dtype=np.float32, min_samples: int = 2,
                t0: float = None) -> PackedFleet:
    """Pack ragged SensorTraces into a padded (fleet, samples) block.

    ``t0`` pins the shared time origin (default: the earliest sample of
    THESE traces).
    """
    traces = list(traces)
    assert traces, "pack_traces needs at least one trace"
    n = len(traces)
    f = _round_up(n, ROW_ALIGN)
    s = max(max(len(tr) for tr in traces), min_samples)
    energy = np.zeros((f, s), dtype)
    times = np.zeros((f, s), dtype)
    n_samples = np.zeros((f,), np.int32)
    wrap = np.zeros((f,), dtype)
    e0 = np.zeros((f,), np.float64)
    names = []
    if t0 is None:
        t0 = min(float((tr.t_measured if use_t_measured
                        else tr.t_read)[0]) for tr in traces)
    for i, tr in enumerate(traces):
        k = len(tr)
        t = (tr.t_measured if use_t_measured else tr.t_read)
        v = tr.value
        if tr.spec.wrap_period_j:
            v = unwrap_counter(v, period=tr.spec.wrap_period_j)
        e0[i] = v[0]
        energy[i, :k] = v - e0[i]
        times[i, :k] = t - t0
        if k < s:
            # tail: replicate the last sample (zero-width intervals)
            energy[i, k:] = energy[i, k - 1]
            times[i, k:] = times[i, k - 1]
        n_samples[i] = k
        names.append(tr.name)
    return PackedFleet(energy, times, n_samples, wrap, names, n,
                       t0=t0, e0=e0)


def unpack_series(packed: PackedFleet, power, times, valid_out):
    """Fleet reconstruction output -> per-trace host ``PowerSeries`` list.

    ``power/times/valid_out`` are the (F, S) results of
    ``fleet_reconstruct`` (tensors on any device, or numpy); rows beyond
    ``packed.n_traces`` are ignored.
    """
    power, times, valid_out = (
        a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
        for a in (power, times, valid_out))
    out = []
    for i in range(packed.n_traces):
        m = valid_out[i]
        out.append(PowerSeries(times[i][m].astype(np.float64) + packed.t0,
                               power[i][m].astype(np.float64),
                               source=packed.names[i]))
    return out
