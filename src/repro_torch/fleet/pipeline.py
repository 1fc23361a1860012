"""The windowed streaming stage pipeline on the device (port of
``repro/fleet/pipeline.py``, the windowed engine).

    Ingest -> Reconstruct -> AlignTrack -> Regrid/Fuse -> PhaseAttribute

Every stage consumes one fixed-width (fleet, chunk) window plus its carry
dataclass, exactly as in the reference; here the windows and carries are
torch tensors that stay on one device between stages:

  Ingest       reorder/duplicate repair with its dq counters, branch-free
               (the reference's "nothing to repair" shortcut becomes a
               device-side select, so no host round trip decides it).
  Reconstruct  per-row wrap-corrected dE/dt: ``power_reconstruct_rows``.
  AlignTrack   online delay tracking: a uniform-grid ring filled through
               ``grid_resample``, scored by ``xcorr_align`` every ``hop``
               slots, float64 EMA on the device.
  Regrid/Fuse  delay-corrected ``grid_resample`` behind the emit frontier
               + the inverse-variance sufficient statistics, over a
               padded (devices, k_max, slots) layout (no per-device loop).
  PhaseAttr    per-(device, coverage pattern, phase, stream) float64
               integrals in a dense (D, 2**k_max, P, k_max) accumulator,
               finalized with the end-of-run weights.

The two-stage fleet streams (``fleet.streaming``) chain Ingest with
``PhaseIntegrateStage`` (``phase_integrate``) or ``CounterAttributeStage``
(``fleet_attribute``).

Optional stages and policies, as in the reference:
  Health       ``health.SensorHealthStage`` between Regrid/Fuse and
               PhaseAttr: per-window sensor statistics on the device,
               folded on the host once per update; its quarantine mask
               gates the fusion statistics and the attribution masks.
  Metering     ``MeteringStage``: the fused accumulator over a serve
               engine's ``SlotSegment`` schedule, split per request.
  Data quality ``DataQualityPolicy``: ingest late/dropped raise modes and
               the emitted-window coverage flag or raise.

Host round trips per window: the two emit/fill frontiers (one scalar
each) and the two tail-reach checks (one bool each); with health, one
(N_STATS, n) block at the fold; a raising data-quality policy reads one
bool per condition it checks.  Float64 sums fold over fixed axes: no
atomics, so results are deterministic.

Multi-host (``collectives`` + ``shard``, driven by
``distributed.multihost.attribute_energy_fused_multihost``): each host
runs the chain over its own device groups; the tracker's ring origin and
fill frontier and Regrid/Fuse's emit frontier are all-reduced, each hop's
(lag, weight) pairs and the health block ride the frontier's one framed
reduce a window, and PhaseAttr merges the fleet's carries at the end.
Every float sum inside a stage adds in an order fixed by the reduced
length alone (``core.reduce``), never by how many rows or
groups a host holds, so results are bit-identical for any process count
and host<-group assignment.

Checkpoints: ``StreamingFusedPipeline.checkpoint``/``restore`` write
and read the reference's on-disk layout (``train.checkpoint``), so a
run killed in either package resumes in the other; keyed by global
group, they restore under any process count.  ``host=True`` runs the
reference's float64 mirror on the CPU; the scan engine
(``engine="scan"``) is ``fleet.scan``.  Calibration ``corrections``
apply per trace on the host before packing (``pack_stream_rows``).
"""
from __future__ import annotations

import dataclasses
import pickle
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.align.delay import (RefbankCache, estimate_delays,
                                     estimate_delays_host,
                                     stream_reference)
from repro_torch.core.calibration import apply_corrections
from repro_torch.core.reduce import fixed_sum, fold_sum
from repro_torch.device import resolve_device
from repro_torch.fleet.config import resolve_config
from repro_torch.fleet.packing import ROW_ALIGN, _round_up, pack_traces
from repro_torch.kernels.fleet_attribute.kernel import fleet_attribute_kernel
from repro_torch.kernels.grid_resample.ops import grid_resample
from repro_torch.kernels.grid_resample.ref import grid_resample_ref
from repro_torch.kernels.phase_integrate.kernel import phase_integrate_kernel
from repro_torch.kernels.power_reconstruct.kernel import (
    power_reconstruct_rows_kernel)
from repro_torch.kernels.power_reconstruct.ref import (
    reconstruct_power_rows_ref)

PHASE_ALIGN = 32
# the fused accumulator is dense over coverage patterns: 2**k_max slots
MAX_GROUP = 8

_F64 = torch.float64


def pad_phases(phases, dtype=np.float32):
    """(P, 2) [a, b) windows -> array padded to the PHASE_ALIGN tile with
    zero-width windows (which integrate to exactly zero energy)."""
    ph = np.asarray(phases, dtype).reshape(-1, 2)
    p = len(ph)
    if p == 0:
        raise ValueError("streaming attribution needs at least one phase "
                         "window (got an empty phase list)")
    pad = (-p) % PHASE_ALIGN
    if pad:
        ph = np.concatenate([ph, np.zeros((pad, 2), dtype)])
    return ph


class DataQualityError(ValueError):
    """A per-stage data-quality policy rejected this window."""


@dataclasses.dataclass(frozen=True)
class DataQualityPolicy:
    """Per-stage late/reordered/dropped-sample handling.

    Production sensor streams deliver reordered reads (``late``) and
    masked/dropped slots (``dropped``); the grid emit can leave streams
    with thin coverage (``min_coverage``, the per-row covered-slot
    fraction of an emitted window).  Every policy defaults to repair and
    keep counting, so a policy-less pipeline is unchanged; ``"raise"``
    turns the corresponding condition into a :class:`DataQualityError`
    at the window that violates it.  The counters and per-window flags
    surface through the ``data_quality`` ``HealthRegistry`` source
    whether or not a policy is attached.
    """
    late: str = "repair"           # "repair" | "raise"
    dropped: str = "repair"        # "repair" | "raise"
    min_coverage: float = 0.0      # emitted-window covered-slot floor
    coverage: str = "flag"         # "flag" | "raise"

    def __post_init__(self):
        assert self.late in ("repair", "raise"), self.late
        assert self.dropped in ("repair", "raise"), self.dropped
        assert self.coverage in ("flag", "raise"), self.coverage
        assert 0.0 <= self.min_coverage <= 1.0, self.min_coverage


def _first_row(flags: torch.Tensor):
    """Index of the first True of a (rows,) device bool, or None: one
    bool and, only when one is set, one index come back to the host."""
    if not bool(flags.any()):
        return None
    return int(torch.argmax(flags.to(torch.uint8)))


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


def _host_device(device, host: bool) -> torch.device:
    """The device a stage runs on: ``host=True`` (the float64 mirror) is
    the caller asking for the host, so None means the CPU there and a
    CUDA device is refused; otherwise ``resolve_device``."""
    if not host:
        return resolve_device(device)
    if device is not None and torch.device(device).type != "cpu":
        raise ValueError(f"host=True runs the float64 mirror on the CPU; "
                         f"got device={device!r}")
    return torch.device("cpu")


def sanitize_chunk(times, energy, valid=None, carry_t=None, carry_e=None,
                   return_counts: bool = False):
    """Make each row's hold edges non-decreasing (device, branch-free).

    Keeps a sample iff its timestamp strictly exceeds the running max of
    everything valid before it, the previous chunk's carry included;
    dropped samples (reordered reads, masked slots) are replaced by the
    last kept (t, E), so they become zero-width.  When nothing in the
    whole chunk needs repair (all valid, no decrease, nothing behind the
    carry) the input is returned unchanged, exactly as the reference's
    shortcut does — selected on the device instead of branched on.

    ``return_counts=True`` also returns ``{"late", "masked"}`` (F,) int64
    tallies: valid samples repaired because their time had already been
    passed (equal-time duplicates are not counted), and invalid slots.
    """
    t, e = times, energy
    f, c = t.shape
    dev = t.device
    ninf = torch.tensor(-torch.inf, dtype=t.dtype, device=dev)
    vm = (torch.ones((f, c), dtype=torch.bool, device=dev) if valid is None
          else valid.to(torch.bool))
    lead = (torch.full((f, 1), -torch.inf, dtype=t.dtype, device=dev)
            if carry_t is None else carry_t.to(t.dtype))
    tv = torch.where(vm, t, ninf)
    run_max = torch.cummax(torch.cat([lead, tv], dim=1), dim=1).values
    prev_max = run_max[:, :-1]
    keep = tv > prev_max
    idx = torch.arange(c, device=dev).expand(f, c)
    last = torch.cummax(torch.where(keep, idx, -1), dim=1).values
    src = last.clamp_min(0)
    t_eff = torch.gather(t, 1, src)
    e_eff = torch.gather(e, 1, src)
    no_prev = last < 0                   # before the chunk's first kept
    if carry_t is not None:
        t_eff = torch.where(no_prev, carry_t.to(t.dtype), t_eff)
        e_eff = torch.where(no_prev, carry_e.to(e.dtype), e_eff)
    else:
        # first chunk: collapse the leading dropped run onto the first
        # kept sample (zero width, zero energy)
        first = keep.to(torch.uint8).argmax(dim=1, keepdim=True)
        t_eff = torch.where(no_prev, torch.gather(t, 1, first), t_eff)
        e_eff = torch.where(no_prev, torch.gather(e, 1, first), e_eff)
    clean = vm.all() & ~(t[:, 1:] < t[:, :-1]).any()
    if carry_t is not None:
        clean = clean & ~(t[:, :1] < carry_t.to(t.dtype)).any()
    t_eff = torch.where(clean, t, t_eff)
    e_eff = torch.where(clean, e, e_eff)
    if not return_counts:
        return t_eff, e_eff
    late = (vm & ~keep & (tv < prev_max)).sum(dim=1, dtype=torch.int64)
    counts = {"late": torch.where(clean, 0, late),
              "masked": (~vm).sum(dim=1, dtype=torch.int64)}
    return t_eff, e_eff, counts


def _maskfill_chunk(times, values, valid, carry_t, carry_v):
    """Valid-mask carry-forward: every slot takes the last VALID (t, v)
    at-or-before it; the (always valid) carry column seeds rows whose
    chunk starts invalid.  Equal-timestamp valid samples are kept."""
    f, c = times.shape
    dev = times.device
    ok = torch.cat([torch.ones((f, 1), dtype=torch.bool, device=dev),
                    valid.to(torch.bool)], dim=1)
    aug_t = torch.cat([carry_t.to(times.dtype), times], dim=1)
    aug_v = torch.cat([carry_v.to(values.dtype), values], dim=1)
    idx = torch.arange(c + 1, device=dev).expand(f, c + 1)
    last = torch.cummax(torch.where(ok, idx, 0), dim=1).values
    return (torch.gather(aug_t, 1, last)[:, 1:],
            torch.gather(aug_v, 1, last)[:, 1:])


# ---------------------------------------------------------------------------
# Window types passed between stages
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ClosedWindow:
    """One (F, C+1) window of hold-interval EDGES on the device.

    Column 0 is the carry edge (previous window's last sample; a
    zero-width duplicate of the first sample on the first window), so
    sample j>=1 closes (times[:, j-1], times[:, j]].  ``t_first[i]`` is
    row i's first defined query time (+inf until known).
    """
    times: torch.Tensor        # (F, C+1)
    values: torch.Tensor       # (F, C+1) cumulative J (counter) or W
    t_first: torch.Tensor      # (F,) float64


@dataclasses.dataclass
class GriddedWindow:
    """Emitted slots [lo, lo+G) of the shared uniform output grid."""
    lo: int                    # first slot index
    grid: torch.Tensor         # (G,) float64 slot times (pipeline time)
    values: torch.Tensor       # (n_streams, G) regridded power
    mask: torch.Tensor         # (n_streams, G) defined-span coverage


# ---------------------------------------------------------------------------
# Stage 1: Ingest
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IngestCarry:
    """Last sanitized hold edge per row."""
    t: torch.Tensor            # (F, 1)
    v: torch.Tensor            # (F, 1)


class IngestStage:
    """Raw (times, values[, valid]) chunks -> sanitized closed windows.

    mode="sanitize"  reorder/duplicate repair incl. masked slots;
    mode="maskfill"  valid-mask carry-forward only, equal times kept.

    kind_row (sanitize mode): True marks cumulative-counter rows, whose
    defined span opens at the first strict timestamp advance; power rows
    open at their first sample.  None treats every row as a counter.
    The dq counters (``dq_late``/``dq_masked``, cumulative, and
    ``dq_last``, this window's) stay on the device whatever the policy;
    ``dq_policy`` (a ``DataQualityPolicy``) may turn late or dropped
    samples into a ``DataQualityError``.
    """

    def __init__(self, n_streams: int, *, mode: str = "sanitize",
                 kind_row=None, dq_policy: DataQualityPolicy = None,
                 device=None):
        assert mode in ("sanitize", "maskfill")
        self.mode = mode
        self.n_streams = n_streams
        self.dq_policy = dq_policy
        self.device = resolve_device(device)
        self.kind_row = (None if kind_row is None else torch.as_tensor(
            np.asarray(kind_row, bool).reshape(-1), device=self.device))
        self.reset()

    def reset(self):
        self.carry: IngestCarry = None
        self._t_first = None
        self._unseeded = None      # (F,) bool: rows with no valid sample yet
        self.dq_late = None        # (F,) int64 cumulative repair counts
        self.dq_masked = None
        self.dq_last: dict = {}
        return self

    def _dq_account(self, counts: dict):
        if self.dq_late is None:
            self.dq_late = torch.zeros_like(counts["late"])
            self.dq_masked = torch.zeros_like(counts["masked"])
        self.dq_late += counts["late"]
        self.dq_masked += counts["masked"]
        self.dq_last = counts
        p = self.dq_policy
        if p is None:
            return
        n = self.n_streams
        if p.late == "raise":
            i = _first_row(counts["late"][:n] > 0)
            if i is not None:
                raise DataQualityError(
                    f"ingest: row {i} delivered "
                    f"{int(counts['late'][i])} late/reordered sample(s) "
                    f"this window and the policy says raise")
        if p.dropped == "raise":
            i = _first_row(counts["masked"][:n] > 0)
            if i is not None:
                raise DataQualityError(
                    f"ingest: row {i} dropped "
                    f"{int(counts['masked'][i])} sample slot(s) this "
                    f"window and the policy says raise")

    def _seed_first(self, t, v, valid):
        f = t.shape[0]
        if valid is None:
            fi = torch.zeros((f, 1), dtype=torch.int64, device=t.device)
            self._unseeded = torch.zeros((f,), dtype=torch.bool,
                                         device=t.device)
        else:
            vb = valid.to(torch.bool)
            fi = vb.to(torch.uint8).argmax(dim=1, keepdim=True)
            self._unseeded = ~vb.any(dim=1)
        seed_t = torch.gather(t, 1, fi)
        seed_v = torch.gather(v, 1, fi)
        self.carry = IngestCarry(t=seed_t, v=seed_v)
        seed64 = torch.where(self._unseeded, torch.inf,
                             seed_t[:, 0].to(_F64))
        if self.mode == "maskfill":
            self._t_first = seed64
        elif self.kind_row is None:
            self._t_first = torch.full((f,), torch.inf, dtype=_F64,
                                       device=t.device)
        else:
            self._t_first = torch.where(self.kind_row, torch.inf, seed64)

    def _reseed(self, t, v, valid):
        """Deferred seeding: a row dark through every earlier chunk seeds
        zero-width at its first valid sample now (a no-op select for
        rows already seeded)."""
        f = t.shape[0]
        if valid is None:
            has = torch.ones((f,), dtype=torch.bool, device=t.device)
            fi = torch.zeros((f, 1), dtype=torch.int64, device=t.device)
        else:
            vb = valid.to(torch.bool)
            has = vb.any(dim=1)
            fi = vb.to(torch.uint8).argmax(dim=1, keepdim=True)
        reseed = self._unseeded & has
        st = torch.gather(t, 1, fi)
        sv = torch.gather(v, 1, fi)
        r = reseed[:, None]
        self.carry = IngestCarry(t=torch.where(r, st, self.carry.t),
                                 v=torch.where(r, sv, self.carry.v))
        st64 = st[:, 0].to(_F64)
        if self.mode == "maskfill":
            self._t_first = torch.where(reseed, st64, self._t_first)
        elif self.kind_row is not None:
            self._t_first = torch.where(
                reseed & ~self.kind_row,
                torch.minimum(self._t_first, st64), self._t_first)
        self._unseeded = self._unseeded & ~reseed

    def update(self, times, values, valid=None) -> ClosedWindow:
        t, v = times, values
        f = t.shape[0]
        if self.carry is None:
            self._seed_first(t, v, valid)
        elif self._unseeded is not None:
            # None after a restore: the reference saves no seeding state
            self._reseed(t, v, valid)
        zeros = torch.zeros((f,), dtype=torch.int64, device=t.device)
        if self.mode == "sanitize":
            t_eff, v_eff, dq = sanitize_chunk(t, v, valid, self.carry.t,
                                              self.carry.v,
                                              return_counts=True)
            self._dq_account(dq)
        elif valid is None:
            t_eff, v_eff = t, v
            self._dq_account({"late": zeros, "masked": zeros.clone()})
        else:
            t_eff, v_eff = _maskfill_chunk(t, v, valid, self.carry.t,
                                           self.carry.v)
            self._dq_account({"late": zeros, "masked": (~valid.to(
                torch.bool)).sum(dim=1, dtype=torch.int64)})
        t_aug = torch.cat([self.carry.t, t_eff], dim=1)
        v_aug = torch.cat([self.carry.v, v_eff], dim=1)
        if self.mode == "sanitize":
            # first strict advance past the seed = first closing edge.
            # Applied every window: once a row's t_first is finite every
            # later edge is >= it, so the minimum leaves it unchanged.
            adv = t_aug > t_aug[:, :1]
            j = adv.to(torch.uint8).argmax(dim=1, keepdim=True)
            tf = torch.where(adv.any(dim=1),
                             torch.gather(t_aug, 1, j)[:, 0].to(_F64),
                             torch.inf)
            self._t_first = torch.minimum(self._t_first, tf)
        self.carry = IngestCarry(t=t_aug[:, -1:].contiguous(),
                                 v=v_aug[:, -1:].contiguous())
        return ClosedWindow(times=t_aug, values=v_aug,
                            t_first=self._t_first)


# ---------------------------------------------------------------------------
# Stage 2: Reconstruct
# ---------------------------------------------------------------------------

class ReconstructStage:
    """Counter rows -> instantaneous power via wrap-corrected dE/dt, on
    the ``power_reconstruct_rows`` kernel; power rows pass through.
    ``host=True``: the float64 mirror (the plain version in float64 on
    the CPU, rounded back to the row dtype).  Stateless given closed
    windows."""

    def __init__(self, kind_row, wrap_row=None, *, device=None,
                 host: bool = False):
        self.device = _host_device(device, host)
        self.host = host
        kr = np.asarray(kind_row, bool).reshape(-1)
        f = len(kr)
        self.any_counter = bool(kr.any())
        self.kind_row = torch.as_tensor(kr, device=self.device)
        self.wrap_row = torch.as_tensor(
            np.zeros((f, 1)) if wrap_row is None
            else np.asarray(wrap_row, np.float64).reshape(f, 1),
            dtype=_F64, device=self.device)

    def reset(self):
        return self

    def update(self, chunk: ClosedWindow) -> ClosedWindow:
        t, v = chunk.times, chunk.values
        if not self.any_counter:
            return chunk
        if self.host:
            power = reconstruct_power_rows_ref(v.to(_F64), t.to(_F64),
                                               self.wrap_row)
        else:
            power = power_reconstruct_rows_kernel(
                v, t, self.wrap_row.to(t.dtype))
        out_v = torch.where(self.kind_row[:, None], power.to(v.dtype), v)
        return ClosedWindow(times=t, values=out_v, t_first=chunk.t_first)


# ---------------------------------------------------------------------------
# Shared carry piece: raw-sample tails for window-crossing grid queries
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TailCarry:
    """Last ``T`` raw samples per row + the newest time that slid out
    (queries must stay > ``dropped_t`` to be answerable)."""
    t: torch.Tensor            # (F, T)
    v: torch.Tensor            # (F, T)
    dropped_t: torch.Tensor    # (F,) float64


class _RowTail:
    def __init__(self, width: int):
        self.width = width
        self.carry: TailCarry = None

    def reset(self):
        self.carry = None
        return self

    def augmented(self, chunk: ClosedWindow):
        """[-inf sentinel | tail | window] rows for ``grid_resample``.

        The sentinel neutralizes the op's own lower-span mask (the true
        span is re-applied from ``chunk.t_first`` by ``_query_grid``); a
        lower bound never selects it for a finite query.
        """
        t, v = chunk.times, chunk.values
        f = t.shape[0]
        sent_t = torch.full((f, 1), -torch.inf, dtype=t.dtype,
                            device=t.device)
        sent_v = torch.zeros((f, 1), dtype=v.dtype, device=v.device)
        if self.carry is None:
            # zero-width replicas of the first edge: search-invisible
            self.carry = TailCarry(
                t=t[:, :1].repeat(1, self.width),
                v=v[:, :1].repeat(1, self.width),
                dropped_t=torch.full((f,), -torch.inf, dtype=_F64,
                                     device=t.device))
        return (torch.cat([sent_t, self.carry.t, t], dim=1),
                torch.cat([sent_v, self.carry.v, v], dim=1))

    def advance(self, chunk: ClosedWindow):
        """Slide the window into the tail (call after querying);
        ``dropped_t`` records only dropped samples STRICTLY older than
        the retained head."""
        t = torch.cat([self.carry.t, chunk.times], dim=1)
        v = torch.cat([self.carry.v, chunk.values], dim=1)
        gone = t[:, :-self.width].to(_F64)
        head = t[:, -self.width].to(_F64)[:, None]
        if gone.shape[1]:
            strict = torch.where(gone < head, gone, -torch.inf).amax(dim=1)
        else:
            strict = torch.full((t.shape[0],), -torch.inf, dtype=_F64,
                                device=t.device)
        dropped = torch.maximum(self.carry.dropped_t, strict)
        self.carry = TailCarry(t=t[:, -self.width:].contiguous(),
                               v=v[:, -self.width:].contiguous(),
                               dropped_t=dropped)

    def check_reach(self, q_min, what: str):
        """Raise when a query needs samples older than the tail holds
        (one bool comes back to the host)."""
        bad = q_min <= self.carry.dropped_t
        if bool(bad.any()):
            i = int(torch.argmax(bad.to(torch.uint8)))
            q = float(q_min if not isinstance(q_min, torch.Tensor)
                      or q_min.dim() == 0 else q_min[i])
            raise ValueError(
                f"{what}: row {i} query at t={q:.6f} reaches behind the "
                f"{self.width}-sample tail (oldest answerable "
                f"t>{float(self.carry.dropped_t[i]):.6f}); widen `tail` "
                f"or reduce the delay range")


def _slot_grid(origin: float, step: float, lo: int, hi: int, device):
    """(hi-lo+1,) float64 slot times ``origin + step * idx`` — the same
    two IEEE operations as the reference's numpy expression."""
    idx = torch.arange(lo, hi + 1, dtype=_F64, device=device)
    return origin + step * idx


def _query_grid(rows_t, rows_v, grid64, delays64, t_first,
                host: bool = False):
    """Hold-resample all rows at ``grid + delay[row]`` -> (vals, mask).

    Queries are formed in the row dtype, exactly as the reference does,
    so both compare the SAME float32 values at hold discontinuities.
    ``host=True``: the reference's float64 mirror — the row-dtype grid
    and delays promoted to float64 and summed there, the plain version
    searching float64 rows; values come back in the row dtype.
    """
    f, s = rows_t.shape
    dtype, dev = rows_t.dtype, rows_t.device
    n_row = torch.full((f,), s, dtype=torch.int32, device=dev)
    first_row = torch.zeros((f,), dtype=torch.int32, device=dev)
    g = grid64.to(dtype)
    d = delays64.to(dtype)
    if host:
        g, d = g.to(_F64), d.to(_F64)
        out, mask = grid_resample_ref(rows_t.to(_F64), rows_v.to(_F64),
                                      n_row[:, None], first_row[:, None],
                                      g[:, None], d[:, None], mode="hold")
        span = t_first.to(dtype).to(_F64)
    else:
        out, mask = grid_resample(rows_t, rows_v, n_row, first_row, g, d,
                                  mode="hold")
        span = t_first.to(dtype)
    ge = g[None, :] + d[:, None]
    mask = mask & (ge >= span[:, None])
    return torch.where(mask, out, 0.0).to(dtype), mask


# ---------------------------------------------------------------------------
# Stage 3: AlignTrack — online per-sensor delay tracking
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AlignCarry:
    """Sliding uniform-grid ring + the tracked per-row delay EMA."""
    ring_v: torch.Tensor       # (F, W) regridded power on the track grid
    ring_m: torch.Tensor       # (F, W) coverage
    next_slot: int             # global index of the next unfilled slot
    last_est_slot: int
    delay: torch.Tensor        # (F,) float64 EMA-tracked lag (seconds)
    seen: torch.Tensor         # (F,) bool — row has >=1 accepted estimate


@dataclasses.dataclass
class DelayTrackPoint:
    """One per-window re-estimate (kept for tests/diagnostics)."""
    t_lo: float                # window start (pipeline time)
    t_hi: float
    t_center: float
    raw: torch.Tensor          # (n_streams,) this window's lag estimate
    ema: torch.Tensor          # (n_streams,) tracked delay after folding
    peak: torch.Tensor         # (n_streams,) correlation at the peak


class AlignTrackStage:
    """Re-estimate per-stream delays on sliding windows, online.

    An (F, window) ring on a uniform ``grid_step`` grid is filled from
    each closed window through the hold regrid; every ``hop`` new slots
    the FULL ring is scored against the reference by ``xcorr_align`` and
    the per-window lag folds into an exponential moving average.

    reference: callable(times_f64 ndarray) -> (W,) watts, evaluated on the
    host (e.g. ``lambda t: truth.power_at(t + t0)``).  When None, each
    group's FIRST stream is its own reference (``groups`` required);
    that mode scores one group per launch.  Estimates with peak
    correlation below ``min_corr`` leave the EMA untouched.
    grid_step must come from the MEASURED cadence (see the reference).

    Multi-host (``collectives`` + ``shard``, "synced"): the ring origin
    and each update's fill frontier are all-reduced (min), so every host
    fills the same global slots and fires in lockstep; each host scores
    its own rows (a row's score does not depend on the rows scored with
    it), folds them into its local EMA, and queues the fire's (lag,
    peak) pairs (``pending_contribution``), which Regrid/Fuse sums over
    the hosts on its frontier frame and hands to ``fold_fleet``: the
    shared ``fleet_delay_s`` EMA, the same float64 operations on the
    same inputs as the owner's, so it equals every owner's local delays
    bit for bit.
    """

    def __init__(self, n_streams: int, *, grid_step: float,
                 reference=None, groups=None, window: int = 2048,
                 hop: int = 512, max_lag: int = 64, ema: float = 0.5,
                 min_corr: float = 0.2, min_fill: int = None,
                 tail: int = 256, delay0=None, collectives=None,
                 shard=None, host: bool = False):
        assert reference is not None or groups is not None, \
            "AlignTrack needs a reference schedule or group structure"
        if collectives is not None:
            if shard is None:
                raise ValueError("synchronized tracking needs the "
                                 "HostShard (global row ids place this "
                                 "host's lags in the fleet vector)")
            if host:
                raise ValueError("synchronized tracking scores on the "
                                 "device: the host mirror's full-fleet "
                                 "float64 product is not partition-"
                                 "invariant (host=True)")
            if not min_corr > 0.0:
                raise ValueError("synchronized tracking needs min_corr > "
                                 "0 (the zero frames of hop-less windows "
                                 "must never pass the gate)")
        self.collectives = collectives
        self.shard = shard
        self.host = host
        self.n_streams = n_streams
        self.step = float(grid_step)
        self.reference = reference
        self.groups = groups
        self.window = int(window)
        self.hop = int(hop)
        self.max_lag = int(max_lag)
        self.ema = float(ema)
        self.min_corr = float(min_corr)
        self.min_fill = (self.window // 2 if min_fill is None
                         else int(min_fill))
        self._tail = _RowTail(tail)
        self._delay0 = (np.zeros((0,)) if delay0 is None
                        else np.asarray(delay0, np.float64))
        self._banks = RefbankCache()
        self.reset()

    def reset(self):
        self.origin = None
        self.carry: AlignCarry = None
        self.history: list = []
        self._pending = None       # (2, n) device (lag, peak) of a fire
        self.delay_fleet = None    # (n_global,) shared EMA (synced)
        self._seen_fleet = None
        self._tail.reset()
        return self

    @property
    def delay_s(self) -> torch.Tensor:
        """(F,) currently tracked per-row delay (float64 seconds)."""
        if self.carry is None:
            raise RuntimeError("AlignTrack has seen no data yet")
        return self.carry.delay

    @property
    def synced(self) -> bool:
        """True when the tracking state is shared over collectives."""
        return self.collectives is not None

    @property
    def fleet_delay_s(self) -> np.ndarray:
        """(n_global,) fleet-wide tracked delays (host float64),
        identical on every host (synced mode only)."""
        if not self.synced:
            raise ValueError("fleet_delay_s needs collectives")
        if self.delay_fleet is None:
            raise RuntimeError("AlignTrack has seen no data yet")
        return self.delay_fleet.copy()

    def _init(self, chunk: ClosedWindow):
        f = chunk.times.shape[0]
        n = self.n_streams
        dev = chunk.times.device
        origin = float(chunk.times[:n, 0].to(_F64).min())
        d0 = len(self._delay0)
        delay = torch.zeros((f,), dtype=_F64, device=dev)
        if d0:
            delay[:d0] = torch.as_tensor(self._delay0, dtype=_F64,
                                         device=dev)
        if self.synced:
            # shared ring origin: every host fills the same global slots,
            # so the hops (and every estimate's window) land in lockstep
            n_global = int(self.shard.row_offsets[-1])
            seed = np.zeros((n_global,))
            seed[self.shard.row_ids[:d0]] = self._delay0[:n]
            origin, self.delay_fleet = self.collectives.allreduce_framed(
                origin, seed, scalar_op="min")
            self._seen_fleet = np.zeros((n_global,), bool)
        self.origin = origin
        self.carry = AlignCarry(
            ring_v=torch.zeros((f, self.window), dtype=chunk.values.dtype,
                               device=dev),
            ring_m=torch.zeros((f, self.window), dtype=torch.bool,
                               device=dev),
            next_slot=0, last_est_slot=0, delay=delay,
            seen=torch.zeros((f,), dtype=torch.bool, device=dev))

    def update(self, chunk: ClosedWindow) -> ClosedWindow:
        if self.carry is None:
            self._init(chunk)
        c = self.carry
        n = self.n_streams
        rows_t, rows_v = self._tail.augmented(chunk)
        frontier = float(chunk.times[:n, -1].to(_F64).min())
        if self.synced:
            # fill to the globally slowest stream: the ring advances, and
            # the hops fire, identically on every host
            frontier = self.collectives.allreduce_min(frontier)
        hi = int(np.floor((frontier - self.origin) / self.step - 0.01))
        if hi >= c.next_slot:
            grid64 = _slot_grid(self.origin, self.step, c.next_slot, hi,
                                rows_t.device)
            self._tail.check_reach(
                self.origin + self.step * c.next_slot, "AlignTrack")
            vals, mask = _query_grid(
                rows_t, rows_v, grid64,
                torch.zeros((rows_t.shape[0],), dtype=_F64,
                            device=rows_t.device), chunk.t_first,
                host=self.host)
            k = grid64.shape[0]
            if k >= self.window:
                c.ring_v = vals[:, -self.window:].contiguous()
                c.ring_m = mask[:, -self.window:].contiguous()
            else:
                c.ring_v = torch.cat([c.ring_v[:, k:], vals], dim=1)
                c.ring_m = torch.cat([c.ring_m[:, k:], mask], dim=1)
            c.next_slot = hi + 1
        self._tail.advance(chunk)
        if (c.next_slot - c.last_est_slot >= self.hop
                and c.next_slot >= self.min_fill):
            self._estimate()
            c.last_est_slot = c.next_slot
        return chunk

    def _estimate(self):
        c = self.carry
        w_idx = np.arange(c.next_slot - self.window, c.next_slot)
        c.delay, c.seen, point = _track_estimate(
            c.ring_v, c.ring_m, self.origin + self.step * w_idx, c.delay,
            c.seen, n=self.n_streams, reference=self.reference,
            groups=self.groups, step=self.step, max_lag=self.max_lag,
            ema=self.ema, min_corr=self.min_corr, banks=self._banks,
            host=self.host)
        if self.synced:
            # this fire's (lag, peak) pairs wait for the framed reduce of
            # Regrid/Fuse's next frontier round trip
            self._pending = torch.stack([point.raw, point.peak])
        self.history.append(point)

    def pending_contribution(self) -> np.ndarray:
        """(2, n_global) framed (lag, peak) contribution: this host's
        rows' lags and peak correlations of the fire since the last fold
        (one (2, n) float64 copy to the host), zeros elsewhere, and all
        zero when no hop fired (zero peaks fail the gate on every host,
        so such a frame folds nothing)."""
        out = np.zeros((2, len(self.delay_fleet)))
        if self._pending is not None:
            out[:, self.shard.row_ids] = self._pending.cpu().numpy()
            self._pending = None
        return out

    def fold_fleet(self, reduced) -> None:
        """Fold the host-summed (lag, peak) vectors into the shared fleet
        EMA: the gate and fold of ``_track_estimate`` in the same float64
        operations, on inputs that equal the owners' (each element came
        from one host), so ``delay_fleet`` equals every owner's local
        delays bit for bit."""
        raw, peak = np.asarray(reduced, np.float64).reshape(2, -1)
        good = peak >= self.min_corr
        a = np.where(self._seen_fleet, self.ema, 1.0)
        self.delay_fleet = np.where(
            good, (1 - a) * self.delay_fleet + a * raw, self.delay_fleet)
        self._seen_fleet = self._seen_fleet | good


def _track_estimate(v_win, m_win, times64, delay, seen, *, n: int,
                    reference, groups, step: float, max_lag: int,
                    ema: float, min_corr: float, banks: RefbankCache,
                    host: bool):
    """One AlignTrack re-estimate over an (F, window) track window at
    ``times64``: every row scored against the reference (or its group's
    first stream, one group a call), the ``min_corr`` gate, then the EMA
    fold -> (delay, seen, DelayTrackPoint).  ``host=True`` scores in
    float64 on the host (``estimate_delays_host``)."""
    f = v_win.shape[0]
    dev = v_win.device

    def run(vals, mask, ref):
        if host:
            return estimate_delays_host(vals.to(_F64), mask, ref,
                                        step=step, max_lag=max_lag)
        # rows scored alone: a row's delay never depends on how many
        # rows its host scores with it (the multi-host invariance)
        return estimate_delays(vals, mask.to(vals.dtype), ref, step=step,
                               max_lag=max_lag, bank_cache=banks,
                               rows_alone=True)

    if reference is not None:
        ref = np.asarray(reference(times64), np.float64)
        est = run(v_win, m_win, ref)
        raw, peak = est.delay_s, est.peak_corr
    else:
        raw = torch.zeros((f,), dtype=_F64, device=dev)
        peak = torch.zeros((f,), dtype=_F64, device=dev)
        lo = 0
        for g in groups:
            hi = lo + g
            ref = stream_reference(v_win[lo], m_win[lo])
            est = run(v_win[lo:hi], m_win[lo:hi], ref)
            raw[lo:hi], peak[lo:hi] = est.delay_s, est.peak_corr
            lo = hi
    good = peak >= min_corr
    good[n:] = False                      # padding rows never track
    # first estimate: direct.  float64 like the host's fleet fold, which
    # must see the same three operations on the same values (a fill, not
    # a copy of a host scalar: no sync)
    a = torch.ones_like(delay).masked_fill_(seen, ema)
    delay = torch.where(good, (1 - a) * delay + a * raw, delay)
    seen = seen | good
    return delay, seen, DelayTrackPoint(
        t_lo=float(times64[0]), t_hi=float(times64[-1]),
        t_center=float(0.5 * (times64[0] + times64[-1])),
        raw=raw[:n].clone(), ema=delay[:n].clone(), peak=peak[:n].clone())


# ---------------------------------------------------------------------------
# Padded device-group layout shared by Regrid/Fuse and PhaseAttribute
# ---------------------------------------------------------------------------

class _GroupLayout:
    """Rows grouped by device as a padded (D, k_max) index.

    ``rows[d, k]`` is the row of device d's k-th stream (0 for padding),
    ``valid[d, k]`` marks real streams and ``flat[i]`` is stream i's
    position in the flattened (D * k_max) layout, so per-stream results
    come back by one gather.  ``k_max`` defaults to the largest group; a
    multi-host stage passes the fleet's, so every host's layout (and
    pattern space) is the same.
    """

    def __init__(self, group_sizes, device, k_max: int = None):
        sizes = [int(k) for k in group_sizes]
        assert sizes and min(sizes) >= 1, group_sizes
        self.n_devices = len(sizes)
        self.k_max = max(sizes) if k_max is None else int(k_max)
        assert self.k_max >= max(sizes), (k_max, sizes)
        rows = np.zeros((self.n_devices, self.k_max), np.int64)
        valid = np.zeros((self.n_devices, self.k_max), bool)
        flat = []
        lo = 0
        for d, k in enumerate(sizes):
            rows[d, :k] = np.arange(lo, lo + k)
            valid[d, :k] = True
            flat += [d * self.k_max + j for j in range(k)]
            lo += k
        self.rows = torch.as_tensor(rows, device=device)
        self.valid = torch.as_tensor(valid, device=device)
        self.flat = torch.as_tensor(np.asarray(flat, np.int64),
                                    device=device)

    def gather(self, per_row: torch.Tensor) -> torch.Tensor:
        """(n, ...) per-stream -> (D, k_max, ...) with zeros/False pads."""
        out = per_row[self.rows]
        pad = self.valid.reshape(self.valid.shape
                                 + (1,) * (per_row.dim() - 1))
        return out & pad if out.dtype == torch.bool else out * pad

    def scatter(self, padded: torch.Tensor) -> torch.Tensor:
        """(D, k_max) -> (n,) per-stream."""
        return padded.reshape(-1)[self.flat]


# ---------------------------------------------------------------------------
# Stage 4: Regrid/Fuse — streaming resample + fusion statistics
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FuseCarry:
    """Emit frontier + the additive inverse-variance sufficient stats
    (per-stream valid counts and squared residuals against the per-slot
    unweighted cross-sensor mean)."""
    next_slot: int
    n_k: torch.Tensor          # (n_streams,) float64
    ssr: torch.Tensor          # (n_streams,) float64


class RegridFuseStage:
    """Power windows -> delay-corrected shared-grid slots + fusion stats.

    The output grid is fixed (``origin + step * slot``); each update
    emits every slot whose per-row query ``slot_time + delay[row]`` is
    already closed by ALL rows (the emit frontier).  Delays come live
    from an ``AlignTrackStage`` or stay fixed.  ``flush`` emits the rest
    once the run ends.

    ``health`` (a ``SensorHealthStage``, set by the pipeline) folds its
    pending statistics once per update and in ``flush``, and its
    quarantine mask gates the fusion statistics from the next window on.
    The coverage counters (``dq_covered``, ``dq_last_coverage``,
    ``dq_low_coverage``) stay on the device; ``dq_policy`` with a
    ``min_coverage`` flags (or raises on) thinly covered rows.

    Multi-host (``collectives``): the frontier is all-reduced every
    update (``_sync``), so every host emits the same slot windows
    whichever rows it holds; a synced tracker's pending (lag, peak)
    pairs and the health stage's pending block ride that reduce as one
    frame and fold before the frontier is used.  Every host must drive
    the stage through the same number of ``update``/``flush`` calls
    (time-aligned replay windows over the all-reduced span do).
    """

    def __init__(self, group_sizes, *, grid_origin: float,
                 grid_step: float, delays=None, align=None,
                 tail: int = 256, var_floor: float = 0.25,
                 collectives=None, dq_policy: DataQualityPolicy = None,
                 device=None, host: bool = False):
        self.device = _host_device(device, host)
        self.host = host
        self.collectives = collectives
        self.group_sizes = list(group_sizes)
        self.n_streams = int(sum(self.group_sizes))
        self.layout = _GroupLayout(self.group_sizes, self.device)
        self.origin = float(grid_origin)
        self.step = float(grid_step)
        self.align = align
        self._fixed = torch.as_tensor(
            np.zeros((self.n_streams,)) if delays is None
            else np.asarray(delays, np.float64).reshape(-1),
            dtype=_F64, device=self.device)
        self.var_floor = float(var_floor)
        self._tail = _RowTail(tail)
        self.health = None
        self.dq_policy = dq_policy
        self.last_frontier = None   # telemetry: emit-frontier lag
        self.reset()

    def reset(self):
        n = self.n_streams
        dev = self.device
        self._tail.reset()
        self.carry = FuseCarry(
            next_slot=0,
            n_k=torch.zeros((n,), dtype=_F64, device=dev),
            ssr=torch.zeros((n,), dtype=_F64, device=dev))
        self._t_first = None
        # coverage accounting: per-stream covered-slot tallies plus the
        # latest emitted window's coverage fraction and flag
        self.dq_covered = torch.zeros((n,), dtype=torch.int64, device=dev)
        self.dq_slots = 0
        self.dq_last_coverage = torch.ones((n,), dtype=_F64, device=dev)
        self.dq_low_coverage = torch.zeros((n,), dtype=torch.bool,
                                           device=dev)
        return self

    def _fold_health(self):
        if self.health is not None:
            self.health.fold(self.health.take_pending())

    def _sync(self, value: float, op: str) -> float:
        """Frontier all-reduce (min or max); a synced tracker's pending
        (lag, peak) pairs and the health stage's pending block ride the
        same frame (still one round trip) and fold into the shared state
        before the value is used.  Both blocks are fleet-sized, so every
        host's frame has the same length, and each element is written by
        one host, so the left-fold sum is exact."""
        al, hs = self.align, self.health
        pend = (al.pending_contribution()
                if al is not None and al.synced else None)
        if pend is None and hs is None:
            return (self.collectives.allreduce_min(value) if op == "min"
                    else self.collectives.allreduce_max(value))
        blocks = [] if pend is None else [pend.ravel()]
        if hs is not None:
            blocks.append(hs.take_pending().ravel())
        value, summed = self.collectives.allreduce_framed(
            value, np.concatenate(blocks), scalar_op=op)
        off = 0
        if pend is not None:
            off = pend.size
            al.fold_fleet(summed[:off].reshape(2, -1))
        if hs is not None:
            # the fleet delays folded first, so the drift flag sees this
            # window's shared delays on every host
            hs.fold(summed[off:])
        return value

    def _delays(self, f: int) -> torch.Tensor:
        d = torch.zeros((f,), dtype=_F64, device=self.device)
        if self.align is not None:
            d[:] = self.align.delay_s[:f]
        else:
            d[:self.n_streams] = self._fixed
        return d

    def _emit(self, rows_t, rows_v, t_first, delays, lo: int, hi: int):
        grid64 = _slot_grid(self.origin, self.step, lo, hi, rows_t.device)
        self._tail.check_reach(grid64[0] + delays, "Regrid/Fuse")
        vals, mask = _query_grid(rows_t, rows_v, grid64, delays, t_first,
                                 host=self.host)
        n = self.n_streams
        vals, mask = vals[:n], mask[:n]
        self.dq_covered += mask.sum(dim=1)
        self.dq_slots += mask.shape[1]
        cov = mask.to(_F64).mean(dim=1)
        self.dq_last_coverage = cov
        p = self.dq_policy
        if p is not None and p.min_coverage > 0.0:
            low = cov < p.min_coverage
            self.dq_low_coverage = low
            if p.coverage == "raise":
                i = _first_row(low)
                if i is not None:
                    raise DataQualityError(
                        f"regrid/fuse: row {i} covered only "
                        f"{float(cov[i]):.3f} of the emitted window "
                        f"(< min_coverage={p.min_coverage}) and the "
                        f"policy says raise")
        # quarantine feedback: QUARANTINED/RECOVERING rows leave the
        # fusion statistics (the emitted window keeps the RAW mask so the
        # health stage can keep scoring them).  All-healthy fleets skip
        # the masking: the arithmetic below is then the plain chain's.
        stat_mask = mask
        if self.health is not None:
            hm = self.health.local_mask()
            if not hm.all():
                stat_mask = mask & torch.as_tensor(
                    hm, device=mask.device)[:, None]
        # fusion statistics: per-slot cross-sensor mean within each
        # device group, all groups at once over the padded layout
        # (a row's additions never depend on the group count)
        lay = self.layout
        m = lay.gather(stat_mask)                       # (D, K, G)
        v = lay.gather(vals.to(_F64))
        mf = m.to(_F64)
        cnt = fold_sum(mf, 1)                           # (D, G)
        m0 = fold_sum(v * mf, 1) / torch.clamp_min(cnt, 1.0)
        resid = (v - m0[:, None, :]) * mf
        self.carry.n_k += lay.scatter(fixed_sum(mf, 2))
        self.carry.ssr += lay.scatter(fixed_sum(resid * resid, 2))
        self.carry.next_slot = hi + 1
        return GriddedWindow(lo=lo, grid=grid64, values=vals, mask=mask)

    def update(self, chunk: ClosedWindow):
        n = self.n_streams
        self._t_first = chunk.t_first
        rows_t, rows_v = self._tail.augmented(chunk)
        delays = self._delays(rows_t.shape[0])
        frontier = float((chunk.times[:n, -1].to(_F64)
                          - delays[:n]).min())
        if self.collectives is not None:
            # every host trails the globally slowest stream and emits
            # the same slot windows (the accumulation order, and so the
            # fused energies, do not depend on the assignment)
            frontier = self._sync(frontier, "min")
        else:
            # single host: fold at the same cadence (once per update),
            # so window w's stats gate the masks from window w+1 on
            self._fold_health()
        self.last_frontier = frontier
        # 1% of a step keeps float32-rounded queries strictly inside
        # every row's closed span (flush re-emits with the final bound)
        hi = int(np.floor((frontier - self.origin) / self.step - 0.01))
        out = None
        if hi >= self.carry.next_slot:
            out = self._emit(rows_t, rows_v, chunk.t_first, delays,
                             self.carry.next_slot, hi)
        self._tail.advance(chunk)
        return out

    def flush(self, t_end: float = None):
        """Emit the remaining slots with the rows' FINAL spans.

        t_end: last grid time to cover (pipeline seconds); default covers
        every row's last closed sample.
        """
        if self._tail.carry is None:
            return None
        tc = self._tail.carry
        f = tc.t.shape[0]
        n = self.n_streams
        delays = self._delays(f)
        synced = self.collectives is not None and (
            self.health is not None
            or (self.align is not None and self.align.synced))
        if t_end is None:
            t_end = float((tc.t[:n, -1].to(_F64) - delays[:n]).max())
            if self.collectives is not None:
                # cover through the globally LAST row (rows that end
                # early mask off, as in the batch regrid)
                t_end = self._sync(t_end, "max")
            else:
                self._fold_health()
        elif synced:
            # an explicit t_end is the same on every host: the reduce is
            # a no-op on it but still folds the (lag, peak) pairs a last
            # hop left pending and the health stage's last block
            t_end = self._sync(float(t_end), "max")
        else:
            self._fold_health()
        hi = int(np.floor((t_end - self.origin) / self.step + 1e-9))
        if hi < self.carry.next_slot:
            return None
        sent_t = torch.full((f, 1), -torch.inf, dtype=tc.t.dtype,
                            device=tc.t.device)
        sent_v = torch.zeros((f, 1), dtype=tc.v.dtype, device=tc.v.device)
        rows_t = torch.cat([sent_t, tc.t], dim=1)
        rows_v = torch.cat([sent_v, tc.v], dim=1)
        return self._emit(rows_t, rows_v, self._t_first, delays,
                          self.carry.next_slot, hi)

    def weights(self) -> torch.Tensor:
        """(n_streams,) end-of-run inverse-variance weights."""
        return _ivw_weights(self.carry.n_k, self.carry.ssr,
                            self.var_floor)


def _ivw_weights(n_k, ssr, var_floor: float) -> torch.Tensor:
    """The batch ``fuse_gridded`` per-stream weight rule from the
    additive sufficient statistics."""
    var = ssr / torch.clamp_min(n_k, 1.0)
    return torch.where(n_k > 1, 1.0 / (var + var_floor), 0.0)


# ---------------------------------------------------------------------------
# Stage 5: PhaseAttribute
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FusedAttrCarry:
    """Per-device carry for fused streaming attribution.

    ``integrals[d, pattern]`` is a (P, k_max) float64 block: for every
    grid interval whose closing slot had exactly ``pattern`` coverage
    (bit k = stream k of the device), the per-stream sum of value x
    phase-overlap.  The fused per-phase energy is
    sum_pattern (I @ w) / sum_{k in pattern} w_k once the end-of-run
    weights are known.  The reference keeps one dict per device; here it
    is one dense tensor over every possible pattern.
    """
    t_prev: torch.Tensor       # (D,) float64 last valid slot time (nan)
    integrals: torch.Tensor    # (D, 2**k_max, P, k_max) float64


class FusedPhaseAttributeStage:
    """Gridded windows -> per-(device, phase) fused energies.

    The fused series is sample-and-hold on the output grid, invalid slots
    are bridged by carrying the previous valid edge forward, and the
    first valid slot seeds zero-width — the batch convention.  All device
    groups fold at once over the padded (D, k_max, G) layout, one float64
    product a coverage pattern summed over the slots by ``fixed_sum``
    (no atomics, and a group's sums do not depend on the group count).

    Multi-host (``collectives`` + ``shard``): ``group_sizes`` are this
    host's groups, ``k_max`` is the fleet's (every host's pattern space
    is the same), and ``totals``/``weights`` are collective calls: the
    integrals and the fuse stage's (n_k, ssr) of every host are gathered
    once and placed by global group, then finalized on every host from
    the same fleet-wide carries — pure placement, so the answer does not
    depend on the assignment.
    """

    def __init__(self, phases, group_sizes, fuse: RegridFuseStage, *,
                 collectives=None, shard=None, device=None):
        self.device = resolve_device(device)
        ph = np.asarray(phases, np.float64).reshape(-1, 2)
        self.phases = torch.as_tensor(ph, dtype=_F64, device=self.device)
        self.n_phases = len(ph)
        self.group_sizes = list(group_sizes)
        self.fuse = fuse
        self.collectives = collectives
        self.shard = shard
        k_max = None
        if collectives is not None:
            if shard is None:
                raise ValueError("multi-host totals need the HostShard "
                                 "(global row ids)")
            if list(shard.local_group_sizes) != self.group_sizes:
                raise ValueError("group_sizes must be the shard's local "
                                 "groups")
            k_max = max(shard.global_group_sizes)
        self.layout = _GroupLayout(self.group_sizes, self.device, k_max)
        if self.layout.k_max > MAX_GROUP:
            raise ValueError(f"fused attribution keeps a dense coverage-"
                             f"pattern accumulator: at most {MAX_GROUP} "
                             f"sensors per device, got "
                             f"{self.layout.k_max}")
        self.n_patterns = 1 << self.layout.k_max
        self.reset()

    def _fresh(self):
        lay = self.layout
        return FusedAttrCarry(
            t_prev=torch.full((lay.n_devices,), torch.nan, dtype=_F64,
                              device=self.device),
            integrals=torch.zeros((lay.n_devices, self.n_patterns,
                                   self.n_phases, lay.k_max),
                                  dtype=_F64, device=self.device))

    def reset(self):
        self.carry = self._fresh()
        return self

    def update(self, gw: GriddedWindow):
        lay = self.layout
        c = self.carry
        grid = gw.grid                                   # (G,) float64
        g = grid.shape[0]
        m = lay.gather(gw.mask)                          # (D, K, G)
        vv = lay.gather(gw.values.to(_F64)) * m          # (D, K, G)
        anyv = m.any(dim=1)                              # (D, G)
        has = anyv.any(dim=1)                            # (D,)
        gi = torch.arange(g, device=grid.device)
        last_valid = torch.cummax(torch.where(anyv, gi, -1), dim=1).values
        prev = torch.cat([torch.full_like(last_valid[:, :1], -1),
                          last_valid[:, :-1]], dim=1)
        first_valid = anyv.to(torch.uint8).argmax(dim=1)
        tp = torch.where(torch.isfinite(c.t_prev), c.t_prev,
                         grid[first_valid])              # zero-width seed
        t_lo = torch.where(prev >= 0, grid[prev.clamp_min(0)], tp[:, None])
        a = self.phases[:, 0][None, :, None]
        b = self.phases[:, 1][None, :, None]
        ov = torch.clamp_min(torch.minimum(grid[None, None, :], b)
                             - torch.maximum(t_lo[:, None, :], a), 0.0)
        bits = (1 << torch.arange(lay.k_max, device=grid.device))
        pat = (m.to(torch.int64) * bits[None, :, None]).sum(dim=1)
        # phases in chunks that keep each (D, P', K, G) product near
        # 64M elements; a sum over G does not depend on the chunking
        step = max(1, (1 << 26) // max(lay.n_devices * lay.k_max * g, 1))
        for p in range(1, self.n_patterns):
            sel = (pat == p).to(_F64)[:, None, :]        # (D, 1, G)
            ovs = ov * sel                               # (D, P, G)
            for lo in range(0, self.n_phases, step):
                prod = (ovs[:, lo:lo + step, None, :]
                        * vv[:, None, :, :])             # (D, P', K, G)
                c.integrals[:, p, lo:lo + step] += fixed_sum(prod, -1)
        c.t_prev = torch.where(has, grid[last_valid[:, -1].clamp_min(0)],
                               c.t_prev)
        return None

    def _gathered(self):
        """(integrals, layout, group sizes, stream weights): this host's,
        or the fleet-wide merge when collectives are attached (a
        COLLECTIVE call).  The carries cross to the host as float64
        numpy before they are pickled, are placed by global group id (a
        group owned twice or by nobody raises), and the merged carries
        go back to the device."""
        if self.collectives is None:
            return (self.carry.integrals, self.layout, self.group_sizes,
                    self.fuse.weights())
        sh, n = self.shard, self.fuse.n_streams
        payload = pickle.dumps(
            (tuple(int(g) for g in sh.group_ids),
             self.carry.integrals.cpu().numpy(),
             self.fuse.carry.n_k[:n].cpu().numpy(),
             self.fuse.carry.ssr[:n].cpu().numpy()))
        sizes = [int(k) for k in sh.global_group_sizes]
        off = sh.row_offsets
        integrals = np.zeros((len(sizes),)
                             + tuple(self.carry.integrals.shape[1:]))
        owned = np.zeros((len(sizes),), bool)
        n_k = np.zeros((int(off[-1]),))
        ssr = np.zeros((int(off[-1]),))
        for raw in self.collectives.allgather_bytes(payload):
            gids, ints, nk_l, ssr_l = pickle.loads(raw)
            lo = 0
            for j, g in enumerate(gids):
                if owned[g]:
                    raise ValueError(f"device group {g} owned by two "
                                     f"hosts")
                owned[g] = True
                integrals[g] = ints[j]
                k = sizes[g]
                n_k[off[g]:off[g] + k] = nk_l[lo:lo + k]
                ssr[off[g]:off[g] + k] = ssr_l[lo:lo + k]
                lo += k
        if not owned.all():
            raise ValueError(f"multi-host merge: device groups "
                             f"{np.flatnonzero(~owned).tolist()} are "
                             f"owned by no host")
        dev = self.device
        w = _ivw_weights(torch.as_tensor(n_k, device=dev),
                         torch.as_tensor(ssr, device=dev),
                         self.fuse.var_floor)
        return (torch.as_tensor(integrals, device=dev),
                _GroupLayout(sizes, dev, self.layout.k_max), sizes, w)

    def totals(self) -> torch.Tensor:
        """(n_devices, n_phases) float64 fused joules, finalized with the
        end-of-run inverse-variance weights; fleet-wide (global device
        order, the same on every host) in multi-host mode."""
        integrals, layout, _, w = self._gathered()
        return _pattern_totals(integrals, layout.gather(w))

    def weights(self) -> list:
        """Per-device normalized stream weights (diagnostics);
        fleet-wide in multi-host mode."""
        _, _, sizes, w_flat = self._gathered()
        out = []
        lo = 0
        for k in sizes:
            w = w_flat[lo:lo + k]
            out.append(w / torch.clamp_min(w.sum(), 1e-30))
            lo += k
        return out


def _pattern_totals(integrals, w) -> torch.Tensor:
    """(D, 2**K, P, K) pattern integrals and (D, K) stream weights (0 on
    padding) -> (D, P) fused joules: each coverage pattern's integrals
    weighted by its streams and normalized by their total weight."""
    k = w.shape[1]
    pats = torch.arange(integrals.shape[1], device=w.device)
    member = ((pats[:, None] >> torch.arange(
        k, device=w.device)[None, :]) & 1).to(_F64)          # (C, K)
    w_tot = fold_sum(w[:, None, :] * member[None], 2)        # (D, C)
    contrib = fold_sum(integrals * w[:, None, None, :], 3)   # (D, C, P)
    ok = w_tot > 0
    part = torch.where(ok[..., None],
                       contrib / torch.where(ok, w_tot, 1.0)[..., None],
                       0.0)
    return fixed_sum(part, 1)


# ---------------------------------------------------------------------------
# Stage 5b: per-request metering (token-weighted occupancy split)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SlotSegment:
    """One constant-occupancy interval of a serve engine's timeline.

    ``rids``/``tokens`` list the requests concurrently active in
    ``[t_lo, t_hi)`` and the token weight each contributed (prompt
    length for prefill segments, decoded steps for decode segments).
    Segment boundaries fall on every admission/eviction, so occupancy
    is constant inside a segment and the union of segments tiles the
    engine's depth-0 phases exactly.
    """
    t_lo: float
    t_hi: float
    rids: tuple
    tokens: tuple
    kind: str = "decode"

    def shifted(self, dt: float) -> "SlotSegment":
        return dataclasses.replace(self, t_lo=self.t_lo + dt,
                                   t_hi=self.t_hi + dt)


class MeteringStage(FusedPhaseAttributeStage):
    """Fused window energies -> per-REQUEST energies.

    A pass-through sibling of ``FusedPhaseAttributeStage``: the phase
    table is the engine's slot-segment schedule (one row per constant-
    occupancy interval), accumulated in the same dense per-(device,
    coverage pattern, segment, stream) float64 integrals on the device
    and finalized with the same deferred inverse-variance weights.  Each
    segment's energy is then split across the requests active in it by
    token-weighted occupancy, on the host.

    Determinism: segments are sorted before they become phases, shares
    within a segment fold in ascending request-id order, and every
    accumulation of the split is an exact float64 left fold, so
    per-request energies are bit-identical under any slot-assignment
    permutation.  Shares sum to 1 per segment, so per-request energies
    sum to the segment (= phase) totals to float64 round-off.
    """

    def __init__(self, segments, group_sizes, fuse: RegridFuseStage, *,
                 collectives=None, shard=None, device=None):
        segs = sorted(segments,
                      key=lambda s: (s.t_lo, s.t_hi, tuple(sorted(s.rids))))
        self.segments = segs
        super().__init__([(s.t_lo, s.t_hi) for s in segs], group_sizes,
                         fuse, collectives=collectives, shard=shard,
                         device=device)

    def update(self, gw: GriddedWindow):
        super().update(gw)
        return gw              # pass-through: PhaseAttribute still runs

    def segment_totals(self) -> np.ndarray:
        """(n_devices, n_segments) fused joules per slot segment (host
        float64)."""
        return self.totals().cpu().numpy()

    def request_energies(self) -> dict:
        """{rid: (n_devices,) float64 joules}, token-weighted split."""
        seg_e = self.segment_totals()
        d = seg_e.shape[0]
        out: dict = {}
        for j, s in enumerate(self.segments):
            if not s.rids:
                continue               # idle interval: nobody to bill
            # canonicalize to ascending-rid order FIRST so both the
            # weight-sum fold and the share folds are permutation-proof
            order = np.argsort(np.asarray(s.rids, np.int64),
                               kind="stable")
            w = np.asarray(s.tokens, np.float64)[order]
            tot = float(w.sum())
            if tot <= 0.0:             # degenerate: equal split
                w = np.ones((len(s.rids),), np.float64)
                tot = float(len(s.rids))
            for k, idx in enumerate(order):
                rid = int(s.rids[idx])
                acc = out.setdefault(rid, np.zeros((d,), np.float64))
                acc += (w[k] / tot) * seg_e[:, j]
        return out


# ---------------------------------------------------------------------------
# Two-stage fleet streams: per-phase integration of closed windows
# ---------------------------------------------------------------------------

class _PhaseSumStage:
    """The (F, P) float accumulator of per-phase joules that both
    two-stage streams keep; phases are padded to the PHASE_ALIGN tile."""

    def __init__(self, phases, n_streams: int, dtype, device):
        self.device = resolve_device(device)
        self.phases = torch.as_tensor(pad_phases(phases, dtype),
                                      device=self.device)
        self.n_phases = len(np.asarray(phases, np.float64).reshape(-1, 2))
        self._acc = torch.zeros((n_streams, len(self.phases)),
                                dtype=_torch_dtype(dtype), device=self.device)

    def reset(self):
        self._acc = torch.zeros_like(self._acc)
        return self

    def totals(self) -> np.ndarray:
        """(n_streams, n_phases) accumulated joules (host numpy)."""
        return self._acc[:, :self.n_phases].cpu().numpy()


class PhaseIntegrateStage(_PhaseSumStage):
    """Power windows -> (F, P) energies through the ``phase_integrate``
    kernel (the ``StreamingPhaseAccumulator`` core)."""

    def __init__(self, phases, n_streams: int, *, dtype=np.float32,
                 device=None):
        super().__init__(phases, n_streams, dtype, device)

    def update(self, chunk: ClosedWindow):
        self._acc = self._acc + phase_integrate_kernel(
            chunk.times.contiguous(), chunk.values.contiguous(),
            self.phases)
        return None


class CounterAttributeStage(_PhaseSumStage):
    """Counter windows -> (F, P) energies through the fused
    ``fleet_attribute`` kernel (dE/dt and integration in one pass; the
    ``FleetStream`` core).  The counter wrap is fixed per interval inside
    the kernel: dE telescopes across windows through the carry edge.
    Single device: ``mesh`` sharding is not ported."""

    def __init__(self, phases, n_streams: int, wrap_period=None, *,
                 dtype=np.float32, device=None):
        super().__init__(phases, n_streams, dtype, device)
        wp = (np.zeros((n_streams,), dtype) if wrap_period is None
              else np.asarray(wrap_period, dtype))
        self._wrap_row = torch.as_tensor(wp.reshape(n_streams, 1),
                                         device=self.device)

    def update(self, chunk: ClosedWindow):
        self._acc = self._acc + fleet_attribute_kernel(
            chunk.times.contiguous(), chunk.values.contiguous(),
            self._wrap_row, self.phases)
        return None


# ---------------------------------------------------------------------------
# The pipeline driver
# ---------------------------------------------------------------------------

class StreamPipeline:
    """Chain stages; push each (fleet, chunk) window through all of them.

    ``update`` feeds the first stage raw tensors and forwards each stage's
    output window to the next (None ends the window's journey).
    ``finalize`` flushes every stage in order through the rest of the
    chain.  ``stage_wall_s`` keeps per-stage host wall time: on a CUDA
    device that is enqueue time plus the stage's host syncs, not kernel
    time.
    """

    def __init__(self, *stages):
        self.stages = list(stages)
        self.stage_wall_s = {type(st).__name__: 0.0 for st in stages}
        self.windows = 0

    def _timed(self, st, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.stage_wall_s[type(st).__name__] += time.perf_counter() - t0
        return out

    def update(self, times, values, valid=None):
        self.windows += 1
        st0 = self.stages[0]
        out = self._timed(st0, st0.update, times, values, valid)
        for st in self.stages[1:]:
            if out is None:
                break
            out = self._timed(st, st.update, out)
        return self

    def finalize(self, t_end: float = None):
        for i, st in enumerate(self.stages):
            flush = getattr(st, "flush", None)
            if flush is None:
                continue
            out = self._timed(st, flush, t_end)
            for st2 in self.stages[i + 1:]:
                if out is None:
                    break
                out = self._timed(st2, st2.update, out)
        return self

    def attach_registry(self, registry) -> None:
        """Expose ``stage_wall_s`` and the window count through a
        ``health.HealthRegistry`` (the ``pipeline`` source)."""
        from repro_torch.health.registry import Metric

        def _fn():
            return [
                Metric("stage_wall_seconds", dict(self.stage_wall_s),
                       kind="counter", label="stage"),
                Metric("pipeline_windows_total", float(self.windows),
                       kind="counter"),
            ]
        registry.register_source("pipeline", _fn)

    def reset(self):
        for st in self.stages:
            st.reset()
        self.stage_wall_s = {type(st).__name__: 0.0
                             for st in self.stages}
        self.windows = 0
        return self


# ---------------------------------------------------------------------------
# High level: the streaming fused pipeline and its trace-level entry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StreamRows:
    """Raw packed rows for streaming replay (mixed sensor kinds), on the
    host.  Counter rows keep their (float64-unwrapped, rebased)
    cumulative joules; dE/dt happens in the Reconstruct stage.  Float32
    times match the reference's packing bit for bit."""
    times: np.ndarray          # (F, S) seconds since t0
    values: np.ndarray         # (F, S) cumulative J or W
    kind_row: np.ndarray       # (F,) True = cumulative counter
    n_samples: np.ndarray      # (F,)
    names: list
    n_streams: int
    t0: float

    @property
    def shape(self):
        return self.times.shape


def pack_stream_rows(traces, *, corrections=None,
                     use_t_measured: bool = True, t0=None,
                     dtype=np.float32, cum_t0=None) -> StreamRows:
    """SensorTraces (mixed cumulative + power) -> raw streaming rows.

    Calibration ``corrections`` (``core.calibration``) apply to each
    trace on the host before packing and before the float32 rebase.
    """
    traces = [apply_corrections(tr, corrections) for tr in traces]
    assert traces, "pack_stream_rows needs at least one trace"
    if t0 is None:
        t0 = min(float((tr.t_measured if use_t_measured
                        else tr.t_read)[0]) for tr in traces)
    cum = [i for i, tr in enumerate(traces) if tr.spec.is_cumulative]
    pwr = [i for i, tr in enumerate(traces) if not tr.spec.is_cumulative]
    f = _round_up(len(traces), ROW_ALIGN)
    s_cum = s_pwr = 2
    packed = None
    if cum:
        packed = pack_traces([traces[i] for i in cum],
                             use_t_measured=use_t_measured, dtype=dtype,
                             t0=cum_t0)
        s_cum = packed.shape[1]
    if pwr:
        s_pwr = max(max(len(traces[i]) for i in pwr), 2)
    s = max(s_cum, s_pwr)
    times = np.zeros((f, s), dtype)
    values = np.zeros((f, s), dtype)
    kind = np.zeros((f,), bool)
    n = np.full((f,), 2, np.int32)
    if cum:
        sel = np.asarray(cum)
        n_cum = len(cum)
        # two-step rebase (pack origin, then the shared origin) exactly
        # as the reference does — identical float32 times
        shift = dtype(packed.t0 - t0)
        times[sel, :s_cum] = packed.times[:n_cum] + shift
        values[sel, :s_cum] = packed.energy[:n_cum]
        if s > s_cum:                        # replicate-last tails
            times[sel, s_cum:] = times[sel, s_cum - 1][:, None]
            values[sel, s_cum:] = values[sel, s_cum - 1][:, None]
        kind[sel] = True
        n[sel] = packed.n_samples[:n_cum]
    for i in pwr:
        tr = traces[i]
        t = (tr.t_measured if use_t_measured else tr.t_read)
        kk = len(tr)
        times[i, :kk] = np.maximum.accumulate(t - t0)
        values[i, :kk] = tr.value
        times[i, kk:] = times[i, kk - 1]
        values[i, kk:] = values[i, kk - 1]
        n[i] = kk
    return StreamRows(times, values, kind, n,
                      [tr.name for tr in traces], len(traces), t0)


def default_tail(rows: StreamRows, chunk: int, *, delays=None,
                 max_lag: int = 64, grid_step: float = 1e-3,
                 cadence: float = None) -> int:
    """Tail columns needed so delayed queries never outrun the carry:
    the delay spread (the track range when delays are live) plus one
    window of slack."""
    min_step = cadence if cadence is not None else _min_cadence(rows)
    if delays is not None:
        d = np.asarray(delays, np.float64)
        spread = float(d.max() - min(d.min(), 0.0))
    else:
        spread = max_lag * grid_step
    tail_s = spread + chunk * min_step
    return max(256, int(np.ceil(tail_s / min_step)) + 64)


def _min_cadence(rows: StreamRows) -> float:
    """Fastest per-row median sample spacing (seconds; 1e-3 fallback)."""
    steps = []
    for i in range(rows.n_streams):
        dt = np.diff(rows.times[i, :rows.n_samples[i]].astype(np.float64))
        dt = dt[dt > 0]
        if len(dt):
            steps.append(float(np.median(dt)))
    return min(steps) if steps else 1e-3


def _replay_window_plan(rows: StreamRows, chunk: int = 1024, *,
                        span=None, cadence: float = None):
    """Time-aligned replay boundaries -> (n_win, idx); ``idx[i, w]`` is
    row i's first sample index in window w (idx[:, -1] == S)."""
    f, s = rows.shape
    n = rows.n_streams
    dt_win = max(chunk, 2) * (cadence if cadence is not None
                              else _min_cadence(rows))
    if span is not None:
        t_lo, t_hi = float(span[0]), float(span[1])
    else:
        t_lo = float(rows.times[:n, 0].astype(np.float64).min())
        t_hi = float(rows.times[:n, -1].astype(np.float64).max())
    n_win = max(int(np.ceil((t_hi - t_lo) / dt_win)), 1)
    edges = (t_lo + dt_win * np.arange(1, n_win)).astype(rows.times.dtype)
    idx = np.zeros((f, n_win + 1), np.int64)
    for i in range(n):                       # padding rows stay empty
        idx[i, 1:-1] = np.searchsorted(rows.times[i], edges,
                                       side="right")
        idx[i, -1] = s
    return n_win, idx


def stream_row_windows(rows: StreamRows, chunk: int = 1024, *,
                       span=None, cadence: float = None):
    """Replay packed rows as TIME-aligned (fleet, C) numpy windows: each
    window covers one time span for every row, sized so the fastest row
    advances ~``chunk`` samples; short rows replicate their last sample
    (zero-width intervals)."""
    n_win, idx = _replay_window_plan(rows, chunk, span=span,
                                     cadence=cadence)
    for w in range(n_win):
        lo, hi = idx[:, w], idx[:, w + 1]
        width = int((hi - lo).max())
        width = max(_round_up(width, 64), 64)
        cols = lo[:, None] + np.arange(width)[None, :]
        cols = np.minimum(cols, np.maximum(hi - 1, np.maximum(lo - 1,
                                                              0))[:, None])
        yield (np.take_along_axis(rows.times, cols, axis=1),
               np.take_along_axis(rows.values, cols, axis=1))


class StreamingFusedPipeline:
    """Ingest -> Reconstruct -> AlignTrack -> Regrid/Fuse -> PhaseAttr on
    one device.

    group_sizes: sensors per device, in row order (trailing padding rows
    up to a ROW_ALIGN multiple are ignored).  phases: [(a, b)] in pipeline
    time.  reference: callable(times)->watts in pipeline time for delay
    tracking; ``track=False`` freezes ``delays``.  health: True or a
    ``health.HealthConfig`` composes a ``SensorHealthStage`` between
    Regrid/Fuse and PhaseAttr (``health_names`` names its sensors);
    meter: ``SlotSegment``s in pipeline time compose a ``MeteringStage``
    (``request_energies``); registry: a ``health.HealthRegistry`` gets
    the ``pipeline``, ``fuse`` and ``data_quality`` sources (and
    ``health``); dq_policy: a ``DataQualityPolicy`` for Ingest and
    Regrid/Fuse.  ``device=None`` means CUDA.  ``host=True`` is the
    reference's float64 mirror, on the CPU: dE/dt, the hold lookups and
    the tracker's scores in float64 through the plain versions.

    Multi-host: ``collectives`` (a ``distributed.multihost``
    HostCollectives) + ``shard`` (this host's ``HostShard``;
    ``group_sizes`` are its local groups) synchronize the stages (see
    ``distributed.multihost``); ``totals``/``weights`` then return the
    fleet and are collective calls.
    """

    def __init__(self, group_sizes, phases, *, grid_origin: float,
                 grid_step: float, kind_row=None, wrap_period=None,
                 delays=None, reference=None, track: bool = None,
                 window: int = 2048, hop: int = 512, max_lag: int = 64,
                 ema: float = 0.5, min_corr: float = 0.2, tail: int = 256,
                 var_floor: float = 0.25, collectives=None, shard=None,
                 dtype=np.float32, health=None,
                 registry=None, health_names=None, meter=None,
                 dq_policy: DataQualityPolicy = None, device=None,
                 host: bool = False):
        self.device = dev = _host_device(device, host)
        self.group_sizes = list(group_sizes)
        self.collectives = collectives
        self.shard = shard
        if collectives is not None:
            if shard is None:
                raise ValueError("multi-host pipelines need the HostShard")
            if list(shard.local_group_sizes) != self.group_sizes:
                raise ValueError("group_sizes must be this host's local "
                                 "groups")
        n = int(sum(self.group_sizes))
        self.n_streams = n
        f = _round_up(n, ROW_ALIGN)
        self.n_rows = f
        kr = np.zeros((f,), bool)
        if kind_row is not None:
            kr[:len(np.asarray(kind_row))] = np.asarray(kind_row, bool)
        wp = np.zeros((f,), np.float64)
        if wrap_period is not None:       # pad to the row tile, like kr
            wp_in = np.asarray(wrap_period, np.float64).reshape(-1)
            wp[:len(wp_in)] = wp_in
        if track is None:
            track = delays is None
        self.ingest = IngestStage(n, mode="sanitize", kind_row=kr,
                                  dq_policy=dq_policy, device=dev)
        self.reconstruct = ReconstructStage(kr, wp, device=dev, host=host)
        self.align = None
        if track:
            self.align = AlignTrackStage(
                n, grid_step=grid_step, reference=reference,
                groups=None if reference is not None else self.group_sizes,
                window=window, hop=hop, max_lag=max_lag, ema=ema,
                min_corr=min_corr, tail=tail, delay0=delays,
                collectives=collectives, shard=shard, host=host)
        self.fuse = RegridFuseStage(
            self.group_sizes, grid_origin=grid_origin,
            grid_step=grid_step, delays=delays, align=self.align,
            tail=tail, var_floor=var_floor, collectives=collectives,
            dq_policy=dq_policy, device=dev, host=host)
        self.attr = FusedPhaseAttributeStage(
            phases, self.group_sizes, self.fuse, collectives=collectives,
            shard=shard, device=dev)
        self.health_stage = None
        if health is not None and health is not False:
            from repro_torch.health.stage import (HealthConfig,
                                                  SensorHealthStage)
            hcfg = health if isinstance(health, HealthConfig) else None
            row_ids = n_global = None
            if shard is not None:
                row_ids = np.asarray(shard.row_ids, np.int64)
                n_global = int(sum(shard.global_group_sizes))
            self.health_stage = SensorHealthStage(
                self.group_sizes, hcfg, grid_step=grid_step,
                row_ids=row_ids, n_global=n_global, names=health_names,
                align=self.align, registry=registry, device=dev)
            self.fuse.health = self.health_stage
        self.meter_stage = None
        if meter:
            self.meter_stage = MeteringStage(
                list(meter), self.group_sizes, self.fuse,
                collectives=collectives, shard=shard, device=dev)
        stages = [self.ingest, self.reconstruct]
        if self.align is not None:
            stages.append(self.align)
        stages += [self.fuse]
        if self.health_stage is not None:
            stages.append(self.health_stage)
        if self.meter_stage is not None:
            stages.append(self.meter_stage)
        stages += [self.attr]
        self.pipeline = StreamPipeline(*stages)
        if registry is not None:
            self.pipeline.attach_registry(registry)
            self._attach_fuse_metrics(registry)
            self._attach_dq_metrics(registry)
            if collectives is not None:
                registry.track_collectives(collectives)
        self._dtype = _torch_dtype(dtype)
        self._np_dtype = torch.empty((), dtype=self._dtype).numpy().dtype
        self._window = int(window)
        self._hop = int(hop)
        self._tail_width = int(tail)
        self._var_floor = float(var_floor)

    def _attach_fuse_metrics(self, registry) -> None:
        from repro_torch.health.registry import Metric
        fuse = self.fuse

        def _fn():
            lag = 0.0
            if fuse.last_frontier is not None:
                lag = (fuse.last_frontier
                       - (fuse.origin + fuse.step
                          * fuse.carry.next_slot))
            return [
                Metric("emit_frontier_lag_s", float(lag),
                       help="closed stream not yet emitted (s)"),
                Metric("emitted_slots_total",
                       float(fuse.carry.next_slot), kind="counter"),
            ]
        registry.register_source("fuse", _fn)

    def _attach_dq_metrics(self, registry) -> None:
        """The ``data_quality`` registry source: ingest repair counters,
        emitted-window coverage, and the per-window flags (read from the
        device when the registry is exported, not per window)."""
        from repro_torch.health.registry import Metric
        ing, fuse, n = self.ingest, self.fuse, self.n_streams

        def host(t):
            return np.zeros((n,), np.int64) if t is None \
                else t[:n].cpu().numpy()

        def per(arr):
            return {f"r{i}": float(arr[i]) for i in range(n)}

        def _fn():
            w_late = ing.dq_last.get("late")
            w_masked = ing.dq_last.get("masked")
            flags = {
                "late": float(bool(w_late is not None
                                   and host(w_late).any())),
                "dropped": float(bool(w_masked is not None
                                      and host(w_masked).any())),
                "low_coverage": float(bool(
                    host(fuse.dq_low_coverage).any())),
            }
            return [
                Metric("ingest_late_samples_total", per(host(ing.dq_late)),
                       kind="counter", label="row",
                       help="reordered/late samples repaired at ingest"),
                Metric("ingest_dropped_samples_total",
                       per(host(ing.dq_masked)), kind="counter",
                       label="row",
                       help="masked/dropped sample slots at ingest"),
                Metric("window_coverage_frac",
                       per(host(fuse.dq_last_coverage)), label="row",
                       help="last emitted window's covered-slot "
                            "fraction per stream"),
                Metric("dq_flag", flags, label="flag",
                       help="per-window data-quality flags (1 = seen "
                            "in the latest window)"),
            ]
        registry.register_source("data_quality", _fn)

    def update(self, times, values, valid=None):
        """Feed one (rows, C) window (numpy or tensors); rows short of the
        row tile are padded by replicating the last row."""
        t = torch.as_tensor(times, dtype=self._dtype, device=self.device)
        v = torch.as_tensor(values, dtype=self._dtype, device=self.device)
        if valid is not None:
            valid = torch.as_tensor(valid, dtype=torch.bool,
                                    device=self.device)
        if t.shape[0] < self.n_rows:
            pad = self.n_rows - t.shape[0]
            t = torch.cat([t, t[-1:].expand(pad, -1)])
            v = torch.cat([v, v[-1:].expand(pad, -1)])
            if valid is not None:
                valid = torch.cat([valid, valid.new_ones(
                    (pad, t.shape[1]))])
        self.pipeline.update(t.contiguous(), v.contiguous(), valid)
        return self

    def finalize(self, t_end: float = None):
        self.pipeline.finalize(t_end)
        return self

    def totals(self) -> torch.Tensor:
        """(n_devices, n_phases) float64 fused joules so far; multi-host,
        the fleet's (global device order, the same on every host) and a
        collective call."""
        return self.attr.totals()

    def weights(self) -> list:
        return self.attr.weights()

    def request_energies(self) -> dict:
        """{rid: (n_devices,) float64 joules} from the metering stage
        (needs ``meter=`` slot segments at construction)."""
        if self.meter_stage is None:
            raise ValueError("request_energies() needs meter= slot "
                             "segments")
        return self.meter_stage.request_energies()

    def delays(self) -> torch.Tensor:
        """(n_streams,) per-stream delay in use (tracked or fixed)."""
        if self.align is not None and self.align.carry is not None:
            return self.align.delay_s[:self.n_streams].clone()
        return self.fuse._fixed.clone()

    def fleet_delays(self):
        """(n_global,) fleet-wide tracked delays, identical on every host
        (multi-host tracking; None otherwise)."""
        al = self.align
        if al is not None and al.synced and al.delay_fleet is not None:
            return al.fleet_delay_s
        return None

    @property
    def delay_history(self) -> list:
        return [] if self.align is None else self.align.history

    def reset(self):
        self.pipeline.reset()
        return self

    # -- checkpoint/restart ----------------------------------------------
    #
    # The reference's layout (a directory every host can reach):
    #
    #   ckpt_dir/shared/step_W/          process 0 only: state that is
    #                                    the same on every host (the
    #                                    frontier slots, the tracker's
    #                                    origin and fleet EMA, the
    #                                    health machine)
    #   ckpt_dir/group_{gid:05d}/step_W/ the owning host: one GLOBAL
    #                                    device group's carry slices
    #
    # Keyed by global group, a checkpoint restores under any process
    # count and host<-group assignment, each host gathering the groups
    # it now owns.  Every saved array is the exact carry, so a restored
    # run continues the left folds bit-identically.  Each carry tensor crosses to the
    # host once per checkpoint and is sliced per group in numpy; restore
    # assembles each carry in numpy and moves it to the device once.
    # The dense attribution integrals are saved as the reference's
    # per-group dicts of patterns.

    @property
    def _ckpt_group_ids(self) -> list:
        if self.shard is not None:
            return [int(g) for g in self.shard.group_ids]
        return list(range(len(self.group_sizes)))

    def _ckpt_config(self) -> dict:
        """Pipeline-shape fingerprint, the reference's field for field
        (plain Python values, numpy's dtype spelling): restore refuses
        a checkpoint written by a differently configured pipeline."""
        gs = (self.shard.global_group_sizes if self.shard is not None
              else self.group_sizes)
        al = self.align
        return {
            "global_group_sizes": [int(s) for s in gs],
            "n_phases": int(self.attr.n_phases),
            "grid_origin": float(self.fuse.origin),
            "grid_step": float(self.fuse.step),
            "track": al is not None,
            "synced": bool(al is not None and al.synced),
            "window": int(self._window),
            "hop": int(self._hop),
            "tail": int(self._tail_width),
            "var_floor": float(self._var_floor),
            "health": self.health_stage is not None,
            "meter": self.meter_stage is not None,
            "dtype": str(np.dtype(self._np_dtype)),
        }

    def _shared_state(self) -> dict:
        al, hs, fz = self.align, self.health_stage, self.fuse
        i64 = np.int64
        tree = {
            "windows": np.asarray([self.pipeline.windows], i64),
            "fuse": {
                "next_slot": np.asarray([fz.carry.next_slot], i64),
                "last_frontier": np.asarray(
                    [np.nan if fz.last_frontier is None
                     else fz.last_frontier], np.float64),
                "dq_slots": np.asarray([fz.dq_slots], i64),
            },
        }
        if al is not None:
            tree["align"] = {
                "origin": np.asarray([np.nan if al.origin is None
                                      else al.origin], np.float64),
                "next_slot": np.asarray([al.carry.next_slot], i64),
                "last_est_slot": np.asarray([al.carry.last_est_slot],
                                            i64)}
            if al.synced:
                tree["align"]["delay_fleet"] = np.asarray(al.delay_fleet,
                                                          np.float64)
                tree["align"]["seen_fleet"] = np.asarray(al._seen_fleet,
                                                         bool)
        if hs is not None:
            tree["health"] = {
                "state": np.asarray(hs.state, i64),
                "flag_streak": np.asarray(hs.flag_streak, i64),
                "clean_streak": np.asarray(hs.clean_streak, i64),
                "ema_bias": np.asarray(hs.ema_bias, np.float64),
                "ema_rms": np.asarray(hs.ema_rms, np.float64),
                "ema_refresh": np.asarray(hs.ema_refresh, np.float64),
                "ema_seen": np.asarray(hs._ema_seen, bool),
                "refresh_seen": np.asarray(hs._refresh_seen, bool),
                "bias": np.asarray(hs.bias, np.float64),
                "rms": np.asarray(hs.rms, np.float64),
                "dropout": np.asarray(hs.dropout, np.float64),
                "windows": np.asarray([hs.windows], i64),
            }
        return tree

    def _shared_skeleton(self) -> dict:
        """Zeros tree matching ``_shared_state`` leaf for leaf (shape
        and dtype: ``restore_checkpoint`` validates both)."""
        al, hs = self.align, self.health_stage
        i1 = lambda: np.zeros((1,), np.int64)          # noqa: E731
        f1 = lambda: np.zeros((1,), np.float64)        # noqa: E731
        tree = {"windows": i1(),
                "fuse": {"next_slot": i1(), "last_frontier": f1(),
                         "dq_slots": i1()}}
        if al is not None:
            tree["align"] = {"origin": f1(), "next_slot": i1(),
                             "last_est_slot": i1()}
            if al.synced:
                g = int(self.shard.row_offsets[-1])
                tree["align"]["delay_fleet"] = np.zeros((g,), np.float64)
                tree["align"]["seen_fleet"] = np.zeros((g,), bool)
        if hs is not None:
            g = hs.n_global
            gi = lambda: np.zeros((g,), np.int64)      # noqa: E731
            gf = lambda: np.zeros((g,), np.float64)    # noqa: E731
            gb = lambda: np.zeros((g,), bool)          # noqa: E731
            tree["health"] = {
                "state": gi(), "flag_streak": gi(), "clean_streak": gi(),
                "ema_bias": gf(), "ema_rms": gf(), "ema_refresh": gf(),
                "ema_seen": gb(), "refresh_seen": gb(),
                "bias": gf(), "rms": gf(), "dropout": gf(),
                "windows": i1()}
        return tree

    def _group_skeleton(self, k: int, meta: dict) -> dict:
        """Zeros tree matching one saved group slice (k streams)."""
        dt = self._np_dtype
        T = self._tail_width
        tree = {
            "ingest": {"t": np.zeros((k, 1), dt),
                       "v": np.zeros((k, 1), dt),
                       "t_first": np.zeros((k,), np.float64),
                       "dq_late": np.zeros((k,), np.int64),
                       "dq_masked": np.zeros((k,), np.int64)},
            "fuse": {"tail_t": np.zeros((k, T), dt),
                     "tail_v": np.zeros((k, T), dt),
                     "tail_dropped": np.zeros((k,), np.float64),
                     "n_k": np.zeros((k,), np.float64),
                     "ssr": np.zeros((k,), np.float64),
                     "t_first": np.zeros((k,), np.float64),
                     "dq_covered": np.zeros((k,), np.int64)},
            "attr": {"t_prev": np.zeros((1,), np.float64),
                     "integrals": {
                         str(p): np.zeros((self.attr.n_phases, k))
                         for p in meta["attr_patterns"]}},
        }
        if self.align is not None:
            tree["align"] = {
                "ring_v": np.zeros((k, self._window), dt),
                "ring_m": np.zeros((k, self._window), bool),
                "delay": np.zeros((k,), np.float64),
                "seen": np.zeros((k,), bool),
                "tail_t": np.zeros((k, T), dt),
                "tail_v": np.zeros((k, T), dt),
                "tail_dropped": np.zeros((k,), np.float64)}
        if self.meter_stage is not None:
            tree["meter"] = {
                "t_prev": np.zeros((1,), np.float64),
                "integrals": {
                    str(p): np.zeros((self.meter_stage.n_phases, k))
                    for p in meta["meter_patterns"]}}
        if self.health_stage is not None:
            from repro_torch.health.stage import N_STATS
            tree["health"] = {"pending": np.zeros((N_STATS, k))}
        return tree

    def _row_carries(self) -> dict:
        """The per-row carries as the saved group trees name them, on
        the host: one copy per tensor."""
        ing, fz = self.ingest, self.fuse
        tree = {
            "ingest": {"t": ing.carry.t, "v": ing.carry.v,
                       "t_first": ing._t_first, "dq_late": ing.dq_late,
                       "dq_masked": ing.dq_masked},
            "fuse": {"tail_t": fz._tail.carry.t, "tail_v": fz._tail.carry.v,
                     "tail_dropped": fz._tail.carry.dropped_t,
                     "n_k": fz.carry.n_k, "ssr": fz.carry.ssr,
                     "t_first": fz._t_first, "dq_covered": fz.dq_covered},
        }
        if self.align is not None:
            ac, tc = self.align.carry, self.align._tail.carry
            tree["align"] = {"ring_v": ac.ring_v, "ring_m": ac.ring_m,
                             "delay": ac.delay, "seen": ac.seen,
                             "tail_t": tc.t, "tail_v": tc.v,
                             "tail_dropped": tc.dropped_t}
        return {sec: {k: x.detach().cpu().numpy() for k, x in d.items()}
                for sec, d in tree.items()}

    def _phase_stages(self) -> dict:
        """{saved section: stage} of the dense per-pattern integrals."""
        out = {"attr": self.attr}
        if self.meter_stage is not None:
            out["meter"] = self.meter_stage
        return out

    def checkpoint(self, ckpt_dir, *, keep: int = 3) -> int:
        """Write one checkpoint at the current window boundary (between
        ``update`` calls; every host at the same boundary in multi-host
        mode, though it is not a collective); returns its step, the
        windows processed.  Each host writes the groups it owns, and
        process 0 the shared state."""
        from repro_torch.train.checkpoint import save_checkpoint
        assert self.pipeline.windows > 0, \
            "checkpoint() before the first update has nothing to save"
        assert self.align is None or self.align._pending is None, \
            "checkpoint() must run at a window boundary (a pending " \
            "tracker contribution would be lost)"
        step = int(self.pipeline.windows)
        root = Path(ckpt_dir)
        cfg = self._ckpt_config()
        rows = self._row_carries()
        dense = {sec: (st.carry.t_prev.cpu().numpy(),
                       st.carry.integrals.cpu().numpy())
                 for sec, st in self._phase_stages().items()}
        hs = self.health_stage
        if hs is not None:
            from repro_torch.health.stage import N_STATS
            pend = np.zeros((N_STATS, hs.n_global))
            if hs._pending is not None:
                pend[:, hs.row_ids] = hs._pending.cpu().numpy()[:N_STATS]
        lo = 0
        for j, (gid, k) in enumerate(zip(self._ckpt_group_ids,
                                         self.group_sizes)):
            sl = slice(lo, lo + k)
            tree = {sec: {name: a[sl] for name, a in d.items()}
                    for sec, d in rows.items()}
            meta = {"config": cfg, "gid": gid}
            for sec, (t_prev, ints) in dense.items():
                # the patterns that integrated anything: a pattern seen
                # but integrating exactly 0 adds 0 to every total
                pats = [p for p in range(1, ints.shape[1])
                        if ints[j, p].any()]
                tree[sec] = {"t_prev": t_prev[j:j + 1], "integrals": {
                    str(p): np.ascontiguousarray(ints[j, p, :, :k])
                    for p in pats}}
                meta[f"{sec}_patterns"] = pats
            if hs is not None:
                tree["health"] = {"pending": pend[:, hs.row_ids[sl]]}
            save_checkpoint(root / f"group_{gid:05d}", step, tree,
                            keep=keep, extra_meta=meta)
            lo += k
        if self.collectives is None or self.collectives.process_id == 0:
            save_checkpoint(
                root / "shared", step, self._shared_state(), keep=keep,
                extra_meta={"config": cfg,
                            "suggested": (dict(hs._suggested)
                                          if hs is not None else {})})
        return step

    def _resolve_ckpt_step(self, root, step):
        """Largest step published by ``shared`` and EVERY global group
        dir: the same answer on every host, and a kill that landed
        mid-checkpoint drops that step for everyone."""
        n_groups = len(self._ckpt_config()["global_group_sizes"])
        common = _published_steps(root / "shared")
        for gid in range(n_groups):
            common &= _published_steps(root / f"group_{gid:05d}")
        if step is not None:
            if int(step) not in common:
                raise FileNotFoundError(
                    f"checkpoint step {step} is not complete under "
                    f"{root} (published everywhere: {sorted(common)})")
            return int(step)
        if not common:
            raise FileNotFoundError(
                f"no complete checkpoint under {root}")
        return max(common)

    def restore(self, ckpt_dir, *, step: int = None) -> int:
        """Reload the carries of :meth:`checkpoint` (written by this
        package or the reference); returns the window count it was
        taken at (the replay skip count).  Elastic: this host gathers the
        global groups it owns now, whatever process count and
        assignment wrote them.

        Trailing padding rows replicate the last real row, the state an
        uninterrupted run holds (``update`` pads its inputs the same
        way); the tracker's padding rows keep delay 0 and ``seen``
        False.  The ingest stage's ``_unseeded`` is not saved, as in
        the reference: a row still dark at the checkpoint is not
        reseeded after a restore.
        """
        from repro_torch.train.checkpoint import (checkpoint_meta,
                                                  restore_checkpoint)
        root = Path(ckpt_dir)
        step = self._resolve_ckpt_step(root, step)
        shared_meta, _ = checkpoint_meta(root / "shared", step=step)
        cfg = self._ckpt_config()
        assert dict(shared_meta["config"]) == cfg, \
            f"checkpoint config mismatch:\n  saved {shared_meta['config']}" \
            f"\n  self  {cfg}"
        shared, _, _ = restore_checkpoint(
            root / "shared", self._shared_skeleton(), step=step)
        groups = []
        for gid, k in zip(self._ckpt_group_ids, self.group_sizes):
            gdir = root / f"group_{gid:05d}"
            gmeta, _ = checkpoint_meta(gdir, step=step)
            assert dict(gmeta["config"]) == cfg, \
                f"group {gid}: checkpoint config mismatch"
            assert int(gmeta["gid"]) == gid
            groups.append(restore_checkpoint(
                gdir, self._group_skeleton(k, gmeta), step=step)[0])

        n, pad = self.n_streams, self.n_rows - self.n_streams
        al, hs = self.align, self.health_stage
        dev = self.device

        def rows(sec, name, fill=None):
            """One carry: the groups' slices in row order, padding rows
            replicating the last real row (or ``fill``), on the device."""
            a = np.concatenate([g[sec][name] for g in groups])
            if pad:
                tail = (np.repeat(a[-1:], pad, axis=0) if fill is None
                        else np.full((pad,) + a.shape[1:], fill, a.dtype))
                a = np.concatenate([a, tail])
            return torch.as_tensor(a, device=dev)

        def streams(sec, name):
            return torch.as_tensor(
                np.concatenate([g[sec][name] for g in groups]), device=dev)

        ing = self.ingest
        ing.carry = IngestCarry(t=rows("ingest", "t"), v=rows("ingest", "v"))
        ing._t_first = rows("ingest", "t_first")
        ing._unseeded = None
        ing.dq_late = rows("ingest", "dq_late")
        ing.dq_masked = rows("ingest", "dq_masked")
        ing.dq_last = {}
        fz, sf = self.fuse, shared["fuse"]
        fz._tail.carry = TailCarry(t=rows("fuse", "tail_t"),
                                   v=rows("fuse", "tail_v"),
                                   dropped_t=rows("fuse", "tail_dropped"))
        fz.carry = FuseCarry(next_slot=int(sf["next_slot"][0]),
                             n_k=streams("fuse", "n_k"),
                             ssr=streams("fuse", "ssr"))
        lf = float(sf["last_frontier"][0])
        fz.last_frontier = None if np.isnan(lf) else lf
        fz._t_first = rows("fuse", "t_first")
        fz.dq_covered = streams("fuse", "dq_covered")
        fz.dq_slots = int(sf["dq_slots"][0])
        fz.dq_last_coverage = torch.ones((n,), dtype=_F64, device=dev)
        fz.dq_low_coverage = torch.zeros((n,), dtype=torch.bool,
                                         device=dev)
        if al is not None:
            sa = shared["align"]
            origin = float(sa["origin"][0])
            al.origin = None if np.isnan(origin) else origin
            al.carry = AlignCarry(
                ring_v=rows("align", "ring_v"),
                ring_m=rows("align", "ring_m"),
                next_slot=int(sa["next_slot"][0]),
                last_est_slot=int(sa["last_est_slot"][0]),
                delay=rows("align", "delay", 0.0),
                seen=rows("align", "seen", False))
            al._tail.carry = TailCarry(
                t=rows("align", "tail_t"), v=rows("align", "tail_v"),
                dropped_t=rows("align", "tail_dropped"))
            al._pending = None
            if al.synced:
                al.delay_fleet = np.asarray(sa["delay_fleet"], np.float64)
                al._seen_fleet = np.asarray(sa["seen_fleet"], bool)
        for sec, st in self._phase_stages().items():
            ints = np.zeros(tuple(st.carry.integrals.shape))
            for j, (g, k) in enumerate(zip(groups, self.group_sizes)):
                for p, a in g[sec]["integrals"].items():
                    ints[j, int(p), :, :k] = a
            st.carry = FusedAttrCarry(t_prev=streams(sec, "t_prev"),
                                      integrals=torch.as_tensor(
                                          ints, device=dev))
        if hs is not None:
            sh = shared["health"]
            for name in ("state", "flag_streak", "clean_streak",
                         "ema_bias", "ema_rms", "ema_refresh", "bias",
                         "rms", "dropout"):
                setattr(hs, name, sh[name])
            hs._ema_seen = sh["ema_seen"]
            hs._refresh_seen = sh["refresh_seen"]
            hs.windows = int(sh["windows"][0])
            from repro_torch.health.stage import N_STATS
            pend = np.zeros((N_STATS, hs.n_global))
            lo = 0
            for g, k in zip(groups, self.group_sizes):
                pend[:, hs.row_ids[lo:lo + k]] = g["health"]["pending"]
                lo += k
            # a saved all-zeros block folds exactly like no pending
            # block (a fold of zeros updates nothing)
            hs._pending = torch.as_tensor(pend[:, hs.row_ids], device=dev)
            hs._delays = None
            hs._suggested = dict(shared_meta.get("suggested", {}))
        self.pipeline.windows = int(shared["windows"][0])
        return self.pipeline.windows


def _published_steps(d) -> set:
    """Step numbers atomically published under one checkpoint dir."""
    d = Path(d)
    if not d.exists():
        return set()
    return {int(p.name.split("_")[1]) for p in d.iterdir()
            if p.is_dir() and p.name.startswith("step_")
            and not p.name.endswith(".tmp")}


def _unsupported(cfg):
    """Refuse the Pallas knobs (``interpret=True``, ``use_kernel=False``)
    instead of ignoring them: the port's CPU path is ``device="cpu"``."""
    todo = []
    if cfg.stream.interpret:
        todo.append("interpret=True")
    if cfg.stream.use_kernel is False:
        todo.append("use_kernel=False")
    if todo:
        raise NotImplementedError(
            "repro_torch's attribute_energy_fused_streaming does not "
            "support " + ", ".join(todo) + " yet")


def attribute_energy_fused_streaming(trace_groups, phases, *,
                                     config=None, reference=None,
                                     corrections=None, registry=None,
                                     meter=None,
                                     return_pipe: bool = False,
                                     on_window=None, device=None,
                                     **legacy) -> list:
    """The streaming fused-attribution pipeline on the device.

    trace_groups: [[SensorTrace, ...], ...] — all sensors observing one
    device per group.  The traces are packed once on the host and
    REPLAYED through ``StreamingFusedPipeline`` in chunk-column windows.
    phases: [(name, a, b)] absolute seconds.  Returns one
    ``[PhaseEnergy]`` per group (and the pipeline with
    ``return_pipe=True``).

    config: a ``fleet.config.PipelineConfig`` (or one section); the flat
    legacy kwargs resolve through ``resolve_config`` with a
    ``DeprecationWarning``, as in the reference.  ``StreamConfig.grid``
    (absolute) pins the output grid.  reference: a ``PiecewisePower``
    (anything with ``power_at``, absolute seconds) or a callable in
    pipeline time.  corrections: a ``core.calibration.Corrections``,
    applied per trace before packing.  ``PipelineConfig.health`` (True
    or a ``health.HealthConfig``) composes the health stage and
    ``PipelineConfig.dq`` (a ``DataQualityPolicy``) the data-quality
    policy; registry: a ``health.HealthRegistry`` for telemetry export;
    meter: ``SlotSegment``s (absolute seconds, like phases) compose a
    ``MeteringStage`` (``pipe.request_energies()`` with
    ``return_pipe=True``).  ``CheckpointConfig(dir=, every=K)`` writes a
    checkpoint every K replay windows; ``resume=True`` reloads the newest
    complete one (a cold start when none is published) and skips the
    windows it already folded, bit-identically to an uninterrupted run.
    ``on_window(pipe, w)`` fires after window ``w`` (1-based).  device:
    None means CUDA (raises without a card); pass "cpu" for the plain
    PyTorch versions of the kernels.

    engine: ``"windowed"`` drives the per-window stage chain (the
    oracle); ``"scan"`` plans the same replay on the host and runs it as
    one loop of fixed-size steps on the device
    (``fleet.scan.attribute_totals_fused_scan``), with no health stage,
    meter, checkpoints or ``return_pipe``, as in the reference.
    ``StreamConfig(host=True)``: the reference's float64 mirror, on the
    CPU (a CUDA ``device`` raises ``ValueError``).
    """
    cfg = resolve_config(config, legacy,
                         "attribute_energy_fused_streaming")
    _unsupported(cfg)
    engine, host = cfg.stream.engine, cfg.stream.host
    dev = _host_device(device, host)
    chunk = cfg.stream.chunk
    grid, grid_step = cfg.stream.grid, cfg.stream.grid_step
    dtype, var_floor = cfg.stream.dtype, cfg.stream.var_floor
    track, delays = cfg.track.track, cfg.track.delays
    tail = cfg.track.tail
    groups = [list(g) for g in trace_groups]
    flat = [tr for g in groups for tr in g]
    rows = pack_stream_rows(flat, corrections=corrections,
                            use_t_measured=cfg.stream.use_t_measured,
                            dtype=dtype)
    # one pass over the rows (the reference scans them once per use)
    cadence = _min_cadence(rows)
    if grid is not None:
        grid = np.asarray(grid, np.float64)
        grid_step = float(np.median(np.diff(grid)))
        origin = float(grid[0]) - rows.t0
        t_end = float(grid[-1]) - rows.t0
    else:
        if grid_step is None:
            grid_step = 0.5 * cadence
        origin = float(rows.times[:rows.n_streams, 0]
                       .astype(np.float64).min())
        t_end = None
    if tail is None and engine == "windowed":
        # the scan engine has no carry tail: no cadence scan for it
        tail = default_tail(rows, chunk, delays=delays,
                            max_lag=cfg.track.max_lag, grid_step=grid_step,
                            cadence=cadence)
    ref = None
    if reference is not None:
        if hasattr(reference, "power_at"):
            t0 = rows.t0
            ref = lambda t, _r=reference: _r.power_at(t + t0)  # noqa: E731
        else:
            ref = reference
    if not phases:
        return [[] for _ in groups]
    windows = [(a - rows.t0, b - rows.t0) for _, a, b in phases]
    assert engine in ("windowed", "scan"), engine
    if cfg.health:
        assert engine == "windowed", \
            "the health stage composes with the windowed engine only"
    if meter:
        assert engine == "windowed", \
            "the metering stage composes with the windowed engine only"
        meter = [s.shifted(-rows.t0) for s in meter]
    ckpt_dir, every = cfg.checkpoint.dir, cfg.checkpoint.every
    if ckpt_dir is not None or cfg.checkpoint.resume \
            or on_window is not None:
        assert engine == "windowed", \
            "checkpointing drives the windowed engine only"
    if engine == "scan":
        assert not return_pipe, "return_pipe needs the windowed engine"
        from repro_torch.fleet.scan import attribute_totals_fused_scan
        totals = attribute_totals_fused_scan(
            rows, [len(g) for g in groups], windows, grid_origin=origin,
            grid_step=grid_step, t_end=t_end, chunk=chunk, delays=delays,
            reference=ref, track=track, window=cfg.track.window,
            hop=cfg.track.hop, max_lag=cfg.track.max_lag,
            ema=cfg.track.ema, var_floor=var_floor, host=host,
            device=dev).totals
        return _phase_rows(phases, totals)
    pipe = StreamingFusedPipeline(
        [len(g) for g in groups], windows, grid_origin=origin,
        grid_step=grid_step, kind_row=rows.kind_row, delays=delays,
        reference=ref, track=track, window=cfg.track.window,
        hop=cfg.track.hop, max_lag=cfg.track.max_lag, ema=cfg.track.ema,
        tail=tail, var_floor=var_floor, dtype=dtype, health=cfg.health,
        registry=registry, health_names=[tr.name for tr in flat],
        meter=meter, dq_policy=cfg.dq, device=dev, host=host)
    start_w = 0
    if cfg.checkpoint.resume:
        assert ckpt_dir is not None, "resume=True needs checkpoint_dir"
        try:
            start_w = pipe.restore(ckpt_dir)
        except FileNotFoundError:
            start_w = 0          # cold start: nothing published yet
    for w, (t_blk, v_blk) in enumerate(
            stream_row_windows(rows, chunk, cadence=cadence), start=1):
        if w <= start_w:
            continue             # replayed windows: already folded
        pipe.update(t_blk, v_blk)
        if ckpt_dir is not None and every and w % every == 0:
            pipe.checkpoint(ckpt_dir)
        if on_window is not None:
            on_window(pipe, w)
    pipe.finalize(t_end)
    out = _phase_rows(phases, pipe.totals().cpu().numpy())
    return (out, pipe) if return_pipe else out


def _phase_rows(phases, totals) -> list:
    """(n_devices, n_phases) joules -> one ``[PhaseEnergy]`` per device."""
    from repro_torch.core.attribution import PhaseEnergy
    out = []
    for row_e in totals:
        row = []
        for (name, a, b), e in zip(phases, row_e):
            dur = max(b - a, 1e-12)
            row.append(PhaseEnergy(name, a, b, float(e), float(e / dur)))
        out.append(row)
    return out
