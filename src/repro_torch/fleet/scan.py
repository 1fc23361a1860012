"""The fused-scan replay engine (port of the reference's
``attribute_totals_fused_scan``, reached through
``attribute_energy_fused_streaming(engine="scan")``).

The host plans the whole replay once; the device then runs every
Reconstruct -> Regrid/Fuse -> PhaseAttribute step of it:

  closed rows   the packed rows with the seed column prepended, every
                counter row reconstructed once at full width
                (``power_reconstruct_rows``);
  track         the online tracker replayed: one hold resample at every
                track slot (``grid_resample``), one lag-bank score per
                hop fire (``xcorr_align``), the ``min_corr`` gate and the
                EMA fold, as ``AlignTrackStage`` does;
  plan          the emit schedule with RegridFuse's frontier margins,
                re-chunked into ``scan_block``-slot steps, and each
                step's per-row search slice (host numpy, the reference's
                arithmetic: ``np.array_equal`` plans);
  steps         one loop over the planned steps of PyTorch ops on the
                device, carrying float64 fusion statistics and
                per-(device, pattern, phase, stream) integrals.  Every
                step's inputs are copied once before the loop, which
                reads nothing back: no host sync, no float atomics.

The reference runs the step loop as one jitted ``lax.scan``; here it is
a Python loop over fixed-size steps (one launch of each op a step).
``host=True`` is the reference's float64 mirror on the CPU for the
closed rows and the tracker; the step loop is the same either way.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.align.delay import RefbankCache
from repro_torch.device import refuse_unported
from repro_torch.fleet.packing import _round_up
from repro_torch.fleet.pipeline import (MAX_GROUP, StreamRows, _F64,
                                        _GroupLayout, _host_device,
                                        _ivw_weights, _pattern_totals,
                                        _query_grid, _replay_window_plan,
                                        _slot_grid, _track_estimate)
from repro_torch.kernels.power_reconstruct.kernel import (
    power_reconstruct_rows_kernel)
from repro_torch.kernels.power_reconstruct.ref import (
    reconstruct_power_rows_ref)


def _scan_closed_rows(rows: StreamRows, *, host: bool, device):
    """Full-run closed rows -> (t_aug host numpy, v_aug tensor on
    ``device``, t_first float64 host numpy).

    Over a full replay the union of the per-window closed windows is the
    packed rows with the seed column prepended (the replica columns a
    replay pads in are invisible to the hold lower bound, and dE/dt is
    interval-local), so one reconstruction of the full rows gives every
    query the source samples the windowed chain gives it.
    """
    t = rows.times
    v = rows.values
    kind = np.asarray(rows.kind_row, bool).reshape(-1)
    t_aug = np.concatenate([t[:, :1], t], axis=1)
    v_aug = torch.as_tensor(np.concatenate([v[:, :1], v], axis=1),
                            device=device)
    # IngestStage's convention: counters open at the first strict advance
    # past the seed, power rows at the seed
    t64 = t_aug.astype(np.float64)
    adv = t64 > t64[:, :1]
    j = np.argmax(adv, axis=1)
    tf = np.where(adv.any(axis=1), t64[np.arange(len(j)), j], np.inf)
    t_first = np.where(kind, tf, t64[:, 0])
    if kind.any():
        f = t.shape[0]
        if host:
            power = reconstruct_power_rows_ref(
                v_aug.to(_F64), torch.as_tensor(t64),
                torch.zeros((f, 1), dtype=_F64))
        else:
            power = power_reconstruct_rows_kernel(
                v_aug, torch.as_tensor(t_aug, device=device),
                torch.zeros((f, 1), dtype=v_aug.dtype, device=device))
        v_aug = torch.where(torch.as_tensor(kind, device=device)[:, None],
                            power.to(v_aug.dtype), v_aug)
    return t_aug, v_aug, t_first


def _scan_track_delays(rows: StreamRows, rows_t, rows_v, t_first, last_t,
                       n_win: int, *, group_sizes, reference,
                       grid_step: float, window: int, hop: int,
                       max_lag: int, ema: float, min_corr: float,
                       min_fill, delay0, host: bool):
    """AlignTrack replayed over the whole run -> (delays_win (n_win, F)
    float64 host numpy, history).

    The online tracker's ring is a sliding view of one uniform track
    grid filled through the hold resample, so the replay resamples the
    closed rows at every track slot up to the last fire in one call and
    slices each fire's window out of it.  The hop schedule, the scores,
    the ``min_corr`` gate and the EMA fold are the windowed tracker's
    (``_track_estimate``), so ``delays_win[w]`` is the delay vector the
    windowed chain applies to replay window ``w``.  rows_t/rows_v/t_first
    are tensors on the scan's device.
    """
    f = rows.shape[0]
    n = rows.n_streams
    dev = rows_v.device
    step = float(grid_step)
    origin = float(rows.times[:n, 0].astype(np.float64).min())
    delay = torch.zeros((f,), dtype=_F64, device=dev)
    if delay0 is not None:
        d0 = np.asarray(delay0, np.float64).reshape(-1)
        delay[:len(d0)] = torch.as_tensor(d0, device=dev)
    seen = torch.zeros((f,), dtype=torch.bool, device=dev)
    min_fill = window // 2 if min_fill is None else int(min_fill)

    # hop schedule: the replay windows that fire a re-estimate (the
    # online ring's -0.01-step fill margin)
    next_slot, last_est = 0, 0
    fires = {}                       # window index -> ring frontier slot
    for w in range(n_win):
        frontier = float(last_t[:, w].min())
        hi = int(np.floor((frontier - origin) / step - 0.01))
        if hi >= next_slot:
            next_slot = hi + 1
        if next_slot - last_est >= hop and next_slot >= min_fill:
            fires[w] = next_slot
            last_est = next_slot
    if not fires:
        return np.repeat(delay.cpu().numpy()[None], n_win, axis=0), []

    # one resample at every track slot the ring will ever hold (slots
    # < 0 stay the ring's zero-initialized prefix)
    grid64 = _slot_grid(origin, step, 0, max(fires.values()) - 1, dev)
    vals, mask = _query_grid(rows_t, rows_v, grid64,
                             torch.zeros((f,), dtype=_F64, device=dev),
                             t_first, host=host)
    banks = RefbankCache()
    per_win, history = [], []
    for w in range(n_win):
        ns = fires.get(w)
        if ns is not None:
            lo = ns - window
            v_win, m_win = vals[:, max(lo, 0):ns], mask[:, max(lo, 0):ns]
            if lo < 0:
                v_win = torch.cat([v_win.new_zeros((f, -lo)), v_win], dim=1)
                m_win = torch.cat([m_win.new_zeros((f, -lo)), m_win], dim=1)
            delay, seen, point = _track_estimate(
                v_win, m_win, origin + step * np.arange(lo, ns), delay,
                seen, n=n, reference=reference, groups=group_sizes,
                step=step, max_lag=max_lag, ema=ema, min_corr=min_corr,
                banks=banks, host=host)
            history.append(point)
        per_win.append(delay)
    return torch.stack(per_win).cpu().numpy(), _history_to_host(history)


def _history_to_host(history) -> list:
    """The tracker's points with their per-stream tensors as host numpy
    (one copy per field)."""
    if not history:
        return []
    fields = {k: torch.stack([getattr(p, k) for p in history]).cpu()
              .numpy() for k in ("raw", "ema", "peak")}
    return [dataclasses.replace(p, **{k: v[i] for k, v in fields.items()})
            for i, p in enumerate(history)]


@dataclasses.dataclass
class ScanPlan:
    """The host's plan of the step loop (the reference's scan inputs)."""
    lo: np.ndarray             # (T,) int64 first slot of each step
    cnt: np.ndarray            # (T,) int32 slots in each step
    starts: np.ndarray         # (max(T, 1), F) int32 search-slice starts
    d32: np.ndarray            # (T, F) float32 delays of each step
    width: int                 # search-slice columns
    n_slots: int               # grid slots emitted

    @property
    def n_steps(self) -> int:
        return len(self.lo)


def _scan_plan(rows: StreamRows, rows_t: np.ndarray, delays_win, last_t,
               t_end, *, origin: float, step: float,
               scan_block: int) -> ScanPlan:
    """The emit schedule, the steps and their search slices (host numpy).

    Tracked (``last_t`` given): replay window ``w`` emits the slots its
    frontier closes, with RegridFuse's floors and margins, under
    ``delays_win[w]``.  Untracked: the delays are constant, so one range
    up to the flush covers the run.  Then the flush window, the
    re-chunking into ``scan_block``-slot steps (each inside one emitted
    window, so it carries that window's delays), and each step's
    per-row search slice: the step's first and last float32 queries
    bracketed by two ``searchsorted`` calls a row, one ``width`` that
    covers the widest step.
    """
    f = rows.shape[0]
    n = rows.n_streams
    emits = []
    next_slot = 0
    if last_t is not None:
        for w in range(len(delays_win)):
            frontier = float((last_t[:, w] - delays_win[w, :n]).min())
            hi = int(np.floor((frontier - origin) / step - 0.01))
            if hi >= next_slot:
                emits.append((next_slot, hi, w))
                next_slot = hi + 1
        if t_end is None:
            t_end = float((last_t[:, -1] - delays_win[-1, :n]).max())
    elif t_end is None:
        last_real = rows.times[np.arange(f), rows.n_samples - 1] \
            .astype(np.float64)
        t_end = float((last_real[:n] - delays_win[0, :n]).max())
    hi = int(np.floor((float(t_end) - origin) / step + 1e-9))
    if hi >= next_slot:                   # the flush window
        emits.append((next_slot, hi, len(delays_win) - 1))
        next_slot = hi + 1

    blk = int(scan_block)
    step_lo, step_cnt, step_w = [], [], []
    for (lo, hi, w) in emits:
        c = lo
        while c <= hi:
            cc = min(blk, hi - c + 1)
            step_lo.append(c)
            step_cnt.append(cc)
            step_w.append(w)
            c += cc
    t_steps = len(step_lo)
    lo_arr = np.asarray(step_lo, np.int64)
    d32 = np.ascontiguousarray(
        delays_win[np.asarray(step_w, np.int64)].astype(np.float32))

    s_pad = rows_t.shape[1]
    width = min(64, s_pad)
    starts = np.zeros((max(t_steps, 1), f), np.int32)
    if t_steps:
        hi_arr = lo_arr + np.asarray(step_cnt, np.int64) - 1
        q_lo = (origin + step * lo_arr).astype(np.float32)[:, None] + d32
        q_hi = (origin + step * hi_arr).astype(np.float32)[:, None] + d32
        ends = np.zeros((t_steps, f), np.int64)
        for r in range(f):
            starts[:, r] = np.searchsorted(rows_t[r], q_lo[:, r],
                                           side="left")
            ends[:, r] = np.searchsorted(rows_t[r], q_hi[:, r],
                                         side="left")
        ends = np.minimum(ends, s_pad - 1)   # beyond-span queries mask
        width = int((ends - starts).max()) + 1
        width = min(max(_round_up(width, 64), 64), s_pad)
        starts = np.clip(starts, 0, s_pad - width).astype(np.int32)
    return ScanPlan(lo=lo_arr, cnt=np.asarray(step_cnt, np.int32),
                    starts=starts, d32=d32, width=width, n_slots=next_slot)


def _fused_scan_steps(xs, rows_t, rows_v, t_first32,
                      layout: _GroupLayout, phases, *, origin: float,
                      step: float, block: int, width: int):
    """Regrid + fuse + phase-attribute over every planned step, on the
    device -> (n_k, ssr, integrals) float64.

    ``xs``: the plan's (lo, cnt, starts, d32), already on the device.

    Queries are formed in the row dtype, bit for bit as ``_query_grid``
    forms them, and each step's hold lookup searches only the planned
    ``width``-column slice of every row (the plan proves it holds every
    lower bound the step's queries reach, so the indices are a full-row
    search's).  Statistics and integrals accumulate in float64 over
    fixed axes; per-stream sums leave the padded (D, k_max) layout by
    its one slot per stream, so no float atomics and a fixed fold order.
    """
    dev = rows_v.device
    d, k = layout.n_devices, layout.k_max
    n_pat = 1 << k
    n = int(layout.flat.shape[0])
    lo_all, cnt_all, starts_all, d32_all = xs
    iota = torch.arange(block, device=dev)
    cols = torch.arange(width, device=dev)
    t_last32 = rows_t[:, -1]
    gmask = layout.valid.to(_F64)[:, :, None]                 # (D, K, 1)
    a = phases[:, 0][:, None]                                 # (P, 1)
    blen = torch.clamp_min(phases[:, 1] - phases[:, 0], 0.0)[:, None]
    pows = (2.0 ** torch.arange(k, dtype=_F64, device=dev))[None, :, None]
    neg_inf = torch.full((d, 1), -torch.inf, dtype=_F64, device=dev)
    # the carry, float64 and updated in place by every step
    n_k = torch.zeros((n,), dtype=_F64, device=dev)
    ssr = torch.zeros((n,), dtype=_F64, device=dev)
    t_prev = torch.full((d,), -torch.inf, dtype=_F64, device=dev)
    seen = torch.zeros((d,), dtype=torch.bool, device=dev)
    integrals = torch.zeros((d, n_pat, phases.shape[0], k), dtype=_F64,
                            device=dev)
    for i in range(lo_all.shape[0]):
        grid64 = origin + step * (lo_all[i] + iota).to(_F64)
        ge = grid64.to(rows_t.dtype)[None, :] + d32_all[i][:, None]
        sl = starts_all[i][:, None] + cols[None, :]
        idx = torch.searchsorted(torch.gather(rows_t, 1, sl), ge,
                                 side="left")
        out = torch.gather(torch.gather(rows_v, 1, sl), 1,
                           idx.clamp_max(width - 1))
        mask = ((ge >= t_first32[:, None]) & (ge <= t_last32[:, None])
                & (iota < cnt_all[i])[None, :])
        vals = torch.where(mask, out, 0.0)
        # per-group fusion statistics (the RegridFuse carry update)
        vg = vals[layout.rows].to(_F64) * gmask              # (D, K, B)
        mg = mask[layout.rows].to(_F64) * gmask
        cnt_g = mg.sum(dim=1)                                # (D, B)
        m0 = (vg * mg).sum(dim=1) / torch.clamp_min(cnt_g, 1.0)
        resid = (vg - m0[:, None, :]) * mg
        n_k.add_(layout.scatter(mg.sum(dim=2)))
        ssr.add_(layout.scatter((resid * resid).sum(dim=2)))
        # t_lo bridging: an invalid slot folds into the next valid one
        anyv = cnt_g > 0
        run = torch.cummax(torch.where(anyv, grid64[None, :], -torch.inf),
                           dim=1).values
        t_lo = torch.maximum(torch.cat([neg_inf, run[:, :-1]], dim=1),
                             t_prev[:, None])
        first_ever = anyv & ~seen[:, None] \
            & (torch.cumsum(anyv.to(torch.int32), dim=1) == 1)
        t_lo = torch.where(first_ever, grid64[None, :], t_lo)
        # overlap of [t_lo, grid] with phase [a, b] as F(grid) - F(t_lo),
        # F(x) = clip(x - a, 0, b - a); invalid slots weigh zero
        f_g = torch.minimum(torch.clamp_min(grid64[None, :] - a, 0.0),
                            blen)                            # (P, B)
        f_lo = torch.minimum(torch.clamp_min(t_lo[:, None, :] - a[None],
                                             0.0), blen[None])
        ov = f_g[None] - f_lo                                # (D, P, B)
        # one (D, P, B) x (D, B, K) product per coverage pattern: no
        # (D, 2^K, ...) intermediate
        pat = (mg * pows).sum(dim=1)                         # (D, B)
        wt = (vg * mg).transpose(1, 2)                       # (D, B, K)
        for q in range(1, n_pat):
            sel = (pat == q).to(_F64)[:, None, :]
            integrals[:, q].add_(torch.bmm(ov * sel, wt))
        torch.maximum(t_prev, run[:, -1], out=t_prev)
        seen.logical_or_(anyv.any(dim=1))
    return n_k, ssr, integrals


@dataclasses.dataclass
class ScanResult:
    """What the fused-scan engine hands back (host numpy)."""
    totals: np.ndarray         # (n_devices, n_phases) fused joules
    weights: np.ndarray        # (n_streams,) end-of-run IVW weights
    delays: np.ndarray         # (n_streams,) final per-stream delay
    history: list              # [DelayTrackPoint] (tracked mode)
    n_steps: int               # scan steps executed
    n_slots: int               # grid slots emitted


def attribute_totals_fused_scan(rows: StreamRows, group_sizes, phases,
                                *, grid_origin: float, grid_step: float,
                                t_end: float = None, chunk: int = 1024,
                                delays=None, reference=None,
                                track: bool = None, window: int = 2048,
                                hop: int = 512, max_lag: int = 64,
                                ema: float = 0.5, min_corr: float = 0.2,
                                min_fill: int = None,
                                var_floor: float = 0.25,
                                scan_block: int = 512, interpret=None,
                                use_kernel=None, host: bool = False,
                                device=None) -> ScanResult:
    """The streaming chain as one planned loop of fixed-size steps.

    Plans on the host (the replay window edges of ``_replay_window_plan``
    when tracking, the tracker's delay schedule, the emit slot ranges and
    search slices), then runs every Reconstruct -> Regrid/Fuse ->
    PhaseAttribute step on ``device`` (None means CUDA) with no host
    round trip between steps.  Arguments mirror
    ``StreamingFusedPipeline``; ``scan_block`` is the slots a step.  The
    windowed chain is the parity oracle (<= 1e-5, tracked and
    untracked).  ``host=True`` runs the float64 mirror of the closed
    rows and the tracker on the CPU (a CUDA ``device`` raises).  The
    Pallas knobs (``interpret=True``, ``use_kernel=False``) are refused.
    Returns a ``ScanResult`` (host numpy).
    """
    refuse_unported("attribute_totals_fused_scan", interpret=interpret,
                    use_kernel=use_kernel)
    dev = _host_device(device, host)
    group_sizes = list(group_sizes)
    n = int(sum(group_sizes))
    assert n == rows.n_streams, (n, rows.n_streams)
    k_max = int(max(group_sizes))
    assert k_max <= MAX_GROUP, \
        f"fused scan holds 2^k coverage patterns per device (k={k_max})"
    f = rows.shape[0]
    if track is None:
        track = delays is None
    origin = float(grid_origin)
    step = float(grid_step)

    t_aug, v_aug, t_first = _scan_closed_rows(rows, host=host, device=dev)
    rows_t = np.concatenate([np.full((f, 1), -np.inf, t_aug.dtype), t_aug],
                            axis=1)
    rows_t_dev = torch.as_tensor(rows_t, device=dev)
    rows_v_dev = torch.cat([v_aug.new_zeros((f, 1)), v_aug], dim=1)
    t_first_dev = torch.as_tensor(t_first, device=dev)

    last_t = None
    if track:
        n_win, idx = _replay_window_plan(rows, chunk)
        cols = np.maximum(idx[:, 1:] - 1, np.maximum(idx[:, :-1] - 1, 0))
        last_t = np.take_along_axis(rows.times, cols,
                                    axis=1).astype(np.float64)[:n]
        delays_win, history = _scan_track_delays(
            rows, rows_t_dev, rows_v_dev, t_first_dev, last_t, n_win,
            group_sizes=group_sizes, reference=reference, grid_step=step,
            window=window, hop=hop, max_lag=max_lag, ema=ema,
            min_corr=min_corr, min_fill=min_fill, delay0=delays,
            host=host)
    else:
        d0 = np.zeros((f,), np.float64)
        if delays is not None:
            dv = np.asarray(delays, np.float64).reshape(-1)
            d0[:len(dv)] = dv
        delays_win = d0[None, :]
        history = []
    plan = _scan_plan(rows, rows_t, delays_win, last_t, t_end,
                      origin=origin, step=step, scan_block=scan_block)

    layout = _GroupLayout(group_sizes, dev)
    ph = torch.as_tensor(np.asarray(phases, np.float64).reshape(-1, 2),
                         device=dev)
    if plan.n_steps:
        # every step's inputs, copied to the device once
        xs = tuple(torch.as_tensor(a, device=dev) for a in (
            plan.lo, plan.cnt.astype(np.int64),
            plan.starts.astype(np.int64), plan.d32))
        n_k, ssr, integrals = _fused_scan_steps(
            xs, rows_t_dev, rows_v_dev, t_first_dev.to(rows_t_dev.dtype),
            layout, ph, origin=origin, step=step, block=int(scan_block),
            width=plan.width)
    else:
        n_k = torch.zeros((n,), dtype=_F64, device=dev)
        ssr = torch.zeros((n,), dtype=_F64, device=dev)
        integrals = torch.zeros((layout.n_devices, 1 << k_max, len(ph),
                                 k_max), dtype=_F64, device=dev)
    w_flat = _ivw_weights(n_k, ssr, var_floor)
    totals = _pattern_totals(integrals, layout.gather(w_flat))
    return ScanResult(totals=totals.cpu().numpy(),
                      weights=w_flat.cpu().numpy(),
                      delays=np.asarray(delays_win[-1][:n],
                                        np.float64).copy(),
                      history=history, n_steps=plan.n_steps,
                      n_slots=plan.n_slots)
