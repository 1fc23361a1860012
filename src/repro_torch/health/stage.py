"""Streaming sensor-health diagnostics (the paper's §V, made 24/7; port
of ``repro/health/stage.py``).

``SensorHealthStage`` sits between Regrid/Fuse and PhaseAttribute in
the streaming pipeline.  Every emitted grid window contributes one
``(N_STATS, n_global)`` float64 sufficient-statistics block per sensor
— residuals vs the healthy-sensor fused mean, value moments, refresh
and fused-transition counts — which rides the fuse stage's existing
framed frontier reduce (multi-host) or folds locally (single host).
Each folded block drives per-sensor diagnostic flags (bias, RMS,
dropout, stuck counter, aliasing via the Nyquist rule in
``core.aliasing``, tracker drift beyond the capture range), a
HEALTHY -> SUSPECT -> QUARANTINED -> RECOVERING state machine with
typed :class:`~repro_torch.health.events.HealthEvent` emission, and a
deterministic fusion mask fed back to the fuse/attribute stages.

Where the work runs: the per-window statistics block is computed on
the device from the emitted window's tensors (float32 window
arithmetic, float64 row sums, the group sums over a padded
(groups, k_max) row index; every float sum by ``core.reduce``, so a
row's statistics do not depend on how many rows or groups its host
holds) and stays there until the fold; the fold copies the
``(N_STATS, n)`` block to the host once (with the tracked delays for the
drift flag riding in the same copy, unless the tracker is synced and
the flag reads the shared fleet delays), and the state machine, streaks,
flags and events run on the host in numpy, as in the reference.  The
window itself never leaves the device.

Decisions folded from window ``w`` gate the masks applied from window
``w+1`` on; with every sensor healthy the masks are all-ones and the
fuse/attribute arithmetic is bypassed entirely, keeping results
bit-identical to a pipeline without the stage.  Single host: every
component of the block is written by this host (``row_ids`` places the
local rows among ``n_global``); multi-host, each host writes its rows
and the blocks are summed on the frontier frame.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.reduce import fixed_sum, fold_sum
from repro_torch.device import resolve_device
from repro_torch.health.events import (
    HEALTHY, SUSPECT, QUARANTINED, RECOVERING, HealthEvent)

# per-sensor sufficient-statistics layout (rows of the framed block);
# all components are additive float64 sums written by the owning host
# only, so the multi-host left fold is exact
N_STATS = 11
(_N_VALID,   # valid slots this sensor covered
 _N_EXP,     # slots where the group's healthy fused mean existed
 _R_SUM,     # sum of residuals vs the healthy fused mean
 _R_SQ,      # sum of squared residuals
 _V_SUM,     # sum of the sensor's valid values
 _V_SQ,      # sum of squared values
 _F_SUM,     # group: sum of the fused mean over its defined slots
 _F_SQ,      # group: sum of the squared fused mean
 _CHG,       # valid slot-to-slot value changes (refresh estimate)
 _TRANS,     # group: fused-mean mean-crossing count
 _T_LAST,    # last grid time of the window (owner-written)
 ) = range(N_STATS)


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Thresholds and pacing for the sensor health state machine.

    Streak counts are in folded windows: a sensor is SUSPECT after
    ``suspect_after`` consecutive flagged folds, QUARANTINED after
    ``quarantine_after`` more, RECOVERING after ``recover_after``
    consecutive clean folds, and HEALTHY again after its clean streak
    reaches ``2 * recover_after``.  Windows folding fewer than
    ``min_slots`` fused slots for a group leave its streaks untouched.
    """
    bias_limit_w: float = 15.0      # |mean residual| flag threshold
    rms_limit_w: float = 50.0       # residual RMS flag threshold
    dropout_frac: float = 0.5       # missing-slot fraction threshold
    stuck_var_frac: float = 0.01    # sensor var < frac * fused var
    stuck_floor_w2: float = 1.0     # fused var floor for stuck checks
    drift_frac: float = 0.9         # |delay| vs tracker capture range
    min_slots: int = 8              # fold participation floor
    dropout_min_changes: int = 1    # fewer refreshes/window = dropout
    suspect_after: int = 1
    quarantine_after: int = 2
    recover_after: int = 2
    ema: float = 0.25               # rolling bias/RMS fold factor
    recalibrate: bool = True        # emit offset suggestions
    recal_min_w: float = 1.0        # |EMA bias| floor for suggestions
    alias_quarantines: bool = False  # aliasing flag is advisory
    drift_quarantines: bool = True


class SensorHealthStage:
    """Rolling per-sensor diagnostics + quarantine between Fuse/Attr.

    group_sizes: this host's LOCAL groups (row order).  row_ids maps
    local rows to global fleet rows (``HostShard.row_ids``); single
    host passes nothing and local == global.  ``align`` (optional
    AlignTrackStage) provides tracked delays for the drift flag.
    ``registry`` (optional HealthRegistry) gets a ``health`` metrics
    source.  The stage composes like any other: ``update(gw)`` returns
    the (possibly quarantine-masked) window for the next stage.
    device: where the windows live (None means CUDA).
    """

    def __init__(self, group_sizes, config: HealthConfig = None, *,
                 grid_step: float, row_ids=None, n_global: int = None,
                 names=None, align=None, registry=None, device=None):
        self.device = resolve_device(device)
        self.group_sizes = list(group_sizes)
        self.n_streams = int(sum(self.group_sizes))
        self.cfg = config if config is not None else HealthConfig()
        self.step = float(grid_step)
        self.row_ids = (np.arange(self.n_streams, dtype=np.int64)
                        if row_ids is None
                        else np.asarray(row_ids, np.int64))
        assert self.row_ids.shape[0] == self.n_streams, \
            "row_ids must map every local row to its global id"
        self.n_global = (self.n_streams if n_global is None
                         else int(n_global))
        self.align = align
        if names is None:
            names = [f"s{gid}" for gid in range(self.n_global)]
        elif len(names) == self.n_streams != self.n_global:
            # local names only: place them at their global rows
            full = [f"s{gid}" for gid in range(self.n_global)]
            for ri, nm in zip(self.row_ids, names):
                full[int(ri)] = nm
            names = full
        assert len(names) == self.n_global, \
            "names must cover the global fleet (or the local rows)"
        self.names = list(names)
        sizes = np.asarray(self.group_sizes, np.int64)
        self._gidx = np.repeat(np.arange(len(sizes)), sizes)
        # the (groups, rows) indicator decides the dark-group fallback on
        # the host; the device sums a group over its padded row index
        self._ind = np.zeros((len(sizes), self.n_streams), np.float32)
        self._ind[self._gidx, np.arange(self.n_streams)] = 1.0
        k_max = int(sizes.max())
        rows = np.zeros((len(sizes), k_max), np.int64)
        member = np.zeros((len(sizes), k_max), np.float32)
        lo = 0
        for g, k in enumerate(sizes):
            rows[g, :k] = np.arange(lo, lo + k)
            member[g, :k] = 1.0
            lo += k
        self._grows = torch.as_tensor(rows, device=self.device)
        self._gmember = torch.as_tensor(member[..., None],
                                        device=self.device)
        self._gidx_dev = torch.as_tensor(self._gidx, device=self.device)
        self.reset()
        if registry is not None:
            registry.register_source("health", self.metrics)

    def reset(self):
        g = self.n_global
        self.state = np.zeros((g,), np.int64)
        self.flag_streak = np.zeros((g,), np.int64)
        self.clean_streak = np.zeros((g,), np.int64)
        self.ema_bias = np.zeros((g,))
        self.ema_rms = np.zeros((g,))
        self.ema_refresh = np.zeros((g,))
        self._ema_seen = np.zeros((g,), bool)
        self._refresh_seen = np.zeros((g,), bool)
        self.windows = 0           # folds so far (the event clock)
        self.events: list = []
        self.flags_last: dict = {}
        self.bias = np.zeros((g,))
        self.rms = np.zeros((g,))
        self.dropout = np.zeros((g,))
        self._counts: dict = {}
        self._suggested: dict = {}
        self._pending = None       # (N_STATS, n_streams) float64 device
        self._delays = None        # host delays fetched with the block
        return self

    # -- masks -----------------------------------------------------------

    def fusion_mask(self) -> np.ndarray:
        """(n_global,) True where the sensor may contribute to fusion
        (HEALTHY or SUSPECT) — identical on every host by construction."""
        return self.state <= SUSPECT

    def local_mask(self) -> np.ndarray:
        """(n_streams,) fusion mask restricted to this host's rows."""
        return self.fusion_mask()[self.row_ids]

    # -- the framed-stats producer/consumer pair -------------------------

    def take_pending(self) -> np.ndarray:
        """(N_STATS, n_global) stats accumulated since the last fold, on
        the host; clears the pending block (zeros, and no device
        traffic, when no window was emitted).  This is the stage's one
        device-to-host copy a window: the tracker's current delays, which
        the drift flag reads at the fold, ride in the same copy."""
        p = self._pending
        self._pending = None
        out = np.zeros((N_STATS, self.n_global))
        if p is None:
            return out
        al = self.align
        if (al is not None and al.carry is not None
                and not getattr(al, "synced", False)):
            d = al.delay_s[:self.n_streams].to(p.dtype)
            host = torch.cat([p, d[None]]).cpu().numpy()
            self._delays = host[N_STATS]
        else:
            host = p.cpu().numpy()
        out[:, self.row_ids] = host[:N_STATS]
        return out

    def fold(self, reduced) -> None:
        """Consume one all-reduced (or local) stats block: update the
        rolling diagnostics, streaks and state machines for EVERY
        global sensor.  All inputs are identical across hosts, so the
        transitions are too."""
        st = np.asarray(reduced, np.float64).reshape(
            N_STATS, self.n_global)
        self.windows += 1
        cfg = self.cfg
        n_valid, n_exp = st[_N_VALID], st[_N_EXP]
        upd = n_exp >= cfg.min_slots
        if not upd.any():
            return
        inv_v = 1.0 / np.maximum(n_valid, 1.0)
        inv_e = 1.0 / np.maximum(n_exp, 1.0)
        bias = st[_R_SUM] * inv_v
        rms = np.sqrt(np.maximum(st[_R_SQ] * inv_v, 0.0))
        mean = st[_V_SUM] * inv_v
        var = np.maximum(st[_V_SQ] * inv_v - mean * mean, 0.0)
        fmean = st[_F_SUM] * inv_e
        fvar = np.maximum(st[_F_SQ] * inv_e - fmean * fmean, 0.0)
        dropout = 1.0 - n_valid * inv_e
        refresh = st[_CHG] * inv_v
        enough = upd & (n_valid >= cfg.min_slots)
        # the aliasing rule is core.aliasing.nyquist_limit_hz applied
        # to the estimated refresh interval: with span = n_exp * step,
        # refresh f_N = 0.5 * chg / span and the fused signal's
        # fundamental ~= trans / (2 * span); f > f_N  <=>  trans > chg
        flags = {
            "bias": enough & (np.abs(bias) > cfg.bias_limit_w),
            "rms": enough & (rms > cfg.rms_limit_w),
            # dropout = missing coverage, a zero-refresh window, OR a
            # refresh-rate collapse below the sensor's own rolling norm
            # (a dead endpoint behind the hold-resample publishes stale
            # data, not gaps — and a burst gets lumped into one large
            # emit window when the frontier jumps, so the absolute
            # change count alone stays nonzero)
            "dropout": upd & ((dropout > cfg.dropout_frac)
                              | (enough & (st[_CHG]
                                           < cfg.dropout_min_changes))
                              | (enough & self._refresh_seen
                                 & (refresh < cfg.dropout_frac
                                    * self.ema_refresh))),
            "stuck": enough & (fvar > cfg.stuck_floor_w2)
            & (var < cfg.stuck_var_frac * fvar),
            "aliasing": enough & (st[_CHG] >= 1.0)
            & (st[_TRANS] > st[_CHG]),
            "drift": upd & self._drift_flag(),
        }
        bad = (flags["bias"] | flags["rms"] | flags["dropout"]
               | flags["stuck"])
        if cfg.drift_quarantines:
            bad = bad | flags["drift"]
        if cfg.alias_quarantines:
            bad = bad | flags["aliasing"]
        flagged = bad & upd
        clean = upd & ~bad
        self.flag_streak = np.where(
            flagged, self.flag_streak + 1,
            np.where(upd, 0, self.flag_streak))
        self.clean_streak = np.where(
            clean, self.clean_streak + 1,
            np.where(upd, 0, self.clean_streak))
        a = cfg.ema
        seed = upd & ~self._ema_seen
        fold_b = (1.0 - a) * self.ema_bias + a * bias
        fold_r = (1.0 - a) * self.ema_rms + a * rms
        self.ema_bias = np.where(
            seed, bias, np.where(upd, fold_b, self.ema_bias))
        self.ema_rms = np.where(
            seed, rms, np.where(upd, fold_r, self.ema_rms))
        self._ema_seen |= upd
        # the refresh-rate norm learns only from non-dropout windows so
        # a sustained outage cannot become the sensor's "new normal"
        r_ok = enough & ~flags["dropout"]
        r_seed = r_ok & ~self._refresh_seen
        fold_f = (1.0 - a) * self.ema_refresh + a * refresh
        self.ema_refresh = np.where(
            r_seed, refresh, np.where(r_ok, fold_f, self.ema_refresh))
        self._refresh_seen |= r_ok
        self.bias, self.rms, self.dropout = bias, rms, dropout
        self.flags_last = flags
        t_w = st[_T_LAST]
        for i in np.nonzero(upd)[0]:
            self._step_state(int(i), bool(bad[i]), float(t_w[i]), flags)

    def _drift_flag(self) -> np.ndarray:
        """(n_global,) True where the tracked delay left the tracker's
        capture range (shared ``delay_fleet`` when synced, so the flag
        is identical on every host)."""
        al = self.align
        out = np.zeros((self.n_global,), bool)
        if al is None:
            return out
        if getattr(al, "synced", False):
            if al.delay_fleet is None:
                return out
            delays = al.delay_fleet
        else:
            local, self._delays = self._delays, None
            if local is None:
                if al.carry is None:
                    return out
                local = al.delay_s[:self.n_streams].cpu().numpy()
            delays = np.zeros((self.n_global,))
            delays[self.row_ids] = local
        cap = self.cfg.drift_frac * al.max_lag * al.step
        return np.abs(np.asarray(delays, np.float64)) > cap

    def _step_state(self, i: int, bad: bool, t: float, flags) -> None:
        cfg = self.cfg
        s = int(self.state[i])
        new = s
        if s == HEALTHY:
            if self.flag_streak[i] >= cfg.suspect_after:
                new = SUSPECT
        elif s == SUSPECT:
            if self.flag_streak[i] >= (cfg.suspect_after
                                       + cfg.quarantine_after):
                new = QUARANTINED
            elif self.clean_streak[i] >= cfg.recover_after:
                new = HEALTHY
        elif s == QUARANTINED:
            if self.clean_streak[i] >= cfg.recover_after:
                new = RECOVERING
        elif s == RECOVERING:
            if bad:
                new = QUARANTINED
            elif self.clean_streak[i] >= 2 * cfg.recover_after:
                new = HEALTHY
        if new == s:
            return
        fl = tuple(k for k, v in flags.items() if bool(v[i]))
        self._emit(HealthEvent(
            kind="transition", window=self.windows, t=t, sensor=i,
            name=self.names[i], state_from=s, state_to=new, flags=fl,
            detail={"bias_w": float(self.bias[i]),
                    "rms_w": float(self.rms[i]),
                    "dropout_frac": float(self.dropout[i])}))
        self.state[i] = new
        if (s == QUARANTINED and new == RECOVERING and cfg.recalibrate
                and abs(float(self.ema_bias[i])) >= cfg.recal_min_w):
            off = float(self.ema_bias[i])
            self._suggested[self.names[i]] = off
            self._emit(HealthEvent(
                kind="recalibrate", window=self.windows, t=t, sensor=i,
                name=self.names[i], state_from=new, state_to=new,
                flags=("recalibrate",), detail={"offset_w": off}))

    def _emit(self, ev: HealthEvent) -> None:
        self.events.append(ev)
        self._counts[ev.kind] = self._counts.get(ev.kind, 0) + 1

    # -- the pipeline stage interface ------------------------------------

    def update(self, gw):
        """Accumulate this window's residual stats (from the RAW mask,
        so quarantined sensors stay monitored for recovery), then hand
        the next stage the window with the CURRENT quarantine mask
        applied.  All-healthy fleets skip the masking entirely.

        The block is computed where the window lives: float32 window
        math with every row sum accumulated in float64, the group sums
        over the padded row index, all by ``core.reduce``; nothing comes
        back to the host here (``local_mask`` is host state)."""
        n = self.n_streams
        vals = gw.values[:n].to(torch.float32)
        mask = gw.mask[:n].to(torch.bool)
        dev = vals.device
        hm = self.local_mask()
        f64 = torch.float64
        gidx = self._gidx_dev

        def group_sum(x):                      # (n, W) -> (groups, W)
            return fold_sum(x[self._grows] * self._gmember, 1)

        maskf = mask.to(torch.float32)
        # reference = healthy-member fused mean; a fully-dark group
        # (every member quarantined) falls back to the raw mean so its
        # sensors stay monitored and can still recover
        healthy = bool(hm.all())
        if healthy:
            mhf = maskf
        else:
            dark = self._ind @ hm.astype(np.float32) == 0.0
            keep = torch.as_tensor(hm | dark[self._gidx], device=dev)
            mhf = (mask & keep[:, None]).to(torch.float32)
        vmh = vals * mhf
        cnt = group_sum(mhf)                             # (groups, W)
        have = cnt > 0
        fused = torch.where(
            have, group_sum(vmh) / torch.clamp_min(cnt, 1.0),
            torch.zeros((), dtype=torch.float32, device=dev))
        if healthy:
            # all-healthy: a valid sample implies its own group is
            # covered, so mask & have[gidx] == mask and both per-stream
            # gathers drop out of the residual
            r = (vals - fused[gidx]) * maskf
            vm = vmh
        else:
            r = (vals - fused[gidx]) * (maskf * have[gidx])
            vm = vals * maskf
        hsum = have.to(f64).sum(dim=1)
        blk = torch.zeros((N_STATS, n), dtype=f64, device=dev)
        blk[_N_VALID] = mask.sum(dim=1).to(f64)
        blk[_N_EXP] = hsum[gidx]
        blk[_R_SUM] = fixed_sum(r.to(f64), 1)
        blk[_R_SQ] = fixed_sum((r * r).to(f64), 1)
        blk[_V_SUM] = fixed_sum(vm.to(f64), 1)
        blk[_V_SQ] = fixed_sum((vals * vm).to(f64), 1)
        if vals.shape[1] > 1:
            blk[_CHG] = ((vals[:, 1:] != vals[:, :-1])
                         & mask[:, 1:] & mask[:, :-1]).sum(dim=1).to(f64)
        fh = fused * have
        fsum = fixed_sum(fh.to(f64), 1)
        blk[_F_SUM] = fsum[gidx]
        blk[_F_SQ] = fixed_sum((fused * fh).to(f64), 1)[gidx]
        if fused.shape[1] > 2:
            # fused-mean crossings between adjacent covered slots
            fmean = (fsum / torch.clamp_min(hsum, 1.0))[:, None]
            sgn = fused > fmean
            blk[_TRANS] = ((sgn[:, 1:] != sgn[:, :-1])
                           & have[:, 1:]
                           & have[:, :-1]).sum(dim=1).to(f64)[gidx]
        if self._pending is not None:
            blk[:_T_LAST] += self._pending[:_T_LAST]
        blk[_T_LAST] = gw.grid[-1].to(f64)
        self._pending = blk
        if healthy:
            return gw
        return dataclasses.replace(
            gw, mask=gw.mask & torch.as_tensor(hm, device=dev)[:, None])

    def flush(self, t_end: float = None):
        """End of stream: if ``REPRO_HEALTH_LOG_DIR`` is set, append
        this run's typed events as JSON lines (the CI artifact)."""
        import os
        d = os.environ.get("REPRO_HEALTH_LOG_DIR")
        if d and self.events:
            from repro_torch.health.events import write_events_jsonl
            os.makedirs(d, exist_ok=True)
            write_events_jsonl(self.events, os.path.join(
                d, f"health-events-{os.getpid()}.jsonl"))
        return None

    # -- exports ---------------------------------------------------------

    def suggested_corrections(self):
        """Accumulated auto-recalibration offsets as a
        ``core.calibration.Corrections`` (subtract-offset convention:
        the suggested offset is the sensor's rolling bias vs the fused
        consensus at the moment it re-entered RECOVERING)."""
        from repro_torch.core.calibration import Corrections
        return Corrections(offsets_w=dict(self._suggested), slopes={})

    def metrics(self):
        """The HealthRegistry source: per-sensor gauges + event
        counters (names are the registry's metric names, un-prefixed)."""
        from repro_torch.health.registry import Metric

        def per(arr):
            return {self.names[i]: float(arr[i])
                    for i in range(self.n_global)}

        out = [
            Metric("sensor_state", per(self.state), label="sensor",
                   help="0 healthy, 1 suspect, 2 quarantined, "
                        "3 recovering"),
            Metric("sensor_bias_w", per(self.bias), label="sensor"),
            Metric("sensor_rms_w", per(self.rms), label="sensor"),
            Metric("sensor_dropout_frac", per(self.dropout),
                   label="sensor"),
            Metric("quarantined_sensors",
                   float((self.state == QUARANTINED).sum())),
            Metric("health_windows_total", float(self.windows),
                   kind="counter"),
        ]
        if self._counts:
            out.append(Metric(
                "health_events_total",
                {k: float(v) for k, v in sorted(self._counts.items())},
                kind="counter", label="kind"))
        return out
