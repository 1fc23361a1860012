"""Variance-weighted cross-sensor fusion and the §V-B validation report
(port of ``repro/align/fusion.py``, batch path).

``align_and_fuse`` runs the whole batch front end on the device:
``series_rows_from_traces`` (``power_reconstruct_fleet``), a first
``grid_resample`` pass, delay estimation (``xcorr_align``), the
delay-corrected ``grid_resample`` pass and ``fuse_gridded``, one batched
reduction over (devices, streams, grid); it returns one ``FusedStream``
per device on the host.  ``validate_streams`` reproduces the paper's
cross-sensor comparison; ``attribute_energy_fused`` integrates the fused
streams per phase through ``StreamingPhaseAccumulator``
(``phase_integrate``) without bringing them to the host.
``fuse_gridded_host`` is the float64 numpy mirror of the fusion, and
``align_fuse_host`` the per-trace float64 host loop (reconstruct,
resample, correlate, shift and fuse one trace at a time): the
independent cross-check of the batched path.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from repro_torch.align.delay import (estimate_delays, peak_to_delay,
                                     schedule_reference, stream_reference)
from repro_torch.align.regrid import (SeriesRows, make_grid, regrid_rows,
                                      series_rows_from_traces)
from repro_torch.core.calibration import apply_corrections
from repro_torch.core.power_model import PiecewisePower
from repro_torch.core.reconstruction import (PowerSeries,
                                             delta_e_over_delta_t,
                                             power_trace_series)
from repro_torch.device import refuse_unported, resolve_device

DEFAULT_MAX_LAG = 512          # grid steps; ~256 ms at a 0.5 ms grid
VAR_FLOOR_W2 = 0.25            # (0.5 W)^2: no stream gets infinite weight


def fuse_gridded(values, mask, var_floor=VAR_FLOOR_W2):
    """Inverse-variance fusion of co-gridded streams, batched per device.

    values/mask: (D, K, G) tensors — D devices, K sensor streams each
    (masked rows pad ragged groups).  Per-stream noise variance is the
    mean squared residual against the unweighted cross-sensor mean;
    ``var_floor`` keeps near-identical streams finite.

    Returns (fused, disagreement, confidence, weights, out_mask):
      fused        (D, G) inverse-variance weighted power
      disagreement (D, G) weighted cross-sensor std at each sample
      confidence   (D, G) 1 sigma of the fused estimate (1/sqrt(sum w))
      weights      (D, K) per-stream weights (normalized per device)
      out_mask     (D, G) some stream with weight is valid
    """
    m = mask.to(values.dtype)
    cnt = torch.sum(m, dim=1)                                   # (D, G)
    m0 = torch.sum(values * m, dim=1) / torch.clamp_min(cnt, 1.0)
    resid = (values - m0[:, None, :]) * m
    n_k = torch.sum(m, dim=2)                                   # (D, K)
    var_k = torch.sum(resid * resid, dim=2) / torch.clamp_min(n_k, 1.0)
    w_k = torch.where(n_k > 1, 1.0 / (var_k + var_floor),
                      torch.zeros_like(var_k))                  # (D, K)
    wm = w_k[:, :, None] * m                                    # (D, K, G)
    w_tot = torch.sum(wm, dim=1)                                # (D, G)
    safe = torch.clamp_min(w_tot, 1e-30)
    fused = torch.sum(wm * values, dim=1) / safe
    dev = values - fused[:, None, :]
    disagree = torch.sqrt(torch.sum(wm * dev * dev, dim=1) / safe)
    conf = 1.0 / torch.sqrt(safe)
    # a grid point counts only where some stream carries weight
    out_mask = w_tot > 0
    z = torch.zeros_like(fused)
    w_norm = w_k / torch.clamp_min(torch.sum(w_k, dim=1, keepdim=True),
                                   1e-30)
    return (torch.where(out_mask, fused, z),
            torch.where(out_mask, disagree, z),
            torch.where(out_mask, conf, z), w_norm, out_mask)


def fuse_gridded_host(values, mask, var_floor=VAR_FLOOR_W2):
    """Float64 numpy mirror of ``fuse_gridded`` (parity oracle)."""
    v = np.asarray(values, np.float64)
    m = np.asarray(mask, np.float64)
    cnt = m.sum(axis=1)
    m0 = (v * m).sum(axis=1) / np.maximum(cnt, 1.0)
    resid = (v - m0[:, None, :]) * m
    n_k = m.sum(axis=2)
    var_k = (resid * resid).sum(axis=2) / np.maximum(n_k, 1.0)
    w_k = np.where(n_k > 1, 1.0 / (var_k + var_floor), 0.0)
    wm = w_k[:, :, None] * m
    w_tot = wm.sum(axis=1)
    safe = np.maximum(w_tot, 1e-30)
    fused = (wm * v).sum(axis=1) / safe
    dev = v - fused[:, None, :]
    disagree = np.sqrt((wm * dev * dev).sum(axis=1) / safe)
    conf = 1.0 / np.sqrt(safe)
    out_mask = w_tot > 0
    w_norm = w_k / np.maximum(w_k.sum(axis=1, keepdims=True), 1e-30)
    z = np.zeros_like(fused)
    return (np.where(out_mask, fused, z), np.where(out_mask, disagree, z),
            np.where(out_mask, conf, z), w_norm, out_mask)


@dataclasses.dataclass
class FusedStream:
    """One device's fused power timeline + per-sensor diagnostics (host)."""
    grid: np.ndarray            # (G,) absolute seconds (float64)
    watts: np.ndarray           # (G,) fused power
    mask: np.ndarray            # (G,) any-sensor coverage
    disagreement_w: np.ndarray  # (G,) weighted cross-sensor std
    confidence_w: np.ndarray    # (G,) 1 sigma of the fused estimate
    weights: np.ndarray         # (K,) normalized per-stream weights
    delays: np.ndarray          # (K,) detected lag vs the reference (s)
    peak_corr: np.ndarray       # (K,) correlation at the detected lag
    names: list                 # (K,) stream names
    stream_values: np.ndarray   # (K, G) aligned per-stream power
    stream_mask: np.ndarray     # (K, G)

    @property
    def series(self) -> PowerSeries:
        """Hold-integrable view (``watts[i]`` on ``(grid[i-1], grid[i]]``)."""
        return PowerSeries(self.grid, self.watts.astype(np.float64),
                           source="fused")


def default_grid(rows: SeriesRows, *, grid_step=None,
                 max_points: int = 65536):
    """Shared grid spanning every row, at half the fastest cadence."""
    steps = rows.median_step()
    pos = steps[steps > 0]
    if grid_step is None:
        grid_step = 0.5 * float(pos.min()) if len(pos) else 1e-3
    t_lo = min(float(rows.times[i, rows.first[i]]) for i in
               range(rows.n_streams) if rows.first[i] < rows.n[i])
    t_hi = max(float(rows.times[i, rows.n[i] - 1])
               for i in range(rows.n_streams))
    span = max(t_hi - t_lo, grid_step)
    grid_step = max(grid_step, span / max_points)
    return make_grid(rows.t0 + t_lo, rows.t0 + t_hi, grid_step), grid_step


@dataclasses.dataclass
class _Fused:
    """``align_and_fuse``'s result while it is still on the device."""
    grid: np.ndarray           # (G,) float64, absolute
    groups: list               # [[trace, ...], ...]
    vals: torch.Tensor         # (K, G) aligned per-stream power
    mask: torch.Tensor         # (K, G)
    delays: torch.Tensor       # (K,) float64 seconds
    peak: torch.Tensor         # (K,) float64
    fused: tuple               # fuse_gridded's five (D, ...) tensors


def _group_rows(groups, device) -> torch.Tensor:
    """(D, k_max) flat stream row of each (device, sensor); -1 pads."""
    k_max = max(len(g) for g in groups)
    idx = np.full((len(groups), k_max), -1, np.int64)
    lo = 0
    for di, g in enumerate(groups):
        idx[di, :len(g)] = lo + np.arange(len(g))
        lo += len(g)
    return torch.as_tensor(idx, device=device)


def _align_fuse(groups, *, reference=None, grid=None, grid_step=None,
                max_lag=None, corrections=None, mode: str = "hold",
                use_t_measured: bool = True, align: bool = True,
                delays=None, var_floor=VAR_FLOOR_W2, interpret=None,
                use_kernel=None, dtype=np.float32, device=None) -> _Fused:
    refuse_unported("align_and_fuse", interpret=interpret,
                    use_kernel=use_kernel)
    dev = resolve_device(device)
    groups = [list(g) for g in groups]
    flat = [tr for g in groups for tr in g]
    rows = series_rows_from_traces(flat, corrections=corrections,
                                   use_t_measured=use_t_measured,
                                   dtype=dtype, device=dev)
    if grid is None:
        grid, grid_step = default_grid(rows, grid_step=grid_step)
    else:
        grid = np.asarray(grid, np.float64)
        grid_step = float(np.median(np.diff(grid)))
    if max_lag is None:
        max_lag = min(DEFAULT_MAX_LAG, max(len(grid) // 4, 1))

    vals0, mask0 = regrid_rows(rows, grid, mode=mode, device=dev)
    k_tot = rows.n_streams
    d_s = torch.zeros((k_tot,), dtype=torch.float64, device=dev)
    peak = torch.ones((k_tot,), dtype=torch.float64, device=dev)
    if delays is not None:
        d_s = torch.as_tensor(np.asarray(delays, np.float64).reshape(-1),
                              device=dev)
    elif align:
        if hasattr(reference, "power_at"):
            est = estimate_delays(vals0, mask0,
                                  schedule_reference(reference, grid),
                                  step=grid_step, max_lag=max_lag)
            d_s, peak = est.delay_s, est.peak_corr
        elif reference is not None:
            ref = (reference if isinstance(reference, torch.Tensor)
                   else np.asarray(reference))
            est = estimate_delays(vals0, mask0, ref, step=grid_step,
                                  max_lag=max_lag)
            d_s, peak = est.delay_s, est.peak_corr
        else:
            lo = 0
            for g in groups:
                hi = lo + len(g)
                ref = stream_reference(vals0[lo], mask0[lo])
                est = estimate_delays(vals0[lo:hi], mask0[lo:hi], ref,
                                      step=grid_step, max_lag=max_lag)
                # every lag relative to the group's reference stream; its
                # own self-lag (~0) is kept so sub-sample bias cancels
                d_s[lo:hi] = est.delay_s
                peak[lo:hi] = est.peak_corr
                lo = hi
    if bool((d_s != 0.0).any()):
        vals, mask = regrid_rows(rows, grid, delays=d_s, mode=mode,
                                 device=dev)
    else:
        vals, mask = vals0, mask0

    # ragged groups -> (D, k_max, G) with masked padding rows
    idx = _group_rows(groups, dev)
    pad = (idx < 0)[:, :, None]
    src = idx.clamp_min(0)
    sv = torch.where(pad, torch.zeros((), dtype=vals.dtype, device=dev),
                     vals[src])
    sm = ~pad & mask[src]
    return _Fused(grid=grid, groups=groups, vals=vals, mask=mask,
                  delays=d_s, peak=peak,
                  fused=fuse_gridded(sv, sm, var_floor))


def align_and_fuse(groups, **kw) -> list:
    """groups: [[SensorTrace, ...], ...] — one list per device.

    Keywords as the reference: ``reference`` (a schedule with
    ``power_at``, an explicit (G,) signal on the grid, or None: each
    group's FIRST stream is its own reference), ``grid``/``grid_step``,
    ``max_lag``, ``mode``, ``use_t_measured``, ``align``, ``delays``
    (seconds per stream, flat order; overrides estimation),
    ``var_floor``, ``dtype``, ``corrections`` (``core.calibration``,
    applied per trace before packing); plus ``device`` (None means
    CUDA).  ``interpret=True`` and ``use_kernel=False`` are not ported.
    Returns one ``FusedStream`` (host numpy) per group.
    """
    r = _align_fuse(groups, **kw)
    fused, dis, conf, w, out_m = (a.cpu().numpy() for a in r.fused)
    v_np, m_np = r.vals.cpu().numpy(), r.mask.cpu().numpy()
    d_np, p_np = r.delays.cpu().numpy(), r.peak.cpu().numpy()
    out = []
    lo = 0
    for di, g in enumerate(r.groups):
        hi = lo + len(g)
        out.append(FusedStream(
            grid=r.grid, watts=fused[di].astype(np.float64),
            mask=out_m[di], disagreement_w=dis[di], confidence_w=conf[di],
            weights=w[di, :len(g)], delays=d_np[lo:hi],
            peak_corr=p_np[lo:hi], names=[tr.name for tr in g],
            stream_values=v_np[lo:hi], stream_mask=m_np[lo:hi]))
        lo = hi
    return out


# per-grid-slot data-quality flag bits (ValidationReport.slot_flags)
FLAG_NO_COVERAGE = 1        # no stream valid at the slot
FLAG_PARTIAL_COVERAGE = 2   # some but not all streams valid
FLAG_HIGH_DISAGREEMENT = 4  # disagreement > disagree_frac * |fused|


@dataclasses.dataclass(frozen=True)
class StreamValidation:
    """One sensor stream's §V-B row: bias/RMS vs the fused consensus,
    the detected lag and its correlation, and the fusion weight."""
    name: str
    bias_w: float
    rms_w: float
    delay_s: float
    peak_corr: float
    weight: float

    def as_dict(self) -> dict:
        return {"bias_w": self.bias_w, "rms_w": self.rms_w,
                "delay_s": self.delay_s, "peak_corr": self.peak_corr,
                "weight": self.weight}


@dataclasses.dataclass(frozen=True)
class DeviceValidation:
    """One device group's validation: per-stream rows plus coverage-
    pattern accounting surfaced as per-slot data-quality flags."""
    name: str
    streams: dict              # {sensor name: StreamValidation}
    mean_disagreement_w: float
    coverage_counts: dict      # {stream-bitmask pattern: slot count}
    slot_flags: np.ndarray     # (G,) uint8 of FLAG_* bits per slot
    quality_flags: tuple       # summary flags for the whole group

    def as_dict(self) -> dict:
        return {"name": self.name,
                "streams": {k: v.as_dict()
                            for k, v in self.streams.items()},
                "mean_disagreement_w": self.mean_disagreement_w}


class ValidationReport:
    """Typed §V-B report with a dict view: ``report.devices`` is the
    typed list, ``report["devices"]`` (and ``as_dict()``) the nested
    dict shape."""

    def __init__(self, devices):
        self.devices = list(devices)
        self._dict = {"devices": [d.as_dict() for d in self.devices]}

    def as_dict(self) -> dict:
        return self._dict

    def __getitem__(self, key):
        return self._dict[key]

    def __iter__(self):
        return iter(self._dict)

    def __len__(self):
        return len(self._dict)

    def keys(self):
        return self._dict.keys()

    def __contains__(self, key):
        return key in self._dict


def validate_streams(groups, *, disagree_frac: float = 0.25,
                     partial_frac: float = 0.25,
                     low_corr: float = 0.2, **kw) -> ValidationReport:
    """The paper's §V-B cross-sensor comparison, per device group.

    Typed per-sensor bias/RMS/lag rows plus per-slot coverage-pattern
    accounting and group-level ``quality_flags`` ("partial_coverage",
    "high_disagreement", "low_peak_corr"), as the reference.  ``kw`` goes
    to ``align_and_fuse`` (``device`` included).
    """
    fused_list = align_and_fuse(groups, **kw)
    devices = []
    for di, fs in enumerate(fused_list):
        streams = {}
        for k, name in enumerate(fs.names):
            m = fs.stream_mask[k] & fs.mask
            dev = fs.stream_values[k][m] - fs.watts[m]
            streams[name] = StreamValidation(
                name=name,
                bias_w=float(dev.mean()) if m.any() else float("nan"),
                rms_w=(float(np.sqrt((dev ** 2).mean()))
                       if m.any() else float("nan")),
                delay_s=float(fs.delays[k]),
                peak_corr=float(fs.peak_corr[k]),
                weight=float(fs.weights[k]))
        k_n = len(fs.names)
        sm = np.asarray(fs.stream_mask[:k_n], bool)
        cnt = sm.sum(axis=0)
        bits = (1 << np.arange(k_n, dtype=np.int64))[:, None]
        pattern = (sm * bits).sum(axis=0)
        pats, pat_counts = np.unique(pattern, return_counts=True)
        flags = np.zeros(sm.shape[1], np.uint8)
        flags[cnt == 0] |= FLAG_NO_COVERAGE
        flags[(cnt > 0) & (cnt < k_n)] |= FLAG_PARTIAL_COVERAGE
        mean_w = (float(np.abs(fs.watts[fs.mask]).mean())
                  if fs.mask.any() else 0.0)
        hi_dis = fs.mask & (fs.disagreement_w
                            > disagree_frac * max(mean_w, 1e-9))
        flags[hi_dis] |= FLAG_HIGH_DISAGREEMENT
        quality = []
        covered = cnt > 0
        if covered.any() and (((cnt > 0) & (cnt < k_n)).sum()
                              > partial_frac * covered.sum()):
            quality.append("partial_coverage")
        mean_dis = (float(fs.disagreement_w[fs.mask].mean())
                    if fs.mask.any() else float("nan"))
        if fs.mask.any() and mean_dis > disagree_frac * max(mean_w,
                                                            1e-9):
            quality.append("high_disagreement")
        if any(s.peak_corr < low_corr for s in streams.values()):
            quality.append("low_peak_corr")
        devices.append(DeviceValidation(
            name=f"device{di}", streams=streams,
            mean_disagreement_w=mean_dis,
            coverage_counts={int(p): int(c)
                             for p, c in zip(pats, pat_counts)},
            slot_flags=flags, quality_flags=tuple(quality)))
    return ValidationReport(devices)


def attribute_energy_fused(groups, phases, *, chunk: int = 4096,
                           **kw) -> list:
    """Per-phase energy on the FUSED stream of each device group.

    phases: [(name, t_start, t_end)] absolute seconds.  Returns one
    ``[PhaseEnergy]`` row per group.  The fused streams stay on the
    device and integrate through ``StreamingPhaseAccumulator`` (the
    ``phase_integrate`` kernel) in ``chunk``-column windows.  ``kw`` as
    ``align_and_fuse``.
    """
    from repro_torch.core.attribution import PhaseEnergy
    from repro_torch.fleet.streaming import StreamingPhaseAccumulator
    r = _align_fuse(groups, **kw)
    if not phases:
        return [[] for _ in r.groups]
    fused, out_m = r.fused[0], r.fused[4]
    dev = fused.device
    grid = r.grid
    t0 = float(grid[0])
    d_n, g_n = fused.shape
    # pad the device axis to the row tile (all-padding rows are fully
    # masked -> exactly zero energy), as the reference does
    d_pad = d_n if d_n <= 8 else -(-d_n // 8) * 8
    times = torch.as_tensor((grid - t0).astype(np.float32),
                            device=dev).expand(d_pad, g_n)
    watts = torch.zeros((d_pad, g_n), dtype=torch.float32, device=dev)
    valid = torch.zeros((d_pad, g_n), dtype=torch.bool, device=dev)
    watts[:d_n] = fused
    valid[:d_n] = out_m
    windows = [(a - t0, b - t0) for _, a, b in phases]
    acc = StreamingPhaseAccumulator(windows, d_pad, device=dev)
    for lo in range(0, g_n, chunk):
        hi = min(lo + chunk, g_n)
        acc.update(times[:, lo:hi], watts[:, lo:hi], valid=valid[:, lo:hi])
    totals = acc.totals()
    out = []
    for di in range(d_n):
        row = []
        for (name, a, b), e in zip(phases, totals[di]):
            dur = max(b - a, 1e-12)
            row.append(PhaseEnergy(name, a, b, float(e), float(e / dur)))
        out.append(row)
    return out


_DEVICE_RE = re.compile(r"^(?:chip|pm_accel)(\d+)_")


def group_traces_by_device(traces: dict, *, include_node: bool = False):
    """{name: SensorTrace} -> ordered {device: [SensorTrace]} groups.

    Chip-scope streams (``chip{i}_*``, ``pm_accel{i}_*``) group by device
    index with cumulative counters first (the best in-group alignment
    reference).  Node-scope sensors form a ``"node"`` group only when
    ``include_node`` (fusing node power into a chip stream would
    double-count).
    """
    groups: dict = {}
    for name, tr in traces.items():
        m = _DEVICE_RE.match(name)
        if m:
            groups.setdefault(f"device{int(m.group(1))}", []).append(tr)
        elif include_node:
            groups.setdefault("node", []).append(tr)
    for key, trs in groups.items():
        trs.sort(key=lambda tr: (not tr.spec.is_cumulative, tr.name))
    return dict(sorted(groups.items()))


# ---------------------------------------------------------------------------
# Independent per-trace float64 host loop (cross-check of the batched path)
# ---------------------------------------------------------------------------

def _xcorr_np(xc, refc, max_lag):
    """Per-trace normalized xcorr scores, one np.dot per candidate lag
    over the bounded lag window."""
    g = len(refc)
    lags = np.arange(-max_lag, max_lag + 1)
    num = np.empty(len(lags))
    den_r = np.empty(len(lags))
    for i, lag in enumerate(lags):
        a, b = (xc[lag:], refc[:g - lag]) if lag >= 0 \
            else (xc[:g + lag], refc[-lag:])
        num[i] = a @ b
        den_r[i] = b @ b
    den_x = np.sqrt((xc * xc).sum())
    return num / (den_x * np.sqrt(den_r) + 1e-12)


def align_fuse_host(groups, grid, *, reference=None, max_lag: int = 256,
                    corrections=None, var_floor=VAR_FLOOR_W2):
    """Per-trace float64 numpy pipeline on the host: reconstruct /
    resample / correlate / shift / fuse one trace at a time (the
    looser, compaction-based rather than padded, semantic cross-check).
    Returns (fused (D, G), delays (D, Kmax), masks (D, G)) as numpy.
    """
    grid = np.asarray(grid, np.float64)
    step = float(np.median(np.diff(grid)))
    g_n = len(grid)
    d_n = len(groups)
    k_max = max(len(g) for g in groups)
    fused = np.zeros((d_n, g_n))
    delays = np.zeros((d_n, k_max))
    masks = np.zeros((d_n, g_n), bool)
    for di, group in enumerate(groups):
        series = []
        for tr in group:
            tr = apply_corrections(tr, corrections)
            series.append(delta_e_over_delta_t(tr)
                          if tr.spec.is_cumulative
                          else power_trace_series(tr))
        if isinstance(reference, PiecewisePower):
            ref = reference.power_at(grid)
        elif reference is not None:
            ref = np.asarray(reference, np.float64)
        else:
            s0 = series[0]
            ref = s0.resample(grid).watts
            rm = (grid >= s0.t[0]) & (grid <= s0.t[-1])
            ref = np.where(rm, ref - ref[rm].mean(), 0.0)
        refc = ref - ref.mean()
        vals = np.zeros((len(group), g_n))
        m = np.zeros((len(group), g_n), bool)
        for k, s in enumerate(series):
            x = s.resample(grid).watts
            xm = (grid >= s.t[0]) & (grid <= s.t[-1])
            xc = np.where(xm, x - x[xm].mean(), 0.0)
            scores = _xcorr_np(xc, refc, max_lag)
            est = peak_to_delay(torch.from_numpy(scores[None, :]), step,
                                max_lag)
            delays[di, k] = float(est.delay_s[0])
            sh = grid + delays[di, k]
            vals[k] = s.resample(sh).watts
            m[k] = (sh >= s.t[0]) & (sh <= s.t[-1])
        f, _, _, _, om = fuse_gridded_host(vals[None], m[None], var_floor)
        fused[di] = f[0]
        masks[di] = om[0]
    return fused, delays, masks
