"""Heterogeneous sensor streams -> padded sample rows -> one shared grid
(port of ``repro/align/regrid.py``).

  ``series_rows_from_traces`` — SensorTraces (mixed cumulative + power) to
      padded per-stream (times, values) rows on the host: counters run
      through ``fleet_reconstruct`` on the device (one fused kernel
      launch), power sensors pack directly; everything is rebased to one
      float64 origin before the float32 cast.
  ``regrid_rows`` — every row onto a shared uniform grid through the
      ``grid_resample`` kernel, with optional per-row delay shifts (row
      i is queried at ``grid + delay[i]``).

``regrid_rows_host`` is the float64 mirror of the same padded semantics
(the <= 1e-5 parity oracle).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.calibration import apply_corrections
from repro_torch.device import refuse_unported, resolve_device
from repro_torch.fleet.packing import ROW_ALIGN, _round_up, pack_traces
from repro_torch.fleet.reconstruct import fleet_reconstruct
from repro_torch.kernels.grid_resample.ops import grid_resample
from repro_torch.kernels.grid_resample.ref import grid_resample_ref


def make_grid(t_lo: float, t_hi: float, step: float) -> np.ndarray:
    """Uniform float64 grid covering [t_lo, t_hi] at ``step`` seconds."""
    n = max(int(np.floor((t_hi - t_lo) / step)) + 1, 2)
    return t_lo + step * np.arange(n)


@dataclasses.dataclass
class SeriesRows:
    """Padded per-stream sample rows on one shared time origin (host).

    times/values: (K, S) with K a multiple of ROW_ALIGN; row tails
    replicate the last sample (zero-width, search-invisible).
    ``first[i]`` is the first *defined* sample (0 for raw power readings,
    the first interval-closing slot for dE/dt rows); ``n[i]`` bounds the
    search.
    """
    times: np.ndarray         # (K, S), seconds since t0
    values: np.ndarray        # (K, S), watts
    n: np.ndarray             # (K,) int32
    first: np.ndarray         # (K,) int32
    names: list
    n_streams: int
    t0: float                 # shared absolute origin (float64)
    _dev: tuple = dataclasses.field(default=None, init=False, repr=False,
                                    compare=False)

    @property
    def shape(self):
        return self.times.shape

    def device_arrays(self, device):
        """(times, values, n, first) as tensors on ``device``, uploaded
        once: the regrid runs twice per pipeline (estimate, then
        delay-corrected) on the same rows."""
        device = torch.device(device)
        if self._dev is None or self._dev[0] != device:
            self._dev = (device, tuple(
                torch.as_tensor(a, device=device)
                for a in (self.times, self.values, self.n, self.first)))
        return self._dev[1]

    def median_step(self) -> np.ndarray:
        """(n_streams,) median positive sample spacing per row."""
        out = np.zeros((self.n_streams,))
        for i in range(self.n_streams):
            t = self.times[i, self.first[i]:self.n[i]].astype(np.float64)
            dt = np.diff(t)
            dt = dt[dt > 0]
            out[i] = float(np.median(dt)) if len(dt) else 0.0
        return out


def series_rows_from_traces(traces, *, corrections=None,
                            use_t_measured: bool = True, t0=None,
                            interpret=None, use_kernel=None,
                            dtype=np.float32, device=None) -> SeriesRows:
    """SensorTraces -> SeriesRows (order preserved).

    Counters are reconstructed to instantaneous power by
    ``fleet_reconstruct`` on ``device`` (None means CUDA); power sensors
    pack their raw readings, made non-decreasing in time with a running
    max (the lower-bound search's precondition).  ``corrections``
    (``core.calibration``) apply to each trace on the host first.
    ``interpret=True`` and ``use_kernel=False`` are not ported.
    """
    refuse_unported("series_rows_from_traces", interpret=interpret,
                    use_kernel=use_kernel)
    traces = [apply_corrections(tr, corrections) for tr in traces]
    if not traces:
        raise ValueError("series_rows_from_traces needs at least one trace")
    dev = resolve_device(device)
    if t0 is None:
        t0 = min(float((tr.t_measured if use_t_measured
                        else tr.t_read)[0]) for tr in traces)
    cum = [i for i, tr in enumerate(traces) if tr.spec.is_cumulative]
    pwr = [i for i, tr in enumerate(traces) if not tr.spec.is_cumulative]

    k = _round_up(len(traces), ROW_ALIGN)
    s_cum = s_pwr = 2
    packed = None
    if cum:
        packed = pack_traces([traces[i] for i in cum],
                             use_t_measured=use_t_measured, dtype=dtype)
        recon = fleet_reconstruct(packed, device=dev)
        s_cum = packed.shape[1]
    if pwr:
        s_pwr = max(max(len(traces[i]) for i in pwr), 2)
    s = max(s_cum, s_pwr)

    times = np.zeros((k, s), dtype)
    values = np.zeros((k, s), dtype)
    n = np.full((k,), 2, np.int32)
    first = np.zeros((k,), np.int32)

    if cum:
        power, r_times, valid = (a.cpu().numpy() for a in recon)
        rows_sel = np.asarray(cum)
        n_cum = len(cum)
        # rebase the pack's origin onto the shared one; slots at/after
        # ``n`` are never consulted, so the packed tails copy as they are
        shift = dtype(packed.t0 - t0)
        times[rows_sel, :s_cum] = r_times[:n_cum] + shift
        values[rows_sel, :s_cum] = power[:n_cum]
        n[rows_sel] = packed.n_samples[:n_cum]
        v = valid[:n_cum]
        first[rows_sel] = np.where(v.any(axis=1), np.argmax(v, axis=1),
                                   packed.n_samples[:n_cum])
    for i in pwr:
        tr = traces[i]
        t = (tr.t_measured if use_t_measured else tr.t_read)
        kk = len(tr)
        times[i, :kk] = np.maximum.accumulate(t - t0)
        values[i, :kk] = tr.value
        times[i, kk:] = times[i, kk - 1]
        values[i, kk:] = values[i, kk - 1]
        n[i] = kk
    first[len(traces):] = 2                  # all-padding rows: masked out
    return SeriesRows(times, values, n, first, [tr.name for tr in traces],
                      len(traces), t0)


def _delay_row(rows: SeriesRows, delays, device) -> torch.Tensor:
    """(K,) float32 per-row delays (zero past ``n_streams``)."""
    d = torch.zeros((rows.shape[0],), dtype=torch.float64, device=device)
    if delays is not None:
        d[:rows.n_streams] = torch.as_tensor(
            delays, dtype=torch.float64, device=device).reshape(-1)
    return d.to(torch.float32 if rows.times.dtype == np.float32
                else torch.float64)


def regrid_rows(rows: SeriesRows, grid, *, delays=None, mode: str = "hold",
                device=None, interpret=None, use_kernel=None):
    """Resample all rows onto ``grid`` (absolute seconds) -> (vals, mask),
    (n_streams, G) tensors on ``device`` (None means CUDA).

    delays: (n_streams,) per-row lag in seconds (numpy or a tensor;
    positive = the stream lags the reference); row i is queried at
    ``grid + delay[i]``, formed in float32 as the reference does.
    """
    refuse_unported("regrid_rows", interpret=interpret, use_kernel=use_kernel)
    dev = resolve_device(device)
    g_rel = (np.asarray(grid, np.float64) - rows.t0).astype(rows.times.dtype)
    times, values, n, first = rows.device_arrays(dev)
    vals, mask = grid_resample(times, values, n, first,
                               torch.as_tensor(g_rel, device=dev),
                               _delay_row(rows, delays, dev), mode=mode)
    return vals[:rows.n_streams], mask[:rows.n_streams]


def regrid_rows_host(rows: SeriesRows, grid, *, delays=None,
                     mode: str = "hold"):
    """Float64 mirror of ``regrid_rows`` (numpy results) — the <= 1e-5
    parity oracle.  The query points (grid, delays and their sum) stay
    in the rows' dtype, so the float64 search compares the exact values
    the device compares: a hold lookup is discontinuous at sample times.
    """
    cpu = torch.device("cpu")
    g_rel = (np.asarray(grid, np.float64) - rows.t0).astype(rows.times.dtype)
    out, mask = grid_resample_ref(
        torch.as_tensor(rows.times.astype(np.float64)),
        torch.as_tensor(rows.values.astype(np.float64)),
        torch.as_tensor(rows.n.reshape(-1, 1)),
        torch.as_tensor(rows.first.reshape(-1, 1)),
        torch.as_tensor(g_rel.reshape(-1, 1)),
        _delay_row(rows, delays, cpu).reshape(-1, 1), mode=mode)
    return (out[:rows.n_streams].numpy(), mask[:rows.n_streams].numpy())
