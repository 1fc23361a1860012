"""Fleet-wide sensor delay estimation by lag-bank cross-correlation
(port of ``repro/align/delay.py``: the device path and its float64 host
mirrors ``make_refbank_host`` / ``estimate_delays_host``).

Every stream is scored in one ``xcorr_align`` call against a shared
reference (the known phase schedule, or a chosen stream), and each
stream's lag is read off the correlation peak with 3-point parabolic
sub-sample refinement, in float64 on the device.

Sign convention: positive delay means the stream LAGS the reference.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch.kernels.xcorr_align.ops import make_refbank, xcorr_scores
from repro_torch.kernels.xcorr_align.ref import xcorr_scores_ref


@dataclasses.dataclass
class DelayEstimate:
    """Per-stream lag against the reference, in seconds and grid steps
    (float64 tensors on the scoring device)."""
    delay_s: torch.Tensor     # (K,) seconds; positive = stream lags ref
    peak_corr: torch.Tensor   # (K,) normalized score at the peak
    lag_steps: torch.Tensor   # (K,) sub-sample peak location
    step: float               # grid step the lags are quantized to


def peak_to_delay(scores: torch.Tensor, step: float,
                  max_lag: int) -> DelayEstimate:
    """(K, L) correlation scores -> per-row sub-sample delay.

    3-point parabolic refinement around the argmax (the first maximum on
    ties); at the bank's edge the raw argmax is kept.
    """
    s = scores.to(torch.float64)
    n_lags = s.shape[1]
    rows = torch.arange(s.shape[0], device=s.device)
    peak = torch.argmax(s, dim=1)
    interior = (peak >= 1) & (peak <= n_lags - 2)
    p = peak.clamp(1, n_lags - 2)
    s0, s1, s2 = s[rows, p - 1], s[rows, p], s[rows, p + 1]
    denom = s0 - 2.0 * s1 + s2
    flat = torch.abs(denom) <= 1e-12      # flat 3-point top: keep argmax
    delta = torch.where(flat, 0.0,
                        0.5 * (s0 - s2) / torch.where(flat, 1.0, denom))
    delta = torch.where(interior, torch.clamp(delta, -0.5, 0.5), 0.0)
    lag = peak.to(torch.float64) + delta - max_lag
    return DelayEstimate(delay_s=lag * step, peak_corr=s[rows, peak],
                         lag_steps=lag, step=float(step))


def stream_reference(values_row: torch.Tensor,
                     mask_row: torch.Tensor) -> torch.Tensor:
    """A chosen stream as reference: mean-centred over its valid span,
    zeroed elsewhere (float64, on the stream's device)."""
    v = values_row.to(torch.float64)
    m = mask_row.to(torch.bool)
    cnt = m.sum()
    mean = torch.where(m, v, 0.0).sum() / torch.clamp_min(cnt, 1)
    return torch.where(cnt > 0, torch.where(m, v - mean, 0.0), v)


class RefbankCache:
    """Lag banks are pure functions of (ref, max_lag): memoized by a
    content digest so repeated scoring against one reference skips the
    (L, G) shift/gather.  Bounded: cleared past ``max_entries``."""

    def __init__(self, max_entries: int = 16):
        self.max_entries = max_entries
        self._banks: dict = {}

    def get(self, ref: np.ndarray, max_lag: int, dtype, device):
        ref = np.ascontiguousarray(ref, np.float64)
        key = (zlib.crc32(ref.tobytes()), ref.shape[0], max_lag,
               str(dtype), str(device))
        bank = self._banks.get(key)
        if bank is None:
            bank = make_refbank(torch.as_tensor(ref, dtype=dtype,
                                                device=device),
                                max_lag=max_lag)
            if len(self._banks) >= self.max_entries:
                self._banks.clear()
            self._banks[key] = bank
        return bank


def delay_scores(values: torch.Tensor, mask: torch.Tensor, ref, *,
                 max_lag: int, bank_cache: RefbankCache = None,
                 rows_alone: bool = False) -> torch.Tensor:
    """Raw (K, L) lag-bank correlations BEFORE the parabolic refine.

    ``ref`` is the (G,) reference on the host (numpy) or the device
    (tensor).  The kernel's row scores do not depend on how many rows
    are scored together (it sums each output in one thread, in a fixed
    order); ``rows_alone`` secures the same of the CPU's plain version,
    as the reference's tracker does by pinning ROW_ALIGN.
    """
    if isinstance(ref, torch.Tensor):
        bank = make_refbank(ref.to(values.dtype), max_lag=max_lag)
    else:
        cache = bank_cache if bank_cache is not None else RefbankCache(1)
        bank = cache.get(ref, max_lag, values.dtype, values.device)
    return xcorr_scores(values, mask.to(values.dtype), bank,
                        rows_alone=rows_alone)


def estimate_delays(values, mask, ref, *, step: float, max_lag: int,
                    bank_cache: RefbankCache = None,
                    rows_alone: bool = False) -> DelayEstimate:
    """Delay of every co-gridded stream against one reference.

    values/mask: (K, G) on the device; ref: (G,) reference on the same
    grid; step: the grid step (seconds); max_lag: half-width of the
    search window in grid steps.
    """
    scores = delay_scores(values, mask, ref, max_lag=max_lag,
                          bank_cache=bank_cache, rows_alone=rows_alone)
    return peak_to_delay(scores, step, max_lag)


def schedule_reference(truth, grid) -> np.ndarray:
    """The known phase schedule sampled on the grid (float64 watts, host);
    ``truth`` is anything with ``power_at`` (a ``PiecewisePower``)."""
    return truth.power_at(np.asarray(grid, np.float64))


def make_refbank_host(ref, *, max_lag: int) -> np.ndarray:
    """Float64 numpy mirror of ``make_refbank``."""
    ref = np.asarray(ref, np.float64)
    g = ref.shape[0]
    ref_c = ref - ref.mean()
    lags = np.arange(-max_lag, max_lag + 1)
    src = np.arange(g)[None, :] - lags[:, None]
    ok = (src >= 0) & (src < g)
    return np.where(ok, ref_c[np.clip(src, 0, g - 1)], 0.0)


def estimate_delays_host(values, mask, ref, *, step: float,
                         max_lag: int) -> DelayEstimate:
    """Float64 host mirror of ``estimate_delays`` (parity oracle): the
    plain scores in float64 on the CPU; the estimate's tensors are float64
    on the CPU."""
    def host64(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return torch.as_tensor(np.asarray(a, np.float64))
    bank = torch.as_tensor(make_refbank_host(ref, max_lag=max_lag))
    scores = xcorr_scores_ref(host64(values), host64(mask), bank)
    return peak_to_delay(scores, step, max_lag)
