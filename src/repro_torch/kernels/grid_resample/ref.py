"""Plain PyTorch version of the regrid (port of
``repro/kernels/grid_resample/ref.py``).

Hold convention: the value at a query is the FIRST sample with
t >= query (lower bound), i.e. the interval average covering it on a
reconstructed dE/dt row.  The lower bound is unique, so the halving loop
and ``torch.searchsorted`` give identical indices.
"""
from __future__ import annotations

import torch


def _ceil_log2(n: int) -> int:
    k = 0
    while (1 << k) < n:
        k += 1
    return k


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis on dim 1 with broadcast row indices."""
    return torch.gather(a, 1, idx.expand(a.shape[0], -1))


def searchsorted_rows(t, target, lo, hi):
    """Per-row lower bound: first j in [lo, hi) with ``t[r, j] >=
    target[r, g]`` (hi if none), by ``ceil(log2 S) + 1`` branch-free
    halving steps — the CUDA kernel's loop, step for step."""
    s = t.shape[1]
    lo = lo.to(torch.int32).expand(target.shape).clone()
    hi = hi.to(torch.int32).expand(target.shape).clone()
    for _ in range(_ceil_log2(s) + 1):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        tm = torch.gather(t, 1, mid.clamp(0, s - 1).long())
        go_right = (tm < target) & (mid < hi)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, torch.minimum(mid, hi))
    return lo


def searchsorted_rows_sorted(t, target, lo, hi):
    """``searchsorted_rows`` via ``torch.searchsorted``: slots before
    ``lo`` become -inf and slots at/after ``hi`` +inf, which keeps each
    row sorted and out of every query's range; identical indices."""
    s = t.shape[1]
    j = torch.arange(s, device=t.device)[None, :]
    t_m = torch.where(j < lo, -torch.inf,
                      torch.where(j >= hi, torch.inf, t)).contiguous()
    idx = torch.searchsorted(t_m, target.contiguous(), side="left")
    idx = idx.to(torch.int32)
    return torch.minimum(torch.maximum(idx, lo.to(torch.int32)),
                         hi.to(torch.int32))


def grid_resample_ref(times, values, n_row, first_row, grid, delays, *,
                      mode: str = "hold", sorted_search: bool = False):
    """times/values: (R, S); n_row/first_row: (R, 1) int; delays: (R, 1);
    grid: (G, 1) -> (out, mask), each (R, G).

    ``out[r, g]`` is row r at ``grid[g] + delays[r]``; ``mask`` marks
    queries inside [t[first], t[n-1]]."""
    s = times.shape[1]
    ge = grid[:, 0][None, :] + delays                 # (R, G)
    n_i = n_row.to(torch.int32)
    first = first_row.to(torch.int32)
    if sorted_search:
        idx = searchsorted_rows_sorted(times, ge, first, n_i)
    else:
        idx = searchsorted_rows(times, ge, first, n_i)
    last = torch.clamp_min(n_i - 1, 0)
    t_first = _take(times, torch.clamp_max(first, s - 1).long())
    t_last = _take(times, last.long())
    mask = (ge >= t_first) & (ge <= t_last) & (n_i > first)

    def at(a, j):
        return torch.gather(a, 1, j.clamp(0, s - 1).long())

    if mode == "hold":
        j = torch.minimum(torch.maximum(idx, first), last)
        out = at(values, j)
    else:                                             # linear
        j_hi = torch.minimum(torch.maximum(idx, first + 1), last)
        j_lo = torch.clamp_min(j_hi - 1, 0)
        t_lo, t_hi = at(times, j_lo), at(times, j_hi)
        v_lo, v_hi = at(values, j_lo), at(values, j_hi)
        tiny = torch.tensor(1e-12, dtype=times.dtype, device=times.device)
        frac = torch.clamp((ge - t_lo) / torch.maximum(t_hi - t_lo, tiny),
                           0.0, 1.0)
        out = v_lo + frac * (v_hi - v_lo)
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device)), mask
