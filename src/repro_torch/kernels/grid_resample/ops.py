"""Public op: batched delay-shifted regridding onto a shared grid (port of
``repro/kernels/grid_resample/ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.grid_resample.kernel import grid_resample_kernel

GRID_ALIGN = 512


def grid_resample(times, values, n_row, first_row, grid, delays, *,
                  mode: str = "hold"):
    """Resample a padded fleet onto one grid -> (out, mask), each (F, G).

    times/values: (F, S), each row non-decreasing in [first, n);
    n_row/first_row/delays: (F,) or (F, 1); grid: (G,) or (G, 1), sorted
    for the kernel's fast path (any order gives the same result).  G is
    padded to ``GRID_ALIGN`` (replicating the last query point, which
    keeps a sorted grid sorted) and sliced back, as the reference op does.
    """
    n_row = n_row.reshape(-1).to(torch.int32).contiguous()
    first_row = first_row.reshape(-1).to(torch.int32).contiguous()
    delays = delays.reshape(-1).to(times.dtype).contiguous()
    grid = grid.reshape(-1).to(times.dtype)
    g = grid.shape[0]
    pad = (-g) % GRID_ALIGN
    if pad:
        grid = torch.cat([grid, grid[-1:].expand(pad)])
    out, mask = grid_resample_kernel(times, values, n_row, first_row,
                                     grid.contiguous(), delays, mode=mode)
    return out[:, :g], mask[:, :g]
