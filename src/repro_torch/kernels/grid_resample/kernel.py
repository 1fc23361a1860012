"""Wrapper of the ``grid_resample`` CUDA kernel (``csrc/grid_resample.cu``;
replaces the TPU kernel ``grid_resample_kernel`` of
``repro/kernels/grid_resample/kernel.py``)."""
from __future__ import annotations

import torch

from repro_torch.device import refuse_detached
from repro_torch.kernels import build
from repro_torch.kernels.grid_resample.ref import (_ceil_log2,
                                                   grid_resample_ref)

_ARGS = (build.PTR,) * 8 + (build.INT,) * 5 + (build.PTR,)


def grid_resample_kernel(times, values, n_row, first_row, grid, delays, *,
                         mode: str = "hold"):
    """times/values: (F, S) float32; n_row/first_row: (F,) int32;
    grid: (G,) float32; delays: (F,) float32 -> (out (F, G) float32,
    mask (F, G) bool).

    Each row must be non-decreasing in ``[first_row, n_row)`` (slots
    outside may hold anything), with ``0 <= first_row`` and ``n_row <=
    S``; on such rows every lower bound is unique.  A CPU tensor takes the
    plain version (its ``torch.searchsorted`` lower bound, index-identical
    to the reference's halving loop); a CUDA tensor launches the kernel on
    the current stream.  The kernel is fastest when ``grid`` is sorted
    (as ``ops.grid_resample`` keeps it): it then searches each run of 32
    queries between the lower bounds of its ends.  Where 32 consecutive
    queries are out of order (an unsorted or NaN grid) it searches each
    over the whole row instead: the same indices.
    """
    if mode not in ("hold", "linear"):
        raise ValueError(f"grid_resample: unknown mode {mode!r}")
    dev = times.device
    if dev.type == "cpu":
        return grid_resample_ref(times, values, n_row.reshape(-1, 1),
                                 first_row.reshape(-1, 1),
                                 grid.reshape(-1, 1), delays.reshape(-1, 1),
                                 mode=mode, sorted_search=True)
    if dev.type != "cuda":
        raise ValueError(f"grid_resample: unsupported device {dev}")
    refuse_detached("grid_resample", times, values, grid, delays, item="B5")
    f, s = times.shape
    g = grid.shape[0]
    for x, what, dtype, shape in (
            (times, "times", torch.float32, (f, s)),
            (values, "values", torch.float32, (f, s)),
            (n_row, "n_row", torch.int32, (f,)),
            (first_row, "first_row", torch.int32, (f,)),
            (grid, "grid", torch.float32, (g,)),
            (delays, "delays", torch.float32, (f,))):
        build.check_tensor(x, what, dtype=dtype, shape=shape, device=dev)
    out = torch.empty((f, g), dtype=torch.float32, device=dev)
    mask = torch.empty((f, g), dtype=torch.bool, device=dev)
    fn = build.c_function("grid_resample_launch", _ARGS)
    with torch.cuda.device(dev):
        rc = fn(times.data_ptr(), values.data_ptr(), n_row.data_ptr(),
                first_row.data_ptr(), grid.data_ptr(), delays.data_ptr(),
                out.data_ptr(), mask.data_ptr(), f, s, g,
                _ceil_log2(s) + 1, int(mode == "linear"),
                build.stream_ptr(dev))
    build.check_launch(rc, "grid_resample")
    grid_resample_kernel.launches += 1
    return out, mask


grid_resample_kernel.launches = 0
