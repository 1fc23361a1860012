"""Wrapper of the ``xcorr_align`` CUDA kernel (``csrc/xcorr_align.cu``;
replaces the TPU kernel ``xcorr_align_kernel`` of
``repro/kernels/xcorr_align/kernel.py``)."""
from __future__ import annotations

import math

import torch

from repro_torch.device import refuse_detached
from repro_torch.kernels import build
from repro_torch.kernels.xcorr_align.ref import xcorr_scores_ref

STAGE = 32             # grid points a stage of the product (kBK)
SPLIT_POINTS = 32768   # grid points a split aims to give the card at once
MAX_CHUNKS = 16

_ARGS = (build.PTR,) * 8 + (build.INT,) * 6 + (build.PTR,)


def split_plan(g: int) -> tuple:
    """(stages per chunk, chunks) of the product's split of G grid points:
    a function of G alone, never of the row count, so a row's summation
    order (and its bits) never depends on the rows scored with it.

    The chunk count is the power of two nearest SPLIT_POINTS / G, at most
    MAX_CHUNKS: 16 chunks of 4 stages at the windowed path's G = 2048 and
    2 at the batch path's ~16k, so that at their 1024 rows every SM gets
    a block of whole lag tiles.
    """
    stages = -(-g // STAGE)
    if stages <= 1:
        return 1, 1
    want = 2 ** round(math.log2(SPLIT_POINTS / g))
    per = -(-stages // min(max(want, 1), MAX_CHUNKS))
    return per, -(-stages // per)


def xcorr_align_kernel(x, m, refbank, *, n_lags: int,
                       rows_alone: bool = False):
    """x/m: (F, G) float32 streams and 0/1 validity; refbank: (L, G)
    float32 whose rows from ``n_lags`` on are zero padding -> (F, L)
    float32 normalized scores (those of the padding are 0).

    A CPU tensor takes the plain version over the whole bank; with
    ``rows_alone`` one row a call, so a row's scores do not depend on the
    rows scored with it (a CPU matmul's blocking does; the kernel's
    never do).  A CUDA tensor launches the kernel (two or three CUDA
    launches, one call) on the current stream, which writes the
    padding's zeros without a product.
    """
    dev = x.device
    if dev.type == "cpu":
        if rows_alone:
            return torch.cat([xcorr_scores_ref(x[i:i + 1], m[i:i + 1],
                                               refbank)
                              for i in range(x.shape[0])])
        return xcorr_scores_ref(x, m, refbank)
    if dev.type != "cuda":
        raise ValueError(f"xcorr_align: unsupported device {dev}")
    refuse_detached("xcorr_align", x, m, refbank, item="B4")
    f, g = x.shape
    lags = refbank.shape[0]
    if not 0 <= n_lags <= lags:
        raise ValueError(f"xcorr_align: n_lags {n_lags} outside [0, {lags}]")
    for t, what, shape in ((x, "x", (f, g)), (m, "m", (f, g)),
                           (refbank, "refbank", (lags, g))):
        build.check_tensor(t, what, dtype=torch.float32, shape=shape,
                           device=dev)
    per, chunks = split_plan(g)
    mean = torch.empty((f,), dtype=torch.float32, device=dev)
    den_x = torch.empty((f,), dtype=torch.float32, device=dev)
    den_r = torch.empty((n_lags,), dtype=torch.float32, device=dev)
    part = torch.empty((chunks, f, -(-n_lags // 8) * 8) if chunks > 1
                       else (0,), dtype=torch.float32, device=dev)
    out = torch.empty((f, lags), dtype=torch.float32, device=dev)
    fn = build.c_function("xcorr_align_launch", _ARGS)
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), m.data_ptr(), refbank.data_ptr(),
                mean.data_ptr(), den_x.data_ptr(), den_r.data_ptr(),
                part.data_ptr() if chunks > 1 else None, out.data_ptr(),
                f, g, lags, n_lags, per, chunks, build.stream_ptr(dev))
    build.check_launch(rc, "xcorr_align")
    xcorr_align_kernel.launches += 1
    return out


xcorr_align_kernel.launches = 0
