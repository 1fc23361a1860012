"""Public op: lag-bank construction + batched correlation scores (port of
``repro/kernels/xcorr_align/ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.xcorr_align.kernel import xcorr_align_kernel

LAG_ALIGN = 128
ROW_ALIGN = 8          # the fleet row tile (matches fleet packing)


def make_refbank(ref: torch.Tensor, *, max_lag: int) -> torch.Tensor:
    """Reference (G,) -> (2*max_lag+1, G) bank of shifted centred copies:
    ``refbank[l, g] = ref_c[g - (l - max_lag)]``, zeros shifted in, so a
    stream that lags the reference by d grid steps peaks at row
    ``max_lag + d``.  Plain PyTorch (the reference's is plain jnp too)."""
    g = ref.shape[0]
    ref_c = ref - torch.mean(ref)
    lags = torch.arange(-max_lag, max_lag + 1, device=ref.device)
    src = torch.arange(g, device=ref.device)[None, :] - lags[:, None]
    ok = (src >= 0) & (src < g)
    return torch.where(ok, ref_c[src.clamp(0, g - 1)],
                       torch.zeros((), dtype=ref.dtype, device=ref.device))


def xcorr_scores(x, m, refbank):
    """(F, G) streams + mask vs (L, G) bank -> (F, L) scores.

    Pads L to ``LAG_ALIGN`` with all-zero bank rows (they score 0: the
    plain version through the eps-guarded norm, the CUDA kernel without
    a product) and F to ``ROW_ALIGN`` with zero rows, and slices both
    back, as the reference op does.  The CUDA kernel's row scores do not
    depend on F, so the padding changes no score.
    """
    m = m.to(x.dtype)
    f, g = x.shape
    lags = refbank.shape[0]
    pad_l = (-lags) % LAG_ALIGN
    if pad_l:
        refbank = torch.cat([refbank, refbank.new_zeros((pad_l, g))])
    pad_f = (-f) % ROW_ALIGN if f > ROW_ALIGN else 0
    if pad_f:
        x = torch.cat([x, x.new_zeros((pad_f, g))])
        m = torch.cat([m, m.new_zeros((pad_f, g))])
    scores = xcorr_align_kernel(x.contiguous(), m.contiguous(),
                                refbank.contiguous(), n_lags=lags)
    return scores[:f, :lags]
