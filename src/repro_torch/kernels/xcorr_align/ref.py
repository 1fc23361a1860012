"""Plain PyTorch version of the lag-bank correlation (port of
``repro/kernels/xcorr_align/ref.py``)."""
from __future__ import annotations

import torch


def xcorr_scores_ref(x, m, refbank):
    """x: (F, G) streams; m: (F, G) 0/1 validity; refbank: (L, G)
    lag-shifted, mean-centred reference rows -> (F, L) scores:

        score[f, l] = <(x_f - mean_f)·m_f, refbank_l> / (‖·‖ ‖·‖ + 1e-12)
    """
    cnt = torch.clamp_min(torch.sum(m, dim=1, keepdim=True), 1.0)
    mean = torch.sum(x * m, dim=1, keepdim=True) / cnt
    xc = (x - mean) * m
    den_x = torch.sqrt(torch.sum(xc * xc, dim=1, keepdim=True))
    den_r = torch.sqrt(torch.sum(refbank * refbank, dim=1))[None, :]
    num = xc @ refbank.T
    return num / (den_x * den_r + 1e-12)
