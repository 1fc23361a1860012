"""Plain PyTorch version of the segmented per-phase integration (port of
``repro/kernels/phase_integrate/ref.py``)."""
from __future__ import annotations

import torch


def phase_energies_ref(times, watts, phases):
    """times/watts: (R, S) sample-and-hold power (``watts[:, i]`` holds on
    ``(times[:, i-1], times[:, i]]``; column 0 is zero-width); phases:
    (P, 2) [a, b) windows -> (R, P) energies.  Materializes (P, R, S)."""
    t_lo = torch.cat([times[:, :1], times[:, :-1]], dim=1)
    a = phases[:, 0][:, None, None]
    b = phases[:, 1][:, None, None]
    overlap = torch.clamp_min(
        torch.minimum(times[None], b) - torch.maximum(t_lo[None], a), 0.0)
    return torch.sum(overlap * watts[None], dim=-1).T
