"""Plain PyTorch version of the rows dE/dt (port of
``repro/kernels/power_reconstruct/ref.py``: ``wrapped_diff`` and
``reconstruct_power_rows_ref``)."""
from __future__ import annotations

import torch


def wrapped_diff(e: torch.Tensor, wrap_row: torch.Tensor) -> torch.Tensor:
    """Per-row wrap-corrected dE along axis 1 (canonical definition).

    The correction is reassociated as ``e_i + (w - e_{i-1})``: both
    subtractions are Sterbenz-exact in float32, so dE never rounds at the
    counter's full magnitude.
    """
    de = e[:, 1:] - e[:, :-1]
    return torch.where((wrap_row > 0) & (de < -0.5 * wrap_row),
                       e[:, 1:] + (wrap_row - e[:, :-1]), de)


def reconstruct_power_rows_ref(energy, times, wrap_row):
    """(F, S) energy/times + (F, 1) wrap periods (0 = none) -> (F, S)
    power; column 0 is 0."""
    de = wrapped_diff(energy, wrap_row)
    dt = torch.diff(times, dim=1)
    dt = torch.maximum(dt, torch.tensor(1e-12, dtype=dt.dtype,
                                        device=dt.device))
    return torch.nn.functional.pad(de / dt, (1, 0))
