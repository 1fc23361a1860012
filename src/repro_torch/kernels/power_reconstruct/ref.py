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


def reconstruct_power_ref(energy, times, *, wrap_period: float = 0.0):
    """(F, S) energy/times with ONE wrap period -> (F, S) power; column 0
    is 0.  The correction is the plain ``de + wrap`` (not reassociated),
    as the reference's ``reconstruct_power_ref``; the scalars are float32
    in the arithmetic, as there."""
    de = torch.diff(energy, dim=1)
    if wrap_period > 0:
        w = torch.tensor(wrap_period, dtype=de.dtype, device=de.device)
        half = torch.tensor(-0.5 * wrap_period, dtype=de.dtype,
                            device=de.device)
        de = torch.where(de < half, de + w, de)
    dt = torch.diff(times, dim=1)
    dt = torch.maximum(dt, torch.tensor(1e-12, dtype=dt.dtype,
                                        device=dt.device))
    return torch.nn.functional.pad(de / dt, (1, 0))


def reconstruct_power_fleet_ref(energy, times, wrap_row, n_row):
    """The fused fleet front end: (F, S) raw padded reads, (F, 1) wrap
    periods and raw sample counts -> (power, valid, reordered).

    ``valid[i, j]`` (j >= 1) marks a read inside the row's ``n`` whose
    time strictly advanced; power is 0 elsewhere.  ``reordered[i]`` flags
    rows whose timestamps went backwards between two raw reads.
    """
    s = energy.shape[1]
    idx = torch.arange(s, dtype=torch.int32, device=energy.device)[None, :]
    valid = idx < n_row
    adv = torch.nn.functional.pad(times[:, 1:] > times[:, :-1], (1, 0),
                                  value=True)
    valid_out = valid & adv & (idx >= 1)
    power = reconstruct_power_rows_ref(energy, times, wrap_row)
    reordered = torch.any(valid[:, 1:] & valid[:, :-1]
                          & (times[:, 1:] < times[:, :-1]),
                          dim=1, keepdim=True)
    return (torch.where(valid_out, power, torch.zeros((), dtype=power.dtype,
                                                      device=power.device)),
            valid_out, reordered)
