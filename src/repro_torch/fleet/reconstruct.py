"""Whole-fleet dE/dt reconstruction on the device (port of
``repro/fleet/reconstruct.py``).

  1. dedup+mono    a sample is kept iff its time strictly advanced (cached
                   re-reads republish the same (t, E) pair),
  2. carry-forward dropped samples replicate the last kept (t, E) via
                   cummax + gather, so adjacent diffs bridge them exactly
                   and dropped slots become zero-width intervals,
  3. unwrap+dE/dt  per-row wrap periods corrected per interval.

The common case is ONE fused ``power_reconstruct_fleet`` launch, which
also flags rows whose timestamps went backwards; only then does the
carry-forward path run (plain torch cummax + gather, then the
``power_reconstruct_rows`` kernel).  Kept samples stay in place:
``valid`` marks them.  ``fleet_reconstruct_host`` is the float64 numpy
mirror of the same padded semantics.

With a fleet mesh the rows are split over its devices, each running the
same fused kernel on its block (rows are independent: no collective,
and each row's result is bit-identical to the unsharded one); a row
count that does not divide the mesh is padded with zero-width rows that
are sliced off again.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import refuse_unported, resolve_device
from repro_torch.distributed.sharding import (fleet_row_padding,
                                              fleet_shard_map,
                                              resolve_fleet_mesh)
from repro_torch.fleet.packing import PackedFleet
from repro_torch.kernels.power_reconstruct.kernel import (
    power_reconstruct_fleet_kernel, power_reconstruct_rows_kernel)
from repro_torch.kernels.power_reconstruct.ref import wrapped_diff


def _fleet_fast(energy, times, wrap_period, n_samples):
    """One fused kernel pass -> (power, valid, reordered)."""
    return power_reconstruct_fleet_kernel(
        energy, times, wrap_period[:, None].contiguous(),
        n_samples[:, None].contiguous())


def _fleet_slow(energy, times, valid, wrap_period):
    """Carry-forward path for reordered timestamps: every slot holds the
    last kept (t, E) at or before it, so adjacent diffs bridge dropped
    samples exactly."""
    f, s = times.shape
    adv = torch.nn.functional.pad(times[:, 1:] > times[:, :-1], (1, 0),
                                  value=True)
    keep = valid & adv
    idx = torch.arange(s, device=times.device).expand(f, s)
    last = torch.cummax(torch.where(keep, idx, -1), dim=1).values
    src = last.clamp_min(0)
    t = torch.gather(times, 1, src)
    e = torch.gather(energy, 1, src)
    power = power_reconstruct_rows_kernel(e, t,
                                          wrap_period[:, None].contiguous())
    # a kept sample closes an interval iff a kept sample precedes it
    prev = torch.nn.functional.pad(last[:, :-1], (1, 0), value=-1)
    valid_out = keep & (prev >= 0)
    return torch.where(valid_out, power, torch.zeros(
        (), dtype=power.dtype, device=power.device)), t, valid_out


def fleet_reconstruct(packed: PackedFleet, *, device=None, interpret=None,
                      use_kernel=None, mesh=None):
    """Reconstruct instantaneous power for every stream of the fleet.

    Returns (power, times, valid) as (F, S) tensors on ``device`` (None
    means CUDA): ``power[i, j]`` holds on ``(times[i, j-1], times[i, j]]``
    wherever ``valid[i, j]``.  One fused kernel launch in the common
    case (one a shard on a mesh); the one host read of the kernel's
    per-row ``reordered`` flags decides whether the carry-forward pass
    runs instead (unsharded, on the real rows).

    ``mesh``: None (the default) runs on ``device``; a ``Mesh`` with a
    ``"fleet"`` axis, or ``"auto"`` for every local card when there are
    several (``distributed.sharding.fleet_mesh``), shards the fleet rows,
    padding a row count that does not divide the mesh with masked
    zero-width rows.  The reference defaults to ``"auto"``; the port does
    not, since at a few hundred rows the copies to the other cards cost
    more than they save (PERF.md, the meshes' findings).
    ``interpret=True`` and ``use_kernel=False`` are not ported.
    """
    refuse_unported("fleet_reconstruct", interpret=interpret,
                    use_kernel=use_kernel)
    dev = resolve_device(device)
    mesh = resolve_fleet_mesh(mesh, dev)
    energy = torch.as_tensor(packed.energy, device=dev)
    times = torch.as_tensor(packed.times, device=dev)
    wrap_period = torch.as_tensor(packed.wrap_period, device=dev)
    n_samples = torch.as_tensor(packed.n_samples, dtype=torch.int32,
                                device=dev)
    if mesh is None:
        power, valid, reordered = _fleet_fast(energy, times, wrap_period,
                                              n_samples)
    else:
        f0 = energy.shape[0]
        pad = fleet_row_padding(mesh, f0)

        def padded(x):
            return torch.nn.functional.pad(
                x, (0, 0) * (x.dim() - 1) + (0, pad)) if pad else x
        fast = fleet_shard_map(power_reconstruct_fleet_kernel, mesh,
                               n_in=4, n_out=3)
        power, valid, reordered = (o.to(dev)[:f0] for o in fast(
            padded(energy), padded(times),
            padded(wrap_period)[:, None].contiguous(),
            padded(n_samples)[:, None].contiguous()))
    if bool(reordered.any()):
        return _fleet_slow(energy, times,
                           torch.as_tensor(packed.valid, device=dev),
                           wrap_period)
    return power, times, valid


def fleet_reconstruct_host(packed: PackedFleet):
    """Float64 numpy mirror of ``fleet_reconstruct`` — the fleet-level
    oracle (same padded semantics, host math)."""
    e_in = packed.energy.astype(np.float64)
    t_in = packed.times.astype(np.float64)
    f, s = e_in.shape
    keep = packed.valid & np.concatenate(
        [np.ones((f, 1), bool), t_in[:, 1:] > t_in[:, :-1]], axis=1)
    idx = np.broadcast_to(np.arange(s)[None, :], (f, s))
    src = np.maximum(np.maximum.accumulate(
        np.where(keep, idx, -1), axis=1), 0)
    t = np.take_along_axis(t_in, src, axis=1)
    e = np.take_along_axis(e_in, src, axis=1)
    period = packed.wrap_period.astype(np.float64)[:, None]
    de = wrapped_diff(torch.from_numpy(e), torch.from_numpy(period)).numpy()
    dt = np.maximum(t[:, 1:] - t[:, :-1], 1e-12)
    power = np.pad(de / dt, ((0, 0), (1, 0)))
    valid_out = keep & (np.cumsum(keep, axis=1) >= 2)
    return np.where(valid_out, power, 0.0), t, valid_out
