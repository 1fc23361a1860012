"""Device meshes and the fleet-row split (port of the mesh pieces of
``repro/distributed/sharding.py``).

The reference's mesh is single-controller: one program drives every
device of a ``jax.sharding.Mesh`` and ``shard_map`` runs a function on
each device's block.  The port keeps that model with no process groups:
a :class:`Mesh` is an n-d array of ``torch.device`` objects with named
axes, and each sharded function is written as a per-shard part issued
from one Python loop (row-major mesh order; each card's work is
asynchronous, so distinct cards overlap) followed by its combine:

  * the fleet rows need no combine (``fleet_shard_map``),
  * decode attention combines its online-softmax partials and the MoE
    sums its partial outputs, each as a left fold in axis-index order
    on the mesh's first device (``core.reduce.fold_sum``), so a row's
    result never depends on where its shards ran.

A device may repeat in a mesh: one card then stands for several shards
(every ``.to`` of a tensor already there is a no-op), which is how one
card checks the sharded code.  A mesh is all CPU or all CUDA.

Not ported yet (ROADMAP A14): ``ShardingPlan`` and the parameter, batch
and cache shardings of training on a mesh.
"""
from __future__ import annotations

import itertools
import math
import weakref
from typing import Optional

import numpy as np
import torch


def _as_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An n-d array of devices with named axes.

    ``devices``: a nested list (or numpy object array) of
    ``torch.device`` objects or device strings whose shape matches
    ``axis_names``.  ``shape[name]`` is the size of an axis.  A device
    may repeat; CPU and CUDA devices may not mix.
    """

    def __init__(self, devices, axis_names):
        src = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if src.ndim != len(names) or src.size == 0:
            raise ValueError(f"a mesh of shape {src.shape} needs one axis "
                             f"name per dimension, got {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"repeated mesh axis name in {names}")
        raw = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            raw[idx] = _as_device(src[idx])
        kinds = sorted({d.type for d in raw.flat})
        if len(kinds) != 1 or kinds[0] not in ("cpu", "cuda"):
            raise ValueError(f"a mesh is all CPU or all CUDA devices, got "
                             f"{kinds}")
        self.devices = raw
        self.axis_names = names
        self.shape = dict(zip(names, raw.shape))
        self.size = int(raw.size)
        # (id of a source tensor, its slice, device) -> the copy there
        self._placed = {}

    @property
    def device(self) -> torch.device:
        """The mesh's first device: combines and unsharded work run here."""
        return self.devices.flat[0]

    def distinct_devices(self) -> list:
        """The devices of the mesh, each once, in row-major order."""
        out = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def device_at(self, **coords) -> torch.device:
        """The device at the given axis indices (the other axes at 0)."""
        bad = set(coords) - set(self.axis_names)
        if bad:
            raise KeyError(f"no mesh axis {sorted(bad)} in "
                           f"{self.axis_names}")
        return self.devices[tuple(coords.get(a, 0)
                                  for a in self.axis_names)]

    def data_split(self, dp_axes, batch: int) -> tuple:
        """``(axes, n)``: the axes of ``dp_axes`` this mesh has and the
        number of batch blocks they make, or ``((), 1)`` when they do not
        divide ``batch`` (the batch then replicates, as in the
        reference)."""
        axes = tuple(a for a in dp_axes if a in self.axis_names)
        n = math.prod(self.shape[a] for a in axes)
        return (axes, n) if batch % n == 0 else ((), 1)

    def block_index(self, coords: dict, axes) -> int:
        """The row-major index of ``coords`` over ``axes``: a shard's
        batch block."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + coords[a]
        return i

    def put(self, t: torch.Tensor, device, dim: int = 0, start: int = 0,
            stop: Optional[int] = None) -> torch.Tensor:
        """``t``'s slice ``start:stop`` along ``dim`` on ``device``.

        On ``t``'s own device this is a view.  Elsewhere the copy is made
        once and kept until the tensor ``t`` views is freed, so weights a
        shard reads are placed on its device once, not moved each call
        (a layer's weights are a fresh view of the stacked leaf at every
        call: the key is the leaf and the view's place in it).
        """
        device = torch.device(device)
        stop = t.shape[dim] if stop is None else stop
        part = t.narrow(dim, start, stop - start)
        if t.device == device:
            return part
        base = t if t._base is None else t._base
        key = (id(base), t.storage_offset(), tuple(t.shape), t.stride(),
               dim, start, stop, str(device))
        got = self._placed.get(key)
        if got is None:
            got = part.to(device, copy=True)
            self._placed[key] = got
            weakref.finalize(base, self._placed.pop, key, None)
        return got

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, "
                f"{[str(d) for d in self.distinct_devices()]})")


def check_mesh(mesh) -> Optional[Mesh]:
    """``mesh`` if it is None or a :class:`Mesh`; anything else raises."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.distributed.sharding."
                        f"Mesh or None, got {type(mesh).__name__}")
    return mesh


def shard_coords(mesh: Mesh, axes) -> list:
    """Every combination of indices over ``axes`` (a tuple of axis
    names), in row-major mesh order: the shards of a function sharded
    over those axes and replicated over the others."""
    axes = tuple(a for a in mesh.axis_names if a in axes)
    return [dict(zip(axes, idx)) for idx in itertools.product(
        *(range(mesh.shape[a]) for a in axes))]


# ---------------------------------------------------------------------------
# Fleet-axis sharding: the packed (fleet, samples) layout's natural split.
# ---------------------------------------------------------------------------

def fleet_mesh(min_devices: int = 2) -> Optional[Mesh]:
    """1-D ``("fleet",)`` mesh over every local card for fleet-row
    sharding, or None with fewer than ``min_devices`` cards (and with no
    card): the fleet consumers then run exactly the unsharded path."""
    if not torch.cuda.is_available():
        return None
    n = torch.cuda.device_count()
    if n < min_devices:
        return None
    return Mesh([torch.device("cuda", i) for i in range(n)], ("fleet",))


def resolve_fleet_mesh(mesh, device: torch.device) -> Optional[Mesh]:
    """A fleet consumer's ``mesh`` argument on ``device``: ``"auto"`` is
    ``fleet_mesh()`` for a CUDA device and None on the CPU; an explicit
    mesh must be a :class:`Mesh` of ``device``'s type with a ``"fleet"``
    axis."""
    if isinstance(mesh, str) and mesh == "auto":
        return fleet_mesh() if device.type == "cuda" else None
    check_mesh(mesh)
    if mesh is None:
        return None
    if mesh.device.type != device.type:
        raise ValueError(f"a {mesh.device.type} mesh cannot shard work on "
                         f"{device}")
    if "fleet" not in mesh.axis_names:
        raise ValueError(f"a fleet mesh needs a 'fleet' axis, got "
                         f"{mesh.axis_names}")
    return mesh


def fleet_row_padding(mesh: Optional[Mesh], n_rows: int) -> int:
    """Masked rows to append so the fleet axis splits over the mesh (the
    consumers pad with rows that integrate to exactly zero and slice
    them off their outputs)."""
    if mesh is None:
        return 0
    return (-n_rows) % mesh.shape["fleet"]


def fleet_shard_map(fn, mesh: Mesh, n_in: int, n_out: int,
                    replicated_in: tuple = ()):
    """Wrap a row-independent fleet function for per-device execution.

    The returned function splits every input's rows evenly over the
    mesh's ``"fleet"`` axis, except the positions in ``replicated_in``
    (a shared phase table: placed on each device once, ``Mesh.put``),
    runs ``fn`` on each block on its device in axis order, and
    concatenates the ``n_out`` outputs' blocks on the mesh's first
    device.  No collective: each device computes its own rows.
    """
    n = mesh.shape["fleet"]

    def run(*args):
        if len(args) != n_in:
            raise TypeError(f"expected {n_in} inputs, got {len(args)}")
        rows = {a.shape[0] for i, a in enumerate(args)
                if i not in replicated_in}
        if len(rows) != 1 or next(iter(rows)) % n:
            raise ValueError(f"fleet rows {sorted(rows)} do not split over "
                             f"a fleet axis of {n}")
        r = next(iter(rows)) // n
        outs = []
        for c in shard_coords(mesh, ("fleet",)):
            dev = mesh.device_at(**c)
            i = c["fleet"]
            outs.append(fn(*(
                mesh.put(a, dev) if j in replicated_in
                else a[i * r:(i + 1) * r].to(dev)
                for j, a in enumerate(args))))
        first = mesh.device
        if n_out == 1:
            return torch.cat([o.to(first) for o in outs])
        return tuple(torch.cat([o[k].to(first) for o in outs])
                     for k in range(n_out))

    return run
