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

Training on a mesh (the reference's ``ShardingPlan``):

  * :class:`ShardingPlan` maps each leaf's logical axes to a spec, a
    plain tuple with one entry per dim (None, a mesh axis name, or a
    tuple of names: the reference's ``PartitionSpec`` entries, with a
    one-name tuple written as the name, as ``PartitionSpec`` writes
    it), and gives the parameter, batch and decode-cache shardings;
  * :func:`place` stores a tensor by a :class:`Sharding` as a
    :class:`Placed` leaf: each block at the devices of the mesh
    coordinates that hold it, once per distinct device, and
    ``Placed.full`` gathers it back;
  * :func:`block_view` and :func:`take` are how one data block's
    forward reads a leaf: each shard gathers the slice it computes with
    onto its device.  A piece that several consumers read goes to them
    through one :func:`broadcast`, whose backward folds their gradients
    in consumer order (``fold_sum``), so no gradient is summed by
    autograd across devices in the order the devices finish.
"""
from __future__ import annotations

import dataclasses
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
        # bytes of weight pieces that ``take`` assembled on a shard from
        # blocks its own coordinate does not hold (FSDP's gathers)
        self.gathered_bytes = 0

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


# ---------------------------------------------------------------------------
# The sharding plan: logical parameter/activation axes -> mesh axes
# ---------------------------------------------------------------------------

FSDP_THRESHOLD = 500_000_000   # params; above this, shard "embed" on data


def _norm_entry(m):
    """A spec entry as ``PartitionSpec`` writes it: a one-name tuple is
    the name."""
    if isinstance(m, tuple) and len(m) == 1:
        return m[0]
    return m


def entry_axes(entry) -> tuple:
    """A spec entry's mesh axes: () for None, (name,) for a name, else
    the tuple (the first axis major)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a leaf lives: a :class:`Mesh` and a spec, one entry per dim
    (trailing dims past the spec are replicated), as the reference's
    ``NamedSharding(mesh, PartitionSpec)``."""
    mesh: Mesh
    spec: tuple


def _shape_of(s) -> tuple:
    """A struct's shape: a tensor's or array's, or a ``(shape, dtype)``
    pair's (``Model.cache_specs``)."""
    return tuple(s.shape) if hasattr(s, "shape") else tuple(s[0])


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """The reference's plan (``repro/distributed/sharding.py``):

      * TP (``"model"``): attention q/kv features, FFN hidden, MoE
        experts, Mamba inner channels, the vocabulary;
      * DP (``dp_axes``): the batch;
      * FSDP (``"data"``, when ``fsdp``): the ``embed`` dim of every
        2-D+ weight but the vocabulary tables;
      * decode caches: the sequence on ``"model"``, the batch on DP when
        it divides.
    """
    mesh: Mesh
    fsdp: bool
    dp_axes: tuple            # ("pod", "data") or ("data",)

    def _axis(self, logical: Optional[str]):
        if logical is None:
            return None
        table = {
            "vocab": "model",
            "q_features": "model",
            "kv_features": "model",
            "mlp": "model",
            "expert": "model",
            "mamba_inner": "model",
            "embed": "data" if self.fsdp else None,
            "fsdp": "data" if self.fsdp else None,
            "layers": None,
            "batch": self.dp_axes,
        }
        return table.get(logical, None)

    def _mesh_size(self, m) -> int:
        return math.prod(self.mesh.shape[a] for a in entry_axes(m))

    def spec_for(self, axes: tuple, shape: Optional[tuple] = None) -> tuple:
        """The spec of a leaf with logical ``axes``: a vocabulary table
        takes no FSDP on ``embed``, no mesh axis serves two dims, and a
        dim the axis does not divide stays replicated."""
        mesh_axes = []
        used = set()
        no_fsdp = "vocab" in axes
        for i, a in enumerate(axes):
            m = self._axis(a)
            if a == "embed" and no_fsdp:
                m = None
            if m is not None and not isinstance(m, tuple) and m in used:
                m = None
            if m is not None and shape is not None \
                    and shape[i] % self._mesh_size(m) != 0:
                m = None
            if m is not None:
                used.add(m if not isinstance(m, tuple) else "_dp")
            mesh_axes.append(_norm_entry(m))
        return tuple(mesh_axes)

    def param_shardings(self, logical_axes_tree, structs_tree=None):
        """A tree of :class:`Sharding` shaped like ``logical_axes_tree``
        (``Model.param_logical_axes()``); with ``structs_tree``
        (``Model.param_structs()``) a dim its axis does not divide
        stays replicated."""
        from repro_torch.models.layers import tree_map
        if structs_tree is None:
            return tree_map(lambda ax: Sharding(self.mesh,
                                                self.spec_for(ax)),
                            logical_axes_tree)
        return tree_map(lambda ax, s: Sharding(
            self.mesh, self.spec_for(ax, _shape_of(s))),
            logical_axes_tree, structs_tree)

    # -- activations / batch ---------------------------------------------
    def dp_size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.dp_axes)

    def batch_spec(self, global_batch: int, ndim: int) -> tuple:
        dp = self.dp_axes if global_batch % self.dp_size() == 0 else None
        return (_norm_entry(dp),) + (None,) * (ndim - 1)

    def batch_shardings(self, batch_structs):
        """A :class:`Sharding` for each leaf of a batch: the leading dim
        on DP when it divides, except ``(3, B, S)`` M-RoPE positions,
        whose second dim is the batch."""
        from repro_torch.models.layers import tree_map

        def shard_one(s):
            shape = _shape_of(s)
            if len(shape) == 0:
                return Sharding(self.mesh, ())
            if len(shape) == 3 and shape[0] == 3:
                return Sharding(self.mesh,
                                (None,) + self.batch_spec(shape[1], 2))
            return Sharding(self.mesh, self.batch_spec(shape[0],
                                                       len(shape)))
        return tree_map(shard_one, batch_structs)

    # -- decode caches -----------------------------------------------------
    def cache_shardings(self, cache_structs, batch_size: int):
        """A :class:`Sharding` for each leaf of a decode cache
        (``Model.cache_specs``' ``(shape, dtype)`` pairs, or tensors):
        ``k``/``v``/``cross_*`` (G, B, S, kv, h) on the sequence,
        ``ssm`` (G, B, d_in, N) and ``conv`` (G, B, dc-1, d_in) on
        d_in, ``C`` (G, B, H, dk, dv) on dv, the batch on DP when
        ``batch_size`` divides; a dim ``"model"`` does not divide
        stays replicated."""
        from repro_torch.models.layers import tree_map
        batched = batch_size % self.dp_size() == 0
        model_n = self.mesh.shape["model"]
        dp = _norm_entry(self.dp_axes) if batched else None

        def shard_one(path, s):
            shape = _shape_of(s)

            def ns(*spec):
                fixed = [None if m == "model" and shape[i] % model_n
                         else m for i, m in enumerate(spec)]
                fixed += [None] * (len(shape) - len(fixed))
                return Sharding(self.mesh, tuple(fixed))

            name = path[-1]
            if name in ("k", "v", "cross_k", "cross_v"):
                return ns(None, dp, "model")
            if name == "ssm":
                return ns(None, dp, "model")
            if name == "conv":
                return ns(None, dp, None, "model")
            if name == "C":
                return ns(None, dp, None, None, "model")
            return ns(None, dp)

        return tree_map(shard_one, cache_structs, path=())


def make_plan(mesh: Mesh, arch_params: int) -> ShardingPlan:
    """The reference's plan for a model of ``arch_params`` parameters:
    DP over the mesh's ``pod``/``data`` axes, FSDP past
    ``FSDP_THRESHOLD`` when the mesh has a ``data`` axis."""
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    fsdp = arch_params > FSDP_THRESHOLD and "data" in mesh.axis_names
    return ShardingPlan(mesh=mesh, fsdp=fsdp, dp_axes=dp_axes)


# ---------------------------------------------------------------------------
# Placement: a leaf stored by a Sharding, and the gathers that read it
# ---------------------------------------------------------------------------

def _coords(mesh: Mesh) -> list:
    """Every mesh coordinate, row-major: (index tuple, {axis: index})."""
    return [(idx, dict(zip(mesh.axis_names, idx)))
            for idx in np.ndindex(mesh.devices.shape)]


class Placed:
    """A leaf stored by a :class:`Sharding`.

    The spec cuts each dim into ``grid[d]`` equal blocks; block ``idx``
    (one index a dim) is held by every mesh coordinate whose indices
    over the dim's axes give it, and stored once on each distinct device
    among them: ``copies[idx]`` maps those devices to their copies, the
    owner (the first such coordinate's device, row-major) first.  A
    device that repeats in the mesh holds a block once.  The optimizer
    updates the owner's copy and :meth:`sync` copies it to the rest.
    """

    def __init__(self, sharding: Sharding, shape, dtype, copies: dict):
        self.sharding = sharding
        self.spec = tuple(sharding.spec) + (None,) * (
            len(shape) - len(sharding.spec))
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.copies = copies
        mesh = sharding.mesh
        self.grid = tuple(math.prod(mesh.shape[a] for a in entry_axes(e))
                          for e in self.spec)
        for d, (n, g) in enumerate(zip(self.shape, self.grid)):
            if n % g:
                raise ValueError(f"dim {d} of {tuple(self.shape)} does not "
                                 f"split into {g} blocks ({self.spec})")

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def dim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return math.prod(self.shape)

    def block_of(self, coords: dict) -> tuple:
        """The block a mesh coordinate holds."""
        return tuple(self.mesh.block_index(coords, entry_axes(e))
                     for e in self.spec)

    def indices(self) -> list:
        """Every block index, row-major."""
        return list(np.ndindex(*self.grid)) if self.grid else [()]

    def bounds(self, idx) -> tuple:
        """Block ``idx``'s ``(lo, hi)`` in each dim."""
        return tuple((i * (n // g), (i + 1) * (n // g))
                     for i, n, g in zip(idx, self.shape, self.grid))

    def owner(self, idx) -> torch.Tensor:
        return next(iter(self.copies[idx].values()))

    def owners(self) -> list:
        return [self.owner(idx) for idx in self.indices()]

    def full(self, device=None) -> torch.Tensor:
        """The whole leaf on ``device`` (the mesh's first device), from
        the owners' copies (a leaf of one block: its copy there, if it
        has one)."""
        device = self.device if device is None else torch.device(device)
        if all(g == 1 for g in self.grid):
            got = self.copies[self.indices()[0]]
            return got[device] if device in got else \
                self.owner(self.indices()[0]).to(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for idx in self.indices():
            out[tuple(slice(a, b) for a, b in self.bounds(idx))] = \
                self.owner(idx)
        return out

    def __getitem__(self, gi: int) -> "Placed":
        """Group ``gi`` of a leaf whose first dim is not split: views of
        every copy (writes go through)."""
        if not isinstance(gi, int) or self.grid[0] != 1:
            raise TypeError("a Placed leaf takes one int index on an "
                            "unsplit first dim")
        return Placed(Sharding(self.mesh, self.spec[1:]), self.shape[1:],
                      self.dtype, {idx[1:]: {d: t[gi] for d, t in c.items()}
                                   for idx, c in self.copies.items()})

    def write(self, index, value) -> None:
        """``leaf[index] = value`` on every copy of every block the
        region meets; ``index`` is a tuple of ints and step-1 slices
        (basic indexing)."""
        index = index if isinstance(index, tuple) else (index,)
        region, keep = [], []
        for d, n in enumerate(self.shape):
            ix = index[d] if d < len(index) else slice(None)
            if isinstance(ix, slice):
                lo, hi, step = ix.indices(n)
                if step != 1:
                    raise ValueError("Placed.write takes step-1 slices")
                region.append((lo, max(lo, hi)))
                keep.append(True)
            else:
                i = int(ix) % n
                region.append((i, i + 1))
                keep.append(False)
        value = torch.as_tensor(value)
        value = value.broadcast_to(tuple(b - a for (a, b), k in
                                         zip(region, keep) if k))
        for idx in self.indices():
            dst, src = [], []
            for (a, b), (lo, hi), k in zip(region, self.bounds(idx), keep):
                s, e = max(a, lo), min(b, hi)
                if s >= e:
                    break
                dst.append(slice(s - lo, e - lo) if k else s - lo)
                if k:
                    src.append(slice(s - a, e - a))
            else:
                part = value[tuple(src)]
                for t in self.copies[idx].values():
                    t[tuple(dst)] = part.to(t.device)

    def __setitem__(self, index, value) -> None:
        self.write(index, value)

    def write_rows(self, slot: torch.Tensor, value: torch.Tensor) -> None:
        """``leaf[r, slot[r]] = value[r]`` for every row r of a (B, S,
        ...) leaf, block by block, each block's rows whose slot it holds
        (a masked write on the block's device: no host sync; ``slot``
        and ``value`` sent to each device once)."""
        sent = {}
        for idx in self.indices():
            (b0, b1), (s0, s1) = self.bounds(idx)[:2]
            for t in self.copies[idx].values():
                if t.device not in sent:
                    sent[t.device] = (slot.to(t.device),
                                      value.to(t.device, t.dtype))
                sl, new = (x[b0:b1] for x in sent[t.device])
                rows = torch.arange(b1 - b0, device=t.device)
                li = (sl - s0).clamp(0, s1 - s0 - 1).long()
                keep = ((sl >= s0) & (sl < s1)).reshape(
                    (-1,) + (1,) * (new.dim() - 1))
                t[rows, li] = torch.where(keep, new, t[rows, li])

    def copy_(self, value) -> "Placed":
        """The whole leaf set to ``value`` (a tensor or a Placed)."""
        if isinstance(value, Placed):
            value = value.full()
        self.write((), value)
        return self

    def sync(self) -> None:
        """Copy each block's owner into its other copies."""
        for c in self.copies.values():
            it = iter(c.values())
            first = next(it)
            for t in it:
                t.copy_(first)

    def with_owners(self, owners: list) -> "Placed":
        """A Placed of the same sharding holding ``owners`` (one tensor
        a block, in :meth:`indices` order) on the owners' devices only:
        gradients, updates."""
        return Placed(self.sharding, self.shape, owners[0].dtype,
                      {idx: {t.device: t}
                       for idx, t in zip(self.indices(), owners)})

    def __repr__(self):
        return (f"Placed({tuple(self.shape)}, {self.dtype}, spec "
                f"{self.spec}, {sum(len(c) for c in self.copies.values())} "
                f"copies)")


def placed_zeros(sharding: Sharding, shape, dtype) -> Placed:
    """Zeros stored by ``sharding`` (each copy allocated on its device)."""
    lay = Placed(sharding, shape, dtype, {})
    copies = {}
    for mi, c in _coords(sharding.mesh):
        dev = sharding.mesh.devices[mi]
        idx = lay.block_of(c)
        slot = copies.setdefault(idx, {})
        if dev not in slot:
            slot[dev] = torch.zeros(tuple(b - a for a, b in lay.bounds(idx)),
                                    dtype=dtype, device=dev)
    lay.copies = copies
    return lay


def place(t, sharding: Sharding):
    """``t`` stored by ``sharding`` -> a :class:`Placed`; a 0-d leaf (a
    step count) is a tensor on the mesh's first device."""
    t = torch.as_tensor(t)
    if t.dim() == 0:
        return t.to(sharding.mesh.device)
    lay = Placed(sharding, t.shape, t.dtype, {})
    copies = {}
    for mi, c in _coords(sharding.mesh):
        dev = sharding.mesh.devices[mi]
        idx = lay.block_of(c)
        slot = copies.setdefault(idx, {})
        if dev not in slot:
            part = t[tuple(slice(a, b) for a, b in lay.bounds(idx))]
            slot[dev] = torch.empty(part.shape, dtype=t.dtype,
                                    device=dev).copy_(part)
    lay.copies = copies
    return lay


def place_tree(tree, shardings):
    """Every leaf of ``tree`` placed by the matching :class:`Sharding`
    of ``shardings`` (a leaf whose sharding is None stays as it is)."""
    from repro_torch.models.layers import tree_map
    return tree_map(lambda t, s: t if s is None else place(t, s), tree,
                    shardings)


def gather(leaf, device=None, region=None) -> torch.Tensor:
    """The full logical leaf (a :class:`Placed` or a tensor) on
    ``device`` (the mesh's first, or the tensor's), or its ``region``
    (a ``(lo, hi)`` or None a dim): the slice a shard computes with."""
    if isinstance(leaf, Placed):
        full = leaf.full(device)
    else:
        full = leaf if device is None else leaf.to(device)
    if region is None:
        return full
    return full[tuple(slice(None) if r is None else slice(*r)
                      for r in region)]


# ---------------------------------------------------------------------------
# One data block's reads: views, broadcast, take
# ---------------------------------------------------------------------------

def fold_list(parts: list, device=None) -> torch.Tensor:
    """``fold_sum`` over a list, without stacking it: ``((p0 + p1) + p2)
    + ...`` on ``device`` (``p0``'s by default), each part moved there
    as it is added (used once each, so autograd's backward is plain)."""
    acc = parts[0] if device is None else parts[0].to(device)
    for p in parts[1:]:
        acc = acc + p.to(acc.device)
    return acc


class _Broadcast(torch.autograd.Function):
    """``x`` to each of ``devices`` in ``dtype`` (a view where it already
    is, in its dtype); the backward folds the outputs' gradients, each
    in ``x``'s dtype, in output order on ``x``'s device."""

    @staticmethod
    def forward(ctx, x, devices, dtype):
        ctx.src, ctx.dtype = x.device, x.dtype
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) if d == x.device and dtype == x.dtype
                     else x.to(d, dtype) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        parts = [g.to(ctx.src, ctx.dtype) for g in grads if g is not None]
        return (fold_list(parts) if parts else None), None, None


def broadcast(x: torch.Tensor, devices: list, dtype=None) -> list:
    """``x`` on each of ``devices`` (cast to ``dtype`` as it is sent),
    one output a consumer: with more than one, through
    :class:`_Broadcast`, so their gradients fold in this order, in
    ``x``'s dtype."""
    devices = [torch.device(d) for d in devices]
    dtype = x.dtype if dtype is None else dtype
    if len(devices) == 1:
        same = devices[0] == x.device and dtype == x.dtype
        return [x if same else x.to(devices[0], dtype)]
    return list(_Broadcast.apply(x, devices, dtype))


class View:
    """A leaf as one data block reads it: ``pieces[idx]`` is the block
    ``idx`` it reads (the copy at a coordinate of the data block when
    one holds the block, else the owner's), a tensor or, for a leaf
    stacked over pattern groups made trainable, the list of its groups'
    views; ``homes[idx]`` the mesh coordinates holding the block;
    ``dtype`` the dtype its consumers read (:meth:`cast`)."""

    def __init__(self, mesh, spec, shape, grid, pieces, homes, dtype):
        self.mesh, self.spec, self.shape, self.grid = mesh, spec, shape, grid
        self.pieces, self.homes, self.dtype = pieces, homes, dtype

    def group(self, gi: int) -> "View":
        return View(self.mesh, self.spec[1:], self.shape[1:], self.grid[1:],
                    {i[1:]: p[gi] for i, p in self.pieces.items()},
                    {i[1:]: h for i, h in self.homes.items()}, self.dtype)

    def cast(self, dtype) -> "View":
        """The leaf read in ``dtype``: :func:`take` casts each piece as
        it sends it, so the sends move ``dtype`` and a piece's gradients
        from several consumers fold in the piece's own dtype."""
        return View(self.mesh, self.spec, self.shape, self.grid,
                    self.pieces, self.homes, dtype)


def block_view(leaf, mesh: Mesh, block: dict, *, trainable: bool = False,
               stacked: bool = False) -> View:
    """``leaf`` (a :class:`Placed`, or a tensor: one block, held where
    it is) as the data block at ``block`` (its data-axis indices) reads
    it.  ``trainable``: each piece a detached view that requires a
    gradient (a ``stacked`` leaf's, one per group), so the block's
    gradients come back per piece."""
    def prep(t):
        if not trainable:
            return t
        if stacked:
            return [g.requires_grad_() for g in t.detach().unbind(0)]
        return t.detach().requires_grad_()

    if not isinstance(leaf, Placed):
        zero = (0,) * leaf.dim()
        return View(mesh, (None,) * leaf.dim(), tuple(leaf.shape),
                    (1,) * leaf.dim(), {zero: prep(leaf)},
                    {zero: leaf.device}, leaf.dtype)
    pieces, homes = {}, {}
    for mi, c in _coords(mesh):
        idx = leaf.block_of(c)
        homes.setdefault(idx, set()).add(mi)
        local = all(c[a] == i for a, i in block.items())
        if local and idx not in pieces:
            pieces[idx] = prep(leaf.copies[idx][mesh.devices[mi]])
    for idx in leaf.indices():
        if idx not in pieces:
            pieces[idx] = prep(leaf.owner(idx))
    return View(mesh, leaf.spec, tuple(leaf.shape), leaf.grid, pieces,
                homes, leaf.dtype)


def take(view: View, consumers: list) -> list:
    """Each consumer's slice of the leaf on its device, in the view's
    dtype.

    ``consumers``: ``(mesh index, region)`` pairs, ``region`` a
    ``(lo, hi)`` or None a dim.  Every block a region meets goes to the
    consumers that need it through one :func:`broadcast`; each consumer
    concatenates its blocks and narrows to its region.  The bytes of
    blocks a consumer's coordinate does not hold are added to
    ``mesh.gathered_bytes``.
    """
    mesh = view.mesh
    need = {}
    for ci, (mi, region) in enumerate(consumers):
        ranges = []
        for d, (n, g) in enumerate(zip(view.shape, view.grid)):
            lo, hi = (0, n) if region is None or region[d] is None \
                else region[d]
            w = n // g
            ranges.append(range(lo // w, (hi - 1) // w + 1))
        for idx in itertools.product(*ranges):
            need.setdefault(idx, []).append(ci)
    got = {}
    for idx in sorted(need):
        cis = need[idx]
        outs = broadcast(view.pieces[idx],
                         [mesh.devices[consumers[ci][0]] for ci in cis],
                         view.dtype)
        for ci, o in zip(cis, outs):
            got[idx, ci] = o
            home = view.homes[idx]
            mi = consumers[ci][0]
            if (mi not in home) if isinstance(home, set) \
                    else home != mesh.devices[mi]:
                mesh.gathered_bytes += o.numel() * o.element_size()
    outs = []
    for ci, (mi, region) in enumerate(consumers):
        idxs = sorted(i for (i, c) in got if c == ci)
        outs.append(_assemble(view, {i: got[i, ci] for i in idxs}, region))
    return outs


def _assemble(view: View, blocks: dict, region) -> torch.Tensor:
    """Blocks covering a sub-grid -> the region they cover, narrowed."""
    idxs = sorted(blocks)
    first = idxs[0]

    def cat(prefix, d):
        if d == len(view.shape):
            return blocks[prefix]
        ks = sorted({i[d] for i in idxs if i[:d] == prefix})
        parts = [cat(prefix + (k,), d + 1) for k in ks]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)

    out = cat((), 0)
    if region is None:
        return out
    for d, r in enumerate(region):
        if r is None:
            continue
        w = view.shape[d] // view.grid[d]
        lo = r[0] - first[d] * w
        if lo or r[1] - r[0] != out.shape[d]:
            out = out.narrow(d, lo, r[1] - r[0])
    return out


def blockwise(fn, leaf, *others):
    """``fn`` over a leaf's blocks: for a :class:`Placed`, ``fn`` of the
    owners' copies of each block of ``leaf`` and ``others`` (Placed
    leaves of the same sharding) -> a Placed of the results on the
    owners (None when ``fn`` returns None: an update in place); for
    tensors, ``fn(leaf, *others)``."""
    if not isinstance(leaf, Placed):
        return fn(leaf, *others)
    out = [fn(leaf.owner(i), *(o.owner(i) for o in others))
           for i in leaf.indices()]
    return None if out[0] is None else leaf.with_owners(out)
