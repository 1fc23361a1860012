"""Carry state across from the reference package into the port.

The reference's objects reach this module as plain numpy arrays, dicts
and numbers — the port never imports the reference; a caller that holds
both (the parity tests) extracts the fields and passes them here.
Covered: sensor traces and specs, the truth schedule, the packed blocks
of the batch path (``PackedFleet``, ``SeriesRows``), every stage carry
of the windowed pipeline, so a run can start in the reference and finish
in the port, the §V-B case study's inputs (a linear system, a region
tracer's events), a model's parameters and decode cache (nested dicts
of arrays, stacked per ``pos{i}``) and its optimizer state (AdamW's or
Adafactor's), so a training checkpoint crosses too.  Arrays are
installed verbatim: a dtype that differs from the carry's raises
instead of being cast.

State schema for ``load_pipeline_state`` (``pipeline_state`` returns the
same from a port pipeline)::

    {"ingest": {"t", "v": (F, 1); "t_first": (F,) f64;
                "unseeded": (F,) bool; "dq_late", "dq_masked": (F,) i64},
     "align":  None | {"origin": float, "ring_v": (F, W), "ring_m": (F, W)
                bool, "next_slot", "last_est_slot": int, "delay": (F,)
                f64, "seen": (F,) bool, "tail": TAIL},
     "fuse":   {"next_slot": int, "n_k", "ssr": (n,) f64,
                "t_first": (F,) f64, "tail": TAIL},
     "attr":   {"t_prev": (D,) f64,
                "integrals": [{pattern: (P, K_d) f64}, ...] per device}}
    TAIL = None | {"t", "v": (F, T); "dropped_t": (F,) f64}
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.align.regrid import SeriesRows
from repro_torch.core.measurement_model import SensorSpec
from repro_torch.core.power_model import PiecewisePower
from repro_torch.core.sensors import SensorTrace
from repro_torch.core.tracing import RegionTracer
from repro_torch.fleet.packing import PackedFleet
from repro_torch.fleet.pipeline import (AlignCarry, FusedAttrCarry,
                                        FuseCarry, IngestCarry, TailCarry)

_NP_OF = {torch.float32: np.float32, torch.float64: np.float64,
          torch.bool: np.bool_, torch.int64: np.int64}


def _tensor(arr, dtype: torch.dtype, device, what: str) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype != np.dtype(_NP_OF[dtype]):
        raise TypeError(f"{what}: dtype {a.dtype}, the carry holds "
                        f"{np.dtype(_NP_OF[dtype])}")
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def spec_from_fields(fields: dict) -> SensorSpec:
    """``dataclasses.asdict`` of a reference ``SensorSpec``."""
    return SensorSpec(**fields)


def trace_from_fields(name: str, spec: dict, t_read, t_measured,
                      value) -> SensorTrace:
    """A reference ``SensorTrace``'s fields -> the port's trace."""
    return SensorTrace(name, spec_from_fields(spec), np.asarray(t_read),
                       np.asarray(t_measured), np.asarray(value))


def power_from_arrays(times, watts) -> PiecewisePower:
    """A reference ``PiecewisePower``'s (times, watts)."""
    return PiecewisePower(np.asarray(times), np.asarray(watts))


def packed_fleet_from_fields(fields: dict) -> PackedFleet:
    """A reference ``PackedFleet``'s fields (``energy``, ``times``,
    ``n_samples``, ``wrap_period``, ``names``, ``n_traces``, ``t0``,
    ``e0``) -> the port's, arrays verbatim."""
    f = dict(fields)
    for k in ("energy", "times", "n_samples", "wrap_period", "e0"):
        if f.get(k) is not None:
            f[k] = np.array(f[k])
    return PackedFleet(**f)


def series_rows_from_fields(fields: dict) -> SeriesRows:
    """A reference ``SeriesRows``' fields (``times``, ``values``, ``n``,
    ``first``, ``names``, ``n_streams``, ``t0``) -> the port's, arrays
    verbatim."""
    f = dict(fields)
    for k in ("times", "values", "n", "first"):
        f[k] = np.array(f[k])
    return SeriesRows(**f)


def system_from_arrays(a, b, x_true, *, dtype=torch.float32, device=None):
    """A reference linear system (``make_system``/``make_dd_system``/
    ``make_poisson`` outputs as numpy; ``None`` for a part the function
    does not return) -> tensors of ``dtype`` on ``device`` (None means
    CUDA).  ``x_true`` stays float32, as the reference keeps it."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)

    def conv(x, dt):
        return None if x is None else torch.as_tensor(
            np.array(x), device=dev).to(dt)
    return conv(a, dtype), conv(b, dtype), conv(x_true, torch.float32)


def tracer_from_arrays(arrays: dict) -> RegionTracer:
    """``RegionTracer.to_arrays()`` of either package -> the port's
    tracer holding the same events (in start-time order)."""
    tracer = RegionTracer()
    names = list(arrays["names"])
    for i in range(len(arrays["name_id"])):
        tracer.add_region(names[int(arrays["name_id"][i])],
                          float(arrays["t_start"][i]),
                          float(arrays["t_end"][i]),
                          depth=int(arrays["depth"][i]),
                          device=int(arrays["device"][i]),
                          step=int(arrays["step"][i]),
                          slot=int(arrays["slot"][i]))
    return tracer


def tail_carry(d, dtype: torch.dtype, device) -> TailCarry:
    if d is None:
        return None
    return TailCarry(t=_tensor(d["t"], dtype, device, "tail.t"),
                     v=_tensor(d["v"], dtype, device, "tail.v"),
                     dropped_t=_tensor(d["dropped_t"], torch.float64,
                                       device, "tail.dropped_t"))


def align_carry(d, dtype: torch.dtype, device) -> AlignCarry:
    return AlignCarry(
        ring_v=_tensor(d["ring_v"], dtype, device, "align.ring_v"),
        ring_m=_tensor(d["ring_m"], torch.bool, device, "align.ring_m"),
        next_slot=int(d["next_slot"]),
        last_est_slot=int(d["last_est_slot"]),
        delay=_tensor(d["delay"], torch.float64, device, "align.delay"),
        seen=_tensor(d["seen"], torch.bool, device, "align.seen"))


def fuse_carry(d, device) -> FuseCarry:
    return FuseCarry(next_slot=int(d["next_slot"]),
                     n_k=_tensor(d["n_k"], torch.float64, device,
                                 "fuse.n_k"),
                     ssr=_tensor(d["ssr"], torch.float64, device,
                                 "fuse.ssr"))


def fused_attr_carry(d, group_sizes, n_phases: int,
                     device) -> FusedAttrCarry:
    """The reference's per-device {pattern: (P, K_d)} dicts -> the dense
    (D, 2**k_max, P, k_max) accumulator (absent patterns are zero)."""
    k_max = max(group_sizes)
    dense = np.zeros((len(group_sizes), 1 << k_max, n_phases, k_max))
    for di, (ints, k) in enumerate(zip(d["integrals"], group_sizes)):
        for pattern, acc in ints.items():
            a = np.asarray(acc)
            if a.dtype != np.float64 or a.shape != (n_phases, k):
                raise TypeError(f"attr.integrals[{di}][{pattern}]: "
                                f"{a.dtype} {a.shape}, expected float64 "
                                f"{(n_phases, k)}")
            dense[di, int(pattern), :, :k] = a
    return FusedAttrCarry(
        t_prev=_tensor(d["t_prev"], torch.float64, device, "attr.t_prev"),
        integrals=torch.as_tensor(dense, device=device))


def load_pipeline_state(pipe, state: dict):
    """Install a windowed-pipeline state (schema above) into the port's
    ``StreamingFusedPipeline`` ``pipe``; returns ``pipe``."""
    dev, dt = pipe.device, pipe._dtype
    ing = state["ingest"]
    pipe.ingest.carry = IngestCarry(t=_tensor(ing["t"], dt, dev,
                                              "ingest.t"),
                                    v=_tensor(ing["v"], dt, dev,
                                              "ingest.v"))
    pipe.ingest._t_first = _tensor(ing["t_first"], torch.float64, dev,
                                   "ingest.t_first")
    pipe.ingest._unseeded = _tensor(ing["unseeded"], torch.bool, dev,
                                    "ingest.unseeded")
    pipe.ingest.dq_late = _tensor(ing["dq_late"], torch.int64, dev,
                                  "ingest.dq_late")
    pipe.ingest.dq_masked = _tensor(ing["dq_masked"], torch.int64, dev,
                                    "ingest.dq_masked")
    al = state.get("align")
    if (al is None) != (pipe.align is None):
        raise ValueError("state and pipeline disagree on delay tracking")
    if al is not None:
        pipe.align.origin = float(al["origin"])
        pipe.align.carry = align_carry(al, dt, dev)
        pipe.align._tail.carry = tail_carry(al["tail"], dt, dev)
    fu = state["fuse"]
    pipe.fuse.carry = fuse_carry(fu, dev)
    pipe.fuse._t_first = _tensor(fu["t_first"], torch.float64, dev,
                                 "fuse.t_first")
    pipe.fuse._tail.carry = tail_carry(fu["tail"], dt, dev)
    pipe.attr.carry = fused_attr_carry(state["attr"], pipe.group_sizes,
                                       pipe.attr.n_phases, dev)
    return pipe


def _np(x):
    return x.detach().cpu().numpy()


def _tail_state(carry):
    if carry is None:
        return None
    return {"t": _np(carry.t), "v": _np(carry.v),
            "dropped_t": _np(carry.dropped_t)}


def pipeline_state(pipe) -> dict:
    """The port pipeline's state in the schema above (numpy, host)."""
    ing = pipe.ingest
    out = {"ingest": {"t": _np(ing.carry.t), "v": _np(ing.carry.v),
                      "t_first": _np(ing._t_first),
                      "unseeded": _np(ing._unseeded),
                      "dq_late": _np(ing.dq_late),
                      "dq_masked": _np(ing.dq_masked)},
           "align": None}
    if pipe.align is not None:
        c = pipe.align.carry
        out["align"] = {"origin": pipe.align.origin,
                        "ring_v": _np(c.ring_v), "ring_m": _np(c.ring_m),
                        "next_slot": c.next_slot,
                        "last_est_slot": c.last_est_slot,
                        "delay": _np(c.delay), "seen": _np(c.seen),
                        "tail": _tail_state(pipe.align._tail.carry)}
    fu = pipe.fuse
    out["fuse"] = {"next_slot": fu.carry.next_slot, "n_k": _np(fu.carry.n_k),
                   "ssr": _np(fu.carry.ssr), "t_first": _np(fu._t_first),
                   "tail": _tail_state(fu._tail.carry)}
    dense = _np(pipe.attr.carry.integrals)
    ints = []
    for di, k in enumerate(pipe.group_sizes):
        ints.append({p: dense[di, p, :, :k].copy()
                     for p in range(1, dense.shape[1])
                     if dense[di, p].any()})
    out["attr"] = {"t_prev": _np(pipe.attr.carry.t_prev), "integrals": ints}
    return out


# ---------------------------------------------------------------------------
# Models: parameters and decode caches
# ---------------------------------------------------------------------------

def _array_tensor(arr, dtype: torch.dtype, shape, device, what: str):
    """A numpy array (bfloat16 as ml_dtypes gives it) -> a tensor of
    exactly ``dtype`` and ``shape`` on ``device``; anything else raises."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {a.dtype}, the port holds {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, the port holds "
                         f"{tuple(shape)}")
    return t.to(device)


def _install(tree, spec, device, what: str, leaf):
    """Walk ``spec`` (nested dict of leaves); ``leaf(spec_leaf)`` gives
    (dtype, shape).  The tree must have exactly the spec's keys."""
    if isinstance(spec, dict):
        if not isinstance(tree, dict) or set(tree) != set(spec):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{what}: keys {got}, the port holds "
                             f"{sorted(spec)}")
        return {k: _install(tree[k], spec[k], device, f"{what}.{k}", leaf)
                for k in spec}
    dtype, shape = leaf(spec)
    return _array_tensor(tree, dtype, shape, device, what)


def model_params_from_arrays(tree, cfg, device=None, *, plan=None) -> dict:
    """The reference ``Model.init`` pytree as nested dicts of numpy
    arrays -> the port's parameters for ``cfg`` on ``device`` (None
    means CUDA), each leaf in the config's ``param_dtype``.  With a
    ``plan`` (``distributed.sharding.ShardingPlan``), each leaf placed
    on the plan's mesh by ``plan.param_shardings`` (``device`` is then
    unused)."""
    from repro_torch.device import resolve_device
    from repro_torch.models import Model
    from repro_torch.models.layers import torch_dtype
    dtype = torch_dtype(cfg.param_dtype)
    model = Model(cfg)
    dev = torch.device("cpu") if plan is not None else resolve_device(device)
    params = _install(tree, model.specs(), dev, "params",
                      lambda s: (dtype, s.shape))
    if plan is None:
        return params
    from repro_torch.distributed.sharding import place_tree
    return place_tree(params, plan.param_shardings(
        model.param_logical_axes(), model.param_structs()))


def model_cache_from_arrays(tree, cfg, batch_size: int, max_len: int,
                            device=None) -> dict:
    """A reference decode cache (``Model.init_cache(batch_size,
    max_len)`` or a prefilled one) as nested dicts of numpy arrays ->
    the port's cache on ``device`` (None means CUDA)."""
    from repro_torch.device import resolve_device
    from repro_torch.models import Model
    specs = Model(cfg).cache_specs(batch_size, max_len)
    return _install(tree, specs, resolve_device(device), "cache",
                    lambda sd: (sd[1], sd[0]))


def optimizer_state_from_arrays(tree, params, kind: str,
                                device=None) -> dict:
    """A reference optimizer state as nested dicts of numpy arrays ->
    the port's, shaped for ``params`` (the port's parameter tree) on
    ``device`` (None means CUDA): ``kind="adamw"`` takes ``{"m", "v",
    "count"}``, ``kind="adafactor"`` ``{"slots", "count"}`` (a factored
    leaf's ``vr``/``vc``, a vector's ``v``).  Moments are float32 and
    ``count`` an int32 scalar, installed verbatim as
    ``model_params_from_arrays`` installs weights: a dtype, shape or key
    that differs raises.  Parameters placed on a mesh (its ``plan=``)
    place each slot the way ``optimizer.init`` places it, and ``count``
    on the mesh's first device."""
    from repro_torch.device import resolve_device
    from repro_torch.distributed.sharding import Placed, Sharding, place
    from repro_torch.train.optimizer import factored_slots
    f32 = torch.float32

    def sharding(p, spec):
        return Sharding(p.mesh, spec) if isinstance(p, Placed) else None

    def moments(p):
        if isinstance(p, dict):
            return {k: moments(v) for k, v in p.items()}
        return (f32, tuple(p.shape), sharding(p, getattr(p, "spec", None)))

    def slots(p):
        if isinstance(p, dict):
            return {k: slots(v) for k, v in p.items()}
        sp = getattr(p, "spec", None)
        if len(p.shape) >= 2:
            return {k: (f32, shape, sharding(p, spec))
                    for k, (shape, spec) in factored_slots(p.shape,
                                                           sp).items()}
        return {"v": (f32, tuple(p.shape), sharding(p, sp))}

    if kind == "adamw":
        spec = {"m": moments(params), "v": moments(params)}
    elif kind == "adafactor":
        spec = {"slots": slots(params)}
    else:
        raise ValueError(f"optimizer kind {kind!r}: adamw or adafactor")
    spec["count"] = (torch.int32, (), None)
    first = _first_leaf(params)
    on_mesh = isinstance(first, Placed)
    state = _install(tree, spec, torch.device("cpu") if on_mesh
                     else resolve_device(device), "opt_state",
                     lambda leaf: leaf[:2])
    if not on_mesh:
        return state

    def put(t, leaf):
        return place(t, leaf[2]) if leaf[2] is not None \
            else t.to(first.device)
    return _map_spec(put, state, spec)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _map_spec(fn, tree, spec):
    """``fn(leaf, spec leaf)`` over ``tree``, walking ``spec``'s dicts."""
    if isinstance(spec, dict):
        return {k: _map_spec(fn, tree[k], spec[k]) for k in spec}
    return fn(tree, spec)
