"""Optimizers (AdamW, Adafactor) and LR schedules (cosine, WSD) (port of
``repro/train/optimizer.py``).

The parameter trees are the port's: nested dicts of tensors, as
``Model.init`` returns them.  Optimizer state is float32 and shaped like
the reference's (AdamW ``{"m", "v", "count"}``, Adafactor ``{"slots",
"count"}``, ``count`` an int32 scalar), so ``interop`` and the
checkpoint format carry it across both ways.  Unlike the reference's
pure functions, ``update`` writes the parameters, the state and the
gradients (clipped) in place and returns them: at llama3.2-3b's width a
second copy of the float32 parameters, moments or gradients (12.8 GB
each) would not fit beside the first on one card.  The arithmetic is the
reference's, in its order, leaf by leaf.

On a mesh (parameters placed by ``ShardingPlan.param_shardings``,
``distributed.sharding.Placed``), ``init`` places each slot the way its
parameter is placed (an Adafactor factor drops its parameter's last or
second-to-last dim's entry), and ``update`` works block by block on each
block's owner, then copies the owners to the blocks' other copies.  The
sums across blocks fold in a fixed order on the mesh's first device:
the global norm's squares in leaf order, then block order; Adafactor's
factor means, its row mean and its update's RMS as block sums folded
in block order and divided once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.distributed.sharding import (Placed, Sharding, blockwise,
                                              fold_list, placed_zeros)
from repro_torch.models.layers import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# Schedules (float32 0-d tensors on the host, as the reference's arrays)
# ---------------------------------------------------------------------------

def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_schedule(base_lr=3e-4, warmup=1000, total=100_000, min_frac=0.1):
    def lr(step):
        step = _f32(step)
        warm = base_lr * (step + 1.0) / max(warmup, 1)
        prog = torch.clip((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def wsd_schedule(base_lr=3e-4, warmup=1000, stable=80_000, decay=19_000,
                 min_frac=0.01):
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395): linear warmup, long
    constant plateau, short exponential-style decay tail."""
    def lr(step):
        step = _f32(step)
        warm = base_lr * (step + 1.0) / max(warmup, 1)
        in_decay = torch.clip((step - warmup - stable) / max(decay, 1),
                              0.0, 1.0)
        dec = base_lr * (_f32(min_frac) ** in_decay)
        return torch.where(step < warmup, warm,
                           torch.where(step < warmup + stable,
                                       _f32(base_lr), dec))
    return lr


def schedule_for(arch_name: str, base_lr=3e-4, total=100_000):
    if arch_name.startswith("minicpm"):
        return wsd_schedule(base_lr, warmup=total // 100,
                            stable=int(total * 0.8), decay=int(total * 0.19))
    return cosine_schedule(base_lr, warmup=total // 100, total=total)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable    # (grads, state, params, lr) -> (params, state, gnorm)


def _blocks(x) -> list:
    return x.owners() if isinstance(x, Placed) else [x]


def _global_norm(tree):
    leaves = tree_leaves(tree)
    dev = leaves[0].device
    return torch.sqrt(sum(torch.sum(torch.square(b.float())).to(dev)
                          for x in leaves for b in _blocks(x)))


def clip_by_global_norm(grads, max_norm=1.0):
    """Scale ``grads`` in place (float32 leaves) so their global norm is
    at most ``max_norm`` -> (grads, the norm before)."""
    norm = _global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: blockwise(
        lambda t: t.float().mul_(scale.to(t.device)), g), grads), norm


def _count(params) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _zeros_like(p, shape=None, spec=None):
    """float32 zeros shaped like ``p`` (or ``shape``), placed like it (by
    ``spec``) when ``p`` is placed."""
    shape = tuple(p.shape) if shape is None else tuple(shape)
    if isinstance(p, Placed):
        return placed_zeros(Sharding(p.mesh, p.spec if spec is None
                                     else spec), shape, torch.float32)
    return torch.zeros(shape, dtype=torch.float32, device=p.device)


def _sync(*leaves):
    for x in leaves:
        if isinstance(x, Placed):
            x.sync()


def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip=1.0):
    def init(params):
        return {"m": tree_map(_zeros_like, params),
                "v": tree_map(_zeros_like, params),
                "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        grads, gnorm = clip_by_global_norm(grads, clip)
        c = state["count"] + 1
        cf = c.float()
        mh = 1.0 / (1 - b1 ** cf)
        vh = 1.0 / (1 - b2 ** cf)
        lr = float(lr)

        def step(p, g, m, v):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            u = (m * mh.to(m.device)).div_(
                torch.sqrt(v * vh.to(v.device)).add_(eps))
            u.add_(weight_decay * p.float())
            p.copy_(p.float() - lr * u)   # rounded to p's dtype

        def leaf(p, g, m, v):
            blockwise(step, p, g, m, v)
            _sync(p, m, v)

        tree_map(leaf, params, grads, state["m"], state["v"])
        state["count"] = c
        return params, state, gnorm

    return Optimizer(init, update)


def factored_slots(shape, spec=None) -> dict:
    """An Adafactor factored slot's ``{"vr": (shape, spec), "vc": ...}``
    for a parameter of ``shape`` (placed by ``spec``, or None): ``vr``
    drops its last dim, ``vc`` its second to last."""
    shape = tuple(shape)
    return {"vr": (shape[:-1], spec and spec[:-1]),
            "vc": (shape[:-2] + shape[-1:], spec and spec[:-2] + spec[-1:])}


class _Whole:
    """A tensor as a leaf of one block (what Adafactor's step reads of
    a :class:`Placed`)."""

    def __init__(self, t):
        self.t, self.shape, self.device = t, t.shape, t.device
        self.grid = (1,) * t.dim()

    def indices(self):
        return [(0,) * self.t.dim()]

    def owner(self, idx):
        return self.t

    def numel(self):
        return self.t.numel()


def _mean(parts, dim, n, device, keepdim=False):
    """The mean over ``dim`` (None: every dim) of a leaf split along it
    into ``parts``: one part's ``torch.mean``; more, their sums folded
    in order on ``device`` and divided once by ``n``."""
    if len(parts) == 1:
        return torch.mean(parts[0], dim=dim, keepdim=keepdim).to(device)
    return fold_list([x.sum(dim=dim, keepdim=keepdim).to(device)
                      for x in parts]) / n


def adafactor(eps=1e-30, clip_rms=1.0, weight_decay=0.0, min_dim=2,
              decay_pow=0.8):
    """Factored second moments for >=2-D params, full for vectors."""
    def _factored(p):
        return p.dim() >= min_dim

    def init(params):
        def slot(p):
            if _factored(p):
                sp = factored_slots(p.shape, getattr(p, "spec", None))
                return {k: _zeros_like(p, shape, spec)
                        for k, (shape, spec) in sp.items()}
            return {"v": _zeros_like(p)}
        return {"slots": tree_map(slot, params), "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        c = state["count"] + 1
        beta = 1.0 - c.float() ** (-decay_pow)
        lr = float(lr)
        gnorm = _global_norm(grads)

        def step(p, g, s):
            """One leaf, block by block on each block's owner (a tensor
            is one block): a mean across blocks is :func:`_mean`'s."""
            factored = _factored(p)
            p, g = (x if isinstance(x, Placed) else _Whole(x)
                    for x in (p, g))
            s = {k: x if isinstance(x, Placed) else _Whole(x)
                 for k, x in s.items()}
            first = p.device
            idxs = p.indices()
            g = {i: g.owner(i).float() for i in idxs}
            g2 = {i: g[i] * g[i] + eps for i in idxs}
            u = {}
            if factored:
                vr, vc = s["vr"], s["vc"]
                n_r, n_c = p.shape[-1], p.shape[-2]
                for r in vr.indices():      # vr's block: p's idx[:-1]
                    t = vr.owner(r)
                    mean = _mean([g2[r + (j,)] for j in range(p.grid[-1])],
                                 -1, n_r, t.device)
                    t.copy_(beta.to(t.device) * t
                            + (1 - beta.to(t.device)) * mean)
                for k in vc.indices():      # vc's: p's idx[:-2] + idx[-1:]
                    t = vc.owner(k)
                    mean = _mean([g2[k[:-1] + (j,) + k[-1:]]
                                  for j in range(p.grid[-2])],
                                 -2, n_c, t.device)
                    t.copy_(beta.to(t.device) * t
                            + (1 - beta.to(t.device)) * mean)
                # vr's row mean: over vr's last dim (p's second to last)
                rmean = {}
                for r in vr.indices():
                    if r[:-1] not in rmean:
                        rmean[r[:-1]] = _mean(
                            [vr.owner(r[:-1] + (j,))
                             for j in range(vr.grid[-1])],
                            -1, n_c, first, keepdim=True)
                for i in idxs:
                    dev = g[i].device
                    rfac = torch.rsqrt(vr.owner(i[:-1]).to(dev)
                                       / rmean[i[:-2]].to(dev) + eps)
                    cfac = torch.rsqrt(vc.owner(i[:-2] + i[-1:]).to(dev)
                                       + eps)
                    u[i] = g[i] * rfac[..., None] * cfac[..., None, :]
                _sync(vr, vc)
            else:
                v = s["v"]
                for i in idxs:
                    t = v.owner(i)
                    t.copy_(beta.to(t.device) * t
                            + (1 - beta.to(t.device)) * g2[i])
                    u[i] = g[i] * torch.rsqrt(t + eps)
                _sync(v)
            rms = torch.sqrt(_mean([u[i] * u[i] for i in idxs], None,
                                   p.numel(), first) + eps)
            for i in idxs:
                t = p.owner(i)
                ui = u[i] / torch.clamp(rms.to(t.device) / clip_rms,
                                        min=1.0)
                if weight_decay:
                    ui = ui + weight_decay * t.float()
                t.copy_(t.float() - lr * ui)   # rounded to p's dtype
            _sync(p)

        tree_map(step, params, grads, state["slots"])
        state["count"] = c
        return params, state, gnorm

    return Optimizer(init, update)


def optimizer_for(arch_cfg) -> Optimizer:
    if arch_cfg.optimizer == "adafactor":
        return adafactor()
    return adamw()
