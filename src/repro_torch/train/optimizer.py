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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

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


def _global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm=1.0):
    """Scale ``grads`` in place (float32 leaves) so their global norm is
    at most ``max_norm`` -> (grads, the norm before)."""
    norm = _global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.float().mul_(scale), grads), norm


def _count(params) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip=1.0):
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
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
            u = (m * mh).div_(torch.sqrt(v * vh).add_(eps))
            u.add_(weight_decay * p.float())
            p.copy_(p.float() - lr * u)   # rounded to p's dtype

        tree_map(step, params, grads, state["m"], state["v"])
        state["count"] = c
        return params, state, gnorm

    return Optimizer(init, update)


def adafactor(eps=1e-30, clip_rms=1.0, weight_decay=0.0, min_dim=2,
              decay_pow=0.8):
    """Factored second moments for >=2-D params, full for vectors."""
    def _factored(p):
        return p.dim() >= min_dim

    def init(params):
        def slot(p):
            f32, dev = torch.float32, p.device
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], dtype=f32,
                                          device=dev),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=f32, device=dev)}
            return {"v": torch.zeros(p.shape, dtype=f32, device=dev)}
        return {"slots": tree_map(slot, params), "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        c = state["count"] + 1
        beta = 1.0 - c.float() ** (-decay_pow)
        lr = float(lr)
        gnorm = _global_norm(grads)

        def step(p, g, s):
            g = g.float()
            g2 = g * g + eps
            if _factored(p):
                s["vr"].copy_(beta * s["vr"]
                              + (1 - beta) * torch.mean(g2, dim=-1))
                s["vc"].copy_(beta * s["vc"]
                              + (1 - beta) * torch.mean(g2, dim=-2))
                rfac = torch.rsqrt(
                    s["vr"] / torch.mean(s["vr"], dim=-1, keepdim=True)
                    + eps)
                cfac = torch.rsqrt(s["vc"] + eps)
                u = g * rfac[..., None] * cfac[..., None, :]
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                u = g * torch.rsqrt(s["v"] + eps)
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms / clip_rms, min=1.0)
            if weight_decay:
                u = u + weight_decay * p.float()
            p.copy_(p.float() - lr * u)   # rounded to p's dtype

        tree_map(step, params, grads, state["slots"])
        state["count"] = c
        return params, state, gnorm

    return Optimizer(init, update)


def optimizer_for(arch_cfg) -> Optimizer:
    if arch_cfg.optimizer == "adafactor":
        return adafactor()
    return adamw()
