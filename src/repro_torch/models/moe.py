"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``).

Routing, dispatch and combine on one device, as the reference runs them
without a mesh: every token's router logits in float32, its top-k
experts (ties to the lower index, as ``lax.top_k``), the assignments
sorted by expert into a capacity-bounded ``(E, C, d)`` buffer (those
past an expert's capacity are dropped), the expert SwiGLU as three
batched matrix products over that buffer, and the weighted outputs
added back to their tokens.  The reference computes the expert SwiGLU
in jnp, outside any Pallas kernel, so there is no TPU kernel to port
here; the port runs it as ``torch.bmm``.

Nothing here synchronizes with the host: the per-expert starts are a
``searchsorted`` on the sorted expert ids (not a ``bincount``, which
sizes its output on the host), the buffer is a gather (each slot reads
the assignment that fills it), and the combine folds each token's k
contributions in a fixed order (the sorted-assignment order in which
the reference's scatter-add applies them) instead of atomics.

Expert parallelism (``mesh=``, the reference's ``shard_map`` branch):
the experts are split over the mesh's ``ep_axis`` and the tokens over
its data axes (when they divide the batch); each (data, expert) shard
routes its own tokens redundantly, keeps the assignments of its experts
in a buffer of the capacity of its data shard's tokens, and adds its
slice of the shared experts' d_ff; the shards' partial outputs are
summed on the mesh's first device in expert-axis order
(``core.reduce.fold_sum``).  The reference casts every weight to the
activations' dtype before it shards them, the router included, so the
port's sharded path rounds the router to that dtype too.  A shard's
expert slices are views of the weights (placed once on a shard's own
card when it is not the weights' card, ``Mesh.put``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.reduce import fold_sum
from repro_torch.distributed.sharding import check_mesh, shard_coords
from repro_torch.models.layers import ParamSpec


def moe_specs(cfg):
    m = cfg.moe
    d = cfg.d_model
    f = m.expert_d_ff or cfg.d_ff
    specs = {
        "router": ParamSpec((d, m.num_experts), ("embed", None),
                            init="small_normal"),
        "w_gate": ParamSpec((m.num_experts, d, f), ("expert", "embed", None)),
        "w_up": ParamSpec((m.num_experts, d, f), ("expert", "embed", None)),
        "w_down": ParamSpec((m.num_experts, f, d), ("expert", None, "embed")),
    }
    if m.num_shared_experts:
        fs = f * m.num_shared_experts
        specs["shared"] = {
            "w_gate": ParamSpec((d, fs), ("embed", "mlp")),
            "w_up": ParamSpec((d, fs), ("embed", "mlp")),
            "w_down": ParamSpec((fs, d), ("mlp", "embed")),
        }
    return specs


def _capacity(n_tokens_local, moe):
    ideal = moe.top_k * n_tokens_local / moe.num_experts
    c = int(ideal * moe.capacity_factor) + 1
    return max(8, min(n_tokens_local, c))


def _route(p, x_flat, moe):
    """Router logits (N, E) float32, their softmax, and each token's
    top-k (gate (N, k) renormalized, expert ids (N, k)).  A stable
    descending sort keeps equal probabilities in index order, so a tie
    goes to the lower expert, as ``lax.top_k`` breaks it."""
    logits = x_flat.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = top[:, :moe.top_k], idx[:, :moe.top_k]
    gate = gate / gate.sum(dim=-1, keepdim=True)
    return logits, probs, gate, idx


def _aux_loss(logits, probs, idx, moe):
    """The load-balancing and router-z losses, weighted and summed."""
    me = probs.mean(dim=0)                                    # (E,)
    ce = F.one_hot(idx, moe.num_experts).float().sum(dim=1).mean(dim=0) \
        / moe.top_k
    aux_lb = moe.num_experts * torch.sum(me * ce)
    aux_z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return moe.router_aux_weight * aux_lb + moe.router_z_weight * aux_z


def _dispatch(idx, *, expert_offset, e_local, capacity):
    """The reference's assignment flattening, sorted by expert: returns
    (order, se, pos, dropped) over the N*k sorted assignments — the
    permutation, each one's (local) expert (``e_local`` for another
    shard's), its slot in that expert's buffer and whether it is
    dropped (past the capacity, or not this shard's) — and the start of
    each expert's run in the sorted order, (e_local + 2,)."""
    nk = idx.numel()
    local_e = idx.reshape(-1) - expert_offset
    mine = (local_e >= 0) & (local_e < e_local)
    sort_key = torch.where(mine, local_e, e_local)           # drops last
    order = torch.argsort(sort_key, stable=True)
    se = sort_key[order]
    starts = torch.searchsorted(
        se, torch.arange(e_local + 2, device=idx.device, dtype=se.dtype))
    pos = torch.arange(nk, device=idx.device) - starts[se]
    dropped = (pos >= capacity) | (se == e_local)
    return order, se, pos, dropped, starts


def moe_assignments(p, cfg, x):
    """x: (B, S, d) -> (expert ids (B*S, k), kept (B*S, k) bool): which
    experts each token was routed to and which of those assignments
    survived the capacity (the rest are dropped), as ``moe_apply``
    routes them."""
    moe = cfg.moe
    xf = x.reshape(-1, x.shape[-1])
    _, _, _, idx = _route(p, xf, moe)
    order, _, _, dropped, _ = _dispatch(
        idx, expert_offset=0, e_local=moe.num_experts,
        capacity=_capacity(xf.shape[0], moe))
    kept = torch.empty_like(dropped)
    kept[order] = ~dropped
    return idx, kept.reshape(idx.shape)


def _moe_local(p, x_flat, *, moe, expert_offset, e_local, capacity,
               with_aux=True):
    """Local MoE over experts ``expert_offset .. + e_local``: x_flat
    (N, d) -> (y (N, d), aux loss scalar or None).  ``with_aux=False``
    skips the aux loss (prefill and decode drop it; the reference's
    compiled steps never compute it).  With ``expert_offset``/``e_local``
    a slice of the experts this is one shard's partial output; the
    reference's ``psum_axis`` is ``moe_apply``'s fold over the shards.
    """
    n, d = x_flat.shape
    k = moe.top_k
    dt = x_flat.dtype

    logits, probs, gate, idx = _route(p, x_flat, moe)
    aux = _aux_loss(logits, probs, idx, moe) if with_aux else None

    order, se, pos, dropped, starts = _dispatch(
        idx, expert_offset=expert_offset, e_local=e_local,
        capacity=capacity)
    tok_sorted = torch.div(order, k, rounding_mode="floor")
    w_sorted = torch.where(dropped, 0.0, gate.reshape(-1)[order])

    # ---- gather into (E_local, C, d): slot (e, c) holds the c-th
    # assignment of expert e in the sorted order, if it has one
    slot = torch.arange(capacity, device=x_flat.device)
    src = starts[:e_local, None] + slot[None, :]              # (E, C)
    filled = slot[None, :] < (starts[1:e_local + 1] - starts[:e_local])[
        :, None]
    src = torch.where(filled, src, 0)
    buf = torch.where(filled[..., None], x_flat[tok_sorted[src]],
                      torch.zeros((), dtype=dt, device=x_flat.device))

    # ---- grouped expert SwiGLU over the buffer
    g = F.silu(torch.bmm(buf, p["w_gate"].to(dt)))
    u = torch.bmm(buf, p["w_up"].to(dt))
    out_buf = torch.bmm(g * u, p["w_down"].to(dt))            # (E, C, d)

    # ---- combine: each assignment's weighted output, back to its token
    flat = torch.where(dropped, 0, se * capacity + pos)
    contrib = out_buf.reshape(-1, d)[flat] * w_sorted[:, None].to(dt)
    contrib = torch.where(dropped[:, None],
                          torch.zeros((), dtype=dt, device=x_flat.device),
                          contrib)
    # the reference adds a token's k contributions in the sorted order
    # (by expert, dropped last): bring them back to (N, k) in that order
    # and fold over k from zero, so every sum rounds as its does
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n * k, device=order.device)
    by_token = torch.sort(rank.reshape(n, k), dim=1).values   # (N, k)
    parts = contrib[by_token]                                 # (N, k, d)
    y = torch.zeros((n, d), dtype=dt, device=x_flat.device)
    for j in range(k):
        y = y + parts[:, j]

    # ---- shared experts (dense)
    if "shared" in p:
        sp = p["shared"]
        sg = F.silu(x_flat @ sp["w_gate"].to(dt))
        su = x_flat @ sp["w_up"].to(dt)
        y = y + (sg * su) @ sp["w_down"].to(dt)
    return y, aux


def _shard_params(p, mesh, dev, *, ep, m, e_local, dt):
    """Shard ``m`` of ``ep``'s view of the MoE weights on ``dev``: its
    experts, its slice of the shared experts' d_ff, the router rounded
    to the activations' dtype (as the reference casts it)."""
    put = mesh.put
    out = {"router": put(p["router"], dev).to(dt)}
    for name in ("w_gate", "w_up", "w_down"):
        out[name] = put(p[name], dev, 0, m * e_local, (m + 1) * e_local)
    if "shared" in p:
        sp = p["shared"]
        fs = sp["w_down"].shape[0] // ep
        out["shared"] = {
            "w_gate": put(sp["w_gate"], dev, 1, m * fs, (m + 1) * fs),
            "w_up": put(sp["w_up"], dev, 1, m * fs, (m + 1) * fs),
            "w_down": put(sp["w_down"], dev, 0, m * fs, (m + 1) * fs)}
    return out


def moe_apply(p, cfg, x, *, mesh=None, ep_axis="model",
              dp_axes=("pod", "data"), with_aux=True):
    """x: (B, S, d) -> (y, aux_loss scalar); ``with_aux=False`` returns
    None for the aux loss.

    ``mesh`` (a ``distributed.sharding.Mesh`` with ``ep_axis``): expert
    parallelism as the module docstring says.  The capacity is that of
    a data shard's tokens, so when it binds the result differs from the
    unsharded one, as the reference's does; the aux loss is the first
    data shard's, computed on its own tokens (the value the reference's
    replicated output takes).  Without a mesh (or one without
    ``ep_axis``) every expert runs on x's device.
    """
    check_mesh(mesh)
    moe = cfg.moe
    b, s, d = x.shape
    if mesh is None or ep_axis not in mesh.axis_names:
        y, aux = _moe_local(p, x.reshape(b * s, d), moe=moe,
                            expert_offset=0, e_local=moe.num_experts,
                            capacity=_capacity(b * s, moe),
                            with_aux=with_aux)
        return y.reshape(b, s, d), aux

    ep = mesh.shape[ep_axis]
    if moe.num_experts % ep:
        raise ValueError(f"{moe.num_experts} experts not divisible by "
                         f"EP={ep}")
    if "shared" in p and p["shared"]["w_down"].shape[0] % ep:
        raise ValueError(f"the shared experts' d_ff "
                         f"{p['shared']['w_down'].shape[0]} does not split "
                         f"over EP={ep}")
    e_local = moe.num_experts // ep
    dp_axes, dp = mesh.data_split(dp_axes, b)     # tiny batches replicate
    b_loc = b // dp
    capacity = _capacity(b_loc * s, moe)
    dt = x.dtype

    partial = {}        # data block -> [y of each expert shard]
    aux = None
    for c in shard_coords(mesh, dp_axes + (ep_axis,)):
        dev = mesh.device_at(**c)
        blk = mesh.block_index(c, dp_axes)
        m = c[ep_axis]
        xf = x[blk * b_loc:(blk + 1) * b_loc].reshape(-1, d).to(dev)
        y, a_loss = _moe_local(
            _shard_params(p, mesh, dev, ep=ep, m=m, e_local=e_local, dt=dt),
            xf, moe=moe, expert_offset=m * e_local, e_local=e_local,
            capacity=capacity, with_aux=with_aux and blk == 0 and m == 0)
        if a_loss is not None:
            aux = a_loss.to(x.device)
        partial.setdefault(blk, []).append(y)
    first = mesh.device
    y = torch.cat([fold_sum(torch.stack([t.to(first) for t in partial[k]]),
                            dim=0) for k in sorted(partial)])
    return y.reshape(b, s, d).to(x.device), aux
