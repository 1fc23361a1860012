"""Train-step construction: autograd + microbatch accumulation + update
(port of ``repro/train/loop.py``).

``make_train_step`` returns ``train_step(params, opt_state, batch, step)
-> (params, opt_state, metrics)``: the gradient of
``model.forward_train`` with respect to every leaf of ``params``
(``torch.autograd.grad`` on detached views that require it, so the
parameters themselves never carry ``requires_grad``), float32
accumulation over microbatches in order, the optional ``grad_hook``,
then ``opt.update``, which writes the parameters and the state in place
(``train.optimizer``).  Nothing in the step waits for the card: the
metrics are device tensors, and the caller reads them.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import blockwise
from repro_torch.models.layers import torch_dtype, tree_leaves, tree_map
from repro_torch.models.transformer import COMPUTE_CAST


def _split_micro(batch, micro):
    def split(t):
        t = torch.as_tensor(t)
        if t.dim() == 3 and t.shape[0] == 3:          # (3, B, S) positions
            t = t.reshape(3, micro, t.shape[1] // micro, t.shape[2])
            return t.transpose(0, 1)                  # (micro, 3, bm, S)
        return t.reshape(micro, t.shape[0] // micro, *t.shape[1:])
    return {k: split(v) for k, v in batch.items()}


def pick_microbatches(arch, shape, dp_size, stash_budget_bytes=3e9):
    """Microbatch count sized so the layer-scan carry stash fits.

    The dominant train-memory term is the residual saved per scanned layer
    for backward:  num_layers x tokens_per_micro x d_model x 2B.  Choose the
    smallest micro count whose stash fits ``stash_budget_bytes``, bounded by
    the local batch size.
    """
    if shape.kind != "train":
        return 1
    local_tokens = shape.tokens // max(dp_size, 1)
    local_batch = max(shape.global_batch // max(dp_size, 1), 1)
    per_layer = arch.d_model * 2          # bf16 residual per token per layer
    target = max(int(stash_budget_bytes / (arch.num_layers * per_layer)),
                 shape.seq_len)           # >= one sequence per micro
    micro = max(1, local_tokens // target)
    while local_batch % micro and micro > 1:
        micro -= 1
    return min(micro, local_batch)


def _refuse_cast(model, params):
    """Training keeps ``param_dtype`` masters: a tree stored cast
    (``Model.init(cast_weights=True)``) would train its bf16 copies."""
    want = torch_dtype(model.cfg.param_dtype)

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k in COMPUTE_CAST and v.dtype != want:
                where = "/".join(path + (k,))
                raise ValueError(
                    f"make_train_step: params {where} is stored in "
                    f"{v.dtype}, not the masters' {want}: train from "
                    f"Model.init(cast_weights=False)")
    walk(params, ())


def _trainable(tree, stacked=False):
    """Views of ``tree``'s leaves that require a gradient.  A leaf stacked
    over pattern groups (under a ``layers`` key) becomes the list of its
    groups' views, each a leaf of its own: the model indexes it group by
    group, and a gradient through ``stacked[g]`` would be a zero tensor of
    the whole stack per group, summed (28 full-size adds a leaf at
    llama's depth); a list gives each group's gradient alone, stacked
    once."""
    if isinstance(tree, dict):
        return {k: _trainable(v, stacked or k == "layers")
                for k, v in tree.items()}
    if stacked:
        return [v.requires_grad_() for v in tree.detach().unbind(0)]
    return tree.detach().requires_grad_()


def loss_and_grads(model, params, batch):
    """-> (loss, metrics, grads): the gradient of ``forward_train`` for
    every leaf of ``params`` (zeros for a leaf the loss does not reach),
    shaped like ``params``.  With ``model.mesh`` set,
    ``models.sharded.loss_and_grads``: each data block's gradients on
    its own devices, folded in block order (a placed leaf's gradient is
    placed on its blocks' owners)."""
    if model.mesh is not None:
        from repro_torch.models import sharded
        return sharded.loss_and_grads(model, params, batch)
    train = _trainable(params)
    loss, metrics = model.forward_train(train, batch)
    groups = tree_leaves(train)
    leaves = [t for g in groups for t in (g if isinstance(g, list) else [g])]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(t): torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)}

    def grad(t):
        if isinstance(t, list):
            return torch.stack([by_id.pop(id(x)) for x in t])
        return by_id.pop(id(t))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(grad, train))


def make_train_step(model, opt, lr_fn, *, micro=1, grad_hook=None):
    """Returns train_step(params, opt_state, batch, step) -> (p, s, metrics).

    grad_hook: optional fn(grads) -> grads (e.g. compression, noise probes).
    """

    def train_step(params, opt_state, batch, step):
        _refuse_cast(model, params)
        if micro == 1:
            loss, _, grads = loss_and_grads(model, params, batch)
        else:
            mbatch = _split_micro(batch, micro)
            grads = tree_map(lambda p: blockwise(
                lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                      device=t.device), p), params)
            loss = None
            for i in range(micro):
                lval, _, g = loss_and_grads(
                    model, params, {k: v[i] for k, v in mbatch.items()})
                tree_map(lambda a, b: blockwise(
                    lambda x, y: x.add_(y.float()), a, b), grads, g)
                loss = lval if loss is None else loss + lval
            grads = tree_map(lambda g: blockwise(lambda t: t.div_(micro), g),
                             grads)
            loss = loss / micro
        if grad_hook is not None:
            grads = grad_hook(grads)
        params, opt_state, gnorm = opt.update(grads, opt_state, params,
                                              lr_fn(step))
        metrics = {"loss": loss, "gnorm": gnorm, "lr": lr_fn(step),
                   "step": step + 1}
        return params, opt_state, metrics

    return train_step


def make_eval_step(model):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = model.forward_train(params, batch)
        return {"loss": loss, **metrics}
    return eval_step
