"""Sums whose order of additions is a function of the reduced length
alone.

``torch.sum`` on a card picks its blocking (and so the association of
its float additions) from the shape of the whole tensor, the number of
outputs included, and a matmul picks its kernel the same way.  A fleet
split over hosts gives each host fewer rows and groups, so a row's sum
would round differently with the row count.  Both sums here are chains
of elementwise adds, the same on every device and for every number of
outputs:

  ``fold_sum``   a left fold, ``((x0 + x1) + x2) + ...``, for the short
                 axes (the sensors of a device group): the order numpy's
                 sum over an outer axis and a small BLAS product take, so
                 it also matches the reference's arithmetic;
  ``fixed_sum``  halving, for the long axes (grid slots): the axis is
                 padded with zeros to a power of two and its upper half
                 added to its lower half until one column is left.

Zeros past the data leave either result unchanged, so it is the same for
any padded length at least the data's.
"""
from __future__ import annotations

import torch


def fold_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Left-fold sum over ``dim`` (floating point tensors)."""
    x = x.movedim(dim, 0)
    if x.shape[0] == 0:
        return x.new_zeros(x.shape[1:])
    acc = x[0]
    for j in range(1, x.shape[0]):
        acc = acc + x[j]
    return acc


def fixed_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` by halving (floating point tensors)."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n == 0:
        return x.new_zeros(x.shape[:-1])
    p = 1 << (n - 1).bit_length()
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]
