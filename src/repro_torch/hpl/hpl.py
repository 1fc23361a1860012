"""rocHPL analogue: blocked LU with partial pivoting (port of
``repro/hpl/hpl.py``).

Right-looking blocked factorization with the classic HPL phase structure
— panel factorization, row swaps, triangular solve, trailing-matrix GEMM
— each annotatable as an attribution region.  The trailing GEMM
dominates FLOPs, which is what makes HPL the paper's compute-bound case
study.  The reference runs FP32 only (the TPU has no fp64 matrix path);
on the H100 the matrix's dtype picks the precision, so ``make_system(n,
dtype=torch.float64)`` is the paper's FP64 rocHPL baseline.

What the port does differently from the reference, computing the same:
- each panel is factored once, with its row swaps applied to the whole
  row at each pivot (the reference factors the panel, applies the swaps,
  then factors the swapped panel again with identity pivots);
- the U12 solve and the trailing update touch the live blocks only
  (``a[j0+nb:, j0+nb:]`` updated in place), where the reference masks
  full ``n x n`` temporaries;
- pivot indices stay on the device (0-d tensors, tensor-indexed swaps):
  no host round trip per column.
"""
from __future__ import annotations

import torch

from repro_torch.core.tracing import RegionTracer
from repro_torch.device import resolve_device, wait


def as_device_tensor(x, device=None) -> torch.Tensor:
    """A tensor stays where it lies unless ``device`` is given; anything
    else (numpy) goes to ``device`` (None means CUDA)."""
    if isinstance(x, torch.Tensor) and device is None:
        return x
    return torch.as_tensor(x, device=resolve_device(device))


def uniform_matrix(n, seed, device=None) -> torch.Tensor:
    """(n, n) float32 uniform in [-0.5, 0.5) from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (None means CUDA)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand((n, n), generator=gen, device=dev,
                      dtype=torch.float32) - 0.5


def make_system(n, seed=0, dtype=torch.float32, *, device=None):
    """(a, b, x_true): a = ``uniform_matrix``, b = a @ ones in float32,
    both then cast to ``dtype``, as the reference builds them."""
    a = uniform_matrix(n, seed, device)
    x_true = torch.ones((n,), dtype=torch.float32, device=a.device)
    b = a @ x_true
    return a.to(dtype), b.to(dtype), x_true


def _panel_lu(a, j0, nb, perm, rows):
    """Unblocked LU with partial pivoting of columns ``j0:j0+nb`` of
    ``a`` (in place), rows ``j0:`` live; each pivot's row swap moves the
    whole row of ``a`` and of ``perm``.  ``rows`` is ``arange(n)`` on the
    device (its 0-d slices index without a host copy)."""
    hi = j0 + nb
    for jj in range(j0, hi):
        r = torch.argmax(a[jj:, jj].abs()) + jj      # first maximum
        pair = torch.stack((rows[jj], r))
        back = pair.flip(0)
        a[pair] = a[back]
        perm[pair] = perm[back]
        pivot = a[jj, jj]
        scale = torch.where(pivot.abs() > 1e-30, 1.0 / pivot, 0.0)
        a[jj + 1:, jj] *= scale
        a[jj + 1:, jj + 1:hi] -= torch.outer(a[jj + 1:, jj],
                                             a[jj, jj + 1:hi])


def lu_factor_blocked(a, *, nb=64):
    """Blocked LU with partial pivoting.  a: (n, n) -> (lu, perm), with
    ``lu`` a new tensor and ``perm`` (n,) int64 on ``a``'s device."""
    n = a.shape[0]
    assert n % nb == 0
    lu = a.clone()
    rows = torch.arange(n, device=a.device)
    perm = rows.clone()
    for j0 in range(0, n, nb):
        hi = j0 + nb
        _panel_lu(lu, j0, nb, perm, rows)
        if hi == n:
            break
        lu[j0:hi, hi:] = torch.linalg.solve_triangular(
            lu[j0:hi, j0:hi], lu[j0:hi, hi:], upper=False,
            unitriangular=True)
        lu[hi:, hi:].addmm_(lu[hi:, j0:hi], lu[j0:hi, hi:],
                            alpha=-1)                   # trailing GEMM
    return lu, perm


def _lu_apply_solve(lu, b):
    """Forward and back substitution on the packed factors: the unit
    lower and the upper triangle of ``lu``, no triangle copied out."""
    y = torch.linalg.solve_triangular(lu, b[:, None], upper=False,
                                      unitriangular=True)
    return torch.linalg.solve_triangular(lu, y, upper=True)[:, 0]


def lu_solve(lu, perm, b):
    return _lu_apply_solve(lu, b[perm])


def hpl_solve(a, b, *, nb=64, tracer=None, device=None):
    """Full HPL: factorize + solve + residual; returns (x, info).

    Runs on the inputs' device (numpy inputs go to ``device``, None
    meaning CUDA).  Each region waits for the device before it ends, so
    its span is the device's time, not the launches'.
    """
    a = as_device_tensor(a, device)
    b = as_device_tensor(b, a.device)
    tracer = tracer or RegionTracer()
    n = a.shape[0]
    with tracer.region("hpl_factorize"):
        lu, perm = lu_factor_blocked(a, nb=nb)
        wait(a.device)
    with tracer.region("hpl_solve"):
        x = lu_solve(lu, perm, b)
        wait(a.device)
    del lu
    with tracer.region("hpl_verify"):
        r = torch.linalg.vector_norm(a @ x - b) / (
            torch.linalg.vector_norm(a) * torch.linalg.vector_norm(x)
            + 1e-30)
        r = float(r)
    flops = 2.0 / 3.0 * n ** 3
    return x, {"residual": r, "flops": flops, "tracer": tracer}
