"""rocHPL-MxP analogue: mixed-precision LU + iterative refinement (port
of ``repro/hpl/hpl_mxp.py``).

Per the paper (§IV-C2): low-precision factorization (bf16 GEMMs standing
in for FP16 tensor cores), NO pivoting (the matrix is constructed
diagonally dominant), and fp32 iterative refinement to recover full
accuracy.  The energy story (§V-B): same instantaneous power class, a
much shorter time-to-solution -> most of the energy saving.

As in ``hpl.py``, the port updates the live blocks in place instead of
masking full ``n x n`` temporaries, and solves against the packed
factors without building the triangles.
"""
from __future__ import annotations

import torch

from repro_torch.core.tracing import RegionTracer
from repro_torch.device import wait
from repro_torch.hpl.hpl import (_lu_apply_solve, as_device_tensor,
                                 uniform_matrix)


def make_dd_system(n, seed=0, *, device=None):
    """Diagonally dominant system (no pivoting required):
    ``uniform_matrix`` plus n on the diagonal."""
    a = uniform_matrix(n, seed, device)
    a.diagonal().add_(float(n))
    x_true = torch.ones((n,), dtype=torch.float32, device=a.device)
    return a, a @ x_true, x_true


def lu_factor_nopiv_bf16(a, *, nb=64):
    """Blocked LU, no pivoting; trailing GEMMs in bf16 (bf16 x bf16 with
    a bf16 result, subtracted in ``a``'s dtype).  Returns a new tensor."""
    n = a.shape[0]
    assert n % nb == 0
    lu = a.clone()
    for j0 in range(0, n, nb):
        hi = j0 + nb
        a11 = lu[j0:hi, j0:hi]
        for j in range(nb):
            pivot = a11[j, j]
            scale = torch.where(pivot.abs() > 1e-30, 1.0 / pivot, 0.0)
            a11[j + 1:, j] *= scale
            a11[j + 1:, j + 1:] -= torch.outer(a11[j + 1:, j],
                                               a11[j, j + 1:])
        if hi == n:
            break
        lu[j0:hi, hi:] = torch.linalg.solve_triangular(
            a11, lu[j0:hi, hi:], upper=False, unitriangular=True)
        lu[hi:, j0:hi] = torch.linalg.solve_triangular(
            a11, lu[hi:, j0:hi], upper=True, left=False)
        # trailing update in bf16 (the mixed-precision hot loop)
        lu[hi:, hi:] -= (lu[hi:, j0:hi].to(torch.bfloat16)
                         @ lu[j0:hi, hi:].to(torch.bfloat16))
    return lu


def hpl_mxp_solve(a, b, *, nb=64, max_ir=30, tol=1e-5, tracer=None,
                  device=None):
    """Mixed-precision solve: bf16-GEMM LU + fp32 iterative refinement.

    Runs on the inputs' device (numpy inputs go to ``device``, None
    meaning CUDA); each region waits for the device before it ends.
    """
    a = as_device_tensor(a, device)
    b = as_device_tensor(b, a.device)
    tracer = tracer or RegionTracer()
    n = a.shape[0]
    with tracer.region("mxp_factorize"):
        lu = lu_factor_nopiv_bf16(a, nb=nb)
        wait(a.device)
    with tracer.region("mxp_refine"):
        x = _lu_apply_solve(lu, b)
        nrm = float(torch.linalg.vector_norm(b))
        iters = 0
        res = float("inf")
        for i in range(max_ir):
            r = b - a @ x                       # fp32 residual
            res = float(torch.linalg.vector_norm(r)) / (nrm + 1e-30)
            iters = i
            if res < tol:
                break
            x = x + _lu_apply_solve(lu, r)
        wait(a.device)
    flops = 2.0 / 3.0 * n ** 3
    return x, {"residual": res, "ir_iters": iters, "flops": flops,
               "tracer": tracer}
