"""HPG-MxP analogue: multi-precision conjugate gradient on a Poisson
stencil (port of ``repro/hpl/hpg_mxp.py``).

One benchmark, two modes, matching the paper: the full-precision run
does the memory-bound stencil matvec in fp32; the mixed run does it in
bf16 with fp32 scalars and reductions.  Phase structure (setup, Krylov
loop, finalize) is traced for attribution — the paper's memory-bound
case study, where mixed precision buys a smaller factor than HPL-MxP.
The Krylov loop runs ``n_iters`` steps with no host round trip.
"""
from __future__ import annotations

import torch

from repro_torch.core.tracing import RegionTracer
from repro_torch.device import resolve_device, wait
from repro_torch.hpl.hpl import as_device_tensor


def make_poisson(nx, seed=0, *, device=None):
    """Right-hand side of a 3-D 7-point Laplacian on an (nx, nx, nx)
    grid: uniform in [0, 1) from a ``torch.Generator``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand((nx, nx, nx), generator=gen, device=dev,
                      dtype=torch.float32)


def _apply_stencil(u, dtype):
    """7-point Laplacian matvec (periodic) in ``dtype`` -> float32."""
    ud = u.to(dtype)
    out = 6.0 * ud
    for axis in range(3):
        out = out - torch.roll(ud, 1, axis) - torch.roll(ud, -1, axis)
    return out.to(torch.float32)


def _dot(u, v):
    return torch.dot(u.reshape(-1), v.reshape(-1))


def _cg(b, n_iters, matvec_dtype):
    x = torch.zeros_like(b)
    r = b - _apply_stencil(x, matvec_dtype)
    p = r
    rs = _dot(r, r)
    hist = []
    for _ in range(n_iters):
        ap = _apply_stencil(p, matvec_dtype)
        alpha = rs / torch.clamp_min(_dot(p, ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = _dot(r, r)
        beta = rs_new / torch.clamp_min(rs, 1e-30)
        p = r + beta * p
        rs = rs_new
        hist.append(torch.sqrt(rs_new))
    return x, torch.stack(hist) if hist else torch.zeros((0,),
                                                         device=b.device)


def hpg_solve(b, *, n_iters=100, mixed=False, tracer=None, device=None):
    """CG in full (fp32) or mixed (bf16-matvec) precision on ``b``'s
    device (numpy goes to ``device``, None meaning CUDA); each region
    waits for the device before it ends."""
    b = as_device_tensor(b, device)
    tracer = tracer or RegionTracer()
    dtype = torch.bfloat16 if mixed else torch.float32
    with tracer.region("hpg_setup"):
        b = b - torch.mean(b)                  # compatible rhs
        wait(b.device)
    with tracer.region("hpg_krylov"):
        x, hist = _cg(b, n_iters, dtype)
        wait(b.device)
    with tracer.region("hpg_finalize"):
        res = float(torch.linalg.vector_norm(
            b - _apply_stencil(x, torch.float32))
            / torch.clamp_min(torch.linalg.vector_norm(b), 1e-30))
    n = b.numel()
    flops = n_iters * (13.0 * n + 10.0 * n)    # stencil + vector ops
    bytes_moved = n_iters * n * 4.0 * 8.0      # ~8 array sweeps / iter
    return x, {"residual": res, "flops": flops, "bytes": bytes_moved,
               "conv": [float(h) for h in hist[-3:]], "tracer": tracer}
