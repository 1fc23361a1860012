"""Plain PyTorch versions of the square-wave FMA chain (port of
``repro/kernels/squarewave/ref.py``).

``squarewave_ref`` is the reference's ``acc * a + b``: two PyTorch
operations, so each step rounds twice, where the CUDA kernel fuses the
step into one FMA and rounds once.  Over K steps the two differ by about
K ulps relative (K * 2**-23 in float32, K * 2**-52 in float64); in
bfloat16 ``a`` rounds to 1.0, ``b`` lies below half an ulp of ``acc`` and
both return ``x`` for every K.

``squarewave_fused_ref`` computes what the kernel computes, one rounding
a step, from plain PyTorch operations (no FMA): it must match the kernel
bit for bit.  A float32 or bfloat16 step forms the product exactly in
the next wider type, adds ``b`` there rounded to odd and rounds that once
to the element type: the wider type has at least two more bits, so this
is one rounding to nearest.  A float64 step is Boldo and Melquiond's
emulated FMA ("Emulation of FMA and correctly rounded sums: proved
algorithms using rounding to odd", IEEE Trans. Computers 57(4), 2008):
Dekker's exact product, an exact sum, the two low parts added rounded to
odd, one final rounding.
"""
from __future__ import annotations

import torch

_A = 1.000000119                # keeps values bounded, non-constant
_WIDER = {torch.float32: torch.float64, torch.bfloat16: torch.float32}
_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


def squarewave_ref(x: torch.Tensor, *, fma_chain: int) -> torch.Tensor:
    a = torch.full_like(x, _A)
    b = x * 1e-6
    acc = x
    for _ in range(fma_chain):
        acc = acc * a + b
    return acc


def _two_sum(x, y):
    """s + e == x + y exactly, s = x + y rounded (Knuth)."""
    s = x + y
    yv = s - x
    return s, (x - (s - yv)) + (y - yv)


def _odd_sum(x, y):
    """x + y rounded to odd: the exact sum where it is representable,
    else whichever of its two neighbours has an odd last bit."""
    s, e = _two_sum(x, y)
    even = (s.view(_BITS[s.dtype]) & 1) == 0
    away = torch.nextafter(s, torch.copysign(torch.full_like(s, torch.inf),
                                             e))
    return torch.where((e != 0) & even, away, s)


def _split(x):
    """Dekker's split of a float64: hi + lo == x, each half 26 bits."""
    c = 134217729.0 * x             # 2**27 + 1
    hi = c - (c - x)
    return hi, x - hi


def _fma_f64(acc, a_split, b):
    """RN(acc * a + b) in float64, one rounding (Boldo-Melquiond)."""
    ah, al = a_split
    uh = acc * (ah + al)
    xh, xl = _split(acc)
    ul = ((xh * ah - uh) + xh * al + xl * ah) + xl * al   # acc*a - uh
    th, tl = _two_sum(b, uh)
    return th + _odd_sum(tl, ul)


def squarewave_fused_ref(x: torch.Tensor, *,
                         fma_chain: int) -> torch.Tensor:
    """The kernel's chain, ``acc = fma(acc, a, b)`` rounded once a step,
    for float32, bfloat16 and float64; same shape and dtype as ``x``."""
    a = torch.full_like(x, _A)
    b = x * 1e-6
    acc = x
    if x.dtype == torch.float64:
        a_split = _split(a)
        for _ in range(fma_chain):
            acc = _fma_f64(acc, a_split, b)
        return acc
    wide = _WIDER[x.dtype]
    aw, bw = a.to(wide), b.to(wide)
    for _ in range(fma_chain):
        acc = _odd_sum(acc.to(wide) * aw, bw).to(x.dtype)
    return acc
