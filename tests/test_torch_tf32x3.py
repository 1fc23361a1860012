"""PyTorch port, the design of B9's float32 kernels on the CPU: 3xTF32
on the tensor cores (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``) emulated in torch and held against the
JAX reference.

The emulation follows the kernels' arithmetic: ``cvt.rna.tf32.f32``
(float32 rounded to 10 mantissa bits, to nearest, ties away from zero)
by bit rounding; every operand split into hi = tf32(v) and lo = tf32(v -
hi); each k-step of 8 adds lo*hi, then hi*lo, then hi*hi (lo*lo
dropped) on the tensor cores, two k-steps at a time from zero, and each
such piece is added to its float32 sum with a float32 add.  mma.sync's
own accumulation is modelled as a step's 8 exact products and its
accumulator summed exactly and truncated toward zero: with one chain a
product (no pieces) that model reads 1.06e-5 of the largest output at
llama's forward shape, where the card read 1.1e-5 (the kernel of that
design, ``scripts/kernel_ab.py``), and the kernels' design 2.1e-6.  The
forward runs the kernel's online softmax, one state for each 32-key
half of the 64-key tiles folded at the end, with the key split of
``kernel.fwd_key_parts`` folded in part order; the backward recomputes P
from the emulated forward's lse, sums dV and dK over the GQA group's
query heads in order and dQ over ``kernel.dq_key_parts``, each sum in
the two halves of its 64-row stages that a warp pair takes, added at
the end.  Each output is held to the JAX reference within half the card
gates' 1e-5 of its largest magnitude, at the card tests' cases
(``tests/test_torch_gpu.py``) and with q and k drawn at
``chip_smoke.py``'s scale of 3.

Why half and not a quarter: the JAX reference runs in float32 and sits
up to 1.8e-6 of its largest magnitude from the float64 result at these
cases (forward and gradients alike), so even the same algorithm with
every product exactly rounded to float32 reads up to 2.7e-6 from its
gradients.  3xTF32 itself (lo*lo dropped, lo rounded to TF32: ~2^-22 of
a product against float32's 2^-24) reads at most 1.9e-6 (forward) and
3.5e-6 (gradients) from float64, 2.4e-6 and 3.3e-6 from the JAX
reference, and 5.2e-6 and 5.0e-6 from the plain float32 version the
card gates hold it to."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from repro.kernels.flash_attention.ref import (flash_attention_ref as
                                               jax_flash_attention_ref)
from repro.models.layers import _attend as jax_attend
from test_torch_bwd_kernels import _jax_vjp
from torch_cases import _attention_case

from repro_torch.kernels.flash_attention.kernel import (KEY_TILE,
                                                        dq_key_parts,
                                                        fwd_key_parts)

torch.set_num_threads(2)

DESIGN_TOL = 0.5e-5         # half the card's 1e-5 gates (see above)
F32 = torch.float32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: the low 13 mantissa bits rounded away, to
    nearest with ties away from zero (on the magnitude: the sign bit is
    apart), the result still a float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(F32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def _truncated(exact: torch.Tensor) -> torch.Tensor:
    """float64 ``exact`` to float32 rounded toward zero."""
    near = exact.to(F32)
    return torch.where(near.double().abs() > exact.abs(),
                       torch.nextafter(near, torch.zeros_like(near)), near)


def mm3(a, b, acc=None):
    """a (..., M, K) @ b (..., K, N) in 3xTF32 as the kernels run it: two
    k-steps of 8 at a time (16 inner indices, zero-padded), each piece's
    six mma.sync (lo*hi, hi*lo, hi*hi a k-step) summed from zero with every
    step rounded toward zero (the model of mma.sync's accumulation: a
    step's 8 exact products and its accumulator, truncated), then added
    to ``acc`` (float32, zeros if None) with a float32 add."""
    pad = -a.shape[-1] % 16
    a, b = F.pad(a.to(F32), (0, pad)), F.pad(b.to(F32), (0, 0, 0, pad))
    (ah, al), (bh, bl) = split(a), split(b)
    if acc is None:
        acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=F32)
    for p0 in range(0, a.shape[-1], 16):
        t = torch.zeros_like(acc)
        for j in (p0, p0 + 8):
            for x, y in ((al, bh), (ah, bl), (ah, bh)):
                step = x[..., j:j + 8].double() @ y[..., j:j + 8, :].double()
                t = _truncated(t.double() + step)
        acc = acc + t
    return acc


def _scale(d: int) -> torch.Tensor:
    """1.0f / sqrtf(D), as the launchers compute it."""
    return 1.0 / torch.sqrt(torch.tensor(float(d), dtype=F32))


def _mask(rows, keys, sk, causal, window):
    i, j = rows[:, None], keys[None, :]
    ok = (j < sk) & (i >= 0)
    if causal:
        ok &= j <= i
        if window:
            ok &= i - j < window
    return ok


def _fold(states):
    """(m, l, acc) states of the same rows folded in order: M = max m,
    w = exp(m - M), L = sum w l, acc = sum w acc (float32)."""
    mx = states[0][0]
    for m, _, _ in states[1:]:
        mx = torch.maximum(mx, m)
    sum_l = torch.zeros_like(mx)
    sum_a = torch.zeros_like(states[0][2])
    for m, l, acc in states:
        w = torch.exp(m - mx)
        sum_l = sum_l + l * w
        sum_a = sum_a + acc * w[..., None]
    return mx, sum_l, sum_a


def forward_emulated(q, k, v, causal, cap, window=0):
    """The float32 forward kernel's arithmetic -> (out, lse): for each key
    part (``fwd_key_parts``), the two warps of a pair run an online
    softmax of their own over the two 32-key halves of every 64-key
    tile, folded at the end (half 0, then half 1), then the parts folded
    in order."""
    b, hq, s, d = q.shape
    sk = k.shape[2]
    g = hq // k.shape[1]
    k, v = (x.repeat_interleave(g, dim=1) for x in (k, v))
    rsd = _scale(d)
    rcap = torch.tensor(1.0, dtype=F32) / cap if cap else None
    rows = torch.arange(s)
    half_keys = KEY_TILE // 2
    parts = []
    for lo, hi in fwd_key_parts(s, sk, causal, F32):
        halves = []
        for first in (lo, lo + half_keys):
            m = torch.full((b, hq, s), -1e30, dtype=F32)
            l = torch.zeros((b, hq, s), dtype=F32)
            acc = torch.zeros((b, hq, s, d), dtype=F32)
            for k0 in range(first, hi, KEY_TILE):
                keys = torch.arange(k0, k0 + half_keys)
                end = min(k0 + half_keys, hi)
                kt, vt = (F.pad(x[:, :, k0:end], (0, 0, 0, k0 + half_keys
                                                  - end))
                          for x in (k, v))
                x = mm3(q, kt.transpose(-1, -2)) * rsd
                if cap:
                    x = cap * torch.tanh(x * rcap)
                x = torch.where(_mask(rows, keys, sk, causal, window), x,
                                torch.tensor(-1e30, dtype=F32))
                mx = torch.maximum(m, x.amax(dim=-1))
                corr = torch.exp(m - mx)
                m = mx
                p = torch.exp(x - m[..., None])
                l = l * corr + p.sum(dim=-1)
                acc = mm3(p, vt, acc * corr[..., None])
            halves.append((m, l, acc))
        parts.append(_fold(halves))
    m, l, acc = parts[0] if len(parts) == 1 else _fold(parts)
    den = l.clamp_min(1e-30)
    return acc / den[..., None], m + torch.log(den)


def backward_emulated(q, k, v, out, dout, lse, causal, cap, window):
    """The float32 backward kernels' arithmetic -> (dq, dk, dv)."""
    b, hq, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    kr, vr = (x.repeat_interleave(g, dim=1) for x in (k, v))
    rsd = _scale(d)
    x = mm3(q, kr.transpose(-1, -2)) * rsd
    dc = torch.ones_like(x)
    if cap:
        t = torch.tanh(x * (torch.tensor(1.0, dtype=F32) / cap))
        x = cap * t
        dc = 1.0 - t * t
    ok = _mask(torch.arange(s), torch.arange(sk), sk, causal, window)
    p = torch.where(ok, torch.exp(x - lse[..., None]), 0.0)
    delta = (dout * out).sum(dim=-1)
    dp = mm3(dout, vr.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * dc * rsd

    rows = -(-s // KEY_TILE) * KEY_TILE     # a head's query tiles

    def over_group(a, m):
        """sum over the group's query heads and their rows in order, each
        head's rows padded to whole query tiles as the kernel stages them:
        a (B, Hq, S, Sk) -> (B, Hkv, Sk, g rows); m (B, Hq, S, D) -> (B,
        Hkv, g rows, D)"""
        a, m = (F.pad(x, (0, 0, 0, rows - s)) for x in (a, m))
        return (a.reshape(b, hkv, g * rows, sk).transpose(-1, -2),
                m.reshape(b, hkv, g * rows, d))
    def by_pair(a, m, n):
        """a (..., n) @ m (..., n, D) as a warp pair sums it: the first
        and second 32 of every 64 inner indices (from 0) apart, in order,
        then the two sums added"""
        pad = -n % KEY_TILE
        a, m = F.pad(a, (0, pad)), F.pad(m, (0, 0, 0, pad))
        idx = torch.arange(n + pad)
        first = (idx // (KEY_TILE // 2)) % 2 == 0
        return (mm3(a[..., first], m[..., first, :])
                + mm3(a[..., ~first], m[..., ~first, :]))
    dv = by_pair(*over_group(p, dout), g * rows)
    dk = by_pair(*over_group(ds, q), g * rows)
    dq = None
    for lo, hi in dq_key_parts(sk, causal):
        part = by_pair(ds[..., lo:hi], kr[:, :, lo:hi], hi - lo)
        dq = part if dq is None else dq + part
    return dq, dk, dv


def _inputs(case_seed, b, hq, hkv, sq, sk, d, scale):
    """q from seed ``case_seed``, k and v from the next; ``scale`` None:
    the card tests' draw (``_attention_case``), else q and k ~ N(0,
    scale^2) and v ~ N(0, 1) as ``chip_smoke.py`` draws them."""
    if scale is None:
        q = _attention_case(case_seed, b=b, hq=hq, hkv=hkv, s=sq, d=d)[0]
        _, k, v = _attention_case(case_seed + 1, b=b, hq=hq, hkv=hkv, s=sk,
                                  d=d)
    else:
        rng = np.random.default_rng(case_seed)
        q = rng.normal(0, scale, (b, hq, sq, d))
        k = rng.normal(0, scale, (b, hkv, sk, d))
        v = rng.normal(0, 1, (b, hkv, sk, d))
    return [torch.from_numpy(np.asarray(x, dtype=np.float32))
            for x in (q, k, v)]


def _err(got, want) -> float:
    """Largest difference relative to the reference's largest
    magnitude."""
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got.double().numpy() - want).max()
                 / np.abs(want).max())


def test_tf32_rounds_to_nearest_ties_away():
    """Ten mantissa bits kept, to nearest, ties away from zero, on both
    signs; hi + lo carries a value to ~2^-22 of it."""
    one = 1.0
    ulp = 2.0 ** -10
    cases = {one + ulp / 2: one + ulp,             # a tie: away from zero
             one + ulp / 2 - 2.0 ** -23: one,      # just under a tie
             one + 3 * ulp / 2: one + 2 * ulp,     # a tie at an odd step
             -(one + ulp / 2): -(one + ulp)}
    for x, want in cases.items():
        got = tf32(torch.tensor([x], dtype=F32)).item()
        assert got == want, (x, got, want)
    v = torch.from_numpy(np.random.default_rng(0).normal(0, 3, 4096)
                         .astype(np.float32))
    hi, lo = split(v)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    rel = ((hi.double() + lo.double() - v.double()).abs()
           / v.double().abs()).max().item()
    assert rel <= 2.0 ** -21


@pytest.mark.parametrize("scale", [None, 3.0], ids=["case", "scale3"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("d", [64, 128])
def test_tf32x3_forward_holds_the_reference(d, cap, causal, scale):
    """S = 200 (a ragged last tile), GQA 4/2, as
    ``test_cuda_flash_attention_matches_plain``: the emulated kernel
    against the JAX ``flash_attention_ref`` within half of 1e-5."""
    q, k, v = _inputs(0, 2, 4, 2, 200, 200, d, scale)
    got, _ = forward_emulated(q, k, v, causal, cap)
    want = jax_flash_attention_ref(*(jnp.asarray(x.numpy()) for x in
                                     (q, k, v)), causal=causal,
                                   logit_cap=cap)
    assert _err(got, want) <= DESIGN_TOL


@pytest.mark.parametrize("scale", [None, 3.0], ids=["case", "scale3"])
@pytest.mark.parametrize("sq", [1, 5, 128])
def test_tf32x3_forward_key_split_holds_the_reference(sq, scale):
    """The split forward (non-causal, 1, 5 and 128 queries against 1500
    keys, D 64: three parts folded in order) against ``_attend``; the
    plan is the wrapper's."""
    assert len(fwd_key_parts(sq, 1500, False, F32)) == 3
    q, k, v = _inputs(10, 1, 4, 2, sq, 1500, 64, scale)
    got, lse = forward_emulated(q, k, v, False, 0.0)
    want = jax_attend(*(jnp.asarray(x.numpy().swapaxes(1, 2)) for x in
                        (q, k, v)), causal=False, q_offset=0)
    assert _err(got, np.asarray(want).swapaxes(1, 2)) <= DESIGN_TOL
    g = q.shape[1] // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(),
                     k.double().repeat_interleave(g, dim=1)) / 8.0
    assert _err(lse, torch.logsumexp(s, dim=-1).numpy()) <= DESIGN_TOL


# (B, Hq, Hkv, Sq, Sk, causal, window, cap): the card test
# test_cuda_flash_attention_backward_matches_plain_gradient's cases
BWD_CASES = [(1, 4, 2, 200, 200, True, 0, 0.0),
             (2, 6, 2, 65, 65, True, 0, 50.0),
             (1, 4, 4, 1, 1, True, 0, 0.0),
             (1, 4, 2, 17, 1500, False, 0, 0.0),
             (2, 2, 2, 130, 63, False, 0, 30.0),
             (1, 4, 2, 300, 300, True, 100, 50.0),
             (1, 8, 2, 129, 129, True, 7, 0.0)]


@pytest.mark.parametrize("scale", [None, 3.0], ids=["case", "scale3"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", BWD_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_tf32x3_backward_holds_jax_vjp(case, d, scale):
    """The emulated forward's output and lse, then the emulated backward,
    against jax.vjp of the reference's ``_attend``: dq/dk/dv within half
    of 1e-5 of each gradient's largest magnitude (of the largest
    of the three where one key or one query makes dq a sum that cancels,
    as the card test holds them)."""
    b, hq, hkv, sq, sk, causal, window, cap = case
    q, k, v = _inputs(20 + sk, b, hq, hkv, sq, sk, d, scale)
    dout = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, q.shape).astype(np.float32))
    out, lse = forward_emulated(q, k, v, causal, cap, window)
    got = backward_emulated(q, k, v, out, dout, lse, causal, cap, window)
    want = _jax_vjp(*(x.numpy() for x in (q, k, v, dout)), causal, window,
                    cap)
    top = max(np.abs(w).max() for w in want)
    for gr, w in zip(got, want):
        assert gr.shape == w.shape
        scale_w = top if 1 in (sq, sk) else np.abs(w).max()
        err = np.abs(gr.double().numpy() - w).max()
        assert err <= DESIGN_TOL * scale_w, err / scale_w
