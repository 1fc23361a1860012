"""PyTorch port, the backward kernels' algorithms on the CPU: B9's
(``flash_attention_bwd_ref``, the order of work of
``csrc/flash_attention_bwd.cu``: P from the forward's lse, delta from
its output, P and dS rounded to bf16 where the kernel rounds them, dQ's
key split ``dq_key_parts`` folded in part order) against ``jax.vjp`` of
the reference's ``models.layers._attend``, and the plan of that split;
B10's block geometry (``bwd_channels``) and the scratch its wrapper
allocates."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models.layers import _attend as jax_attend
from torch_cases import _attention_case

from repro_torch.kernels.flash_attention.kernel import (DQ_PART_KEYS,
                                                        FWD_SPLIT_ROWS,
                                                        KEY_TILE,
                                                        PADDED_HEAD,
                                                        dq_key_parts,
                                                        fwd_key_parts,
                                                        pad_heads)
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

torch.set_num_threads(2)

GRAD_TOL = 1e-5             # float32, of each gradient's largest magnitude
BF16_BWD_TOL = 4 * 2.0 ** -8  # bf16: chip_smoke.py's card gate


def _jax_vjp(q, k, v, dout, causal, window, cap):
    """jax.vjp of the reference's ``_attend`` (its (B, S, H, D) layout)
    at the float32 values of q, k, v and dout -> (dq, dk, dv) numpy in
    the port's (B, H, S, D) layout."""
    def f(q, k, v):
        return jax_attend(q, k, v, causal=causal, q_offset=0,
                          window=window, logit_cap=cap)
    args = [jnp.asarray(x.swapaxes(1, 2)) for x in (q, k, v)]
    _, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(dout.swapaxes(1, 2)))
    return [np.asarray(g).swapaxes(1, 2) for g in grads]


def _forward(q, k, v, causal, window, cap):
    """The forward's output and lse (float32 logsumexp of the scaled,
    capped, masked scores), as the card's forward kernel writes them."""
    d = q.shape[-1]
    g = q.shape[1] // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.float().repeat_interleave(g, dim=1)) / d ** 0.5
    if cap:
        s = cap * torch.tanh(s / cap)
    if causal:
        i = torch.arange(q.shape[2])[:, None]
        j = torch.arange(k.shape[2])[None, :]
        mask = i >= j
        if window:
            mask &= i - j < window
        s = torch.where(mask, s, -1e30)
    out = flash_attention_ref(q, k, v, causal=causal, logit_cap=cap,
                              window=window)
    return out, torch.logsumexp(s, dim=-1)


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# (B, Hq, Hkv, Sq, Sk, D, causal, window, cap): GQA groups 1, 2 and 4,
# causal with and without a window and a cap, non-causal with a key
# length of its own, one key and one query, and non-causal key lengths
# past DQ_PART_KEYS (the dQ split taken: 2 and 3 parts)
BWD_CASES = [
    (2, 4, 2, 40, 40, 64, True, 0, 0.0),
    (1, 4, 4, 33, 33, 64, True, 0, 50.0),
    (1, 4, 1, 70, 70, 128, True, 16, 0.0),
    (1, 2, 2, 65, 65, 64, True, 7, 30.0),
    (2, 4, 2, 17, 40, 64, False, 0, 0.0),
    (1, 2, 2, 40, 7, 128, False, 0, 50.0),
    (1, 2, 1, 1, 1, 64, True, 0, 0.0),
    (1, 2, 2, 1, 63, 64, False, 0, 0.0),
    (1, 2, 2, 9, 700, 64, False, 0, 0.0),
    (1, 2, 1, 5, 1500, 64, False, 0, 20.0)]


@pytest.mark.parametrize("case", BWD_CASES,
                         ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_ref_matches_jax_vjp(dtype, case):
    """dq/dk/dv of the backward kernel's algorithm against jax.vjp of the
    reference's ``_attend`` on the same values: float32 within 1e-5 of
    each gradient's largest magnitude; in bfloat16 (the inputs rounded
    to bf16, the output and dout too, P and dS rounded as the kernel
    rounds them) within the card gate's 4 x 2**-8."""
    b, hq, hkv, sq, sk, d, causal, window, cap = case
    q = _attention_case(40, b=b, hq=hq, hkv=hkv, s=sq, d=d)[0]
    _, k, v = _attention_case(41, b=b, hq=hq, hkv=hkv, s=sk, d=d)
    dout = np.random.default_rng(42).normal(0, 1, q.shape).astype(
        np.float32)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype)
                       for x in (q, k, v, dout))
    out, lse = _forward(tq, tk, tv, causal, window, cap)
    got = flash_attention_bwd_ref(tq, tk, tv, out, tdo, lse, causal=causal,
                                  logit_cap=cap, window=window)
    want = _jax_vjp(*(x.float().numpy() for x in (tq, tk, tv, tdo)),
                    causal, window, cap)
    tol = GRAD_TOL if dtype == torch.float32 else BF16_BWD_TOL
    # a single key or a single query makes dq a sum that cancels exactly
    # (dq = dk = 0 at one key; sum_k dS_k = 0 at one query, so dq is far
    # smaller than its terms): there it is held to the largest gradient
    top = max(np.abs(w).max() for w in want)
    for g, w, x in zip(got, want, (tq, tk, tv)):
        assert g.dtype == dtype and g.shape == x.shape
        err = np.abs(g.float().numpy() - w).max()
        scale = top if 1 in (sq, sk) else np.abs(w).max()
        assert err <= tol * scale, err


def test_flash_attention_bwd_ref_float32_is_autograd_of_the_plain():
    """In float32 the algorithm is the plain version's gradient: within
    1e-5 of autograd through ``flash_attention_ref`` with the dQ split
    taken (1500 keys, 3 parts) and a window and cap elsewhere."""
    for b, hq, hkv, sq, sk, d, causal, window, cap in (
            (1, 4, 2, 6, 1500, 64, False, 0, 0.0),
            (1, 4, 2, 50, 50, 64, True, 9, 50.0)):
        q = torch.from_numpy(_attention_case(43, b=b, hq=hq, hkv=hkv, s=sq,
                                             d=d)[0]).requires_grad_()
        k, v = (torch.from_numpy(x).requires_grad_() for x in
                _attention_case(44, b=b, hq=hq, hkv=hkv, s=sk, d=d)[1:])
        dout = torch.randn(q.shape, generator=torch.Generator()
                           .manual_seed(5))
        out = flash_attention_ref(q, k, v, causal=causal, logit_cap=cap,
                                  window=window)
        want = torch.autograd.grad(out, (q, k, v), dout)
        _, lse = _forward(q.detach(), k.detach(), v.detach(), causal,
                          window, cap)
        got = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                      out.detach(), dout, lse,
                                      causal=causal, logit_cap=cap,
                                      window=window)
        for g, w in zip(got, want):
            assert _rel(g, w.numpy()) <= GRAD_TOL


# the key splits: dQ's (both dtypes' backward) and the float32 forward's
# where it splits (few query rows), which takes dQ's parts
KEY_PLANS = {"dq": lambda sk, causal: dq_key_parts(sk, causal),
             "fwd_f32_1_row": lambda sk, causal: fwd_key_parts(
                 1, sk, causal, torch.float32),
             "fwd_f32_128_rows": lambda sk, causal: fwd_key_parts(
                 FWD_SPLIT_ROWS, sk, causal, torch.float32)}


@pytest.mark.parametrize("plan", list(KEY_PLANS))
@pytest.mark.parametrize("causal", [False, True])
def test_dq_key_parts_cover_the_keys_in_whole_tiles(causal, plan):
    """For every Sk from 1 to 8192 the parts cover [0, Sk) in order
    without overlap; every inner split point is a multiple of the 64-key
    tile and every part but the last holds the same whole tiles, at
    most DQ_PART_KEYS keys; causal calls and Sk <= DQ_PART_KEYS take one
    part.  Both dtypes' backward kernels split (float32's too, since its
    3xTF32 kernels), and so does the float32 forward of few rows."""
    for sk in range(1, 8193):
        parts = KEY_PLANS[plan](sk, causal)
        assert parts[0][0] == 0 and parts[-1][1] == sk
        assert all(a < b for a, b in parts)
        assert all(parts[i][1] == parts[i + 1][0]
                   for i in range(len(parts) - 1))
        if causal or sk <= DQ_PART_KEYS:
            assert parts == [(0, sk)]
            continue
        per = parts[0][1]
        assert per % KEY_TILE == 0 and per <= DQ_PART_KEYS
        assert all(b - a == per for a, b in parts[:-1])
        assert len(parts) == -(-sk // DQ_PART_KEYS)


@pytest.mark.parametrize("plan", list(KEY_PLANS))
def test_dq_key_parts_depend_on_sk_alone(plan):
    """The split is a function of Sk (with causality; the forward's also
    of the query length and the dtype) alone, never of the batch or the
    heads: the wrappers pass only the first part's length, and the
    kernels cut the keys at its multiples, which gives the same parts."""
    import inspect
    assert list(inspect.signature(dq_key_parts).parameters) == [
        "sk", "causal"]
    assert list(inspect.signature(fwd_key_parts).parameters) == [
        "sq", "sk", "causal", "dtype"]
    for sk in (513, 1000, 1500, 4097, 8192):
        parts = KEY_PLANS[plan](sk, False)
        per = parts[0][1]
        assert parts == [(a, min(sk, a + per)) for a in range(0, sk, per)]
    assert KEY_PLANS[plan](1500, False) == [(0, 512), (512, 1024),
                                            (1024, 1500)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq", [1, 5, 64, 128, 129, 1500])
def test_fwd_key_parts_split_only_few_float32_rows(sq, causal, dtype):
    """The forward splits its keys only in float32, non-causal, with at
    most FWD_SPLIT_ROWS query rows (whisper's cross-attention of a
    prompt or of one position against 1500 frames: 3 parts); the
    encoder's 1500 rows, causal calls and bfloat16 take one part."""
    for sk in (1, 512, 513, 1500, 4097):
        parts = fwd_key_parts(sq, sk, causal, dtype)
        split = (dtype == torch.float32 and not causal
                 and sq <= FWD_SPLIT_ROWS)
        assert parts == (dq_key_parts(sk, causal) if split
                         else [(0, sk)])
    assert len(fwd_key_parts(128, 1500, False, torch.float32)) == 3


# ------------------------------------------------ B10's backward geometry

@pytest.mark.parametrize("n", range(1, 65))
def test_bwd_channels_and_scratch_shapes(n):
    """N from 1 to 64: two states a thread, so the lanes of a channel are
    the power of two holding ceil(N / 2) states (at least 4, at most
    32); a part sums a cluster of 8 blocks of 128 / lanes channels; the
    scratch is (parts, B, L, N) for dB and dC with parts = ceil(D /
    channels), and (B, D, N) for dA."""
    from repro_torch.kernels.ssm_scan.kernel import (BWD_CLUSTER, bwd_lanes,
                                                     bwd_channels,
                                                     bwd_scratch_shapes)
    lanes = bwd_lanes(n)
    assert lanes in (4, 8, 16, 32) and 2 * lanes >= n
    assert lanes == 4 or lanes < n             # the smallest that holds N
    assert bwd_channels(n) == BWD_CLUSTER * 128 // lanes
    for b, seq, d in ((2, 1000, 512), (1, 31, 75), (2, 2048, 16384)):
        shapes = bwd_scratch_shapes(b, seq, d, n)
        parts = -(-d // bwd_channels(n))
        assert shapes == {"part_b": (parts, b, seq, n),
                          "part_c": (parts, b, seq, n),
                          "part_a": (b, d, n)}


def test_bwd_scratch_at_the_training_shape_is_a_quarter():
    """At the hybrid's training shape (2, 2048, 16384, 16) the dB/dC
    partials are 128 parts: 67,108,864 bytes, a quarter of the 512
    parts (32 channels a part) of the first version."""
    from repro_torch.kernels.ssm_scan.kernel import bwd_scratch_shapes
    shapes = bwd_scratch_shapes(2, 2048, 16384, 16)
    nbytes = sum(4 * np.prod(shapes[k]) for k in ("part_b", "part_c"))
    assert shapes["part_b"][0] == 128
    assert nbytes == 67_108_864 == 2 * 4 * 512 * 2 * 2048 * 16 // 4


# (B, Hq, Hkv, S, D, window, cap): the reduced configurations' heads the
# wrappers pad (serve_demo's 4/2 of 16, train_lm's 8/4 of 32), causal,
# and a window with a cap at 16
PADDED_CASES = [(1, 4, 2, 26, 16, 0, 0.0), (2, 8, 4, 128, 32, 0, 0.0),
                (1, 4, 2, 40, 16, 7, 30.0)]


@pytest.mark.parametrize("case", PADDED_CASES,
                         ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_heads_match_jax(dtype, case):
    """A head of 16 or 32 as the CUDA wrappers run it: q, k, v
    zero-padded to 64 or 128 with q doubled (``pad_heads``), the forward
    cut back to D; the backward on the padded q, k, v, output and dout,
    dq's first D columns doubled.  Against the reference's ``_attend``
    and its ``jax.vjp`` at D: float32 within 1e-5, bfloat16 within the
    card gates (8e-3 forward, 4 x 2**-8 backward)."""
    b, hq, hkv, s, d, window, cap = case
    q, k, v = _attention_case(43, b=b, hq=hq, hkv=hkv, s=s, d=d)
    dout = np.random.default_rng(44).normal(0, 1, q.shape).astype(
        np.float32)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype)
                       for x in (q, k, v, dout))
    pq, pk, pv = pad_heads(tq, tk, tv)
    assert pq.shape[-1] == PADDED_HEAD[d]
    assert torch.equal(pq[..., :d], tq * 2.0) and not pq[..., d:].any()
    out, lse = _forward(pq, pk, pv, True, window, cap)
    assert not out[..., d:].any()
    want_out = np.asarray(jax_attend(
        *(jnp.asarray(x.float().numpy().swapaxes(1, 2))
          for x in (tq, tk, tv)), causal=True, q_offset=0, window=window,
        logit_cap=cap)).swapaxes(1, 2)
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    assert _rel(out[..., :d], want_out) <= tol
    pad = (0, PADDED_HEAD[d] - d)
    dq, dk, dv = flash_attention_bwd_ref(
        pq, pk, pv, out, torch.nn.functional.pad(tdo, pad), lse,
        causal=True, logit_cap=cap, window=window)
    want = _jax_vjp(*(x.float().numpy() for x in (tq, tk, tv, tdo)),
                    True, window, cap)
    tol = GRAD_TOL if dtype == torch.float32 else BF16_BWD_TOL
    for g, w in zip((dq[..., :d] * 2.0, dk[..., :d], dv[..., :d]), want):
        assert _rel(g, w) <= tol
