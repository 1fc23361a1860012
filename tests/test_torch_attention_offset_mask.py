"""PyTorch port, B9 with a query offset and a key mask on the CPU: the
plain versions the card's kernels are held to (``flash_attention_ref``,
``flash_attention_lse_ref``, the backward kernel's algorithm
``flash_attention_bwd_ref``), ``ops.flash_attention`` and autograd
through ``models.layers.attention``, against the reference's
``models.layers.attention`` / ``_attend`` and their ``jax.vjp``: float32
within 1e-5 of the largest magnitude, the backward's bf16 algorithm
within the card gate's 4 x 2**-8.  Rows with no valid key (a left pad, a
window past the keys, a mask that leaves a row only future keys) take
the mean of v over all Sk keys, send nothing to dq or dk and dout / Sk
to every key's dv, as the reference's -1e30 scores make them."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models.layers import attention as jax_attention
from torch_cases import _attention_case

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.kernel import (PADDED_HEAD,
                                                        may_lack_keys,
                                                        pad_heads)
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref, flash_attention_lse_ref, flash_attention_ref,
    score_mask)
from repro_torch.models.layers import attention

torch.set_num_threads(2)

TOL = 1e-5                    # float32, of the largest magnitude
BF16_BWD_TOL = 4 * 2.0 ** -8  # bf16: chip_smoke.py's card gate


def _key_mask(kind, b, sk, seed=7):
    """(B, Sk) bool numpy or None: ``left`` pads (batch row r masks its
    first (r * 29) % sk keys: pad rows of a causal call have no key),
    ``right`` lengths (row r keeps sk - 13 r keys), ``random`` (30% of
    the keys masked, and key 0: a causal row at position 0 keeps only
    future keys)."""
    if kind is None:
        return None
    j = np.arange(sk)[None, :]
    r = np.arange(b)[:, None]
    if kind == "left":
        return j >= (r * 29) % sk
    if kind == "right":
        return j < np.maximum(sk - 13 * r, 1)
    mask = np.random.default_rng(seed).random((b, sk)) >= 0.3
    mask[:, 0] = False
    return mask


# (B, Hq, Hkv, Sq, Sk, D, causal, window, cap, q_offset, mask): an
# offset with Sk larger than, equal to and smaller than q_offset + Sq;
# an offset with a window and a cap; a window that rows outrun past the
# keys (rows with no key); a non-causal mask (q_offset has no effect);
# left pads with rows that have no key; a random mask that leaves causal
# rows only future keys; GQA groups 1, 3 and 8; D 64 and 128
CASES = [
    (1, 4, 2, 24, 80, 64, True, 0, 0.0, 40, None),
    (2, 4, 2, 24, 64, 64, True, 0, 0.0, 40, None),
    (1, 4, 2, 24, 50, 128, True, 0, 0.0, 40, None),
    (1, 4, 2, 24, 70, 128, True, 16, 30.0, 40, None),
    (1, 4, 2, 16, 40, 64, True, 8, 0.0, 44, None),
    (2, 4, 2, 12, 50, 64, False, 0, 0.0, 5, "right"),
    (3, 4, 2, 40, 40, 64, True, 0, 0.0, 0, "left"),
    (2, 3, 1, 20, 33, 64, True, 0, 50.0, 13, "random"),
    (2, 8, 1, 18, 40, 128, True, 12, 0.0, 22, "left"),
    (1, 2, 2, 9, 9, 64, True, 0, 0.0, 0, "random"),
]


def _ids(c):
    return "x".join(map(str, c))


def _inputs(case, seed=60):
    b, hq, hkv, sq, sk, d, *_ = case
    q = _attention_case(seed, b=b, hq=hq, hkv=hkv, s=sq, d=d)[0]
    _, k, v = _attention_case(seed + 1, b=b, hq=hq, hkv=hkv, s=sk, d=d)
    dout = np.random.default_rng(seed + 2).normal(0, 1, q.shape).astype(
        np.float32)
    return q, k, v, dout


def _jax_attention(q, k, v, case, mask):
    """The reference's ``attention`` in its (B, S, H, D) layout on the
    port's (B, H, S, D) numpy arrays -> numpy (B, H, S, D)."""
    *_, causal, window, cap, q_offset, _ = case
    out = jax_attention(
        *(jnp.asarray(x.swapaxes(1, 2)) for x in (q, k, v)), causal=causal,
        q_offset=q_offset, window=window, logit_cap=cap,
        kv_len_mask=None if mask is None else jnp.asarray(mask))
    return np.asarray(out).swapaxes(1, 2)


def _jax_vjp(q, k, v, dout, case, mask):
    """jax.vjp of the reference's ``attention`` -> (dq, dk, dv) numpy in
    the port's layout."""
    *_, causal, window, cap, q_offset, _ = case

    def f(q, k, v):
        return jax_attention(
            q, k, v, causal=causal, q_offset=q_offset, window=window,
            logit_cap=cap,
            kv_len_mask=None if mask is None else jnp.asarray(mask))
    _, vjp = jax.vjp(f, *(jnp.asarray(x.swapaxes(1, 2)) for x in (q, k, v)))
    grads = vjp(jnp.asarray(dout.swapaxes(1, 2)))
    return [np.asarray(g).swapaxes(1, 2) for g in grads]


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _opts(case, mask):
    *_, causal, window, cap, q_offset, _ = case
    return dict(causal=causal, logit_cap=cap, window=window,
                q_offset=q_offset,
                kv_len_mask=None if mask is None else torch.from_numpy(mask))


def _valid_keys(case, mask):
    """(B, Hq, Sq) int: each row's count of valid keys."""
    b, hq, _, sq, sk, *_ = case
    m = score_mask(torch.zeros((b, hq, sq, 1)), sk,
                   **{k: v for k, v in _opts(case, mask).items()
                      if k != "logit_cap"})
    if m is None:
        return torch.full((b, hq, sq), sk)
    return m.expand(b, hq, sq, sk).sum(dim=-1)


def _no_key_rows(case, mask):
    """(B, Hq, Sq) bool: the rows the case leaves without a valid key."""
    return _valid_keys(case, mask) == 0


def test_the_cases_cover_rows_without_keys():
    """The table holds rows with no key (left pads, a window past the
    keys, the random mask), and ``may_lack_keys`` says so for each case
    that has one."""
    n_with = 0
    for case in CASES:
        mask = _key_mask(case[-1], case[0], case[4])
        none = _no_key_rows(case, mask)
        n_with += bool(none.any())
        if none.any():
            assert may_lack_keys(case[3], case[4], case[6], case[7],
                                 case[9], mask)
    assert n_with >= 3


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_forward_matches_reference(case):
    """``flash_attention_ref`` and ``ops.flash_attention`` on CPU tensors
    against the reference's ``attention`` within 1e-5; rows with no key
    are the mean of v over all Sk keys."""
    q, k, v, _ = _inputs(case)
    mask = _key_mask(case[-1], case[0], case[4])
    want = _jax_attention(q, k, v, case, mask)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    opts = _opts(case, mask)
    got = flash_attention_ref(tq, tk, tv, **opts)
    assert _rel(got, want) <= TOL
    assert _rel(flash_attention(tq, tk, tv, **opts), want) <= TOL
    none = _no_key_rows(case, mask)
    if none.any():
        g = case[1] // case[2]
        mean = tv.repeat_interleave(g, dim=1).mean(dim=2, keepdim=True)
        rows = got[none]
        assert _rel(rows, mean.expand_as(got)[none].numpy()) <= TOL


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_lse_is_logsumexp_with_a_sentinel(case):
    """``flash_attention_lse_ref``: the log-sum-exp of a row's scored
    pairs (against numpy's in float64, 1e-5 of its largest magnitude),
    +inf exactly on the rows with no key."""
    q, k, _, _ = _inputs(case)
    mask = _key_mask(case[-1], case[0], case[4])
    opts = _opts(case, mask)
    lse = flash_attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  **opts)
    none = _no_key_rows(case, mask)
    assert torch.equal(torch.isinf(lse), none)
    g = case[1] // case[2]
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  np.repeat(k, g, axis=1).astype(np.float64)) \
        / np.sqrt(q.shape[-1])
    cap = opts["logit_cap"]
    if cap:
        s = cap * np.tanh(s / cap)
    m = score_mask(torch.from_numpy(q), k.shape[2],
                   **{a: b for a, b in opts.items() if a != "logit_cap"})
    if m is not None:
        s = np.where(m.expand(*s.shape).numpy(), s, -np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        top = s.max(axis=-1, keepdims=True)
        want = (np.log(np.exp(s - top).sum(axis=-1)) + top[..., 0])
    ok = ~none.numpy()
    assert _rel(lse.numpy()[ok], want[ok]) <= TOL


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_algorithm_matches_jax_vjp(dtype, case):
    """The backward kernel's algorithm, from the forward's output and lse
    (+inf on rows with no key), against jax.vjp of the reference's
    ``attention``: float32 within 1e-5 of each gradient's largest
    magnitude, bfloat16 (inputs, output and dout rounded, P and dS
    rounded as the kernel rounds them) within 4 x 2**-8."""
    q, k, v, dout = _inputs(case)
    mask = _key_mask(case[-1], case[0], case[4])
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype)
                       for x in (q, k, v, dout))
    opts = _opts(case, mask)
    out = flash_attention_ref(tq, tk, tv, **opts)
    lse = flash_attention_lse_ref(tq, tk, **opts)
    got = flash_attention_bwd_ref(tq, tk, tv, out, tdo, lse, **opts)
    want = _jax_vjp(*(x.float().numpy() for x in (tq, tk, tv, tdo)), case,
                    mask)
    tol = TOL if dtype == torch.float32 else BF16_BWD_TOL
    top = max(np.abs(w).max() for w in want)
    # in bf16, a row with one valid key has dS = dP - delta, which cancels
    # exactly but for delta's bf16-rounded output (as in the kernel): its
    # dq and its key's dk are held to the largest gradient, as
    # test_torch_bwd_kernels holds one-key calls
    single = dtype == torch.bfloat16 and bool((_valid_keys(case, mask)
                                               == 1).any())
    for g, w, x in zip(got, want, (tq, tk, tv)):
        assert g.dtype == dtype and g.shape == x.shape
        # a gradient that is 0 (or nearly) is held to the largest one
        scale = top if single else max(np.abs(w).max(), 1e-3 * top)
        assert np.abs(g.float().numpy() - w).max() <= tol * scale


@pytest.mark.parametrize(
    "case", [c for c in CASES
             if _no_key_rows(c, _key_mask(c[-1], c[0], c[4])).any()],
    ids=_ids)
def test_rows_without_keys_send_nothing_to_dq_and_dk(case):
    """With dout nonzero only on the rows that have no key, dq and dk are
    exactly 0 (the backward's P is exp(s - inf) = 0 there) and every
    key's dv is the group's sum of those rows' dout over Sk, as in the
    reference's vjp."""
    q, k, v, dout = _inputs(case)
    mask = _key_mask(case[-1], case[0], case[4])
    opts = _opts(case, mask)
    none = _no_key_rows(case, mask)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tdo = torch.from_numpy(dout) * none[..., None]
    out = flash_attention_ref(tq, tk, tv, **opts)
    lse = flash_attention_lse_ref(tq, tk, **opts)
    dq, dk, dv = flash_attention_bwd_ref(tq, tk, tv, out, tdo, lse, **opts)
    assert not dq.any() and not dk.any()
    b, hq, hkv, sq, sk, d = case[:6]
    u = tdo.reshape(b, hkv, hq // hkv * sq, d).sum(dim=2) / sk
    assert _rel(dv, u[:, :, None, :].expand_as(dv).numpy()) <= TOL
    want = _jax_vjp(q, k, v, tdo.numpy(), case, mask)
    assert _rel(dv, want[2]) <= TOL
    assert np.abs(want[0]).max() == 0.0 and np.abs(want[1]).max() == 0.0


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_layers_attention_autograd_matches_jax_vjp(case):
    """Autograd through the port's ``models.layers.attention`` on CPU
    tensors (the model's (B, S, H, D) layout, q_chunk 8 so the offset is
    carried across query chunks) against jax.vjp of the reference's, and
    its output against the reference's: float32 within 1e-5."""
    q, k, v, dout = _inputs(case)
    mask = _key_mask(case[-1], case[0], case[4])
    *_, causal, window, cap, q_offset, _ = case
    tq, tk, tv = (torch.from_numpy(x.swapaxes(1, 2).copy())
                  .requires_grad_() for x in (q, k, v))
    out = attention(tq, tk, tv, causal=causal, q_offset=q_offset,
                    window=window, logit_cap=cap, q_chunk=8,
                    kv_len_mask=None if mask is None
                    else torch.from_numpy(mask))
    assert _rel(out.detach().numpy().swapaxes(1, 2),
                _jax_attention(q, k, v, case, mask)) <= TOL
    got = torch.autograd.grad(out, (tq, tk, tv),
                              torch.from_numpy(dout.swapaxes(1, 2).copy()))
    want = _jax_vjp(q, k, v, dout, case, mask)
    top = max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        scale = max(np.abs(w).max(), 1e-3 * top)
        err = np.abs(g.numpy().swapaxes(1, 2) - w).max()
        assert err <= TOL * scale


# heads of 16 and 32, as the CUDA wrappers pad them, with an offset and
# a mask: (B, Hq, Hkv, Sq, Sk, D, causal, window, cap, q_offset, mask)
PADDED_CASES = [(2, 4, 2, 12, 30, 16, True, 0, 0.0, 18, "left"),
                (2, 8, 4, 16, 40, 32, True, 9, 30.0, 24, "random")]


@pytest.mark.parametrize("case", PADDED_CASES, ids=_ids)
def test_padded_heads_with_offset_and_mask(case):
    """``pad_heads`` (zero columns, q doubled) keeps an offset and a mask
    right: the forward on the padded heads cut to D, and the backward's
    algorithm on them (dq's first D columns doubled), against the
    reference at D, float32 within 1e-5."""
    q, k, v, dout = _inputs(case, seed=80)
    mask = _key_mask(case[-1], case[0], case[4])
    d = case[5]
    opts = _opts(case, mask)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    pq, pk, pv = pad_heads(tq, tk, tv)
    assert pq.shape[-1] == PADDED_HEAD[d]
    out = flash_attention_ref(pq, pk, pv, **opts)
    assert not out[..., d:].any()
    assert _rel(out[..., :d], _jax_attention(q, k, v, case, mask)) <= TOL
    lse = flash_attention_lse_ref(pq, pk, **opts)
    pad = (0, PADDED_HEAD[d] - d)
    dq, dk, dv = flash_attention_bwd_ref(
        pq, pk, pv, out, torch.nn.functional.pad(tdo, pad), lse, **opts)
    want = _jax_vjp(q, k, v, dout, case, mask)
    for g, w in zip((dq[..., :d] * 2.0, dk[..., :d], dv[..., :d]), want):
        assert _rel(g, w) <= TOL


def test_options_are_checked():
    """A negative offset, a window without causality, and a mask of the
    wrong dtype, shape or device raise before anything runs."""
    q = torch.zeros((2, 4, 5, 64))
    k = torch.zeros((2, 2, 7, 64))
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, k, q_offset=-1)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, k, causal=False, window=3)
    with pytest.raises(TypeError, match="kv_len_mask"):
        flash_attention(q, k, k, kv_len_mask=torch.ones((2, 7)))
    with pytest.raises(ValueError, match="kv_len_mask"):
        flash_attention(q, k, k, kv_len_mask=torch.ones(
            (2, 5), dtype=torch.bool))
    assert may_lack_keys(5, 7, True, 0, 100, None) is False
    assert may_lack_keys(5, 7, True, 4, 6, None) is True
    assert may_lack_keys(5, 7, False, 0, 0, torch.ones(
        (2, 7), dtype=torch.bool)) is True
