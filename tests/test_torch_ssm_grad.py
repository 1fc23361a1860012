"""PyTorch port, B10's gradient on the CPU: the plain backward
(``selective_scan_bwd_ref``, the algorithm of the backward kernel
``csrc/selective_scan_bwd.cu``: checkpoints every ``chunk`` steps, each
chunk recomputed and walked back) against ``jax.vjp`` of the reference's
oracle (``repro.kernels.ssm_scan.ref.selective_scan_ref``, an
associative scan) and against autograd through the port's stepped plain
version, on the same seeded inputs; and ``ops.selective_scan`` on CPU
tensors, whose gradient stays autograd through the plain version."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.ssm_scan.ref import (selective_scan_ref as
                                        jax_selective_scan_ref)
from torch_cases import _scan_case

from repro_torch.kernels.ssm_scan import (CHUNK, selective_scan,
                                          selective_scan_bwd_kernel,
                                          selective_scan_bwd_ref,
                                          selective_scan_kernel,
                                          selective_scan_ref)

torch.set_num_threads(2)
torch.use_deterministic_algorithms(True)

GRAD_TOL = 1e-5             # of each gradient's largest magnitude, float32
NAMES = ("ddt", "dx", "dB", "dC", "dA", "dh0")


def _case(n, seq, h0_zero, seed=0):
    """_scan_case's inputs (B = 2, D = 24) and the seeded gradients of y
    and h_last, float32 numpy."""
    dt, x, bm, cm, a, h0 = _scan_case(seed, b=2, seq=seq, d=24, n=n)
    if h0_zero:
        h0 = np.zeros_like(h0)
    rng = np.random.default_rng(seed + 900)
    dy = rng.normal(0.0, 1.0, x.shape).astype(np.float32)
    dh = rng.normal(0.0, 1.0, h0.shape).astype(np.float32)
    return (dt, x, bm, cm, a, h0), dy, dh


def _bf16_np(v):
    """float32 numpy -> the same values rounded to bfloat16, as float32."""
    return torch.from_numpy(v).to(torch.bfloat16).float().numpy()


def _jax_vjp(args, dy, dh, x_bf16):
    """jax.vjp of the reference's oracle -> the six gradients, float32
    numpy (dx in bfloat16's values where x is bfloat16)."""
    jargs = [jnp.asarray(v) for v in args]
    if x_bf16:
        jargs[1] = jargs[1].astype(jnp.bfloat16)
    dh = np.zeros_like(args[5]) if dh is None else dh
    grads = _jax_grads(jargs, jnp.asarray(dy).astype(jargs[1].dtype),
                       jnp.asarray(dh))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


@jax.jit
def _jax_grads(jargs, dy, dh):
    return jax.vjp(jax_selective_scan_ref, *jargs)[1]((dy, dh))


def _autograd(args, dy, dh, x_bf16):
    """torch.autograd through the port's stepped plain version."""
    ins = [torch.from_numpy(v).clone() for v in args]
    if x_bf16:
        ins[1] = ins[1].to(torch.bfloat16)
    ins = [t.requires_grad_() for t in ins]
    y, h = selective_scan_ref(*ins)
    outs, cots = [y], [torch.from_numpy(dy).to(y.dtype)]
    if dh is not None:
        outs.append(h)
        cots.append(torch.from_numpy(dh))
    return [g.float().numpy()
            for g in torch.autograd.grad(outs, ins, cots)]


def _bwd_ref(args, dy, dh, x_bf16):
    ins = [torch.from_numpy(v) for v in args]
    if x_bf16:
        ins[1] = ins[1].to(torch.bfloat16)
    got = selective_scan_bwd_ref(
        *ins, torch.from_numpy(dy).to(ins[1].dtype),
        None if dh is None else torch.from_numpy(dh), chunk=CHUNK)
    assert got[0].dtype == torch.float32
    assert got[1].dtype == ins[1].dtype
    assert all(g.dtype == torch.float32 for g in got[2:])
    return [g.float().numpy() for g in got]


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _bf16_ulps(got, want) -> float:
    """Largest |got - want| in bf16 ulps of each ``want`` element."""
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return float((np.abs(got - want) / ulp).max())


@pytest.mark.parametrize("x_bf16", [False, True], ids=["x_f32", "x_bf16"])
@pytest.mark.parametrize("h0_zero", [False, True], ids=["h0", "h0_zero"])
@pytest.mark.parametrize("with_dh", [True, False], ids=["dh", "no_dh"])
@pytest.mark.parametrize("seq", [1, CHUNK - 1, CHUNK, 2 * CHUNK + 3])
@pytest.mark.parametrize("n", [1, 16, 64])
def test_backward_plain_matches_jax_vjp_and_autograd(n, seq, with_dh,
                                                     h0_zero, x_bf16):
    """Every gradient within 1e-5 of its largest magnitude of both
    oracles, at the chunk's edges (one step, one short of a chunk, a
    chunk, two chunks and a ragged third).  With x in bfloat16 the
    float32 gradients keep that bound; dx comes back rounded to
    bfloat16 by all three, from float32 values that agree to ~1e-7, so
    there it is held within one bf16 ulp of each element, and its
    float32 value (the same inputs with x widened) within 1e-5."""
    args, dy, dh = _case(n, seq, h0_zero)
    if x_bf16:
        args = (args[0], _bf16_np(args[1])) + args[2:]
        dy = _bf16_np(dy)
    dh = dh if with_dh else None
    got = _bwd_ref(args, dy, dh, x_bf16)
    for oracle in (_jax_vjp, _autograd):
        want = oracle(args, dy, dh, x_bf16)
        for name, g, w in zip(NAMES, got, want):
            assert g.shape == w.shape, name
            if x_bf16 and name == "dx":
                assert _bf16_ulps(g, w) <= 1.0, (oracle.__name__, name)
            else:
                assert _rel(g, w) <= GRAD_TOL, (oracle.__name__, name,
                                                _rel(g, w))
    if x_bf16:
        dx32 = _bwd_ref(args, dy, dh, False)[1]
        assert _rel(dx32, _jax_vjp(args, dy, dh, False)[1]) <= GRAD_TOL


def test_backward_plain_zero_cotangents_give_zero_gradients():
    """dy = 0 and dh_last None: every gradient is exactly zero (nothing
    is divided by exp(dt A), so an underflowed decay adds no NaN)."""
    args, dy, _ = _case(16, 40, False)
    args = (args[0] * 200.0,) + args[1:]       # exp(dt A) underflows
    ins = [torch.from_numpy(v) for v in args]
    got = selective_scan_bwd_ref(*ins, torch.zeros_like(ins[1]), None,
                                 chunk=CHUNK)
    for name, g in zip(NAMES, got):
        assert torch.equal(g, torch.zeros_like(g)), name


def test_cpu_gradient_is_the_plain_versions():
    """On CPU tensors ``ops.selective_scan`` is its plain version,
    autograd included: y, h_last and every gradient equal autograd
    through ``selective_scan_ref`` bit for bit, and no launch of either
    kernel is counted."""
    args, dy, dh = _case(16, 70, False, seed=3)
    n0 = selective_scan_kernel.launches
    b0 = selective_scan_bwd_kernel.launches
    outs = []
    for fn in (selective_scan, selective_scan_ref):
        ins = [torch.from_numpy(v).clone().requires_grad_() for v in args]
        y, h = fn(*ins)
        outs.append((y, h) + torch.autograd.grad(
            (y, h), ins, (torch.from_numpy(dy), torch.from_numpy(dh))))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert selective_scan_kernel.launches == n0
    assert selective_scan_bwd_kernel.launches == b0


def test_backward_wrapper_refuses_the_cpu():
    """The backward kernel has no CPU mode: the CPU's gradient is
    autograd through the plain version, so the wrapper raises."""
    args, dy, _ = _case(8, 8, False)
    dt, x, bm, cm, a, _ = (torch.from_numpy(v) for v in args)
    h_chunk = torch.zeros((2, 1, 24, 8))
    with pytest.raises(ValueError, match="unsupported device cpu"):
        selective_scan_bwd_kernel(dt, x, bm, cm, a, h_chunk,
                                  torch.from_numpy(dy))
