"""Wrappers of the ``flash_attention`` CUDA kernels: the forward
(``csrc/flash_attention.cu``; replaces the TPU kernel
``flash_attention_kernel`` of ``repro/kernels/flash_attention/kernel.py``)
and its gradient (``csrc/flash_attention_bwd.cu``; no TPU counterpart:
the reference differentiates its jnp attention), joined by the autograd
``FlashAttention``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.device import refuse_detached
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_ENTRY = {(torch.float32, 64): "fa_launch_f32_d64",
          (torch.float32, 128): "fa_launch_f32_d128",
          (torch.bfloat16, 64): "fa_launch_bf16_d64",
          (torch.bfloat16, 128): "fa_launch_bf16_d128"}
_ARGS = (build.PTR,) * 4 + (build.INT,) * 5 + (
    build.PTR, build.INT, build.INT, ctypes.c_float, build.PTR, build.PTR,
    build.INT, build.PTR)
_BWD_ENTRY = {key: name.replace("fa_launch", "fa_bwd_launch")
              for key, name in _ENTRY.items()}
_BWD_ARGS = (build.PTR,) * 10 + (build.INT,) * 5 + (
    build.PTR, build.INT, build.INT, ctypes.c_float, build.PTR, build.INT,
    build.PTR)

# head dims the wrappers take by padding (the reduced configurations'
# heads): zero-padded to the kernels' 64 or 128 with q doubled, so that
# the kernel's scale, 1/8 or 1/sqrt(128), times 2 is 1/sqrt(16) or
# 1/sqrt(32) exactly; the scores are the same numbers, the padded
# columns add zeros to them and come out zero
PADDED_HEAD = {16: 64, 32: 128}
KEY_TILE = 64          # keys a tile of the kernels (csrc kBK, kTile)
DQ_PART_KEYS = 512     # the most keys a part of a key split holds
FWD_SPLIT_ROWS = 128   # the most query rows of a split float32 forward


def dq_key_parts(sk: int, causal: bool) -> list:
    """The backward's dQ key split: [(start, end), ...] covering [0, sk)
    in order, without overlap.  A non-causal call with more than
    ``DQ_PART_KEYS`` keys splits into ceil(sk / DQ_PART_KEYS) parts of
    equal whole 64-key tiles (the last one short); every other call
    (causal, or few keys) is one part.  Both dtypes' kernels take it.  A
    function of sk alone, never of the batch, the heads or the query
    length, so a row's dq does not depend on what else is computed with
    it."""
    if causal or sk <= DQ_PART_KEYS:
        return [(0, sk)]
    tiles = -(-sk // KEY_TILE)
    n = -(-sk // DQ_PART_KEYS)
    per = -(-tiles // n) * KEY_TILE
    return [(a, min(sk, a + per)) for a in range(0, sk, per)]


def fwd_key_parts(sq: int, sk: int, causal: bool, dtype) -> list:
    """The float32 forward's key split: a non-causal float32 call with at
    most ``FWD_SPLIT_ROWS`` query rows (two query tiles: whisper's
    cross-attention of a prompt, or of one decode position, against the
    encoder's frames) takes dQ's parts (``dq_key_parts``), one block a
    part, so that a short grid still fills the card; every other call is
    one part.  A function of the two lengths (and the dtype) alone,
    never of the batch or the heads."""
    if dtype != torch.float32 or causal or sq > FWD_SPLIT_ROWS:
        return [(0, sk)]
    return dq_key_parts(sk, causal)


def _check(x: torch.Tensor, what: str, dtype, shape, dev):
    if x.device != dev:
        raise ValueError(f"flash_attention: {what} on {x.device}, "
                         f"expected {dev}")
    if x.dtype != dtype:
        raise TypeError(f"flash_attention: {what} dtype {x.dtype}, "
                        f"expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"flash_attention: {what} shape "
                         f"{tuple(x.shape)}, expected {tuple(shape)}")
    if x.stride(-1) != 1:
        raise ValueError(f"flash_attention: {what}'s head dimension must "
                         f"be contiguous")
    if x.dtype == torch.bfloat16 and (
            x.data_ptr() % 16
            or any(st % 8 for st, n in zip(x.stride()[:3], x.shape[:3])
                   if n > 1)):
        raise ValueError(f"flash_attention: bfloat16 {what} must be "
                         f"16-byte aligned, in its pointer and its batch, "
                         f"head and sequence strides (the tensor-core "
                         f"kernel copies 16-byte rows); got pointer "
                         f"offset {x.data_ptr() % 16} and strides "
                         f"{x.stride()}")


def _check_options(q, k, causal, window) -> int:
    window = int(window or 0)
    sk = k.shape[2]
    if sk < 1 or window < 0:
        raise ValueError(f"flash_attention: {sk} keys, window {window}")
    if causal and sk != q.shape[2]:
        raise ValueError(f"flash_attention: a causal call needs as many "
                         f"keys as queries, got {sk} and {q.shape[2]}")
    if window and not causal:
        raise ValueError("flash_attention: a window needs causal=True")
    return window


def _check_cuda(q, k, v):
    """The CUDA kernels' argument checks -> (b, hq, hkv, s, sk, d)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    b, hq, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if (q.dtype, d) not in _ENTRY:
        raise ValueError(f"flash_attention: dtype {q.dtype} with head_dim "
                         f"{d}; the kernel takes float32 or bfloat16 with "
                         f"head_dim 64 or 128 (16 and 32 padded)")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention: {hq} query heads are not a "
                         f"multiple of {hkv} kv heads")
    _check(q, "q", q.dtype, (b, hq, s, d), dev)
    _check(k, "k", q.dtype, (b, hkv, sk, d), dev)
    _check(v, "v", q.dtype, (b, hkv, sk, d), dev)
    return b, hq, hkv, s, sk, d


def _strides(*tensors):
    return (ctypes.c_longlong * (3 * len(tensors)))(
        *(st for x in tensors for st in x.stride()[:3]))


def pad_heads(q, k, v):
    """(q, k, v) of a head dim in ``PADDED_HEAD`` -> the kernel's: each
    zero-padded to its padded head dim, q doubled (exact in either
    dtype)."""
    pad = (0, PADDED_HEAD[q.shape[-1]] - q.shape[-1])
    return F.pad(q * 2.0, pad), F.pad(k, pad), F.pad(v, pad)


def _unpad(x, like):
    """A padded kernel result cut to ``like``'s head dim, in ``like``'s
    layout."""
    return torch.empty_like(like).copy_(x[..., :like.shape[-1]])


def _forward(q, k, v, causal, logit_cap, window, with_lse):
    """Launch the forward on CUDA tensors -> (out, lse or None); lse is
    (B, Hq, S) float32, each row's log-sum-exp of its scores.  A head
    dim of ``PADDED_HEAD`` runs padded (``pad_heads``)."""
    if q.device.type == "cuda" and q.shape[-1] in PADDED_HEAD:
        out, lse = _forward(*pad_heads(q, k, v), causal, logit_cap, window,
                            with_lse)
        return _unpad(out, q), lse
    b, hq, hkv, s, sk, d = _check_cuda(q, k, v)
    dev = q.device
    out = torch.empty_like(q)          # q's layout (dense: same strides)
    lse = (torch.empty((b, hq, s), dtype=torch.float32, device=dev)
           if with_lse else None)
    parts = fwd_key_parts(s, sk, causal, q.dtype)
    part_keys = parts[0][1] if len(parts) > 1 else 0
    part = (torch.empty((len(parts), b, hq, s, d + 2), dtype=torch.float32,
                        device=dev) if part_keys else None)
    strides = _strides(q, k, v, out)
    fn = build.c_function(_ENTRY[(q.dtype, d)], _ARGS)
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, hq, hkv, s, sk, ctypes.addressof(strides),
                int(bool(causal)), window, float(logit_cap or 0.0),
                None if lse is None else lse.data_ptr(),
                None if part is None else part.data_ptr(), part_keys,
                build.stream_ptr(dev))
    build.check_launch(rc, "flash_attention")
    flash_attention_kernel.launches += 1
    flash_attention_kernel.key_parts = len(parts)
    return out, lse


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           logit_cap: float = 0.0,
                           window: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D), float32 or bfloat16 ->
    (B, Hq, Sq, D) in q's dtype, laid out in memory as q is.

    Sk may differ from Sq only with ``causal=False`` (cross-attention);
    ``window > 0`` masks keys at or past ``window`` positions behind the
    query (``q - k >= window``, the reference's sliding window) and
    needs ``causal=True``.  Anything else raises ``ValueError``.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream: bfloat16 runs on the tensor cores
    (``mma.sync``, P rounded to bfloat16), float32 on them too in
    3xTF32 (each operand split into TF32 hi and lo, three products,
    float32 accumulation), its keys split by ``fwd_key_parts`` where few
    query rows meet many keys (a fold in part order).  The kernel takes
    any strides with a contiguous head dimension (so a ``(B, S, H, D)``
    tensor transposed to ``(B, H, S, D)`` goes in without a copy), D in
    {64, 128} (16 and 32 padded to 64 and 128, ``pad_heads``), any S >= 1
    and Hq a multiple of Hkv.  In bfloat16 the
    pointers and the batch, head and sequence strides must be 16-byte
    aligned; a view that is not raises ``ValueError`` (it is not
    copied).

    Its result carries no gradient: a CUDA input that requires one, with
    grad enabled, raises ``NotImplementedError``; ``ops.flash_attention``
    takes such inputs through ``FlashAttention``.
    """
    window = _check_options(q, k, causal, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal,
                                   logit_cap=logit_cap, window=window)
    refuse_detached("flash_attention", q, k, v, item="B9: call "
                    "ops.flash_attention, whose FlashAttention has the "
                    "backward")
    return _forward(q, k, v, causal, logit_cap, window, False)[0]


flash_attention_kernel.launches = 0
flash_attention_kernel.key_parts = 0     # the last launch's key parts


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` if the kernels take its layout, else a contiguous copy (the
    incoming gradient of the output may be any view)."""
    ok = x.stride(-1) == 1 and (x.dtype != torch.bfloat16 or (
        x.data_ptr() % 16 == 0
        and all(st % 8 == 0 for st, n in zip(x.stride()[:3], x.shape[:3])
                if n > 1)))
    return x if ok else x.clone(memory_format=torch.contiguous_format)


def flash_attention_bwd_kernel(q, k, v, out, dout, lse, *, causal=True,
                               logit_cap=0.0, window=0):
    """The gradient of ``flash_attention_kernel``: q (B, Hq, Sq, D), k/v
    (B, Hkv, Sk, D), its output ``out`` and the forward's ``lse`` (B, Hq,
    Sq) float32, and ``dout`` the gradient of ``out`` -> (dq, dk, dv),
    each in its input's dtype and layout.  CUDA tensors only (the CPU's
    gradient is autograd through the plain version): the delta pre-pass,
    the dK/dV kernel and the dQ kernel on the current stream, float32 in
    3xTF32 on the tensor cores (``mma.sync``), bfloat16 on warpgroups of
    them (wgmma; P and dS rounded to bfloat16 for their products); a
    non-causal call with more than 512 keys splits dQ's keys by
    ``dq_key_parts`` (float32 partials, then a fold in part order; the
    algorithm is ``flash_attention_bwd_ref``).  Deterministic: no
    atomics.  ``flash_attention_bwd_kernel.dq_parts`` holds the parts of
    the last launch.  A head dim of ``PADDED_HEAD`` runs padded: q, k,
    v, ``out`` and ``dout`` zero-padded (q doubled, ``pad_heads``), dq
    the padded dq's first columns doubled."""
    window = _check_options(q, k, causal, window)
    if q.device.type == "cuda" and q.shape[-1] in PADDED_HEAD:
        pad = (0, PADDED_HEAD[q.shape[-1]] - q.shape[-1])
        dq, dk, dv = flash_attention_bwd_kernel(
            *pad_heads(q, k, v), F.pad(out, pad), F.pad(dout, pad), lse,
            causal=causal, logit_cap=logit_cap, window=window)
        return _unpad(dq, q).mul_(2.0), _unpad(dk, k), _unpad(dv, v)
    b, hq, hkv, s, sk, d = _check_cuda(q, k, v)
    dev = q.device
    dout = _aligned(dout)
    _check(out, "out", q.dtype, (b, hq, s, d), dev)
    _check(dout, "dout", q.dtype, (b, hq, s, d), dev)
    build.check_tensor(lse, "flash_attention lse", dtype=torch.float32,
                       shape=(b, hq, s), device=dev)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=dev)
    parts = dq_key_parts(sk, causal)
    part_keys = parts[0][1] if len(parts) > 1 else 0
    dq_part = (torch.empty((len(parts), b, hq, s, d), dtype=torch.float32,
                           device=dev) if part_keys else None)
    strides = _strides(q, k, v, out, dout, dq, dk, dv)
    fn = build.c_function(_BWD_ENTRY[(q.dtype, d)], _BWD_ARGS)
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, hq, hkv, s,
                sk, ctypes.addressof(strides), int(bool(causal)), window,
                float(logit_cap or 0.0),
                None if dq_part is None else dq_part.data_ptr(), part_keys,
                build.stream_ptr(dev))
    build.check_launch(rc, "flash_attention_bwd")
    flash_attention_bwd_kernel.launches += 1
    flash_attention_bwd_kernel.dq_parts = len(parts)
    return dq, dk, dv


flash_attention_bwd_kernel.launches = 0
flash_attention_bwd_kernel.dq_parts = 0


class FlashAttention(torch.autograd.Function):
    """B9 with its gradient, on CUDA tensors: the forward kernel writes
    each row's log-sum-exp beside the output, and the backward kernel
    recomputes P from q, k and it.  ``FlashAttention.apply(q, k, v,
    causal, logit_cap, window)``; the CPU's counterpart is autograd
    through ``flash_attention_ref``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, logit_cap, window):
        window = _check_options(q, k, causal, window)
        out, lse = _forward(q, k, v, causal, logit_cap, window, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.options = dict(causal=causal, logit_cap=logit_cap,
                           window=window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_kernel(q, k, v, out, dout, lse,
                                                **ctx.options)
        return dq, dk, dv, None, None, None
