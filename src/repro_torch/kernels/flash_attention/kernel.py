"""Wrapper of the ``flash_attention`` CUDA kernel
(``csrc/flash_attention.cu``; replaces the TPU kernel
``flash_attention_kernel`` of ``repro/kernels/flash_attention/kernel.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_ENTRY = {(torch.float32, 64): "fa_launch_f32_d64",
          (torch.float32, 128): "fa_launch_f32_d128",
          (torch.bfloat16, 64): "fa_launch_bf16_d64",
          (torch.bfloat16, 128): "fa_launch_bf16_d128"}
_ARGS = (build.PTR,) * 4 + (build.INT,) * 5 + (
    build.PTR, build.INT, build.INT, ctypes.c_float, build.PTR)


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
    (``mma.sync``, P rounded to bfloat16), float32 on the SIMT kernel
    (float32 FMAs).  The kernel takes any strides with a contiguous head
    dimension (so a ``(B, S, H, D)`` tensor transposed to
    ``(B, H, S, D)`` goes in without a copy), D in {64, 128}, any
    S >= 1 and Hq a multiple of Hkv.  In bfloat16 the pointers and the
    batch, head and sequence strides must be 16-byte aligned; a view
    that is not raises ``ValueError`` (it is not copied).
    """
    window = int(window or 0)
    sk = k.shape[2]
    if sk < 1 or window < 0:
        raise ValueError(f"flash_attention: {sk} keys, window {window}")
    if causal and sk != q.shape[2]:
        raise ValueError(f"flash_attention: a causal call needs as many "
                         f"keys as queries, got {sk} and {q.shape[2]}")
    if window and not causal:
        raise ValueError("flash_attention: a window needs causal=True")
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal,
                                   logit_cap=logit_cap, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if (q.dtype, d) not in _ENTRY:
        raise ValueError(f"flash_attention: dtype {q.dtype} with head_dim "
                         f"{d}; the kernel takes float32 or bfloat16 with "
                         f"head_dim 64 or 128")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention: {hq} query heads are not a "
                         f"multiple of {hkv} kv heads")
    _check(q, "q", q.dtype, (b, hq, s, d), dev)
    _check(k, "k", q.dtype, (b, hkv, sk, d), dev)
    _check(v, "v", q.dtype, (b, hkv, sk, d), dev)
    out = torch.empty_like(q)          # q's layout (dense: same strides)
    strides = (ctypes.c_longlong * 12)(
        *(st for x in (q, k, v, out) for st in x.stride()[:3]))
    fn = build.c_function(_ENTRY[(q.dtype, d)], _ARGS)
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, hq, hkv, s, sk, ctypes.addressof(strides),
                int(bool(causal)), window, float(logit_cap or 0.0),
                build.stream_ptr(dev))
    build.check_launch(rc, "flash_attention")
    flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0
