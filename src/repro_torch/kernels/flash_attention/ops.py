"""Public API: flash attention with GQA and soft-cap (port of
``repro/kernels/flash_attention/ops.py``), with its gradient."""
from __future__ import annotations

import torch

from repro_torch.device import refuse_unported
from repro_torch.kernels.flash_attention.kernel import (FlashAttention,
                                                        flash_attention_kernel)


def flash_attention(q, k, v, *, causal=True, logit_cap=0.0, window=0,
                    q_offset=0, kv_len_mask=None, interpret=False,
                    use_kernel=True):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D): the
    ``flash_attention`` kernel on CUDA tensors, its plain version on CPU
    tensors (whose gradient is autograd through it).  On CUDA tensors
    that need a gradient (grad enabled, one of them requiring it) the
    call goes through ``FlashAttention``: the forward kernel with the
    log-sum-exp, and the backward kernel.  ``window`` needs
    ``causal=True``; row i sits at position ``q_offset + i``;
    ``kv_len_mask`` (B, Sk) bool masks keys (see
    ``flash_attention_kernel``).  ``interpret=True`` and
    ``use_kernel=False`` are not ported."""
    refuse_unported("flash_attention", interpret=interpret,
                    use_kernel=use_kernel)
    if q.is_cuda and torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, logit_cap, window,
                                    q_offset, kv_len_mask)
    return flash_attention_kernel(q, k, v, causal=causal,
                                  logit_cap=logit_cap, window=window,
                                  q_offset=q_offset,
                                  kv_len_mask=kv_len_mask)
