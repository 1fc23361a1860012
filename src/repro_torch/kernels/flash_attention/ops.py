"""Public API: flash attention with GQA and soft-cap (port of
``repro/kernels/flash_attention/ops.py``)."""
from __future__ import annotations

from repro_torch.device import refuse_unported
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel


def flash_attention(q, k, v, *, causal=True, logit_cap=0.0, window=0,
                    interpret=False, use_kernel=True):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D): the
    ``flash_attention`` kernel on CUDA tensors, its plain version on CPU
    tensors.  Sk != Sq needs ``causal=False``; ``window`` needs
    ``causal=True``.  ``interpret=True`` and ``use_kernel=False`` are
    not ported."""
    refuse_unported("flash_attention", interpret=interpret,
                    use_kernel=use_kernel)
    return flash_attention_kernel(q, k, v, causal=causal,
                                  logit_cap=logit_cap, window=window)
