"""Causal, sliding-window or full GQA flash attention with an optional
soft-cap, and a key length of its own without causality (B9), with its
gradient (``FlashAttention``: the forward and the backward kernel)."""
from repro_torch.kernels.flash_attention.kernel import (  # noqa: F401
    FlashAttention, flash_attention_bwd_kernel, flash_attention_kernel)
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    flash_attention_ref)
