"""jamba-1.5-large-398b — Mamba+attention 1:7 interleave with 16-expert
top-2 MoE
[arXiv:2403.19887; hf:ai21labs/AI21-Jamba-1.5-Large].

Hybrid/sub-quadratic: the only dense-KV layers are the 9 attention layers
(1 per 8-layer jamba block), so ``long_500k`` decode is supported.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, ATTN, MAMBA

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65_536,
    head_dim=128,
    rope_theta=10_000.0,
    # 1:7 attn:mamba interleave (attention at position 4 of each 8-layer block
    # per the paper; we place it first in the repeating pattern)
    block_pattern=(ATTN, MAMBA, MAMBA, MAMBA, MAMBA, MAMBA, MAMBA, MAMBA),
    moe=MoEConfig(num_experts=16, top_k=2, expert_d_ff=24576),
    moe_every=2,                     # MoE on every other layer (jamba e=2)
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    optimizer="adafactor",
    source="arXiv:2403.19887; hf:ai21labs/AI21-Jamba-1.5-Large",
)
