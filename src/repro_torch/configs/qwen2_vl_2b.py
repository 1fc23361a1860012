"""qwen2-vl-2b — VLM backbone (M-RoPE, dynamic resolution)
[arXiv:2409.12191; hf].

The transformer BACKBONE only; the vision frontend is a stub —
``input_specs()``
provides precomputed patch embeddings merged into the token stream.
"""
from repro_torch.configs.base import ArchConfig, ATTN

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151_936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),   # (t, h, w) sections of head_dim/2
    block_pattern=(ATTN,),
    source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-2B-Instruct",
)
