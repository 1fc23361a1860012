"""gemma2-27b — local+global alternating attention, logit softcap
[arXiv:2408.00118; hf]."""
from repro_torch.configs.base import ArchConfig, ATTN, ATTN_LOCAL

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    d_ff=36864,
    vocab_size=256_000,
    head_dim=128,
    logit_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    rope_theta=10_000.0,
    block_pattern=(ATTN_LOCAL, ATTN),   # alternating local/global
    optimizer="adafactor",
    source="arXiv:2408.00118; hf:google/gemma-2-27b",
)
