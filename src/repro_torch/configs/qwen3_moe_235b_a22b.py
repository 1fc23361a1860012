"""qwen3-moe-235b-a22b — 128 experts top-8 MoE
[hf:Qwen/Qwen3-235B-A22B; hf]."""
from repro_torch.configs.base import ArchConfig, MoEConfig, ATTN

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=151_936,
    head_dim=128,
    rope_theta=1_000_000.0,
    block_pattern=(ATTN,),
    moe=MoEConfig(num_experts=128, top_k=8, expert_d_ff=1536),
    optimizer="adafactor",
    source="hf:Qwen/Qwen3-235B-A22B",
)
