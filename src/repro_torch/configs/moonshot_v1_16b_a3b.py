"""moonshot-v1-16b-a3b — kimi/moonlight MoE, 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B; hf]."""
from repro_torch.configs.base import ArchConfig, MoEConfig, ATTN

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163_840,
    rope_theta=50_000.0,
    block_pattern=(ATTN,),
    moe=MoEConfig(num_experts=64, top_k=6, expert_d_ff=1408,
                  num_shared_experts=2),
    source="hf:moonshotai/Moonlight-16B-A3B",
)
