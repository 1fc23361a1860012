"""qwen1.5-32b — dense, QKV bias [hf:Qwen/Qwen1.5-0.5B (family); hf]."""
from repro_torch.configs.base import ArchConfig, ATTN

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    block_pattern=(ATTN,),
    tie_embeddings=False,
    source="hf:Qwen/Qwen1.5-32B",
)
