"""minicpm-2b — llama-like dense; WSD schedule [arXiv:2404.06395; hf].

The WSD (warmup-stable-decay) schedule is implemented in
``repro.train.optimizer.wsd_schedule`` and is this arch's default.
"""
from repro_torch.configs.base import ArchConfig, ATTN

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122_753,
    rope_theta=10_000.0,
    block_pattern=(ATTN,),
    source="arXiv:2404.06395; hf:openbmb/MiniCPM-2B",
)
