"""whisper-base — encoder-decoder, conv frontend (STUB)
[arXiv:2212.04356; unverified].

``input_specs()`` supplies precomputed log-mel frame embeddings (the conv stem
output), per the assignment: modality frontends are stubs.
"""
from repro_torch.configs.base import ArchConfig, ATTN

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,            # decoder layers
    encoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51_865,
    rope_theta=10_000.0,    # (whisper: learned/sinusoidal; rope harmless)
    block_pattern=(ATTN,),
    num_audio_frames=1500,
    source="arXiv:2212.04356; hf:openai/whisper-base",
)
