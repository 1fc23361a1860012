"""Config registry: 10 assigned architectures + the 4 input-shape regimes
(the port's copy of ``repro/configs``: plain data, no JAX).

Usage::

    from repro_torch.configs import get_arch, get_shape, reduced
    cfg = get_arch("llama3.2-3b")
    tiny = reduced(cfg)             # CPU-smoke-testable version, same family
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, MoEConfig, ShapeConfig, SHAPES,
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
    ATTN, ATTN_LOCAL, MAMBA, MLSTM, SLSTM,
    cell_is_runnable,
)

from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2_vl_2b
from repro_torch.configs.qwen1_5_32b import CONFIG as _qwen1_5_32b
from repro_torch.configs.llama3_2_3b import CONFIG as _llama3_2_3b
from repro_torch.configs.minicpm_2b import CONFIG as _minicpm_2b
from repro_torch.configs.gemma2_27b import CONFIG as _gemma2_27b
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as _qwen3_moe
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _jamba
from repro_torch.configs.whisper_base import CONFIG as _whisper
from repro_torch.configs.xlstm_1_3b import CONFIG as _xlstm

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in (
        _qwen2_vl_2b, _qwen1_5_32b, _llama3_2_3b, _minicpm_2b, _gemma2_27b,
        _moonshot, _qwen3_moe, _jamba, _whisper, _xlstm,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def reduced(cfg: ArchConfig) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests.

    Keeps the block pattern, attention options, MoE/hybrid structure;
    shrinks depth/width/experts/vocab so one forward+train step runs on CPU.
    """
    n_layers = (max(2, 2 * len(cfg.block_pattern))
                if len(cfg.block_pattern) > 1 else 2)
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2),
            expert_d_ff=32,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
        )
    kv = min(cfg.num_kv_heads, 2)
    heads = max(4, (4 // kv) * kv)   # keep heads % kv == 0
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=n_layers,
        encoder_layers=2 if cfg.encoder_layers else 0,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        sliding_window=min(cfg.sliding_window, 8) if cfg.sliding_window else 0,
        mrope_sections=(2, 3, 3) if cfg.mrope_sections else None,
        moe=moe,
        mamba_d_state=8,
        num_audio_frames=16,
        remat=False,
    )


SMOKE_SHAPE = ShapeConfig("smoke", seq_len=16, global_batch=2, kind="train")
SMOKE_DECODE = ShapeConfig("smoke_decode", seq_len=32, global_batch=2,
                           kind="decode")
SMOKE_PREFILL = ShapeConfig("smoke_prefill", seq_len=16, global_batch=2,
                            kind="prefill")
