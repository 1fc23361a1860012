"""Architecture + run-shape configuration system.

Every assigned architecture is a :class:`ArchConfig` instance registered
under its public id (``--arch <id>``).  Shapes (the four assigned
input-shape regimes) are :class:`ShapeConfig` instances.  A (arch, shape)
pair fully determines the lowered program: ``train_step`` for ``train_*``
shapes, ``serve_step`` for ``decode_*`` /
``long_*`` shapes, ``prefill`` for ``prefill_*``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

# ---------------------------------------------------------------------------
# Block kinds understood by the model zoo.
# ---------------------------------------------------------------------------
ATTN = "attn"              # full (causal) GQA attention
ATTN_LOCAL = "attn_local"  # sliding-window attention (gemma2 local layers)
MAMBA = "mamba"            # mamba-1 selective SSM block
MLSTM = "mlstm"            # xLSTM mLSTM block (matrix memory)
SLSTM = "slstm"            # xLSTM sLSTM block (scalar memory)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # d_ff of each expert (falls back to ArchConfig.d_ff when 0)
    expert_d_ff: int = 0
    num_shared_experts: int = 0
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    # capacity factor for dispatch buffers (train); decode uses dense gather
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | hybrid | vlm | audio | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    # --- attention options -------------------------------------------------
    qkv_bias: bool = False          # qwen-style QKV bias
    logit_softcap: float = 0.0      # gemma2 attention logit soft-capping
    final_softcap: float = 0.0      # gemma2 final-logit soft-capping
    sliding_window: int = 0         # window for ATTN_LOCAL layers
    rope_theta: float = 10_000.0
    mrope_sections: Optional[tuple] = None   # qwen2-vl M-RoPE (t, h, w) split
    # --- block layout ------------------------------------------------------
    # Pattern of block kinds tiled to num_layers.  E.g. jamba 1:7 ->
    # (ATTN, MAMBA*7); gemma2 -> (ATTN_LOCAL, ATTN); xlstm -> (MLSTM,...,SLSTM)
    block_pattern: tuple = (ATTN,)
    # --- MoE ---------------------------------------------------------------
    moe: Optional[MoEConfig] = None
    moe_every: int = 1          # MoE FFN on layers with i % moe_every == 0
    # --- mamba -------------------------------------------------------------
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # --- xlstm -------------------------------------------------------------
    xlstm_proj_factor: float = 2.0
    # --- enc-dec (whisper) ---------------------------------------------
    encoder_layers: int = 0         # >0 -> encoder-decoder model
    num_audio_frames: int = 1500    # whisper 30 s @ 50 Hz after conv stem
    # --- embedding/misc ------------------------------------------------
    tie_embeddings: bool = True
    rms_eps: float = 1e-6
    # --- training-system knobs (per-arch defaults, overridable) -----------
    optimizer: str = "adamw"        # adamw | adafactor (huge archs)
    remat: bool = True
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # citation provenance (public literature)
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def blocks(self) -> Sequence[str]:
        """Per-layer block kinds, the pattern tiled out to num_layers."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    @property
    def attention_free(self) -> bool:
        return not any(b in (ATTN, ATTN_LOCAL) for b in self.blocks)

    @property
    def subquadratic(self) -> bool:
        """True when the arch can serve 500k-token contexts (SSM / hybrid)."""
        kinds = set(self.blocks)
        return bool(kinds & {MAMBA, MLSTM, SLSTM})

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-flops and reports)."""
        d, h = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        total = self.vocab_size * d                        # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d
        for kind in self.blocks:
            total += 2 * d                                  # norms
            if kind in (ATTN, ATTN_LOCAL):
                total += d * (nq * h) + 2 * d * (nkv * h) + (nq * h) * d
                if self.qkv_bias:
                    total += (nq + 2 * nkv) * h
            elif kind == MAMBA:
                d_in = self.mamba_expand * d
                total += d * 2 * d_in                       # in_proj (x, z)
                total += d_in * self.mamba_d_conv           # conv
                total += d_in * (self.mamba_d_state * 2 + 1)  # B,C,dt proj
                total += d_in * self.mamba_d_state          # A
                total += d_in * d                           # out_proj
            elif kind in (MLSTM, SLSTM):
                d_in = int(self.xlstm_proj_factor * d)
                total += d * 2 * d_in + d_in * d            # up(x,z) + down
                total += 3 * d_in * d_in // max(self.num_heads, 1)  # qkv-ish
                total += 3 * d_in                           # gates
            # FFN
            if self.d_ff > 0 and kind in (ATTN, ATTN_LOCAL, MAMBA):
                if self.moe is not None:
                    eff = self.moe.expert_d_ff or self.d_ff
                    total += self.moe.num_experts * 3 * d * eff
                    total += d * self.moe.num_experts       # router
                    total += self.moe.num_shared_experts * 3 * d * eff
                else:
                    total += 3 * d * self.d_ff              # swiglu
        if self.encoder_layers:
            total += self.encoder_layers * (
                2 * d + d * (nq * h) * 2 + 2 * d * (nkv * h)
                + 4 * d * self.d_ff
            )
            # decoder cross-attention
            total += self.num_layers * (d * (nq * h) * 2
                                        + 2 * d * (nkv * h) + d)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        eff = self.moe.expert_d_ff or self.d_ff
        dense_expert = 3 * d * eff
        n_moe_layers = sum(
            1 for i, k in enumerate(self.blocks)
            if k in (ATTN, ATTN_LOCAL, MAMBA) and i % self.moe_every == 0
        )
        inactive = (self.moe.num_experts - self.moe.top_k) * dense_expert
        return int(self.param_count() - n_moe_layers * inactive)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def cell_is_runnable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether the (arch, shape) dry-run cell is lowered, else why skipped."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, "long_500k requires sub-quadratic attention; " \
                      f"{arch.name} is pure full-attention (see DESIGN.md)"
    return True, ""
