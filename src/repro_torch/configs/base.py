"""Model configuration system.

A model is a stack of *super-blocks*: a repeating pattern of blocks (attn /
mamba / mlstm / slstm ...), each optionally MoE.  All 10 assigned
architectures are expressible as (pattern, repeats) plus head/dim settings,
which keeps the compiled HLO small (``lax.scan`` over the repeats).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One block inside the repeating super-block pattern."""

    kind: str = "attn"            # attn | mamba | mlstm | slstm
    attn: str = "full"            # full | swa (sliding window) | local
    window: int = 0               # sliding/local window size (tokens)
    moe: bool = False             # MoE FFN instead of dense FFN


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | enc_dec | vlm | audio
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    # layer stack = pattern repeated `repeats` times (+ optional prologue)
    pattern: Tuple[BlockSpec, ...]
    repeats: int
    prologue: Tuple[BlockSpec, ...] = ()   # e.g. deepseek's dense first layer
    head_dim: Optional[int] = None         # default d_model // num_heads
    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_num_shared: int = 0                # deepseek shared experts
    moe_d_ff: Optional[int] = None         # expert hidden dim (default d_ff)
    moe_capacity_factor: float = 1.25      # expert buffer slack (tokens may drop)
    moe_groups: int = 0                    # GShard group-local dispatch (0=off)
    moe_decode_drop_free: bool = True      # decode C=T (exact) vs capacity-bounded
    # --- MLA (deepseek) ---
    mla_kv_lora_rank: int = 0              # 0 = MLA off
    mla_q_lora_rank: int = 0
    mla_qk_nope_dim: int = 128
    mla_qk_rope_dim: int = 64
    mla_v_dim: int = 128
    # --- SSM (mamba) ---
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    # --- xLSTM ---
    xlstm_heads: int = 4
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    max_source_positions: int = 1500
    # --- norms / embeddings ---
    mlp_kind: str = "gated"                # gated (SwiGLU) | plain (GELU)
    norm: str = "rmsnorm"                  # rmsnorm | layernorm | nonparam_ln
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    max_position: int = 1 << 20
    # --- dtypes ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # --- notes for DESIGN.md / dry-run bookkeeping ---
    notes: str = ""

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def num_layers(self) -> int:
        return len(self.prologue) + len(self.pattern) * self.repeats

    @property
    def blocks(self) -> Tuple[BlockSpec, ...]:
        return tuple(self.prologue) + tuple(self.pattern) * self.repeats

    @property
    def uses_attention(self) -> bool:
        return any(b.kind == "attn" for b in self.blocks)

    @property
    def pure_full_attention(self) -> bool:
        """True if every sequence-mixing block is full attention (no window,
        no SSM) — such archs skip the long_500k shape."""
        return all(b.kind == "attn" and b.attn == "full" for b in self.blocks)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, h = self.d_model, self.resolved_head_dim
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for b in self.blocks:
            if b.kind == "attn":
                if self.mla_kv_lora_rank:
                    r_kv, r_q = self.mla_kv_lora_rank, self.mla_q_lora_rank
                    nope, rope, vd = (self.mla_qk_nope_dim, self.mla_qk_rope_dim,
                                      self.mla_v_dim)
                    nh = self.num_heads
                    total += d * (r_q or d)                       # q down
                    total += (r_q or d) * nh * (nope + rope)      # q up
                    total += d * (r_kv + rope)                    # kv down
                    total += r_kv * nh * (nope + vd)              # kv up
                    total += nh * vd * d                          # o
                else:
                    total += d * self.num_heads * h               # q
                    total += 2 * d * self.num_kv_heads * h        # k,v
                    total += self.num_heads * h * d               # o
            elif b.kind == "mamba":
                d_in = self.ssm_expand * d
                total += 2 * d * d_in + d_in * d                  # in/out proj
                total += d_in * (self.ssm_conv_width + 2 * self.ssm_state_dim + 2)
            elif b.kind in ("mlstm", "slstm"):
                d_in = 2 * d
                total += 4 * d * d_in + d_in * d
            # FFN
            ff = self.moe_d_ff or self.d_ff
            mats = 3 if self.mlp_kind == "gated" else 2
            if b.moe:
                total += self.moe_num_experts * mats * d * ff
                total += self.moe_num_shared * mats * d * ff
                total += d * self.moe_num_experts                 # router
            elif self.d_ff > 0:
                total += mats * d * self.d_ff
        if self.encoder_layers:
            # encoder blocks (full attn + dense ffn) + decoder cross-attn
            mats = 3 if self.mlp_kind == "gated" else 2
            enc = self.encoder_layers * (4 * d * d + mats * d * self.d_ff)
            cross = len(self.blocks) * 4 * d * d
            total += enc + cross
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k + shared experts)."""
        if not self.moe_num_experts:
            return self.param_count()
        d = self.d_model
        ff = self.moe_d_ff or self.d_ff
        mats = 3 if self.mlp_kind == "gated" else 2
        inactive_experts = self.moe_num_experts - self.moe_top_k
        per_moe_block = inactive_experts * mats * d * ff
        n_moe = sum(1 for b in self.blocks if b.moe)
        return self.param_count() - n_moe * per_moe_block
