"""gemma3-12b [dense] — 5:1 local:global attention, 128k context.

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144
[hf:google/gemma-3-1b-pt; unverified]
Super-block: 5 local (sliding window 1024) + 1 global.
"""
from .base import BlockSpec, ModelConfig

_PATTERN = tuple([BlockSpec(kind="attn", attn="local", window=1024)] * 5
                 + [BlockSpec(kind="attn", attn="full")])

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    pattern=_PATTERN,
    repeats=8,                       # 8 x 6 = 48 layers
    norm="rmsnorm",
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    notes="5:1 local:global; local window 1024; 128k-context target.",
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    family="dense",
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    pattern=tuple([BlockSpec(kind="attn", attn="local", window=16)] * 2
                  + [BlockSpec(kind="attn", attn="full")]),
    repeats=2,
    norm="rmsnorm",
    tie_embeddings=True,
)
