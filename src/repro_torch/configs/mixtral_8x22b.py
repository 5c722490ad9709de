"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768 [arXiv:2401.04088; hf]
"""
from .base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    pattern=(BlockSpec(kind="attn", attn="swa", window=4096, moe=True),),
    repeats=56,
    moe_num_experts=8,
    moe_top_k=2,
    moe_d_ff=16384,
    norm="rmsnorm",
    notes="8 experts top-2 every layer; SWA window 4096.",
)

SMOKE = ModelConfig(
    name="mixtral-smoke",
    family="moe",
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    pattern=(BlockSpec(kind="attn", attn="swa", window=32, moe=True),),
    repeats=4,
    moe_num_experts=4,
    moe_top_k=2,
    moe_capacity_factor=4.0,
    moe_d_ff=128,
    norm="rmsnorm",
)
