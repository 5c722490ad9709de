"""starcoder2-7b [dense] — GQA, RoPE.

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152 [arXiv:2402.19173; hf]
"""
from .base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    pattern=(BlockSpec(kind="attn", attn="full"),),
    repeats=32,
    mlp_kind="plain",
    norm="layernorm",
    notes="GQA kv=4, RoPE, LayerNorm (StarCoder2 uses LN).",
)

SMOKE = ModelConfig(
    name="starcoder2-smoke",
    family="dense",
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    pattern=(BlockSpec(kind="attn", attn="full"),),
    repeats=4,
    mlp_kind="plain",
    norm="layernorm",
)
