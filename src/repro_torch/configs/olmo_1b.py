"""olmo-1b [dense] — non-parametric LayerNorm.

16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304 [arXiv:2402.00838; hf]
"""
from .base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    pattern=(BlockSpec(kind="attn", attn="full"),),
    repeats=16,
    norm="nonparam_ln",
    tie_embeddings=True,
    notes="OLMo: non-parametric LayerNorm (no scale/bias), MHA (kv=16).",
)

SMOKE = ModelConfig(
    name="olmo-smoke",
    family="dense",
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    pattern=(BlockSpec(kind="attn", attn="full"),),
    repeats=4,
    norm="nonparam_ln",
    tie_embeddings=True,
)
