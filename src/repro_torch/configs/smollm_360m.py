"""smollm-360m [dense] — llama-arch small.

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
[hf:HuggingFaceTB/SmolLM-135M; hf]
"""
from .base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    pattern=(BlockSpec(kind="attn", attn="full"),),
    repeats=32,
    norm="rmsnorm",
    tie_embeddings=True,
    notes="llama-family small model; used for the end-to-end training example.",
)

SMOKE = ModelConfig(
    name="smollm-smoke",
    family="dense",
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=192,
    vocab_size=512,
    pattern=(BlockSpec(kind="attn", attn="full"),),
    repeats=4,
    norm="rmsnorm",
    tie_embeddings=True,
)
