"""chameleon-34b [vlm] — early-fusion, VQ image tokens (stub tokenizer).

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 [arXiv:2405.09818;
unverified].  Early fusion means image patches are VQ-quantized into the same
token stream; the VQ tokenizer is a STUB — ``input_specs()`` provides fused
token ids directly.
"""
from .base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    pattern=(BlockSpec(kind="attn", attn="full"),),
    repeats=48,
    norm="rmsnorm",
    notes="Early-fusion VLM backbone == dense LM over fused VQ token stream.",
)

SMOKE = ModelConfig(
    name="chameleon-smoke",
    family="vlm",
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    pattern=(BlockSpec(kind="attn", attn="full"),),
    repeats=4,
    norm="rmsnorm",
)
