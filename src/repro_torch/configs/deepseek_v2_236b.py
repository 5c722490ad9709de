"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6.

60L d_model=5120 128H (GQA kv=128) d_ff=1536 vocab=102400
[arXiv:2405.04434; hf].  First layer uses a dense FFN (DeepSeek convention);
remaining 59 are MoE.  d_ff=1536 is the routed-expert hidden dim; the dense
first-layer FFN uses the standard 12288 intermediate size.
"""
from .base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=12288,                      # dense (first-layer) FFN hidden
    vocab_size=102400,
    prologue=(BlockSpec(kind="attn", attn="full", moe=False),),
    pattern=(BlockSpec(kind="attn", attn="full", moe=True),),
    repeats=59,                      # 1 dense + 59 MoE = 60 layers
    moe_num_experts=160,
    moe_top_k=6,
    moe_num_shared=2,
    moe_d_ff=1536,
    mla_kv_lora_rank=512,
    mla_q_lora_rank=1536,
    mla_qk_nope_dim=128,
    mla_qk_rope_dim=64,
    mla_v_dim=128,
    norm="rmsnorm",
    notes="MLA attention (kv_lora 512 + rope 64); 2 shared + 160 routed top-6.",
)

SMOKE = ModelConfig(
    name="deepseek-smoke",
    family="moe",
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    prologue=(BlockSpec(kind="attn", attn="full", moe=False),),
    pattern=(BlockSpec(kind="attn", attn="full", moe=True),),
    repeats=3,
    moe_num_experts=8,
    moe_top_k=2,
    moe_capacity_factor=4.0,
    moe_num_shared=1,
    moe_d_ff=64,
    mla_kv_lora_rank=32,
    mla_q_lora_rank=48,
    mla_qk_nope_dim=16,
    mla_qk_rope_dim=8,
    mla_v_dim=16,
    norm="rmsnorm",
)
