"""Model assembly for the dense GQA family — counterpart of
``repro.models.model`` (``param_specs`` / ``init``, ``_embed``, ``_logits``,
``forward``).

The layer stack is ``prologue + pattern * repeats``; the repeated part keeps
the reference's layout, params stacked on a leading "layers" axis under
``params["super"]``, and the reference's ``lax.scan`` over it becomes a
Python loop over that axis.  Families other than full-attention GQA with a
SwiGLU FFN (MoE, MLA, SSM, windowed attention, encoder-decoder) are not
ported yet and raise.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Union

import torch

from ..configs.base import BlockSpec, ModelConfig
from .attention import NEG_INF, _gqa_qkv_rope, attn_spec
from .common import (ParamSpec, apply_norm, init_params, map_tree,
                     norm_spec, resolve_device)
from .moe import ffn_apply, ffn_spec


def check_ported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is in the family the port carries: every block
    full-attention GQA with a dense FFN, decoder-only."""
    bad = [b for b in cfg.blocks
           if b.kind != "attn" or b.attn != "full" or b.moe]
    if (bad or cfg.mla_kv_lora_rank or cfg.is_encoder_decoder
            or cfg.d_ff <= 0):
        raise NotImplementedError(
            f"{cfg.name}: only all-full-attention GQA stacks with a dense "
            "FFN are ported (ROADMAP queue 1, model breadth)")


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

def _block_spec(cfg: ModelConfig, b: BlockSpec) -> Dict:
    return {"norm1": norm_spec(cfg), "mix": attn_spec(cfg),
            "norm2": norm_spec(cfg), "ffn": ffn_spec(cfg)}


def _stack_specs(tree, n: int):
    return map_tree(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                        init=s.init, scale=s.scale), tree)


def param_specs(cfg: ModelConfig) -> Dict:
    check_ported(cfg)
    d = cfg.d_model
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "embed"), scale=0.02),
        "final_norm": norm_spec(cfg),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, cfg.vocab_size), ("embed", "vocab"),
                                     scale=0.02)
    if cfg.prologue:
        specs["prologue"] = [_block_spec(cfg, b) for b in cfg.prologue]
    specs["super"] = _stack_specs(
        {f"pos{i}": _block_spec(cfg, b) for i, b in enumerate(cfg.pattern)},
        cfg.repeats)
    return specs


def init(cfg: ModelConfig, generator: Union[torch.Generator, int] = 0, *,
         device="cuda"):
    """Random params in ``cfg.param_dtype``.  Leaves are drawn on the CPU
    from ``generator`` (or a CPU generator seeded with the int) and then
    moved to ``device``, so one seed gives the same weights on every
    device."""
    dev = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device="cpu").manual_seed(int(generator))
    params = init_params(param_specs(cfg), generator, cfg.param_dtype)
    return map_tree(lambda t: t.to(dev), params)


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def _embed(cfg, params, tokens, positions):
    return params["embed"][tokens.long()]


def _logits(cfg, params, h):
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", h, params["embed"])
    return torch.einsum("bsd,dv->bsv", h, params["lm_head"])


def layer_params(params, r: int, i: int):
    """Block params of pattern position ``i`` in repeat ``r`` (a view into
    the stacked ``super`` tree)."""
    return map_tree(lambda x: x[r], params["super"][f"pos{i}"])


# ---------------------------------------------------------------------------
# Train / scoring forward
# ---------------------------------------------------------------------------

def _causal_gqa(cfg, params, x, positions):
    """Full causal GQA self-attention of a whole sequence: one chunk of the
    reference's ``chunked_attention`` (fp32 scores, unnormalized
    probabilities cast to V's dtype, fp32 accumulate, divide by the
    denominator)."""
    B, S, _ = x.shape
    q, k, v = _gqa_qkv_rope(cfg, params, x, positions)
    KH, D = k.shape[2], k.shape[3]
    G = cfg.num_heads // KH
    qg = q.reshape(B, S, KH, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                     k.float()) / math.sqrt(D)
    mask = positions[:, :, None] >= positions[:, None, :]       # (B,Sq,Sk)
    s = torch.where(mask[:, None, None], s,
                    torch.full((), NEG_INF, device=x.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)                                           # (B,KH,G,Sq)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    ctx = (acc / l.clamp_min(1e-30)[..., None]).permute(0, 3, 1, 2, 4)
    ctx = ctx.to(x.dtype)
    ctx = ctx.reshape(B, S, cfg.num_heads, D)
    return torch.einsum("bshk,hkd->bsd", ctx, params["o"])


def _apply_block(cfg, p, h, positions):
    hn = apply_norm(cfg, p["norm1"], h)
    h = h + _causal_gqa(cfg, p["mix"], hn, positions)
    hn = apply_norm(cfg, p["norm2"], h)
    return h + ffn_apply(p["ffn"], hn)


def forward(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B,S) int -> logits (B,S,V).  (The reference also returns a
    MoE aux loss, which is 0 for this family.)"""
    check_ported(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    h = _embed(cfg, params, tokens, positions)
    for i in range(len(cfg.prologue)):
        h = _apply_block(cfg, params["prologue"][i], h, positions)
    for r in range(cfg.repeats):
        for i in range(len(cfg.pattern)):
            h = _apply_block(cfg, layer_params(params, r, i), h, positions)
    h = apply_norm(cfg, params["final_norm"], h)
    return _logits(cfg, params, h)
