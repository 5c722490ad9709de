"""Paged-KV model paths: prefill/decode over a unified page pool —
counterpart of ``repro.models.paged``.

One physical K and V pool is shared by all of a node's paged attention
layers (the paper's §5.1 "pool of pages unified for all local layers").
Every block of the ported family is paged, so there are no dense fallback
caches here (the reference keeps them for MLA/SSM/windowed blocks).

Paged layers are numbered prologue-first, then pattern positions in
repeat-major order; block tables follow the same layout:
``tables_pro`` is (n_paged_prologue, B, NP) and ``tables_super`` is
(repeats, paged_per_pattern, B, NP).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..configs.base import BlockSpec, ModelConfig
from .attention import gqa_decode_paged, gqa_prefill_paged
from .common import apply_norm
from .model import _embed, _logits, check_ported, super_layers
from .moe import ffn_apply


# ---------------------------------------------------------------------------
# Layout helpers
# ---------------------------------------------------------------------------

def is_paged_block(cfg: ModelConfig, b: BlockSpec) -> bool:
    """True if this block's KV lives in the page pool (full-attention GQA)."""
    return (b.kind == "attn" and b.attn == "full"
            and not cfg.mla_kv_lora_rank and not cfg.is_encoder_decoder)


def paged_layer_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(paged prologue blocks, paged blocks per pattern repeat)."""
    n_pro = sum(is_paged_block(cfg, b) for b in cfg.prologue)
    n_pp = sum(is_paged_block(cfg, b) for b in cfg.pattern)
    return n_pro, n_pp


def num_paged_layers(cfg: ModelConfig) -> int:
    n_pro, n_pp = paged_layer_counts(cfg)
    return n_pro + n_pp * cfg.repeats


def all_blocks_paged(cfg: ModelConfig) -> bool:
    """True if the whole stack is paged — enables chunked prefill."""
    return all(is_paged_block(cfg, b) for b in cfg.blocks)


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

def _mlp(cfg, p, h):
    hn = apply_norm(cfg, p["norm2"], h)
    return h + ffn_apply(p["ffn"], hn)


def _block_decode_paged(cfg, p, h, kp, vp, table, cache_pos):
    hn = apply_norm(cfg, p["norm1"], h)
    out, kp, vp = gqa_decode_paged(cfg, p["mix"], hn, kp, vp, table,
                                   cache_pos)
    return _mlp(cfg, p, h + out), kp, vp


def _block_prefill_paged(cfg, p, h, kp, vp, table, positions,
                         active_blocks=None):
    hn = apply_norm(cfg, p["norm1"], h)
    out, kp, vp = gqa_prefill_paged(cfg, p["mix"], hn, kp, vp, table,
                                    positions, active_blocks=active_blocks)
    return _mlp(cfg, p, h + out), kp, vp


def _paged_layers(cfg, params, tables_pro, tables_super):
    """(block params, block table) for every layer, in stack order."""
    for i in range(len(cfg.prologue)):
        yield params["prologue"][i], tables_pro[i]
    n = len(cfg.pattern)
    for j, p in enumerate(super_layers(cfg, params)):
        yield p, tables_super[j // n, j % n]


# ---------------------------------------------------------------------------
# Model-level paged decode / chunked prefill
# ---------------------------------------------------------------------------

def decode_step_paged(cfg: ModelConfig, params, tokens, cache_pos,
                      k_pages, v_pages, tables_pro, tables_super):
    """One autoregressive step over the paged pool.

    tokens/cache_pos: (B,); k/v_pages: (P,page,KH,D); tables as in the
    module docstring (int32).  Returns (logits (B,V), k_pages, v_pages).
    """
    check_ported(cfg)
    positions = cache_pos[:, None]
    h = _embed(cfg, params, tokens[:, None], positions)
    for p, table in _paged_layers(cfg, params, tables_pro, tables_super):
        h, k_pages, v_pages = _block_decode_paged(cfg, p, h, k_pages,
                                                  v_pages, table, cache_pos)
    h = apply_norm(cfg, params["final_norm"], h)
    return _logits(cfg, params, h)[:, 0], k_pages, v_pages


def prefill_chunk_paged(cfg: ModelConfig, params, tokens, start_pos,
                        k_pages, v_pages, tables_pro, tables_super, *,
                        active_blocks=None):
    """Prefill one prompt chunk, appending its K/V to the pool.

    tokens: (B,C); start_pos: (B,) absolute position of tokens[:, 0].
    ``active_blocks``: per-layer gather cap (>= ceil((start+C)/page)); None
    gathers the whole NP budget.  Returns (last-token logits, k_pages,
    v_pages).
    """
    check_ported(cfg)
    B, C = tokens.shape
    positions = start_pos[:, None] + torch.arange(C, device=tokens.device)
    h = _embed(cfg, params, tokens, positions)
    for p, table in _paged_layers(cfg, params, tables_pro, tables_super):
        h, k_pages, v_pages = _block_prefill_paged(
            cfg, p, h, k_pages, v_pages, table, positions, active_blocks)
    h = apply_norm(cfg, params["final_norm"], h)
    return _logits(cfg, params, h[:, -1:])[:, 0], k_pages, v_pages
