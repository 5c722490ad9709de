"""Paged-KV model paths: prefill/decode over a unified page pool —
counterpart of ``repro.models.paged``.

One physical K and V pool is shared by all of a node's paged attention
layers (the paper's §5.1 "pool of pages unified for all local layers").
Full-attention GQA blocks are paged: they read and write the pool through
their block tables, and decode goes through the paged attention kernel.
Every other block (the windowed layers of a hybrid stack such as gemma3)
keeps its dense fallback cache, a ring of ``window`` slots, as on the dense
path.  All-paged stacks prefill in chunks (``prefill_chunk_paged``);
hybrid ones prefill single-shot with the dense ``prefill`` and move the
paged layers' K/V into the pool (``absorb_dense_prefill``).

Paged layers are numbered prologue-first, then pattern positions in
repeat-major order; block tables follow the same layout:
``tables_pro`` is (n_paged_prologue, B, NP) and ``tables_super`` is
(repeats, paged_per_pattern, B, NP).  A block's table row counts paged
blocks only, never its position in the pattern.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..configs.base import BlockSpec, ModelConfig
from .attention import gqa_decode_paged, gqa_prefill_paged
from .common import apply_norm, map_tree, resolve_device, torch_dtype
from .model import (_apply_block_decode, _cache_init_for_block, _embed,
                    _logits, _mlp, check_ported, stacked_caches,
                    super_layers)


# ---------------------------------------------------------------------------
# Layout helpers
# ---------------------------------------------------------------------------

def is_paged_block(cfg: ModelConfig, b: BlockSpec) -> bool:
    """True if this block's KV lives in the page pool (full-attention GQA);
    windowed blocks keep their dense fallback caches."""
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
    """True if the whole stack is paged — enables chunked prefill (no dense
    caches at all); hybrid stacks prefill single-shot instead."""
    return all(is_paged_block(cfg, b) for b in cfg.blocks)


def init_caches_paged(cfg: ModelConfig, batch: int, max_len: int, *,
                      device="cuda"):
    """Dense fallback caches: the tree of ``init_caches``, with ``{}`` for
    every paged block — its KV lives in the pool."""
    check_ported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    return stacked_caches(cfg, lambda b: {} if is_paged_block(cfg, b) else
                          _cache_init_for_block(cfg, b, batch, max_len,
                                                dtype, device=dev))


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

def _block_decode_paged(cfg, p, h, kp, vp, table, cache_pos):
    hn = apply_norm(cfg, p["norm1"], h)
    out, kp, vp = gqa_decode_paged(cfg, p["mix"], hn, kp, vp, table,
                                   cache_pos)
    return _mlp(cfg, p, h + out)[0], kp, vp


def _block_prefill_paged(cfg, p, h, kp, vp, table, positions,
                         active_blocks=None):
    hn = apply_norm(cfg, p["norm1"], h)
    out, kp, vp = gqa_prefill_paged(cfg, p["mix"], hn, kp, vp, table,
                                    positions, active_blocks=active_blocks)
    return _mlp(cfg, p, h + out)[0], kp, vp


def _layers(cfg, params, caches, tables_pro, tables_super):
    """(BlockSpec, block params, dense cache, block table) of every layer,
    in stack order.  A paged block gets its table row, counted over paged
    blocks only, and ``{}`` as its cache; any other block gets its dense
    cache (views into the stacked ``super`` leaves, so in-place writes land
    in ``caches``; ``{}`` when ``caches`` is None) and None as its table."""
    li = 0
    for i, b in enumerate(cfg.prologue):
        paged = is_paged_block(cfg, b)
        yield (b, params["prologue"][i],
               caches["prologue"][i] if caches is not None else {},
               tables_pro[li] if paged else None)
        li += paged
    n = len(cfg.pattern)
    for j, p in enumerate(super_layers(cfg, params)):
        r, i = divmod(j, n)
        b = cfg.pattern[i]
        if is_paged_block(cfg, b):
            ti = sum(is_paged_block(cfg, x) for x in cfg.pattern[:i])
            yield b, p, {}, tables_super[r, ti]
        else:
            yield (b, p, {} if caches is None else
                   map_tree(lambda x: x[r], caches["super"][f"pos{i}"]),
                   None)


# ---------------------------------------------------------------------------
# Model-level paged decode / chunked prefill
# ---------------------------------------------------------------------------

def decode_step_paged(cfg: ModelConfig, params, tokens, caches, cache_pos,
                      k_pages, v_pages, tables_pro, tables_super):
    """One autoregressive step over the paged pool.

    tokens/cache_pos: (B,); caches: the dense fallback caches of
    ``init_caches_paged``, updated in place; k/v_pages: (P,page,KH,D);
    tables as in the module docstring (int32).  Paged blocks run the paged
    attention kernel over their table row, the others decode over their
    dense caches.  Returns (logits (B,V), caches, k_pages, v_pages).
    """
    check_ported(cfg)
    positions = cache_pos[:, None]
    h = _embed(cfg, params, tokens[:, None], positions)
    for b, p, c, table in _layers(cfg, params, caches, tables_pro,
                                  tables_super):
        if table is not None:
            h, k_pages, v_pages = _block_decode_paged(
                cfg, p, h, k_pages, v_pages, table, cache_pos)
        else:
            h, _ = _apply_block_decode(cfg, b, p, h, c, cache_pos)
    h = apply_norm(cfg, params["final_norm"], h)
    return _logits(cfg, params, h)[:, 0], caches, k_pages, v_pages


def prefill_chunk_paged(cfg: ModelConfig, params, tokens, start_pos,
                        k_pages, v_pages, tables_pro, tables_super, *,
                        active_blocks=None):
    """Prefill one prompt chunk, appending its K/V to the pool.

    Only valid when ``all_blocks_paged(cfg)``: chunk N attends over chunks
    0..N through the block tables, and no dense caches exist.  tokens:
    (B,C); start_pos: (B,) absolute position of tokens[:, 0].
    ``active_blocks``: per-layer gather cap (>= ceil((start+C)/page));
    None gathers the whole NP budget.  Returns (last-token logits,
    k_pages, v_pages).
    """
    check_ported(cfg)
    B, C = tokens.shape
    positions = start_pos[:, None] + torch.arange(C, device=tokens.device)
    h = _embed(cfg, params, tokens, positions)
    for b, p, _, table in _layers(cfg, params, None, tables_pro,
                                  tables_super):
        if table is None:
            raise ValueError(f"{cfg.name} holds blocks that are not paged; "
                             "chunked prefill requires an all-paged stack")
        h, k_pages, v_pages = _block_prefill_paged(
            cfg, p, h, k_pages, v_pages, table, positions, active_blocks)
    h = apply_norm(cfg, params["final_norm"], h)
    return _logits(cfg, params, h[:, -1:])[:, 0], k_pages, v_pages


# ---------------------------------------------------------------------------
# Dense-prefill absorption (hybrid stacks)
# ---------------------------------------------------------------------------

def scatter_prefill_kv(k_pages, v_pages, page_ids, k, v, page: int) -> None:
    """Write one layer's prefill K/V (S, KH, D) into its pages in place:
    the token at position s goes to row s % page of page ``page_ids[s //
    page]``.  ``page_ids``: host int array of the layer's table row."""
    S = k.shape[0]
    pos = np.arange(S)
    pids = torch.from_numpy(np.asarray(page_ids)[pos // page].astype(
        np.int64)).to(k_pages.device)
    off = torch.from_numpy(pos % page).to(k_pages.device)
    k_pages[pids, off] = k.to(k_pages.dtype)
    v_pages[pids, off] = v.to(v_pages.dtype)


def absorb_dense_prefill(cfg: ModelConfig, caches, k_pages, v_pages,
                         table, slot: int, seq_len: int, page: int):
    """Move a single-request dense prefill's paged-layer K/V into the pool.

    Hybrid stacks prefill single-shot with the dense ``prefill`` — right at
    any prompt length — then scatter the full-attention layers' K/V into
    this slot's pages (in place) and drop those leaves (replaced by
    ``{}``), keeping only the fallback caches dense.  caches: ``prefill``'s
    output at batch 1; table: the pool's host (L, max_batch, NP) int32
    table.  Param-dtype pools only (int8 pools are ROADMAP queue 1 item
    1).  Returns (caches', k_pages, v_pages).
    """
    n_pro, n_pp = paged_layer_counts(cfg)

    def scatter(li, k, v):
        scatter_prefill_kv(k_pages, v_pages, table[li, slot], k[:seq_len],
                           v[:seq_len], page)

    out: Dict[str, Any] = {}
    if cfg.prologue:
        out["prologue"] = []
        li = 0
        for i, b in enumerate(cfg.prologue):
            c = caches["prologue"][i]
            if is_paged_block(cfg, b):
                scatter(li, c["k"][0], c["v"][0])
                out["prologue"].append({})
                li += 1
            else:
                out["prologue"].append(c)
    out["super"] = {}
    ti = 0
    for i, b in enumerate(cfg.pattern):
        c = caches["super"][f"pos{i}"]
        if is_paged_block(cfg, b):
            for r in range(cfg.repeats):
                scatter(n_pro + r * n_pp + ti, c["k"][r, 0], c["v"][r, 0])
            out["super"][f"pos{i}"] = {}
            ti += 1
        else:
            out["super"][f"pos{i}"] = c
    return out, k_pages, v_pages
