"""Stage-level model execution: run a contiguous layer slice of the stack —
counterpart of the dense and paged paths of ``repro.models.stage``.

Helix's MILP assigns each node a contiguous ``LayerRange``; a stage engine
executes only those blocks, receiving token ids (first stage) or incoming
activations and emitting activations (or sampling-ready logits at the final
stage).

Paged slices hold full-attention GQA blocks in the node's page pool and
every other block (a hybrid stack's windowed layers) in a dense fallback
cache; a slice's block-table row ``li`` counts its paged blocks only.
All-paged slices prefill in chunks (``stage_prefill_chunk_paged``); hybrid
ones single-shot (``stage_prefill``), then ``stage_absorb_dense_prefill``
moves the paged blocks' K/V into the pool.

Per-row entry masking: §3.3 *partial inference* means a request may enter a
node mid-range, and per-node continuous batching mixes requests with
different entry layers in one decode step.  Each block therefore applies
only to rows with ``row_start <= layer``; masked rows pass their hidden state
through unchanged.  Masked rows still run the block and write their
(meaningless) K/V into their own cache rows or pages — those entries are
never read, because a request's entry layer is fixed for its lifetime at a
node — and the pad rows of a fixed-size batch write into a scratch cache
row or scratch page 0.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..configs.base import BlockSpec, ModelConfig
from ..core.placement import LayerRange
from .common import apply_norm, map_tree, torch_dtype
from .model import (_apply_block, _apply_block_decode, _cache_init_for_block,
                    _embed, _logits, check_ported, fill_prefill_cache)
from .paged import (_block_decode_paged, _block_prefill_paged,
                    is_paged_block, scatter_prefill_kv)


# ---------------------------------------------------------------------------
# Slice layout
# ---------------------------------------------------------------------------

def stage_blocks(cfg: ModelConfig, layers: LayerRange
                 ) -> List[Tuple[int, BlockSpec]]:
    """(global layer index, BlockSpec) for every block in the slice."""
    blocks = cfg.blocks
    if not (0 <= layers.start < layers.end <= cfg.num_layers):
        raise ValueError(f"layer range {layers} outside [0, {cfg.num_layers})")
    return [(l, blocks[l]) for l in range(layers.start, layers.end)]


def stage_num_paged_layers(cfg: ModelConfig, layers: LayerRange) -> int:
    return sum(is_paged_block(cfg, b) for _, b in stage_blocks(cfg, layers))


def stage_params(cfg: ModelConfig, params, layers: LayerRange) -> Dict:
    """The param subtree one stage needs: per-block params for
    [start, end) plus the embedding table (first stage, and the last stage
    when embeddings are tied), final norm + LM head (last stage).  Block
    params are views into the stacked ``super`` tree."""
    check_ported(cfg)
    P = len(cfg.prologue)
    pat = max(1, len(cfg.pattern))
    first = layers.start == 0
    last = layers.end == cfg.num_layers
    out: Dict[str, Any] = {"blocks": []}
    for l, _ in stage_blocks(cfg, layers):
        if l < P:
            out["blocks"].append(params["prologue"][l])
        else:
            r, i = divmod(l - P, pat)
            out["blocks"].append(map_tree(lambda x, r=r: x[r],
                                          params["super"][f"pos{i}"]))
    if first or (last and cfg.tie_embeddings):
        out["embed"] = params["embed"]
    if last:
        out["final_norm"] = params["final_norm"]
        if not cfg.tie_embeddings:
            out["lm_head"] = params["lm_head"]
    return out


def stage_cache_init(cfg: ModelConfig, layers: LayerRange, batch: int,
                     max_len: int, *, device="cuda") -> List:
    """Dense per-block decode caches for the slice (batch-major leaves)."""
    dt = torch_dtype(cfg.param_dtype)
    return [_cache_init_for_block(cfg, b, batch, max_len, dt, device=device)
            for _, b in stage_blocks(cfg, layers)]


def stage_cache_init_paged(cfg: ModelConfig, layers: LayerRange, batch: int,
                           max_len: int, *, device="cuda") -> List:
    """Like ``stage_cache_init`` but paged blocks hold ``{}`` — their KV
    lives in the node's page pool."""
    dt = torch_dtype(cfg.param_dtype)
    return [{} if is_paged_block(cfg, b)
            else _cache_init_for_block(cfg, b, batch, max_len, dt,
                                       device=device)
            for _, b in stage_blocks(cfg, layers)]


# ---------------------------------------------------------------------------
# Dense prefill / decode over the slice
# ---------------------------------------------------------------------------

def stage_prefill(cfg: ModelConfig, sparams, layers: LayerRange, x,
                  entry: int, *, max_len: int):
    """Prompt pass over blocks [entry, layers.end).

    ``x`` is token ids (B,S) when ``entry == 0`` else incoming activations
    (B,S,d).  Every block's attention is the flash prefill attention
    kernel.  Returns ``(out, caches)``: last-token logits (B,V) when the
    slice ends the model, else outgoing activations (B,S,d); ``caches``
    covers all local blocks (skipped prefix blocks get fresh inits, so the
    list matches the engine's slot layout).
    """
    B, S = x.shape[:2]
    dev = x.device
    positions = torch.arange(S, device=dev).expand(B, S)
    h = _embed(cfg, sparams, x, positions) if entry == 0 else x
    dt = torch_dtype(cfg.param_dtype)
    caches: List = []
    for (l, b), p in zip(stage_blocks(cfg, layers), sparams["blocks"]):
        if l < entry:
            caches.append(_cache_init_for_block(cfg, b, B, max_len, dt,
                                                device=dev))
            continue
        h, raw = _apply_block(cfg, b, p, h, positions, collect_cache=True)
        caches.append(fill_prefill_cache(cfg, b, raw, B, S, max_len, dt))
    if layers.end == cfg.num_layers:
        h = apply_norm(cfg, sparams["final_norm"], h)
        return _logits(cfg, sparams, h[:, -1:])[:, 0], caches
    return h, caches


def stage_decode(cfg: ModelConfig, sparams, layers: LayerRange, tok, h_in,
                 row_start, caches, cache_pos, rows=None):
    """One batched decode step over the slice with per-row entry masking.

    tok: (B,) token ids (consumed only by rows entering at layer 0 —
    possible only when ``layers.start == 0``); h_in: (B,1,d) incoming
    activations; row_start: (B,) entry layer per row; caches: one dense
    cache per local block, updated in place; cache_pos: (B,); rows: (B,)
    cache row of each batch row (default: row i).  Returns
    ``(h_out (B,1,d), logits (B,V) | None, caches)`` — logits iff the
    slice ends the model.
    """
    h = _stage_input(cfg, sparams, layers, tok, h_in, row_start, cache_pos)
    for (l, b), p, c in zip(stage_blocks(cfg, layers), sparams["blocks"],
                            caches):
        h_new, _ = _apply_block_decode(cfg, b, p, h, c, cache_pos, rows)
        h = torch.where((row_start <= l)[:, None, None], h_new, h)
    return h, _stage_logits(cfg, sparams, layers, h), caches


def _stage_input(cfg, sparams, layers, tok, h_in, row_start, cache_pos):
    """A decode step's hidden state entering the slice: the token's
    embedding for rows entering at layer 0, else the incoming
    activations."""
    if layers.start == 0:
        emb = _embed(cfg, sparams, tok[:, None], cache_pos[:, None])
        return torch.where((row_start == 0)[:, None, None], emb,
                           h_in.to(emb.dtype))
    return h_in.to(torch_dtype(cfg.param_dtype))


def _stage_logits(cfg, sparams, layers, h):
    """Last-position logits (B,V) when the slice ends the model, else
    None."""
    if layers.end != cfg.num_layers:
        return None
    hn = apply_norm(cfg, sparams["final_norm"], h)
    return _logits(cfg, sparams, hn)[:, 0]


# ---------------------------------------------------------------------------
# Paged prefill / decode over the slice
# ---------------------------------------------------------------------------

def stage_prefill_chunk_paged(cfg: ModelConfig, sparams, layers: LayerRange,
                              x, entry: int, start_pos, k_pages, v_pages,
                              tables, *, active_blocks=None):
    """Prefill one prompt chunk through blocks [entry, layers.end),
    appending K/V to the node's pool.

    x: (B,C) tokens when ``entry == 0`` else (B,C,d); start_pos: (B,)
    absolute position of x[:, 0]; tables: (n_local_paged, B, NP) int32 in
    local paged-layer order.  Returns ``(out, k_pages, v_pages)`` with
    ``out`` = last-token logits (B,V) when the slice ends the model, else
    the chunk's outgoing activations (B,C,d).
    """
    C = x.shape[1]
    positions = start_pos[:, None] + torch.arange(C, device=start_pos.device)
    h = _embed(cfg, sparams, x, positions) if entry == 0 else x
    li = sum(is_paged_block(cfg, b) for l, b in stage_blocks(cfg, layers)
             if l < entry)
    for (l, b), p in zip(stage_blocks(cfg, layers), sparams["blocks"]):
        if l < entry:
            continue
        if not is_paged_block(cfg, b):
            raise ValueError(f"layer {l} of {cfg.name} is not paged; chunked "
                             "stage prefill requires an all-paged slice")
        h, k_pages, v_pages = _block_prefill_paged(
            cfg, p, h, k_pages, v_pages, tables[li], positions,
            active_blocks)
        li += 1
    if layers.end == cfg.num_layers:
        h = apply_norm(cfg, sparams["final_norm"], h)
        return _logits(cfg, sparams, h[:, -1:])[:, 0], k_pages, v_pages
    return h, k_pages, v_pages


def stage_decode_paged(cfg: ModelConfig, sparams, layers: LayerRange, tok,
                       h_in, row_start, caches, cache_pos, k_pages, v_pages,
                       tables, rows=None):
    """One batched decode step over the slice with per-row entry masking.

    tok: (B,) token ids (consumed only by rows entering at layer 0 —
    possible only when ``layers.start == 0``); h_in: (B,1,d) incoming
    activations; row_start: (B,) entry layer per row; caches: one entry
    per local block, ``{}`` for a paged block and the dense fallback cache
    of any other, updated in place at ``rows`` (the cache row of each batch
    row; default row i); cache_pos: (B,); tables: (n_local_paged, B, NP)
    int32, row ``li`` counting the slice's paged blocks only.  Paged blocks
    run the paged attention kernel over their table row.  Returns
    ``(h_out (B,1,d), logits (B,V) | None, caches, k_pages, v_pages)`` —
    logits iff the slice ends the model.
    """
    h = _stage_input(cfg, sparams, layers, tok, h_in, row_start, cache_pos)
    li = 0
    for (l, b), p, c in zip(stage_blocks(cfg, layers), sparams["blocks"],
                            caches):
        if is_paged_block(cfg, b):
            h_new, k_pages, v_pages = _block_decode_paged(
                cfg, p, h, k_pages, v_pages, tables[li], cache_pos)
            li += 1
        else:
            h_new, _ = _apply_block_decode(cfg, b, p, h, c, cache_pos, rows)
        h = torch.where((row_start <= l)[:, None, None], h_new, h)
    return (h, _stage_logits(cfg, sparams, layers, h), caches, k_pages,
            v_pages)


def stage_absorb_dense_prefill(cfg: ModelConfig, layers: LayerRange, caches,
                               k_pages, v_pages, table, slot: int,
                               seq_len: int, page: int):
    """Move a single-request dense stage prefill's paged-block K/V into the
    pool.

    Hybrid slices prefill single-shot with ``stage_prefill`` (right at any
    prompt length), then scatter each paged block's K/V into this slot's
    pages (in place) and drop those leaves (replaced by ``{}``).  table:
    the pool's host (n_local_paged, max_batch, NP) int32 table.
    Param-dtype pools only (int8 pools are ROADMAP queue 1 item 1).
    Returns (caches', k_pages, v_pages)."""
    out: List = []
    li = 0
    for (l, b), c in zip(stage_blocks(cfg, layers), caches):
        if not is_paged_block(cfg, b):
            out.append(c)
            continue
        scatter_prefill_kv(k_pages, v_pages, table[li, slot],
                           c["k"][0, :seq_len], c["v"][0, :seq_len], page)
        out.append({})
        li += 1
    return out, k_pages, v_pages
