"""GQA attention — counterpart of the dense and paged GQA paths of
``repro.models.attention``.

Dense prefill (``gqa_prefill``) goes through ``chunked_attention``, which is
the flash prefill attention kernel (``repro_torch.kernels.flash_attention``):
the hand-written CUDA kernel on the card, its plain version on the CPU.
Dense decode (``gqa_decode``) is plain torch over the dense cache, as the
reference is plain jnp there.  Prefill of a paged chunk
(``gqa_prefill_paged``) is plain torch too; paged decode
(``gqa_decode_paged``) writes the new K/V row into its page and calls the
paged attention kernel (``repro_torch.kernels.paged_attention``).

Caches and page pools are updated in place (the reference returns new
arrays; here the same tensors come back, so callers keep the reference's
``cache = ...`` shape of code and no step copies a whole cache).  A dense
decode over some rows of a larger cache (a stage engine's batch) names
them with ``rows``: the new K/V lands at those rows in place, and only
they are read for the attention.
MLA and cross-attention are not ported (ROADMAP queue 1 item 7).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from ..kernels.flash_attention import flash_attention_bshd
from ..kernels.paged_attention import paged_attention
from .common import ParamSpec, apply_rope, rope_angles

NEG_INF = -1e30
_INT32_MAX = 2 ** 31 - 1


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1 "
                               "item 7: the remaining model families)")


def attn_spec(cfg) -> Dict[str, ParamSpec]:
    if cfg.mla_kv_lora_rank:
        raise _not_ported("MLA attention")
    d, h = cfg.d_model, cfg.resolved_head_dim
    return {
        "q": ParamSpec((d, cfg.num_heads, h), ("embed", "heads", "head_dim")),
        "k": ParamSpec((d, cfg.num_kv_heads, h), ("embed", "kv_heads", "head_dim")),
        "v": ParamSpec((d, cfg.num_kv_heads, h), ("embed", "kv_heads", "head_dim")),
        "o": ParamSpec((cfg.num_heads, h, d), ("heads", "head_dim", "embed")),
    }


# ---------------------------------------------------------------------------
# Flash-style attention (the flash prefill attention kernel)
# ---------------------------------------------------------------------------

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool = True, window: int = 0,
                      q_chunk: int = 512, kv_chunk: int = 1024,
                      skip_masked_chunks: bool = False) -> torch.Tensor:
    """q: (B,S,H,D), k/v: (B,S_kv,KH,D) -> (B,S,H,D) in q's dtype.

    The reference's online softmax over kv chunks; here the flash prefill
    attention kernel (plain version for CPU tensors), with the Pallas
    kernel's numerics: q cast to fp32 before the scale, probabilities kept
    in fp32 for P.V (the reference's jnp path scales q in its own dtype and
    casts the probabilities to V's dtype; in f32 the two agree).  Masks are
    aligned top-left, also when S_kv != S.  ``q_chunk``, ``kv_chunk`` and
    ``skip_masked_chunks`` choose a tiling that leaves the result
    unchanged; the kernel tiles by itself (and always skips tiles no query
    of a tile can see), so they are accepted and not used.
    """
    if v.shape[-1] != q.shape[-1]:
        raise _not_ported(f"attention with value dim {v.shape[-1]} != "
                          f"query dim {q.shape[-1]} (MLA)")
    return flash_attention_bshd(q, k, v, causal=causal, window=window)


def _gqa_decode_scores(q, k_cache):
    """q: (B,1,H,D); k_cache: (B,S,KH,D) -> (B,KH,G,S) fp32 scores (bf16
    products are exact in fp32: the reference's
    preferred_element_type=float32)."""
    B, _, H, D = q.shape
    KH = k_cache.shape[2]
    G = H // KH
    qg = q.reshape(B, KH, G, D)
    return torch.einsum("bhgd,bshd->bhgs", qg.float(),
                        k_cache.float()) / math.sqrt(D)


# ---------------------------------------------------------------------------
# Standard GQA attention block (dense caches)
# ---------------------------------------------------------------------------

def gqa_prefill(cfg, params, x, positions, *, window=0, cross_kv=None):
    """Causal self-attention of a whole sequence.  x: (B,S,d); positions:
    (B,S) for rope.  Returns (out, (k, v)) with rope applied to k."""
    if cross_kv is not None:
        raise _not_ported("cross-attention (whisper)")
    q, k, v = _gqa_qkv_rope(cfg, params, x, positions)
    out = chunked_attention(q, k, v, causal=True, window=window)
    out = torch.einsum("bshk,hkd->bsd", out, params["o"])
    return out, (k, v)


def gqa_decode(cfg, params, x, cache, cache_pos, *, window=0, cross_kv=None,
               rows=None):
    """Single-token decode.  x: (B,1,d); cache: dict(k, v, pos) ring buffers
    of length W (windowed) or max_len; cache_pos: (B,) absolute position of
    the token being generated.  The new K/V and its position are written in
    place at slot ``cache_pos % W`` (windowed) or ``min(cache_pos, W-1)``
    (so past the budget the last slot is overwritten, as in the
    reference).  ``rows``: (B,) cache row of each batch row, when the cache
    holds more rows than the batch (default: row i is batch row i).
    Returns (out, cache)."""
    if cross_kv is not None:
        raise _not_ported("cross-attention (whisper)")
    B = x.shape[0]
    q, k_new, v_new = _gqa_qkv_rope(cfg, params, x, cache_pos[:, None])
    W = cache["k"].shape[1]
    pos = cache_pos.long()
    slot = pos % W if window else pos.clamp(max=W - 1)
    bidx = torch.arange(B, device=x.device) if rows is None else rows
    cache["k"][bidx, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][bidx, slot] = cache_pos.to(cache["pos"].dtype)
    k_c, v_c, pos_c = ((cache["k"], cache["v"], cache["pos"]) if rows is None
                       else (cache["k"][rows], cache["v"][rows],
                             cache["pos"][rows]))
    scores = _gqa_decode_scores(q, k_c)
    slot_pos = pos_c.long()
    valid = slot_pos <= pos[:, None]
    if window:
        valid &= pos[:, None] - slot_pos < window
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full((), NEG_INF, device=x.device))
    attn = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhgs,bshd->bhgd", attn.to(x.dtype), v_c)
    ctx = ctx.reshape(B, 1, cfg.num_heads, cfg.resolved_head_dim)
    out = torch.einsum("bshk,hkd->bsd", ctx, params["o"])
    return out, cache


def gqa_cache_init(cfg, batch: int, max_len: int, window: int, dtype, *,
                   device="cuda"):
    """Zeroed dense K/V ring buffers of length ``min(window, max_len)``
    (windowed) or ``max_len``; empty slots hold position int32 max."""
    W = min(window, max_len) if window else max_len
    kh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, W, kh, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, W, kh, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, W), _INT32_MAX, dtype=torch.int32,
                          device=device),
    }


# ---------------------------------------------------------------------------
# Paged GQA paths
# ---------------------------------------------------------------------------

def _gqa_qkv_rope(cfg, params, x, positions):
    """Project q/k/v for a chunk and apply rope at absolute ``positions``.
    x: (B,C,d); positions: (B,C) -> q (B,C,H,D), k/v (B,C,KH,D)."""
    q = torch.einsum("bsd,dhk->bshk", x, params["q"])
    k = torch.einsum("bsd,dhk->bshk", x, params["k"])
    v = torch.einsum("bsd,dhk->bshk", x, params["v"])
    if cfg.rope_theta > 0:
        cos, sin = rope_angles(positions, cfg.resolved_head_dim,
                               cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def gqa_decode_paged(cfg, params, x, k_pages, v_pages, block_table,
                     cache_pos):
    """Single-token decode against a shared page pool.

    x: (B,1,d); k/v_pages: (P,page,KH,D) pool shared across layers;
    block_table: (B,NP) int32 page ids for this layer; cache_pos: (B,)
    absolute position of the token being generated.  Writes the new K/V
    into the page holding ``cache_pos`` (in place) and runs the paged
    attention kernel over the sequence's pages.  Returns
    (out (B,1,d), k_pages, v_pages).
    """
    page = k_pages.shape[1]
    q, k_new, v_new = _gqa_qkv_rope(cfg, params, x, cache_pos[:, None])
    pid = block_table.gather(1, (cache_pos // page)[:, None].long())[:, 0]
    off = cache_pos % page
    k_pages[pid.long(), off.long()] = k_new[:, 0].to(k_pages.dtype)
    v_pages[pid.long(), off.long()] = v_new[:, 0].to(v_pages.dtype)
    ctx = paged_attention(q[:, 0], k_pages, v_pages, block_table,
                          (cache_pos + 1).to(torch.int32))
    out = torch.einsum("bshk,hkd->bsd", ctx[:, None].to(x.dtype),
                       params["o"])
    return out, k_pages, v_pages


def gqa_prefill_paged(cfg, params, x, k_pages, v_pages, block_table,
                      positions, *, active_blocks=None):
    """Chunked paged prefill: write this chunk's K/V into the pool (in
    place) and attend the chunk's queries causally over everything the
    sequence has written so far, earlier chunks included (a plain gather
    over the block table).

    x: (B,C,d); positions: (B,C) absolute positions of the chunk tokens.
    ``active_blocks``: cap on the gather — only the first ``active_blocks``
    table entries (>= ceil((pos+C)/page)) are materialized; masked entries
    contribute exactly 0 to the softmax, so capping is numerically
    identical.  Scores and softmax are fp32; the probabilities are cast to
    x's dtype before the V product, as in the reference.  Returns
    (out (B,C,d), k_pages, v_pages).
    """
    B, C, d = x.shape
    P, page, KH, D = k_pages.shape
    NP = block_table.shape[1]
    H = cfg.num_heads
    G = H // KH
    nact = NP if active_blocks is None else max(1, min(active_blocks, NP))
    q, k_new, v_new = _gqa_qkv_rope(cfg, params, x, positions)
    pid = block_table.gather(1, (positions // page).long()).long()
    off = (positions % page).long()
    k_pages[pid, off] = k_new.to(k_pages.dtype)
    v_pages[pid, off] = v_new.to(v_pages.dtype)
    bt = block_table[:, :nact].long()
    k_all = k_pages[bt].reshape(B, nact * page, KH, D)
    v_all = v_pages[bt].reshape(B, nact * page, KH, D)
    qg = q.reshape(B, C, KH, G, D)
    # bf16 x bf16 products are exact in fp32: casting first is the
    # reference's preferred_element_type=float32
    s = torch.einsum("bchgd,bshd->bhgcs", qg.float(),
                     k_all.float()) / math.sqrt(D)
    kpos = torch.arange(nact * page, device=x.device)
    mask = kpos[None, None, :] <= positions[:, :, None]          # (B,C,S)
    s = torch.where(mask[:, None, None], s,
                    torch.full((), NEG_INF, device=x.device))
    attn = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhgcs,bshd->bchgd", attn.to(x.dtype), v_all)
    ctx = ctx.reshape(B, C, H, D)
    out = torch.einsum("bshk,hkd->bsd", ctx, params["o"])
    return out, k_pages, v_pages
