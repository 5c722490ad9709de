"""GQA attention over the paged KV pool — counterpart of the paged paths of
``repro.models.attention``.

Prefill of a chunk (``gqa_prefill_paged``) is plain torch, as the reference
is plain jnp there.  Decode (``gqa_decode_paged``) writes the new K/V row
into its page and calls the paged attention kernel
(``repro_torch.kernels.paged_attention``), which launches the hand-written
CUDA kernel on the card and runs its plain version on the CPU.

The page pool tensors are updated in place (the reference returns new
arrays; here the same tensors come back, so callers can keep the
reference's ``k_pages, v_pages = ...`` shape of code).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from ..kernels.paged_attention import paged_attention
from .common import ParamSpec, apply_rope, rope_angles

NEG_INF = -1e30


def attn_spec(cfg) -> Dict[str, ParamSpec]:
    if cfg.mla_kv_lora_rank:
        raise NotImplementedError("MLA attention is not ported yet "
                                  "(ROADMAP queue 1, model breadth)")
    d, h = cfg.d_model, cfg.resolved_head_dim
    return {
        "q": ParamSpec((d, cfg.num_heads, h), ("embed", "heads", "head_dim")),
        "k": ParamSpec((d, cfg.num_kv_heads, h), ("embed", "kv_heads", "head_dim")),
        "v": ParamSpec((d, cfg.num_kv_heads, h), ("embed", "kv_heads", "head_dim")),
        "o": ParamSpec((cfg.num_heads, h, d), ("heads", "head_dim", "embed")),
    }


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
