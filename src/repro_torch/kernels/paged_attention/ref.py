"""Plain PyTorch version of paged decode attention.

It follows the numerics of the Pallas kernel
(``repro/kernels/paged_attention/kernel.py::_kernel``), not of the jnp
oracle beside it: q is scaled by 1/sqrt(D) in fp32, K/V are read in fp32
(int8 pages multiplied by their (page, kv head) scale in fp32), the page
index is clamped at each sequence's last live page, and a sequence of
length 0 yields 0.  The CUDA wrapper runs this on CPU tensors, and
``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        lengths: torch.Tensor,
                        k_scales: Optional[torch.Tensor] = None,
                        v_scales: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Decode attention over a paged KV pool.

    q:            (B, H, D)        one query token per sequence
    k/v_pages:    (P, page, KH, D) global page pool (int8 with scales)
    block_tables: (B, NP) int32    page ids per sequence (sequential fill)
    lengths:      (B,) int32       tokens in each sequence's KV
    k/v_scales:   (P, KH) f32      optional int8 per-page per-head scales
    returns:      (B, H, D) in q's dtype
    """
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    B, H, D = q.shape
    P, page, KH, _ = k_pages.shape
    NP = block_tables.shape[1]
    G = H // KH
    dev = q.device
    lengths = lengths.long().clamp(0, NP * page)
    last = ((lengths + page - 1) // page - 1).clamp(min=0)
    ip = torch.minimum(torch.arange(NP, device=dev)[None, :], last[:, None])
    bt = block_tables.long().gather(1, ip)           # clamp: live pages only
    bt = torch.where(lengths[:, None] > 0, bt, 0)    # length 0: no page read
    k = k_pages[bt].float()                          # (B, NP, page, KH, D)
    v = v_pages[bt].float()
    if k_scales is not None:
        k = k * k_scales[bt].float()[:, :, None, :, None]
        v = v * v_scales[bt].float()[:, :, None, :, None]
    k = k.reshape(B, NP * page, KH, D)
    v = v.reshape(B, NP * page, KH, D)
    qg = q.float().reshape(B, KH, G, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bhgd,bshd->bhgs", qg, k)
    mask = (torch.arange(NP * page, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros((), device=dev))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgs,bshd->bhgd", p, v) / denom
    return o.reshape(B, H, D).to(q.dtype)
