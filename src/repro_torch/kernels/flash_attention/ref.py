"""Plain PyTorch version of flash prefill attention.

It follows the numerics of the Pallas kernel
(``repro/kernels/flash_attention/kernel.py::_kernel``), not of the jnp
oracle beside it: q is cast to fp32 before it is scaled by 1/sqrt(D), the
probabilities stay fp32 for the P.V product, and the denominator is clamped
at 1e-30.  Masks are aligned top-left (query i and key j both count from
0, also when Sq != Sk).  A query row that sees no key at all — possible
only with a window and Sq > Sk + window - 1 — yields 0 (the Pallas
kernel's value there depends on its tile size).  The CUDA wrapper runs
this on CPU tensors, and ``chip_smoke.py`` holds the kernel against it on
the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """q: (B,H,Sq,D); k/v: (B,KH,Sk,D) with H = KH*G -> (B,H,Sq,D) in q's
    dtype.  fp32 scores, softmax and P.V."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    G = H // KH
    dev = q.device
    qg = q.float().reshape(B, KH, G, Sq, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    qpos = torch.arange(Sq, device=dev)[:, None]
    kpos = torch.arange(Sk, device=dev)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros((), device=dev))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()) / denom
    return o.reshape(B, H, Sq, D).to(q.dtype)
