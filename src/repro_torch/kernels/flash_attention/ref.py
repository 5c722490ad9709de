"""Plain PyTorch version of flash prefill attention and of its gradient.

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

``attention_lse_ref`` is what the kernels write into the forward's
optional ``lse`` output: each query row's log-sum-exp of its scaled, masked
scores, in the log2 domain (the kernels' exponentials are exp2), and +inf
for a row that sees no key.

``flash_attention_bwd_ref`` is the gradient of that function, written out
in fp32 (it recomputes P from the scores and the log-sum-exp, taking the
forward's when given; it does not call ``torch.autograd``): the reference
differentiates the jnp ``chunked_attention`` with autodiff, and the port's
CUDA backward kernels are held against this.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def _mask(Sq: int, Sk: int, causal: bool, window: int, dev) -> torch.Tensor:
    """(Sq, Sk) bool: key j is visible from query i, aligned top-left."""
    qpos = torch.arange(Sq, device=dev)[:, None]
    kpos = torch.arange(Sk, device=dev)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    return mask


def _scores(qg: torch.Tensor, k: torch.Tensor, mask: torch.Tensor):
    """Scores of the pre-scaled fp32 queries ``qg`` (B,KH,G,Sq,D) against k
    (B,KH,Sk,D): (B,KH,G,Sq,Sk) fp32, NEG_INF where masked."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    return torch.where(mask, s, torch.full((), NEG_INF, device=qg.device))


def _exp_scores(qg: torch.Tensor, k: torch.Tensor, mask: torch.Tensor):
    """``_scores`` exponentiated against their row max: (B,KH,G,Sq,Sk)
    fp32, 0 where masked, and each row's sum clamped at 1e-30 (a row that
    sees no key is all 0)."""
    dev = qg.device
    s = _scores(qg, k, mask)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros((), device=dev))
    return p, p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def _lse2(s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Row log-sum-exp of the scores ``s`` (NEG_INF where masked), in the
    log2 domain: (..., Sq) fp32, +inf for a row that sees no key."""
    seen = mask.any(dim=-1)
    m = s.amax(dim=-1)
    lse = m + torch.log(torch.exp(s - m[..., None]).sum(dim=-1))
    return torch.where(seen, lse * LOG2E,
                       torch.full((), float("inf"), device=s.device))


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,H,Sq,D); k: (B,KH,Sk,D) -> (B,H,Sq) fp32: each query row's
    log2(sum over its visible keys of exp(q.k / sqrt(D))), +inf for a row
    that sees no key (so exp2(s * log2(e) - lse), its P, is 0)."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, KH, H // KH, Sq, D) * (1.0 / math.sqrt(D))
    mask = _mask(Sq, Sk, causal, window, q.device)
    return _lse2(_scores(qg, k, mask), mask).reshape(B, H, Sq)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """q: (B,H,Sq,D); k: (B,KH,Sk,D); v: (B,KH,Sk,DV) with H = KH*G ->
    (B,H,Sq,DV) in q's dtype (DV may differ from D, as in MLA; the scale
    is 1/sqrt(D)).  fp32 scores, softmax and P.V."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.float().reshape(B, KH, G, Sq, D) * (1.0 / math.sqrt(D))
    p, denom = _exp_scores(qg, k, _mask(Sq, Sk, causal, window, q.device))
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()) / denom
    return o.reshape(B, H, Sq, v.shape[3]).to(q.dtype)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, *, causal: bool = True,
                            window: int = 0,
                            lse: Optional[torch.Tensor] = None):
    """Gradient of ``flash_attention_ref`` with respect to q, k and v.

    q: (B,H,Sq,D); k: (B,KH,Sk,D); v: (B,KH,Sk,DV); o, do: (B,H,Sq,DV)
    (DV may differ from D); ``o`` is the forward's output
    and ``do`` the gradient arriving at it; ``lse`` (B,H,Sq), the forward's
    log2-domain log-sum-exp, is recomputed (``attention_lse_ref``) when not
    given.  In fp32: P = exp2(s * log2(e) - lse) over the visible keys of
    the scaled scores s, dV = P^T.dO, dP = dO.V^T, dS = P * (dP - delta)
    with delta = rowsum(dO * o), dQ = dS.K / sqrt(D), dK = dS^T.Q /
    sqrt(D); the G query heads of a kv head sum into its dK and dV.  A
    query row that sees no key gets 0 (its output is defined as 0).
    Returns (dq, dk, dv) in the dtypes of q, k and v."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    DV = v.shape[3]
    qf = q.float().reshape(B, KH, G, Sq, D)
    dof = do.float().reshape(B, KH, G, Sq, DV)
    mask = _mask(Sq, Sk, causal, window, q.device)
    s = _scores(qf * scale, k, mask)
    lse = (_lse2(s, mask) if lse is None
           else lse.float().reshape(B, KH, G, Sq))
    p = torch.where(mask, torch.exp2(s * LOG2E - lse[..., None]),
                    torch.zeros((), device=q.device))
    delta = (dof * o.float().reshape(B, KH, G, Sq, DV)).sum(-1, keepdim=True)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, v.float())
    ds = p * (dp - delta)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * scale
    return (dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
