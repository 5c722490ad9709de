"""Model-layout wrapper of flash prefill attention — counterpart of
``repro.kernels.flash_attention.ops``, differentiable."""
from __future__ import annotations

import torch

from .kernel import flash_attention, flash_attention_bwd


def _heads_major(t: torch.Tensor) -> torch.Tensor:
    """(B,S,H,D) -> the (B,H,S,D) view the kernels take."""
    return t.transpose(1, 2)


class _FlashAttentionBSHD(torch.autograd.Function):
    """K2 forward, and its gradient through ``flash_attention_bwd`` (the
    backward kernels on CUDA tensors, their plain version on CPU ones).
    With ``train`` the forward also writes each row's log-sum-exp and
    saves it beside q, k, v and the output; without (``torch.no_grad()``,
    as the serving engines run, or no input that requires grad) it asks
    for none and saves nothing for backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, train):
        out = q.new_empty(q.shape[:3] + v.shape[3:])
        B, S, H, _ = q.shape
        lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
               if train else None)
        flash_attention(_heads_major(q), _heads_major(k), _heads_major(v),
                        causal=causal, window=window,
                        out=_heads_major(out), lse=lse)
        if train:
            ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if not dout.is_contiguous():   # the kernels read dO by TMA
            dout = dout.contiguous()
        grads = tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                      for t in (q, k, v))
        flash_attention_bwd(*map(_heads_major, (q, k, v, out, dout)),
                            causal=ctx.causal, window=ctx.window,
                            out=tuple(map(_heads_major, grads)), lse=lse)
        return grads + (None, None, None)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0
                         ) -> torch.Tensor:
    """Model layout q (B,S,H,D), k (B,S,KH,D), v (B,S,KH,DV) -> (B,S,H,DV).
    The (B,H,S,D) views the kernel takes are strided views of the same
    memory, and the output is written straight into a (B,S,H,DV) tensor:
    no copy either way.  Differentiable with respect to q, k and v."""
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return _FlashAttentionBSHD.apply(q, k, v, causal, window, train)
