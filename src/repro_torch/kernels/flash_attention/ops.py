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
    Outside autograd (``torch.no_grad()``, as the serving engines run, or
    no input that requires grad) nothing is saved for backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
        flash_attention(_heads_major(q), _heads_major(k), _heads_major(v),
                        causal=causal, window=window,
                        out=_heads_major(out))
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        grads = tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                      for t in (q, k, v))
        flash_attention_bwd(*map(_heads_major, (q, k, v, out, dout)),
                            causal=ctx.causal, window=ctx.window,
                            out=tuple(map(_heads_major, grads)))
        return grads + (None, None)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0
                         ) -> torch.Tensor:
    """Model layout (B,S,H,D)/(B,S,KH,D) -> (B,S,H,D).  The (B,H,S,D) views
    the kernel takes are strided views of the same memory, and the output
    is written straight into a (B,S,H,D) tensor: no copy either way.
    Differentiable with respect to q, k and v."""
    return _FlashAttentionBSHD.apply(q, k, v, causal, window)
