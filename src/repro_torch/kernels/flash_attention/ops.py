"""Model-layout wrapper of flash prefill attention — counterpart of
``repro.kernels.flash_attention.ops``."""
from __future__ import annotations

import torch

from .kernel import flash_attention


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0
                         ) -> torch.Tensor:
    """Model layout (B,S,H,D)/(B,S,KH,D) -> (B,S,H,D).  The (B,H,S,D) views
    the kernel takes are strided views of the same memory, and the output
    is written straight into a (B,S,H,D) tensor: no copy either way."""
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=causal, window=window, out=out.transpose(1, 2))
    return out
