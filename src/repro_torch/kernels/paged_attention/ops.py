"""Page-pool utilities for paged attention decode — counterpart of
``repro.kernels.paged_attention.ops`` (the launch itself is
``kernel.paged_attention``)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def streamed_pages_per_step(lengths, page: int) -> int:
    """Pages one decode launch reads: ``sum_b max(ceil(len_b / page), 1)``.

    The Pallas kernel's clamped index map makes its copies follow the live
    context; the CUDA kernel loops over exactly the live pages (and a
    length-0 row reads none, so this count is an upper bound for it)."""
    l = np.asarray(lengths)
    return int(np.maximum(-(-l // page), 1).sum())


def dense_to_pages(k: torch.Tensor, v: torch.Tensor, lengths, page: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack dense (B,S,KH,D) caches into a page pool + block tables
    (testing helper; a server allocates pages on demand)."""
    B, S, KH, D = k.shape
    assert S % page == 0
    npages = S // page
    k_pages = k.reshape(B * npages, page, KH, D)
    v_pages = v.reshape(B * npages, page, KH, D)
    block_tables = torch.arange(B * npages, dtype=torch.int32,
                                device=k.device).reshape(B, npages)
    return k_pages, v_pages, block_tables
