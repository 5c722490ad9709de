"""Unified paged KV pool for the stage engines (paper §5.1) — counterpart of
``repro.serving.kv_pool``.

One physical pool of ``num_pages`` K and V pages is shared by **all** of a
node's paged attention layers.  A token occupies one row in one page *per
paged layer*, so a logical sequence block costs ``num_paged_layers``
physical pages.  Page 0 is a scratch page: empty block-table entries point
at it, so inactive batch rows write and read it harmlessly.

Pool sizing (``pages_for_vram``): whatever VRAM the node's parameter slice
does not use becomes pages of ``page_bytes`` each (K + V in the param
dtype); token capacity is ``(num_pages - 1) * page / n_paged_layers``.

Allocation is on demand (a block per ``page_size`` tokens, across layers)
and freed on completion or preemption.  The free list is a preallocated
numpy stack: growing a slot by ``n`` blocks is one slice pop covering all
``n * num_layers`` pages, popped in the same order as the reference
(``alloc_ops`` counts these bulk operations, not pages).

Only the param-dtype pool is ported; the int8 pool (``kv_dtype="int8"``)
raises (ROADMAP queue 1: int8 KV serving).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models.common import resolve_device, torch_dtype
from ..models.paged import num_paged_layers


class PoolExhausted(RuntimeError):
    """Raised when a request needs more pages than the pool can ever hold."""


class PagePool:
    """Shared K/V page pool + per-slot block tables and a free list.

    The K/V pages ``k``/``v`` are device tensors of shape (num_pages,
    page_size, kv_heads, head_dim) in the param dtype, updated in place by
    the model steps.  The block table stays a host numpy
    ``(num_paged_layers, max_batch, blocks_per_seq)`` int32 array (the
    engines copy the rows a step needs to the device); row order is
    prologue layers first, then pattern positions repeat-major, matching
    ``models.paged`` layer numbering.
    """

    def __init__(self, cfg: ModelConfig, *, num_pages: int, page_size: int,
                 max_batch: int, max_seq_len: int,
                 paged_layers: Optional[int] = None,
                 kv_dtype: Optional[str] = None, device="cuda"):
        self.cfg = cfg
        self.page = page_size
        # a stage engine's pool covers only the node's layer slice
        self.num_layers = paged_layers if paged_layers is not None \
            else num_paged_layers(cfg)
        if self.num_layers == 0:
            raise ValueError(f"{cfg.name}: no full-attention GQA blocks — "
                             "nothing to page")
        self.blocks_per_seq = -(-max_seq_len // page_size)
        min_pages = 1 + self.blocks_per_seq * self.num_layers
        if num_pages < min_pages:
            raise ValueError(
                f"pool of {num_pages} pages cannot hold one full request: "
                f"need >= {min_pages} (1 scratch + {self.blocks_per_seq} "
                f"blocks x {self.num_layers} layers)")
        if kv_dtype == "int8":
            raise NotImplementedError(
                "int8 KV pages are not ported yet (ROADMAP queue 1: int8 KV "
                "serving — quantized_append and the int8 PagePool)")
        if kv_dtype not in (None, "param"):
            raise ValueError(f"kv_dtype must be 'param' or 'int8', "
                             f"got {kv_dtype!r}")
        self.device = resolve_device(device)
        kh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        self.num_pages = num_pages
        self.k = torch.zeros((num_pages, page_size, kh, hd),
                             dtype=torch_dtype(cfg.param_dtype),
                             device=self.device)
        self.v = torch.zeros_like(self.k)
        # page 0 reserved as scratch; the free list is a preallocated stack
        # whose live region is _free[:_free_top] (top of stack at the end:
        # page 1 first, then 2, ...)
        self._free = np.arange(num_pages - 1, 0, -1, dtype=np.int32)
        self._free_top = num_pages - 1
        self.alloc_ops = 0          # bulk ensure/release ops (not pages)
        self.table = np.zeros((self.num_layers, max_batch,
                               self.blocks_per_seq), np.int32)
        self._nblocks = np.zeros((max_batch,), np.int64)

    # ------------------------------------------------------------------
    @property
    def used(self) -> int:
        """Pages currently allocated (scratch page excluded)."""
        return (self.num_pages - 1) - self._free_top

    @property
    def tokens_used(self) -> int:
        """Token capacity currently allocated (block granularity)."""
        return int(self._nblocks.sum()) * self.page

    @property
    def tokens_capacity(self) -> int:
        """Total token capacity of the pool (block granularity)."""
        return ((self.num_pages - 1) // self.num_layers) * self.page

    def capacity_tokens(self, slot: int) -> int:
        return int(self._nblocks[slot]) * self.page

    def pages_needed(self, slot: int, tokens: int) -> int:
        blocks = -(-tokens // self.page) - int(self._nblocks[slot])
        return max(0, blocks) * self.num_layers

    def can_fit(self, slot: int, tokens: int) -> bool:
        return self.pages_needed(slot, tokens) <= self._free_top

    def ensure(self, slot: int, tokens: int) -> bool:
        """Grow ``slot``'s allocation to hold ``tokens``.  Returns False if
        the pool is currently exhausted (caller blocks or preempts); raises
        PoolExhausted if ``tokens`` exceeds the per-sequence budget.  One
        call is one batched pop from the free-list stack."""
        target = -(-tokens // self.page)
        if target > self.blocks_per_seq:
            raise PoolExhausted(
                f"{tokens} tokens > per-sequence budget "
                f"{self.blocks_per_seq * self.page}")
        if not self.can_fit(slot, tokens):
            return False
        j0 = int(self._nblocks[slot])
        grow = target - j0
        if grow <= 0:
            return True
        n = grow * self.num_layers
        # layer index fastest, block index outer — the reference's order
        popped = self._free[self._free_top - n:self._free_top][::-1]
        self._free_top -= n
        self.table[:, slot, j0:j0 + grow] = \
            popped.reshape(grow, self.num_layers).T
        self._nblocks[slot] = target
        self.alloc_ops += 1
        return True

    def release(self, slot: int) -> None:
        """Return all of ``slot``'s pages to the free list (one batched
        push)."""
        nb = int(self._nblocks[slot])
        if nb:
            n = nb * self.num_layers
            # push order: block outer, layer fastest
            self._free[self._free_top:self._free_top + n] = \
                self.table[:, slot, :nb].T.reshape(-1)
            self._free_top += n
            self.alloc_ops += 1
        self.table[:, slot, :] = 0
        self._nblocks[slot] = 0

    def truncate(self, slot: int, tokens: int) -> None:
        """Shrink ``slot``'s allocation to hold exactly ``tokens`` rows;
        blocks past the new frontier go back to the free list in one
        batched push.  Rows inside the kept frontier block are not zeroed:
        attention masks them by position."""
        target = -(-tokens // self.page)
        nb = int(self._nblocks[slot])
        if target >= nb:
            return
        n = (nb - target) * self.num_layers
        self._free[self._free_top:self._free_top + n] = \
            self.table[:, slot, target:nb].T.reshape(-1)
        self._free_top += n
        self.table[:, slot, target:nb] = 0
        self._nblocks[slot] = target
        self.alloc_ops += 1


def full_rectangle_pages(cfg: ModelConfig, *, max_batch: int, max_len: int,
                         page_size: int,
                         paged_layers: Optional[int] = None) -> int:
    """Pages for a dense-equivalent full allocation — every slot holding its
    whole ``max_len`` budget — plus the scratch page."""
    blocks = -(-max_len // page_size)
    layers = paged_layers if paged_layers is not None \
        else num_paged_layers(cfg)
    return 1 + blocks * layers * max_batch


def page_bytes(cfg: ModelConfig, page_size: int) -> float:
    """Bytes one pool page costs (K + V in the param dtype)."""
    kh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    elt = {"bfloat16": 2, "float32": 4}[cfg.param_dtype]
    return 2 * page_size * kh * hd * elt


def pages_for_vram(cfg: ModelConfig, vram_bytes: float, *, page_size: int,
                   layers_on_node: Optional[int] = None,
                   max_pages: Optional[int] = None) -> int:
    """Size a pool from node VRAM: whatever VRAM the node's parameter slice
    does not use becomes pages.  ``layers_on_node`` is the Helix slice size
    (defaults to the whole model); ``max_pages`` caps the result."""
    elt = {"bfloat16": 2, "float32": 4}[cfg.param_dtype]
    pb = page_bytes(cfg, page_size)
    layers = layers_on_node if layers_on_node is not None else cfg.num_layers
    param_bytes = cfg.param_count() * elt * layers / max(cfg.num_layers, 1)
    free = max(0.0, vram_bytes - param_bytes)
    pages = int(free // pb)
    if max_pages is not None:
        pages = min(pages, max_pages)
    return pages
