"""Per-node stage engines: the execution half of a Helix compute node —
counterpart of ``repro.serving.stage_engine``.

A stage engine holds only the params (``models.stage.stage_params``) and KV
for one node's assigned ``LayerRange`` and exposes the stage-level API the
``ClusterRuntime`` drives:

  prefill_stage(slot, x, entry)    dense: single-shot prompt pass of one
                                   request (``StageEngine``)
  prefill_chunk(slot, x, entry, start)   paged: chunked prefill of one
                                   request (``PagedStageEngine``)
  decode_stage(items)              ONE batched decode step over whatever
                                   stage-work is resident this iteration —
                                   per-node continuous batching; items may
                                   mix requests entering at different layers
  sample(logits, temperature)      final-stage token sampling

Slot mechanics: the dense caches (and the page pool's block table) carry
``max_batch + 1`` rows; the extra row is scratch — decode batches are
padded to a fixed width with scratch rows, whose writes land in the
scratch cache row (or page 0), which nothing ever reads.

Speculative verify passes arrive as multi-token items (``DecodeItem.tokens``,
or ``h`` of shape (n, 1, d) past the entry stage); ``decode_stage`` runs
them as position-ordered sub-batches, so a request's KV write history is
that of ``n`` ordinary decode steps, and ``rollback`` forgets a rejected
draft suffix.

Disaggregated serving hands a prefill node's filled KV to a decode node:
``export_kv(slot, tokens, layers)`` snapshots the slot's KV of the given
global layers as a wire tree ``{layer: {...}}`` of device tensors, and
``import_kv(slot, tokens, payload)`` scatters it into the receiving slot.

Activations between stages stay device tensors; logits leave the device as
float32 numpy rows for sampling.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.placement import LayerRange
from ..models.common import map_tree, resolve_device, torch_dtype
from ..models.paged import all_blocks_paged
from ..models.stage import (stage_blocks, stage_cache_init, stage_decode,
                            stage_decode_paged, stage_num_paged_layers,
                            stage_params, stage_prefill,
                            stage_prefill_chunk_paged)
from .engine import EngineConfig, _active_blocks_bucket
from .kv_pool import PagePool, full_rectangle_pages
from .sampling import sample_token


@dataclasses.dataclass
class DecodeItem:
    """One request's decode-step input resident at a node this iteration.

    A single-token item carries ``token`` (entry 0) or ``h`` of shape
    (1, 1, d).  A speculative verify pass carries ``tokens`` — the last
    confirmed token followed by the draft proposals, consumed at positions
    ``pos .. pos+n-1`` — or, downstream of the entry stage, ``h`` of shape
    (n, 1, d)."""

    slot: int
    pos: int                      # absolute position of the FIRST token
    entry: int                    # request's entry layer at this node
    token: int = 0                # consumed only when entry == 0
    h: Optional[torch.Tensor] = None   # (n, 1, d) incoming activations
    tokens: Optional[Sequence[int]] = None  # verify pass (entry == 0 only)

    @property
    def n(self) -> int:
        """Token count of this item (1 for ordinary decode)."""
        if self.tokens is not None:
            return len(self.tokens)
        if self.h is not None and self.h.ndim == 3:
            return int(self.h.shape[0])
        return 1

    def substep(self, s: int) -> "DecodeItem":
        """The single-token item for sub-step ``s`` (position ``pos + s``)."""
        return DecodeItem(
            slot=self.slot, pos=self.pos + s, entry=self.entry,
            token=int(self.tokens[s]) if self.tokens is not None
            else self.token,
            h=None if self.h is None else self.h[s:s + 1])


@dataclasses.dataclass
class DecodeOut:
    h: Optional[torch.Tensor]     # (n, 1, d) outgoing activations
    logits: Optional[np.ndarray]  # (V,) float32 at the final stage, or
                                  # (n, V) for a verify pass


class _StageEngineBase:
    """Slot bookkeeping, batch assembly and sampling of a stage engine."""

    def __init__(self, cfg: ModelConfig, params, layers: LayerRange,
                 engine_cfg: EngineConfig, rng_seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.layers = layers
        self.ec = engine_cfg
        self.device = resolve_device(device)
        # each node materializes only its share of the stack
        self.sparams = map_tree(lambda t: t.to(self.device),
                                stage_params(cfg, params, layers))
        self.is_first = layers.start == 0
        self.is_last = layers.end == cfg.num_layers
        self.slots: List[Optional[int]] = [None] * engine_cfg.max_batch
        self._scratch = engine_cfg.max_batch   # padding row, never allocated
        self._rng = np.random.RandomState(rng_seed)

    # -- slots ----------------------------------------------------------
    def alloc_slot(self, request_id: int) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is None:
                self.slots[i] = request_id
                return i
        return None

    def free_slot(self, slot: int) -> None:
        self.slots[slot] = None

    @property
    def free_slots(self) -> int:
        return sum(r is None for r in self.slots)

    def pool_used(self) -> Optional[int]:
        """Allocated page count, or None for an engine without a page
        pool."""
        return None

    # -- sampling (final stage) -----------------------------------------
    def sample(self, logits: np.ndarray, temperature: float) -> int:
        return int(sample_token(logits, temperature, self._rng))

    # -- batch assembly ---------------------------------------------------
    def _assemble(self, items: List[DecodeItem]):
        """Pad ``items`` to ``max_batch + 1`` rows.  Returns the host slot
        index array and device tensors (tok, pos, entry, h_in); pad rows
        use the scratch slot, position 0 and an entry past the slice, so
        every block masks them."""
        B = self.ec.max_batch + 1
        if not 0 < len(items) <= self.ec.max_batch:
            raise ValueError(f"{len(items)} decode items for "
                             f"{self.ec.max_batch} slots")
        # one batched step writes each row's KV once, so a batch holding
        # tokens t and t+1 of one request would lose t's write
        slots = [it.slot for it in items]
        if len(set(slots)) != len(slots):
            raise ValueError(
                "duplicate cache slot in one decode batch: in-flight tokens "
                "of a request must decode in separate, position-ordered "
                f"batches (slots={slots})")
        d = self.cfg.d_model
        idx = np.full((B,), self._scratch, np.int64)
        tok = np.zeros((B,), np.int64)
        pos = np.zeros((B,), np.int64)
        entry = np.full((B,), self.layers.end, np.int64)  # pads: all masked
        h_in = torch.zeros((B, 1, d), dtype=torch_dtype(self.cfg.param_dtype),
                           device=self.device)
        for i, it in enumerate(items):
            idx[i] = it.slot
            tok[i] = it.token
            pos[i] = it.pos
            entry[i] = it.entry
            if it.h is not None:
                h_in[i] = it.h.reshape(1, d)
        dev = self.device
        return (idx, torch.from_numpy(tok).to(dev),
                torch.from_numpy(pos).to(dev),
                torch.from_numpy(entry).to(dev), h_in)

    # -- decode orchestration ---------------------------------------------
    def _decode_step(self, items: List[DecodeItem]):
        """One batched decode step.  Returns (h (B,1,d) device tensor,
        logits (B,V) float32 numpy | None) over the padded batch."""
        raise NotImplementedError

    def _spec_begin(self, it: DecodeItem) -> None:
        """Hook before a multi-token item's first sub-step.  A no-op for
        param-dtype pools, whose row-granular writes make truncation exact
        (int8 pools need frontier-page snapshots: ROADMAP queue 1 item 1)."""

    def _snap_substep(self, it: DecodeItem, s: int) -> None:
        """Hook after a multi-token item's sub-step ``s`` wrote its KV; a
        no-op for param-dtype pools (see ``_spec_begin``)."""

    def rollback(self, slot: int, tokens: int) -> None:
        """Forget ``slot``'s rows >= ``tokens`` (rejected draft suffix)."""
        raise NotImplementedError

    def decode_stage(self, items: List[DecodeItem]) -> List[DecodeOut]:
        """ONE batched decode step over the stage-work resident this
        iteration.  Multi-token (speculative verify) items run as
        position-ordered sub-batches: sub-step ``s`` batches the s-th token
        of every item that has one, so a request's token at ``pos+s``
        decodes strictly after its KV write at ``pos+s-1`` — the write
        history of ``n`` ordinary decode steps, which keeps greedy
        speculative output equal to non-speculative output."""
        n = max(it.n for it in items)
        if n == 1:
            # normalize length-1 ``tokens`` items into plain token items
            items = [it if it.tokens is None else it.substep(0)
                     for it in items]
            h, l = self._decode_step(items)
            return [DecodeOut(h=h[i:i + 1],
                              logits=l[i] if l is not None else None)
                    for i in range(len(items))]
        for it in items:
            if it.n > 1:
                self._spec_begin(it)
        hs: List[List[torch.Tensor]] = [[] for _ in items]
        ls: List[List[np.ndarray]] = [[] for _ in items]
        for s in range(n):
            sel = [i for i, it in enumerate(items) if s < it.n]
            h, l = self._decode_step([items[i].substep(s) for i in sel])
            for k, i in enumerate(sel):
                hs[i].append(h[k:k + 1])
                if l is not None:
                    ls[i].append(l[k])
                if items[i].n > 1:
                    self._snap_substep(items[i], s)
        outs = []
        for i, it in enumerate(items):
            if it.n == 1:   # keep single-token output shapes: (1,1,d) / (V,)
                outs.append(DecodeOut(h=hs[i][0],
                                      logits=ls[i][0] if ls[i] else None))
            else:
                outs.append(DecodeOut(
                    h=torch.cat(hs[i], dim=0),
                    logits=np.stack(ls[i], axis=0) if ls[i] else None))
        return outs


def _splice(full: torch.Tensor, one: torch.Tensor, slot: int) -> None:
    """Copy a batch-1 cache leaf into row ``slot`` of the engine leaf (in
    place)."""
    full[slot] = one[0]


class StageEngine(_StageEngineBase):
    """Dense per-slot caches over the node's layer slice: the rectangle
    ``(max_batch + 1) x max_len`` is reserved up front, prefill is
    single-shot through the flash prefill attention kernel, and decode
    attends over the dense caches in plain torch."""

    def __init__(self, cfg: ModelConfig, params, layers: LayerRange,
                 engine_cfg: EngineConfig, rng_seed: int = 0,
                 device="cuda"):
        super().__init__(cfg, params, layers, engine_cfg, rng_seed, device)
        ec = engine_cfg
        self.caches = stage_cache_init(cfg, layers, ec.max_batch + 1,
                                       ec.max_len, device=self.device)
        self._active_tokens = np.zeros((ec.max_batch,), np.int64)
        self.prefills = 0          # prompt passes run on this node
        self.decode_steps = 0      # batched decode passes run on this node

    @torch.no_grad()
    def prefill_stage(self, slot: int, x, entry: int):
        """Prompt pass for one request.  x: (S,) int token ids when
        ``entry == 0`` else (1, S, d) activations.  Returns (1, S, d)
        activations as a device tensor, or (V,) last-token logits as
        float32 numpy at the final stage."""
        if entry == 0:
            xin = torch.as_tensor(np.asarray(x, np.int64),
                                  device=self.device)[None, :]
        else:
            xin = x.to(self.device)
        out, caches1 = stage_prefill(self.cfg, self.sparams, self.layers, xin,
                                     entry, max_len=self.ec.max_len)
        for full, one in zip(self.caches, caches1):
            for key in full:
                _splice(full[key], one[key], slot)
        self._active_tokens[slot] = xin.shape[1]
        self.prefills += 1
        if self.is_last:
            return out[0].float().cpu().numpy()
        return out

    @torch.no_grad()
    def _decode_step(self, items: List[DecodeItem]):
        idx, tok, pos, entry, h_in = self._assemble(items)
        # the step writes each row's new K/V at its cache row in place (pad
        # rows all name the scratch row; whichever write lands there is
        # unread)
        rows = torch.from_numpy(idx).to(self.device)
        h, logits, _ = stage_decode(self.cfg, self.sparams, self.layers,
                                    tok, h_in, entry, self.caches, pos, rows)
        self.decode_steps += 1
        for it in items:
            self._active_tokens[it.slot] = it.pos + 1
        return (h, logits.float().cpu().numpy()
                if logits is not None else None)

    def rollback(self, slot: int, tokens: int) -> None:
        """Dense caches are positional and attention masks rows past the
        position, so forgetting rows >= ``tokens`` is bookkeeping only."""
        self._active_tokens[slot] = tokens

    def release(self, slot: int) -> None:
        self._active_tokens[slot] = 0
        self.free_slot(slot)

    def ensure(self, slot: int, tokens: int) -> bool:
        return tokens <= self.ec.max_len   # rectangle is pre-reserved

    def kv_tokens_used(self) -> int:
        return int(self._active_tokens.sum())

    def kv_tokens_capacity(self) -> int:
        return self.ec.max_batch * self.ec.max_len

    # -- KV handoff (disaggregated prefill -> decode) --------------------
    def export_kv(self, slot: int, tokens: int, layers: List[int]):
        """Snapshot this slot's caches of the given *global* layers as a
        wire tree ``{layer: {key: batchless tensor}}``: clones, so a
        payload in flight survives the slot's release and reuse."""
        want = set(layers)
        return {l: {key: t[slot].clone() for key, t in c.items()}
                for (l, _), c in zip(stage_blocks(self.cfg, self.layers),
                                     self.caches) if l in want}

    def import_kv(self, slot: int, tokens: int, payload) -> None:
        """Splice a shipped snapshot into this slot's caches."""
        for (l, _), c in zip(stage_blocks(self.cfg, self.layers),
                             self.caches):
            for key, a in payload.get(l, {}).items():
                c[key][slot] = a.to(self.device, c[key].dtype)
        self._active_tokens[slot] = tokens


class PagedStageEngine(_StageEngineBase):
    """Paged-KV stage engine: the node's paged blocks share one ``PagePool``
    sized from its VRAM.  Decode runs the paged attention kernel in every
    block; prefill is chunked (all-paged stacks only)."""

    def __init__(self, cfg: ModelConfig, params, layers: LayerRange,
                 engine_cfg: EngineConfig, *, num_pages: Optional[int] = None,
                 page_size: int = 16, rng_seed: int = 0, device="cuda"):
        super().__init__(cfg, params, layers, engine_cfg, rng_seed, device)
        ec = engine_cfg
        self.n_paged = stage_num_paged_layers(cfg, layers)
        if self.n_paged == 0 or not all_blocks_paged(cfg):
            raise NotImplementedError(
                f"{cfg.name}: only all-paged stacks are ported; a paged "
                "stage engine of a hybrid stack is ROADMAP queue 1 item 7 "
                "(c2)")
        if num_pages is None:
            num_pages = full_rectangle_pages(cfg, max_batch=ec.max_batch,
                                             max_len=ec.max_len,
                                             page_size=page_size,
                                             paged_layers=self.n_paged)
        # the scratch slot never allocates, so the pool only needs capacity
        # for the real max_batch; the extra table column stays on page 0
        self.pool = PagePool(cfg, num_pages=num_pages, page_size=page_size,
                             max_batch=ec.max_batch + 1,
                             max_seq_len=ec.max_len,
                             paged_layers=self.n_paged, device=self.device)
        self.decode_steps = 0      # batched decode passes run on this node

    # -- pool ------------------------------------------------------------
    def ensure(self, slot: int, tokens: int) -> bool:
        return self.pool.ensure(slot, tokens)

    def release(self, slot: int) -> None:
        self.pool.release(slot)
        self.free_slot(slot)

    def kv_tokens_used(self) -> int:
        return self.pool.tokens_used

    def kv_tokens_capacity(self) -> int:
        return self.pool.tokens_capacity

    def pool_used(self) -> int:
        """Allocated page count (scratch page excluded)."""
        return self.pool.used

    def _table(self, rows) -> torch.Tensor:
        """Block-table rows for a step, copied host -> device:
        (n_paged, len(rows), NP) int32."""
        return torch.from_numpy(
            np.ascontiguousarray(self.pool.table[:, rows])).to(self.device)

    # -- prefill ---------------------------------------------------------
    @torch.no_grad()
    def prefill_chunk(self, slot: int, x, entry: int, start: int):
        """One prompt chunk through the slice.  x: (C,) tokens or (1, C, d)
        activations.  Returns chunk activations (1, C, d) as a device
        tensor, or last-token logits (V,) float32 numpy at the final
        stage."""
        if entry == 0:
            xin = torch.as_tensor(np.asarray(x, np.int64),
                                  device=self.device)[None, :]
        else:
            xin = x.to(self.device)
        C = xin.shape[1]
        pool = self.pool
        n_act = _active_blocks_bucket(start + C, pool.page,
                                      pool.blocks_per_seq)
        start_t = torch.tensor([start], dtype=torch.int64, device=self.device)
        out, pool.k, pool.v = stage_prefill_chunk_paged(
            self.cfg, self.sparams, self.layers, xin, entry, start_t,
            pool.k, pool.v, self._table(slice(slot, slot + 1)),
            active_blocks=n_act)
        if self.is_last:
            return out[0].float().cpu().numpy()
        return out

    # -- KV handoff (disaggregated prefill -> decode) --------------------
    def _page_ids(self, li: int, slot: int, tokens: int) -> torch.Tensor:
        """Page ids of ``slot``'s first ``tokens`` rows in paged layer
        ``li``, on the pool's device.  Every block of the slice is paged
        (all-paged stacks only), so a block's position in the slice is its
        row of the block table."""
        nb = -(-tokens // self.pool.page)
        return torch.from_numpy(self.pool.table[li, slot, :nb].astype(
            np.int64)).to(self.device)

    def export_kv(self, slot: int, tokens: int, layers: List[int]):
        """Snapshot this slot's live pages of the given *global* layers as
        a wire tree ``{layer: {"k", "v"}}`` of (blocks, page, kv heads,
        head dim) tensors.  Indexing the pool by page id copies, so a
        payload in flight survives the slot's release and the pages'
        reuse."""
        want = set(layers)
        out = {}
        for li, (l, _) in enumerate(stage_blocks(self.cfg, self.layers)):
            if l in want:
                pids = self._page_ids(li, slot, tokens)
                out[l] = {"k": self.pool.k[pids], "v": self.pool.v[pids]}
        return out

    def import_kv(self, slot: int, tokens: int, payload) -> None:
        """Scatter a shipped snapshot into this slot's pages.  The runtime
        reserves the slot's blocks at admission; ``ensure`` here grows
        nothing in the common case."""
        pool = self.pool
        if not pool.ensure(slot, tokens):
            raise RuntimeError(f"import_kv: pool cannot hold {tokens} "
                               f"tokens in slot {slot}")
        for li, (l, _) in enumerate(stage_blocks(self.cfg, self.layers)):
            p = payload.get(l)
            if p is None:
                continue
            pids = self._page_ids(li, slot, tokens)
            pool.k[pids] = p["k"].to(self.device, pool.k.dtype)
            pool.v[pids] = p["v"].to(self.device, pool.v.dtype)

    # -- decode ----------------------------------------------------------
    @torch.no_grad()
    def _decode_step(self, items: List[DecodeItem]):
        idx, tok, pos, entry, h_in = self._assemble(items)
        pool = self.pool
        h, logits, pool.k, pool.v = stage_decode_paged(
            self.cfg, self.sparams, self.layers, tok, h_in, entry, pos,
            pool.k, pool.v, self._table(idx))
        self.decode_steps += 1
        return (h, logits.float().cpu().numpy()
                if logits is not None else None)

    # -- speculative rollback --------------------------------------------
    def rollback(self, slot: int, tokens: int) -> None:
        """Truncate ``slot``'s KV to ``tokens`` rows after a partially
        rejected verify pass: param-dtype writes are row-granular, so the
        kept rows are untouched and the rejected ones are masked by
        position.  (int8 pools would also restore the kept frontier page:
        ROADMAP queue 1 item 1.)"""
        self.pool.truncate(slot, tokens)
