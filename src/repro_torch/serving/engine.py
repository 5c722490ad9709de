"""Per-node serving engine: continuous batching over the whole model —
counterpart of ``repro.serving.engine``.

Two engines share the Request/EngineConfig API:

  * ``Engine`` — dense per-slot caches sized (max_batch, max_len).  Each
    admitted request is prefilled alone (every layer's attention is the
    flash prefill attention kernel) and spliced into its slot; decode runs
    one step for all slots per iteration over the dense caches.  Prompts
    must fit the ``prompt_len`` bucket.  It is the port's single-engine
    oracle: the cluster runtime must reproduce its greedy tokens.
  * ``PagedEngine`` — the full-attention layers' KV lives in a
    ``kv_pool.PagePool`` shared across them.  Prompts of any length are
    accepted: an all-paged stack prefills in ``prompt_len``-sized chunks
    that append pages; a hybrid stack (gemma3: windowed layers beside the
    global ones) prefills single-shot through the dense ``prefill`` and
    scatters its paged layers' K/V into pages (``absorb_dense_prefill``),
    keeping ring caches for the windowed layers.  Decode runs the paged
    attention kernel in the paged layers; admission blocks (and decode
    preempts the newest request, recompute-on-readmit) when the pool is
    exhausted.

Both run on ``device`` (CUDA unless the caller asks for the CPU) and
sample on the host from float32 logits.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models.common import map_tree, resolve_device
from ..models.model import decode_step, init_caches, prefill
from ..models.paged import (absorb_dense_prefill, all_blocks_paged,
                            decode_step_paged, init_caches_paged,
                            paged_layer_counts, prefill_chunk_paged)
from .kv_pool import PagePool, full_rectangle_pages
from .sampling import sample_token


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray                    # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: Optional[str] = None   # "stop" | "length" | "cancelled"
    submitted_s: float = 0.0
    first_token_s: Optional[float] = None
    finished_s: Optional[float] = None
    preemptions: int = 0


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    max_len: int = 512                    # per-request token budget
    prompt_len: int = 128                 # prompt bucket (dense) / chunk (paged)
    eos_token: int = -1                   # -1 = never stop early


class _EngineBase:
    """Shared slot bookkeeping + sampling/termination logic."""

    def __init__(self, cfg: ModelConfig, params, engine_cfg: EngineConfig,
                 rng_seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = map_tree(lambda t: t.to(self.device), params)
        self.ec = engine_cfg
        self.queue: deque = deque()
        self.slots: List[Optional[Request]] = [None] * engine_cfg.max_batch
        self.positions = np.zeros((engine_cfg.max_batch,), np.int64)
        self.tokens = np.zeros((engine_cfg.max_batch,), np.int64)
        self.active = np.zeros((engine_cfg.max_batch,), bool)
        self._rng = np.random.RandomState(rng_seed)
        self.prefills = 0          # request prefills (re-prefills included)
        self.decode_steps = 0      # batched decode steps

    def submit(self, req: Request) -> None:
        if len(req.prompt) == 0:
            raise ValueError("empty prompt")
        self._validate(req)
        req.submitted_s = time.monotonic()
        self.queue.append(req)

    def _validate(self, req: Request) -> None:
        raise NotImplementedError

    def _finish(self, slot: int, req: Request, reason: str) -> None:
        req.done = True
        req.finish_reason = reason
        req.finished_s = time.monotonic()
        self.slots[slot] = None
        self.active[slot] = False

    def _first_token_done(self, req: Request, nxt: int, pos: int
                          ) -> Optional[str]:
        """Done-ness of a request whose only token so far came from prefill
        — checked *before* seating it, so a max_new_tokens=1 request never
        occupies a decode slot or burns a decode step."""
        if int(nxt) == self.ec.eos_token:
            return "stop"
        if req.max_new_tokens <= 1:
            return "length"
        if pos >= self.ec.max_len:
            return "length"          # prompt already filled the budget
        return None

    def _sample_slots(self, logits: np.ndarray) -> int:
        """Sample one token for every seated request, advance positions, and
        retire requests that hit eos / max_new_tokens / the length budget."""
        produced = 0
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            nxt = sample_token(logits[slot], req.temperature, self._rng)
            req.output.append(int(nxt))
            produced += 1
            self.positions[slot] += 1
            reason = None
            if int(nxt) == self.ec.eos_token:
                reason = "stop"
            elif len(req.output) >= req.max_new_tokens:
                reason = "length"
            elif self.positions[slot] >= self.ec.max_len:
                reason = "length"    # cache/pool budget: never write past it
            if reason is not None:
                self._retire(slot, req, reason)
            else:
                self.tokens[slot] = int(nxt)
        return produced

    def _retire(self, slot: int, req: Request, reason: str) -> None:
        self._finish(slot, req, reason)

    def _host(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def step(self) -> int:
        raise NotImplementedError

    def run_until_done(self, max_iters: int = 10000) -> None:
        for _ in range(max_iters):
            if not self.queue and not self.active.any():
                return
            self.step()
        if not self.queue and not self.active.any():
            return                   # finished exactly on the last step
        seated = [r.request_id for r in self.slots if r is not None]
        raise RuntimeError(
            f"not done after {max_iters} iterations; "
            f"queued={len(self.queue)} active={int(self.active.sum())} "
            f"active_requests={seated}")


class Engine(_EngineBase):
    """Continuous-batching engine with fixed dense decode slots.

    Slots hold at most ``max_batch`` concurrent requests; prompts must fit
    the ``prompt_len`` bucket (longer prompts raise — use PagedEngine, which
    chunks); decode runs one step for all slots per iteration and each
    request terminates at the ``max_len`` cache budget.
    """

    def __init__(self, cfg: ModelConfig, params, engine_cfg: EngineConfig,
                 rng_seed: int = 0, device="cuda"):
        super().__init__(cfg, params, engine_cfg, rng_seed, device)
        self.caches = init_caches(cfg, engine_cfg.max_batch,
                                  engine_cfg.max_len, device=self.device)

    def _validate(self, req: Request) -> None:
        if len(req.prompt) > self.ec.prompt_len:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens exceeds the dense "
                f"engine's prompt_len bucket ({self.ec.prompt_len}); "
                "refusing to truncate — use PagedEngine (chunked prefill)")
        if len(req.prompt) > self.ec.max_len:
            raise ValueError(f"prompt of {len(req.prompt)} tokens exceeds "
                             f"max_len {self.ec.max_len}")

    @torch.no_grad()
    def _admit(self) -> None:
        for slot in range(self.ec.max_batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            # prefill this request alone, then splice its caches into the
            # slot
            prompt = np.asarray(req.prompt, np.int64)
            logits, caches1 = prefill(self.cfg, self.params,
                                      self._host(prompt)[None, :],
                                      max_len=self.ec.max_len)
            self.prefills += 1
            nxt = sample_token(logits[0].float().cpu().numpy(),
                               req.temperature, self._rng)
            req.output.append(int(nxt))
            req.first_token_s = time.monotonic()
            reason = self._first_token_done(req, nxt, len(prompt))
            if reason is not None:
                self._finish(slot, req, reason)
                continue
            _map2(lambda full, one: _splice_slot(full, one, slot),
                  self.caches, caches1)
            self.positions[slot] = len(prompt)
            self.tokens[slot] = int(nxt)
            self.active[slot] = True
            self.slots[slot] = req

    @torch.no_grad()
    def step(self) -> int:
        """One engine iteration: admit + one decode step for active slots.
        Returns number of tokens produced."""
        self._admit()
        if not self.active.any():
            return 0
        logits, self.caches = decode_step(self.cfg, self.params,
                                          self._host(self.tokens),
                                          self.caches,
                                          self._host(self.positions))
        self.decode_steps += 1
        return self._sample_slots(logits.float().cpu().numpy())


class PagedEngine(_EngineBase):
    """Continuous-batching engine over a unified KV page pool.

    Differences from the dense ``Engine``:
      * prompts of any length are accepted — all-paged stacks prefill in
        ``prompt_len``-sized chunks that append pages on demand; hybrid
        stacks (windowed blocks) prefill single-shot and scatter their
        full-attention K/V into pages, keeping dense caches only for the
        fallback blocks;
      * decode runs the paged attention kernel over the block tables;
      * capacity is the *pool*, not max_batch x max_len: admission blocks
        while the pool is full, and decode-time growth preempts the newest
        request (recompute-on-readmit) rather than overflowing;
      * a request hard-terminates when it reaches the ``max_len`` budget.
    """

    def __init__(self, cfg: ModelConfig, params, engine_cfg: EngineConfig,
                 *, num_pages: Optional[int] = None, page_size: int = 16,
                 kv_dtype: Optional[str] = None, rng_seed: int = 0,
                 device="cuda"):
        super().__init__(cfg, params, engine_cfg, rng_seed, device)
        ec = engine_cfg
        # the fallback caches first: a stack the port does not carry raises
        # there (check_ported), before the pool finds nothing to page
        self.caches = init_caches_paged(cfg, ec.max_batch, ec.max_len,
                                        device=self.device)
        if num_pages is None:
            # full static allocation (one rectangle); pass a smaller pool to
            # oversubscribe and exercise admission control / preemption
            num_pages = full_rectangle_pages(cfg, max_batch=ec.max_batch,
                                             max_len=ec.max_len,
                                             page_size=page_size)
        self.pool = PagePool(cfg, num_pages=num_pages, page_size=page_size,
                             max_batch=ec.max_batch, max_seq_len=ec.max_len,
                             kv_dtype=kv_dtype, device=self.device)
        self._all_paged = all_blocks_paged(cfg)
        self._n_pro, self._n_pp = paged_layer_counts(cfg)
        self._order = np.full((ec.max_batch,), -1, np.int64)
        self._admit_seq = 0

    def _validate(self, req: Request) -> None:
        if len(req.prompt) > self.ec.max_len:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens exceeds the pool's "
                f"per-request length budget ({self.ec.max_len}); refusing "
                "to truncate")

    # ------------------------------------------------------------------
    def _tables(self, slot: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Block tables as (prologue, super) device tensors; ``slot``
        narrows to a single batch column (per-request prefill)."""
        t = self.pool.table if slot is None \
            else self.pool.table[:, slot:slot + 1]
        B = t.shape[1]
        tp = self._host(np.ascontiguousarray(t[:self._n_pro]))
        ts = self._host(np.ascontiguousarray(t[self._n_pro:].reshape(
            self.cfg.repeats, self._n_pp, B, self.pool.blocks_per_seq)))
        return tp, ts

    def _prefill(self, req: Request, slot: int) -> np.ndarray:
        """Prefill one request into its pages; returns last-token logits.
        A preempted request re-prefills prompt + already-generated tokens
        (recompute) so its output continues where it left off."""
        prompt = np.asarray(req.prompt, np.int64)
        if len(req.output) > 1:
            prompt = np.concatenate(
                [prompt, np.asarray(req.output[:-1], np.int64)])
        pool = self.pool
        self.prefills += 1
        if not self._all_paged:
            # hybrid stack: single-shot dense prefill (right at any prompt
            # length), then the paged layers' K/V moves into pages and the
            # fallback caches are spliced into this slot
            logits, caches1 = prefill(self.cfg, self.params,
                                      self._host(prompt)[None, :],
                                      max_len=self.ec.max_len)
            caches1, pool.k, pool.v = absorb_dense_prefill(
                self.cfg, caches1, pool.k, pool.v, pool.table, slot,
                len(prompt), pool.page)
            _map2(lambda full, one: _splice_slot(full, one, slot),
                  self.caches, caches1)
            return logits[0].float().cpu().numpy()
        # chunked prefill: no truncation at any length, pages appended
        # ahead of admission (ensure() already allocated them)
        chunk = max(1, self.ec.prompt_len)
        tp, ts = self._tables(slot)
        for off in range(0, len(prompt), chunk):
            tok = self._host(prompt[off:off + chunk])[None, :]
            n_act = _active_blocks_bucket(off + tok.shape[1], pool.page,
                                          pool.blocks_per_seq)
            logits, pool.k, pool.v = prefill_chunk_paged(
                self.cfg, self.params, tok,
                torch.tensor([off], device=self.device), pool.k, pool.v,
                tp, ts, active_blocks=n_act)
        return logits[0].float().cpu().numpy()

    @torch.no_grad()
    def _admit(self) -> None:
        for slot in range(self.ec.max_batch):
            if not self.queue:
                return
            if self.slots[slot] is not None:
                continue
            req = self.queue[0]
            resumed = bool(req.output)      # preempted: recompute, not resample
            S = len(req.prompt) + max(0, len(req.output) - 1)
            # admission control: all prompt pages (plus the first decode
            # token's) must be allocatable now, else the request waits
            if not self.pool.ensure(slot, min(S + 1, self.ec.max_len)):
                return
            self.queue.popleft()
            logits = self._prefill(req, slot)
            if resumed:
                nxt = req.output[-1]        # already sampled before eviction
            else:
                nxt = sample_token(logits, req.temperature, self._rng)
                req.output.append(int(nxt))
                req.first_token_s = time.monotonic()
                reason = self._first_token_done(req, nxt, S)
                if reason is not None:
                    self.pool.release(slot)
                    self._finish(slot, req, reason)
                    continue
            self.positions[slot] = S
            self.tokens[slot] = int(nxt)
            self.active[slot] = True
            self.slots[slot] = req
            self._order[slot] = self._admit_seq
            self._admit_seq += 1

    # ------------------------------------------------------------------
    def _preempt(self, slot: int) -> None:
        """Evict a running request: free its pages and requeue it at the
        front.  Generated tokens are kept — readmission re-prefills
        prompt + output (recompute), so the visible output never retracts
        and temperature>0 requests aren't resampled."""
        req = self.slots[slot]
        self.pool.release(slot)
        req.preemptions += 1
        self.queue.appendleft(req)
        self.slots[slot] = None
        self.active[slot] = False
        self.positions[slot] = 0
        self.tokens[slot] = 0
        self._order[slot] = -1

    def _grow_or_preempt(self) -> None:
        """Allocate the pages each active slot needs for this decode step;
        when the pool runs dry, preempt the newest request (least completed
        work) until it fits — including the requester itself if it *is* the
        newest."""
        order = sorted((s for s in range(self.ec.max_batch)
                        if self.active[s]), key=lambda s: self._order[s])
        for slot in order:
            if not self.active[slot]:
                continue          # already preempted this round
            while not self.pool.ensure(slot, int(self.positions[slot]) + 1):
                live = [s for s in range(self.ec.max_batch)
                        if self.active[s]]
                victim = max(live, key=lambda s: self._order[s])
                self._preempt(victim)
                if victim == slot:
                    break

    @torch.no_grad()
    def step(self) -> int:
        """One engine iteration: admit + grow/preempt + one paged decode
        step for active slots.  Returns number of tokens produced."""
        self._admit()
        if not self.active.any():
            return 0
        self._grow_or_preempt()
        if not self.active.any():
            return 0
        tp, ts = self._tables()
        pool = self.pool
        logits, self.caches, pool.k, pool.v = decode_step_paged(
            self.cfg, self.params, self._host(self.tokens), self.caches,
            self._host(self.positions), pool.k, pool.v, tp, ts)
        self.decode_steps += 1
        return self._sample_slots(logits.float().cpu().numpy())

    def _retire(self, slot: int, req: Request, reason: str) -> None:
        self.pool.release(slot)
        self._order[slot] = -1
        self._finish(slot, req, reason)


def _active_blocks_bucket(tokens_through: int, page: int,
                          blocks_per_seq: int) -> int:
    """Gather cap for a prefill chunk ending at ``tokens_through``: the next
    power of two >= ceil(tokens/page), clamped to the per-seq budget."""
    need = -(-tokens_through // page)
    b = 1
    while b < need:
        b <<= 1
    return min(b, blocks_per_seq)


def _map2(fn, full, one):
    """Apply ``fn(full_leaf, one_leaf)`` over two cache trees of one
    structure."""
    if isinstance(full, dict):
        for k in full:
            _map2(fn, full[k], one[k])
    elif isinstance(full, (list, tuple)):
        for f, o in zip(full, one):
            _map2(fn, f, o)
    else:
        fn(full, one)


def _splice_slot(full: torch.Tensor, one: torch.Tensor, slot: int) -> None:
    """Copy a single-request cache leaf (batch=1 on some axis) into ``slot``
    of the engine-wide leaf, in place.  Cache leaves carry batch on axis 0
    (prologue) or axis 1 (stacked super-block caches: (repeats, batch,
    ...))."""
    if full.dim() == one.dim() and one.shape[0] == 1 \
            and full.shape[1:] == one.shape[1:]:
        full[slot] = one[0]
        return
    if full.dim() == one.dim() and one.shape[1] == 1 \
            and full.shape[0] == one.shape[0] \
            and full.shape[2:] == one.shape[2:]:
        full[:, slot] = one[:, 0]
        return
    raise ValueError(f"cannot splice cache leaf {tuple(one.shape)} into "
                     f"{tuple(full.shape)}")
