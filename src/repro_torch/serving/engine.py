"""Request / engine configuration shared by the stage engines — counterpart
of ``repro.serving.engine`` (``Request``, ``EngineConfig`` and
``_active_blocks_bucket``; the single-node ``Engine`` and ``PagedEngine``
are not ported yet)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray                    # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: Optional[str] = None   # "stop" | "length" when done
    submitted_s: float = 0.0
    first_token_s: Optional[float] = None
    finished_s: Optional[float] = None
    preemptions: int = 0


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    max_len: int = 512                    # per-request token budget
    prompt_len: int = 128                 # prefill chunk
    eos_token: int = -1                   # -1 = never stop early


def _active_blocks_bucket(tokens_through: int, page: int,
                          blocks_per_seq: int) -> int:
    """Gather cap for a prefill chunk ending at ``tokens_through``: the next
    power of two >= ceil(tokens/page), clamped to the per-seq budget."""
    need = -(-tokens_through // page)
    b = 1
    while b < need:
        b <<= 1
    return min(b, blocks_per_seq)
