"""Synthetic token data pipeline with deterministic, resumable cursors —
counterpart of ``repro.training.data``.

Produces language-modeling batches (tokens, shifted labels) from a seeded
numpy generator, drawn exactly as the reference draws them, so both
packages see the same tokens and labels; the cursor (step index) is part
of the checkpoint so a restart resumes on the exact batch it left off.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from ..models.common import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    batch_size: int
    seq_len: int
    seed: int = 0
    # synthetic structure: mixture of ngram-ish repeats so the loss can fall
    repeat_prob: float = 0.6


def make_batch(cfg: DataConfig, step: int, *,
               device="cuda") -> Dict[str, torch.Tensor]:
    """Deterministic batch for a given step (resume == same stream): int32
    (B,S) ``tokens`` and ``labels`` on ``device``."""
    rng = np.random.RandomState((cfg.seed * 1_000_003 + step) % (2 ** 31))
    B, S = cfg.batch_size, cfg.seq_len
    base = rng.randint(0, cfg.vocab_size, size=(B, S + 1))
    # inject learnable structure: with prob repeat_prob, token t = token t-k
    for k in (2, 3):
        mask = rng.rand(B, S + 1) < (cfg.repeat_prob / 2)
        mask[:, :k] = False
        idx = np.where(mask)
        base[idx[0], idx[1]] = base[idx[0], idx[1] - k]
    dev = resolve_device(device)
    return {"tokens": torch.from_numpy(base[:, :-1].astype(np.int32)).to(dev),
            "labels": torch.from_numpy(base[:, 1:].astype(np.int32)).to(dev)}


def batch_iterator(cfg: DataConfig, start_step: int = 0, *,
                   device="cuda") -> Iterator[Dict]:
    step = start_step
    while True:
        yield make_batch(cfg, step, device=device)
        step += 1
