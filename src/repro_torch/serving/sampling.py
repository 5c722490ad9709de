"""Token sampling: greedy / temperature (numpy-side, per request)."""
from __future__ import annotations

import numpy as np


def sample_token(logits: np.ndarray, temperature: float,
                 rng: np.random.RandomState) -> int:
    logits = np.asarray(logits, np.float64)
    if temperature <= 0.0:
        return int(np.argmax(logits))
    z = logits / max(temperature, 1e-6)
    z -= z.max()
    p = np.exp(z)
    p /= p.sum()
    return int(rng.choice(len(p), p=p))
