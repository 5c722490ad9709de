"""Step builders — counterpart of ``repro.launch.steps``, with
``optimizer_for`` only.  The cells, sharding rules and abstract shapes of
the reference's module belong to the distribution layer (ROADMAP queue 1
item 8: dist)."""
from __future__ import annotations

from ..configs.base import ModelConfig
from ..training.optimizer import OptimizerConfig


def optimizer_for(cfg: ModelConfig) -> OptimizerConfig:
    """Adafactor >=30B (Adam state would not fit 16GB/chip), AdamW below."""
    if cfg.param_count() >= 30e9:
        return OptimizerConfig(name="adafactor", lr=1e-4)
    return OptimizerConfig(name="adamw", lr=3e-4)
