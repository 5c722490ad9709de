"""Architecture registry of the port: ``get_config(arch_id)`` /
``get_smoke_config``.

A copy of ``repro.configs`` restricted to the architectures the PyTorch port
carries (the dense GQA family).  Each module exports ``CONFIG`` (the full
published config) and ``SMOKE`` (a reduced same-family config for CPU tests).
"""
from __future__ import annotations

import importlib
from typing import Dict

from .base import BlockSpec, ModelConfig

ARCH_IDS = [
    "smollm_360m",
]


# accept dash aliases like "smollm-360m"
def _canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def _module(arch: str):
    name = _canon(arch)
    if name not in ARCH_IDS:
        raise KeyError(f"{arch!r} is not ported to repro_torch yet; "
                       f"ported: {ARCH_IDS}")
    return importlib.import_module(f".{name}", package=__name__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
