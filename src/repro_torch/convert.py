"""Parameter conversion from the JAX reference to the port.

``params_from_jax`` takes the reference's parameter tree with every leaf
already converted to numpy by the caller (``jax.tree.map(np.asarray,
params)``), checks it against the port's ``param_specs`` and returns the
port's tree of torch tensors.  The two packages keep the same layout, so
both compute the same function on the same weights — the parity tests use
this to hold the port against the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from .configs.base import ModelConfig
from .models.common import ParamSpec, resolve_device, torch_dtype
from .models.model import param_specs


def params_from_jax(tree_of_numpy, cfg: ModelConfig, device="cuda"):
    """numpy tree in the reference layout -> torch tree on ``device`` in
    ``cfg.param_dtype`` (bf16 leaves go through float32, which is exact)."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)

    def convert(spec, leaf, path):
        if isinstance(spec, ParamSpec):
            arr = np.asarray(leaf)
            if tuple(arr.shape) != tuple(spec.shape):
                raise ValueError(f"{'/'.join(map(str, path))}: shape "
                                 f"{arr.shape} != spec {spec.shape}")
            t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
            return t.to(device=dev, dtype=dtype)
        if isinstance(spec, dict):
            if set(spec) != set(leaf):
                raise ValueError(f"{'/'.join(map(str, path)) or 'root'}: keys "
                                 f"{sorted(leaf)} != spec {sorted(spec)}")
            return {k: convert(spec[k], leaf[k], path + (k,)) for k in spec}
        if len(spec) != len(leaf):
            raise ValueError(f"{'/'.join(map(str, path))}: {len(leaf)} "
                             f"entries != spec {len(spec)}")
        return [convert(s, l, path + (i,))
                for i, (s, l) in enumerate(zip(spec, leaf))]

    return convert(param_specs(cfg), tree_of_numpy, ())
