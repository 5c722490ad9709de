"""Parameter conversion from the JAX reference to the port.

``params_from_jax`` takes the reference's parameter tree with every leaf
already converted to numpy by the caller (``jax.tree.map(np.asarray,
params)``), checks it against the port's ``param_specs`` and returns the
port's tree of torch tensors.  The two packages keep the same layout, so
both compute the same function on the same weights — the parity tests use
this to hold the port against the reference.  ``opt_state_from_jax`` does
the same for the reference's optimizer state, so both packages can train
on from one state.
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


def _tensor_from_numpy(arr, dev) -> torch.Tensor:
    """A numpy array (ml_dtypes bfloat16 included) -> a tensor of its
    dtype on ``dev``; bf16 goes through float32, which is exact."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
        return t.to(device=dev, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(dev)


def opt_state_from_jax(state_of_numpy, device="cuda"):
    """The reference's optimizer state with every leaf converted to numpy
    by the caller -> the port's, on ``device``, in the same dtypes.  AdamW:
    ``{"m": tree, "v": tree, "step"}``; Adafactor: ``{"v": [one dict per
    param leaf, {"vr", "vc"} when factored else {"v"}], "step"}``; both
    packages keep the same layout."""
    dev = resolve_device(device)
    if set(state_of_numpy) not in ({"m", "v", "step"}, {"v", "step"}):
        raise ValueError(f"not an AdamW or Adafactor state: keys "
                         f"{sorted(state_of_numpy)}")

    def convert(tree):
        if isinstance(tree, dict):
            return {k: convert(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [convert(v) for v in tree]
        return _tensor_from_numpy(tree, dev)

    out = convert(state_of_numpy)
    if out["step"].dtype != torch.int32 or out["step"].dim() != 0:
        raise ValueError(f"step must be an int32 scalar, got "
                         f"{out['step'].dtype} {tuple(out['step'].shape)}")
    return out
