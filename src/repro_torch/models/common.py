"""Shared model utilities: param specs, norms, RoPE, initializers.

Counterpart of ``repro.models.common``.  Params are plain nested dicts of
torch tensors in the JAX package's layout (e.g. attention ``q`` is
``(d, H, D)``), so the parity tests compare like with like.  ``ParamSpec``
is the single source of truth for shapes and init; ``init_params``
materializes a spec tree with an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"            # normal | zeros
    scale: Optional[float] = None   # stddev override for "normal"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  CUDA is the default; asking for it
    on a machine without a card raises instead of falling back to the CPU
    (callers that want the CPU pass ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def init_param(spec: ParamSpec, gen: torch.Generator,
               dtype: torch.dtype) -> torch.Tensor:
    """One leaf, drawn on the generator's device in float32 and cast (the
    reference's rule: std = scale or 1/sqrt(shape[0]))."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=gen.device)
    if spec.init != "normal":
        raise NotImplementedError(f"init {spec.init!r} is not ported")
    fan_in = spec.shape[0] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
    std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * std).to(dtype)


def _leaves(tree, prefix=()):
    """(path, leaf) pairs in sorted-key order — the order ``jax.tree``
    flattens a dict, so leaf i of both packages is the same parameter."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def map_tree(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def init_params(spec_tree, gen: torch.Generator,
                dtype_name: str = "bfloat16"):
    """Materialize a ParamSpec tree, drawing leaves from ``gen`` in sorted
    key order (deterministic for a given generator seed)."""
    dtype = torch_dtype(dtype_name)
    vals = {path: init_param(s, gen, dtype) for path, s in _leaves(spec_tree)}
    return _rebuild(spec_tree, vals)


def _rebuild(tree, vals, prefix=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, vals, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, vals, prefix + (i,))
                          for i, v in enumerate(tree))
    return vals[prefix]


# ---------------------------------------------------------------------------
# Norms (computed in fp32, cast back)
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: Optional[torch.Tensor],
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())
    return y.to(x.dtype)


def norm_spec(cfg) -> Dict[str, ParamSpec]:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"norm {cfg.norm!r} is not ported yet (ROADMAP queue 1, model "
            "breadth)")
    return {"scale": ParamSpec((cfg.d_model,), ("embed",), init="zeros")}


def apply_norm(cfg, params: Dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")
    return rmsnorm(x, params["scale"])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., seq) int -> cos/sin of shape (..., seq, dim//2)."""
    half = dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freq = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., seq, heads, dim); cos/sin: (..., seq, dim//2).  Half-split
    rotation computed in fp32, cast back to x's dtype."""
    half = x.shape[-1] // 2
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s],
                     dim=-1).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)
