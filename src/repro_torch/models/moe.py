"""Dense SwiGLU FFN — counterpart of ``repro.models.moe`` (``ffn_spec`` and
``ffn_apply`` only; the routed MoE is not ported yet)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .common import ParamSpec, silu


def ffn_spec(cfg, d_ff: Optional[int] = None) -> Dict[str, ParamSpec]:
    if getattr(cfg, "mlp_kind", "gated") != "gated":
        raise NotImplementedError(
            f"mlp_kind {cfg.mlp_kind!r} is not ported yet (ROADMAP queue 1, "
            "model breadth)")
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    return {
        "w_up": ParamSpec((d, ff), ("embed", "ff")),
        "w_down": ParamSpec((ff, d), ("ff", "embed")),
        "w_gate": ParamSpec((d, ff), ("embed", "ff")),
    }


def ffn_apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x @ w_gate) * (x @ w_up)) @ w_down, in x's dtype."""
    u = torch.einsum("...d,df->...f", x, params["w_up"])
    g = torch.einsum("...d,df->...f", x, params["w_gate"])
    return torch.einsum("...f,fd->...d", silu(g) * u, params["w_down"])
