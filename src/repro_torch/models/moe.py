"""Dense FFNs — counterpart of ``repro.models.moe`` (``ffn_spec`` and
``ffn_apply``: SwiGLU, or the plain GELU FFN for ``mlp_kind="plain"``).
The routed MoE (``moe_spec`` / ``moe_apply``) is not ported yet; a config
with MoE blocks raises in ``models.model.check_ported``."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .common import ParamSpec, silu


def ffn_spec(cfg, d_ff: Optional[int] = None) -> Dict[str, ParamSpec]:
    kind = getattr(cfg, "mlp_kind", "gated")
    if kind not in ("gated", "plain"):
        raise ValueError(
            f"mlp_kind {kind!r}: the dense FFN is 'gated' (SwiGLU) or "
            "'plain' (GELU); MoE, MLA, windowed or SSM blocks and "
            "encoder-decoders are not ported yet (ROADMAP queue 1 item 7)")
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    spec = {
        "w_up": ParamSpec((d, ff), ("embed", "ff")),
        "w_down": ParamSpec((ff, d), ("ff", "embed")),
    }
    if kind == "gated":
        spec["w_gate"] = ParamSpec((d, ff), ("embed", "ff"))
    return spec


def ffn_apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU, (silu(x @ w_gate) * (x @ w_up)) @ w_down, when the params
    hold ``w_gate``; else the plain FFN, gelu(x @ w_up) @ w_down with the
    tanh approximation (``jax.nn.gelu``'s default).  In x's dtype."""
    u = torch.einsum("...d,df->...f", x, params["w_up"])
    if "w_gate" in params:
        g = torch.einsum("...d,df->...f", x, params["w_gate"])
        h = silu(g) * u
    else:
        h = F.gelu(u, approximate="tanh")
    return torch.einsum("...f,fd->...d", h, params["w_down"])
