"""Dense FFNs and the token-choice top-k MoE — counterpart of
``repro.models.moe`` (``ffn_spec`` / ``ffn_apply``: SwiGLU, or the plain
GELU FFN for ``mlp_kind="plain"``; ``moe_spec`` / ``moe_apply``, and the
``inverse_gather`` routing primitive).

The MoE dispatches by sorting, not scattering, into per-expert capacity
buffers (E, C, d), as the reference does:

  router -> top-k -> sort the (token, k) rows by expert -> gather them
  into (E, C, d) -> expert SwiGLU einsums -> gather back -> gate-weighted
  sum over k.

Rows past an expert's capacity C are dropped (GShard).  The reference's
``constrain`` calls (sharding hints for the expert and batch mesh axes)
have no numeric effect and are left out: the port runs on one device, and
its partitioning waits for the distribution layer (ROADMAP queue 1 item
8).  The expert products stay ``torch.einsum`` (cuBLAS), as they are plain
einsums in the reference, outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import ParamSpec, silu


# ---------------------------------------------------------------------------
# Scatter-free routing primitive
# ---------------------------------------------------------------------------

def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take_along_axis(x, idx[..., None], axis=1)``: x (G,M,D), idx
    (G,P) -> (G,P,D)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


class _InverseGather(torch.autograd.Function):
    """A batched row gather whose backward is another gather through the
    inverse mapping the caller supplies (the reference's ``custom_vjp``),
    not a scatter-add."""

    @staticmethod
    def forward(ctx, x, idx, inv_idx, inv_valid):
        ctx.save_for_backward(inv_idx, inv_valid)
        return _take_rows(x, idx)

    @staticmethod
    def backward(ctx, g):
        inv_idx, inv_valid = ctx.saved_tensors
        gx = torch.where(inv_valid[..., None], _take_rows(g, inv_idx), 0)
        return gx, None, None, None


def inverse_gather(x: torch.Tensor, idx: torch.Tensor, inv_idx: torch.Tensor,
                   inv_valid: torch.Tensor) -> torch.Tensor:
    """x: (G,M,D); idx: (G,P) -> (G,P,D); rows with idx clipped/invalid
    must be masked by the caller.  inv_idx: (G,M) position of each x-row
    in the output (arbitrary where inv_valid is False); the gradient of x
    is ``g`` gathered by ``inv_idx``, zero where ``inv_valid`` is
    False."""
    return _InverseGather.apply(x, idx, inv_idx, inv_valid)


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------

def ffn_spec(cfg, d_ff: Optional[int] = None) -> Dict[str, ParamSpec]:
    kind = getattr(cfg, "mlp_kind", "gated")
    if kind not in ("gated", "plain"):
        raise ValueError(
            f"mlp_kind {kind!r}: the dense FFN is 'gated' (SwiGLU) or "
            "'plain' (GELU); MoE layers are BlockSpec(moe=True), and SSM "
            "blocks and encoder-decoders are not ported yet (ROADMAP queue "
            "1 item 7)")
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


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_spec(cfg) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    ff = cfg.moe_d_ff or cfg.d_ff
    E = cfg.moe_num_experts
    spec = {
        "router": ParamSpec((d, E), ("embed", "experts"), scale=0.02),
        "w_gate": ParamSpec((E, d, ff), ("experts", "embed", "ff")),
        "w_up": ParamSpec((E, d, ff), ("experts", "embed", "ff")),
        "w_down": ParamSpec((E, ff, d), ("experts", "ff", "embed")),
    }
    if cfg.moe_num_shared:
        shared_ff = ff * cfg.moe_num_shared
        spec["shared"] = {
            "w_gate": ParamSpec((d, shared_ff), ("embed", "ff")),
            "w_up": ParamSpec((d, shared_ff), ("embed", "ff")),
            "w_down": ParamSpec((shared_ff, d), ("ff", "embed")),
        }
    return spec


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values of the last axis and their indices, the lower
    index first among equal values (``jax.lax.top_k``'s order, which
    ``torch.topk`` does not promise)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(cfg, params: Dict, x: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict]:
    """x: (B,S,d) -> (B,S,d), aux dict {"aux_loss", "drop_frac"}.

    Token-choice top-k with normalized softmax gates and capacity dropping:
    C = max(1, int(Tg * K / E * capacity_factor)) slots per expert, at
    ``cfg.moe_capacity_factor``.  Decode steps (S == 1) get drop-free
    capacity (C = T) unless ``cfg.moe_decode_drop_free`` is off.  Every
    S > 1 call (prefill and speculative verify alike) drops, its pad rows
    taking capacity as real ones do.  ``cfg.moe_groups`` makes each
    sequence its own group with its own buffers (S > 1).  The router runs
    in x's dtype; softmax, top-k and the gate normalisation in f32; the
    gate-weighted sum in x's dtype."""
    B, S, d = x.shape
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    T = B * S
    capacity_factor = cfg.moe_capacity_factor
    if S == 1 and cfg.moe_decode_drop_free:
        capacity_factor = float(E) / K  # C == T: no drops at decode
    grouped = bool(cfg.moe_groups) and S > 1
    if grouped:
        G, Tg = B, S
        xt = x
    else:
        G, Tg = 1, T
        xt = x.reshape(1, T, d)
    dev = x.device

    logits = torch.einsum("gtd,de->gte", xt, params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, K)                  # (G,Tg,K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    N = Tg * K
    e_flat = expert_idx.reshape(G, N)
    g_flat = gate_vals.reshape(G, N)
    C = max(1, int(Tg * K / E * capacity_factor))

    # dispatch: sort the (token, k) rows by expert, batched gathers only
    sort_idx = torch.argsort(e_flat, dim=1, stable=True)      # (G,N)
    counts = (e_flat[:, :, None] ==
              torch.arange(E, device=dev)).sum(dim=1)         # (G,E)
    offsets = torch.cumsum(counts, dim=1) - counts            # (G,E)
    slots = torch.arange(C, device=dev)
    slot_pos = offsets[:, :, None] + slots                    # (G,E,C)
    slot_valid = slots < counts[:, :, None]
    slot_pos = slot_pos.clamp(0, N - 1).reshape(G, E * C)
    src = torch.gather(sort_idx, 1, slot_pos)                 # (G,E*C)
    slot_valid_f = slot_valid.reshape(G, E * C)

    # token->slot inverse mapping: the rank of (token, k) row n within its
    # expert is its capacity slot
    rank = torch.argsort(sort_idx, dim=1)                     # inverse perm
    slot_c = rank - torch.gather(offsets, 1, e_flat)
    keep = slot_c < C
    flat_idx = e_flat * C + slot_c.clamp(0, C - 1)            # (G,N)

    x_k = xt.repeat_interleave(K, dim=1)                      # (G,N,d)
    buf = inverse_gather(x_k, src, flat_idx, keep)            # (G,E*C,d)
    buf = torch.where(slot_valid_f[..., None], buf, 0)
    buf = buf.reshape(G, E, C, d)

    h_g = torch.einsum("gecd,edf->gecf", buf, params["w_gate"])
    h_u = torch.einsum("gecd,edf->gecf", buf, params["w_up"])
    h = silu(h_g) * h_u
    out_buf = torch.einsum("gecf,efd->gecd", h, params["w_down"])

    # combine: slots -> tokens (the inverse of the dispatch gather)
    g_flat = torch.where(keep, g_flat, 0.0)
    y_tok = inverse_gather(out_buf.reshape(G, E * C, d), flat_idx, src,
                           slot_valid_f)                      # (G,N,d)
    y = (y_tok * g_flat[..., None].to(x.dtype)).reshape(
        G, Tg, K, d).sum(dim=2)

    if cfg.moe_num_shared:
        y = y + ffn_apply(params["shared"], xt)

    # load-balancing aux loss (Switch-style)
    density = probs.mean(dim=(0, 1))                          # (E,)
    sel_frac = counts.float().sum(dim=0) / (G * N)            # (E,)
    aux_loss = E * torch.sum(density * sel_frac)
    # the mean as XLA lowers it: the sum times 1/n
    dropped = 1.0 - keep.float().sum() * (1.0 / keep.numel())
    return y.reshape(B, S, d), {"aux_loss": aux_loss, "drop_frac": dropped}
