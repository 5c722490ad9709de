"""Optimizers over the params tree: AdamW and Adafactor (factored second
moment) — counterpart of ``repro.training.optimizer``.

Functions over nested dicts of tensors, as the reference's are over
pytrees (not ``torch.optim``): leaves are visited in ``jax.tree.leaves``
order (dict keys sorted), so the global norm sums in the reference's
order.  The math runs in fp32 whatever the params' dtype; AdamW keeps m
and v in ``state_dtype`` (float32 or bfloat16), Adafactor its factored
rows and columns (or the full v of a small leaf) in fp32.  The step count
is an int32 tensor.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..models.common import map_tree, tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"              # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    min_dim_factored: int = 128
    state_dtype: str = "float32"     # float32 | bfloat16 (for adamw m/v)


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, fp32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_factor(tree, max_norm: float):
    """(the factor that scales ``tree`` to a global norm of at most
    ``max_norm``; the norm before clipping)."""
    norm = global_norm(tree)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to a global norm of at most ``max_norm``, in fp32;
    the norm before clipping)."""
    scale, norm = clip_factor(tree, max_norm)
    return map_tree(lambda g: g.float() * scale, tree), norm


def _step_of(params) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(cfg: OptimizerConfig, params):
    dt = torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": _step_of(params)}


def adamw_update(cfg: OptimizerConfig, grads, state, params):
    """The reference's update, leaf by leaf: each gradient is clipped (in
    fp32, by the global norm's factor) where its leaf is updated, and the
    bias-corrected moments live only inside the step's expression, so the
    fp32 temporaries at any time are one leaf's, with the same numbers (no
    fp32 copy of the whole gradient tree beside the moments: 9.4 GB at
    gemma3-12b's one super-block on the card)."""
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    scale, gnorm = clip_factor(grads, cfg.clip_norm)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1, bc2 = 1 - b1 ** stepf, 1 - b2 ** stepf

    def upd(g, m, v, p):
        gf = g.float() * scale
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf * gf
        del gf
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p_new = p.float() - lr * delta
        return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

    out = [upd(g, m, v, p) for g, m, v, p in zip(
        tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]),
        tree_leaves(params))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out])
                           for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "step": step}, \
        {"lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern, 2018) — factored second moment
# ---------------------------------------------------------------------------

def _factored(shape, min_dim: int) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def adafactor_init(cfg: OptimizerConfig, params):
    # a flat list aligned with tree_leaves(params), as in the reference
    def state_for(p):
        shape = tuple(p.shape)
        if _factored(shape, cfg.min_dim_factored):
            return {"vr": torch.zeros(shape[:-1], device=p.device),
                    "vc": torch.zeros(shape[:-2] + shape[-1:],
                                      device=p.device)}
        return {"v": torch.zeros(shape, device=p.device)}
    return {"v": [state_for(p) for p in tree_leaves(params)],
            "step": _step_of(params)}


def adafactor_update(cfg: OptimizerConfig, grads, state, params):
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    beta2 = 1.0 - step.to(torch.float32) ** (-cfg.decay_rate)
    eps = 1e-30

    def upd(g, s, p):
        gf = g.float()
        g2 = gf * gf + eps
        if "vr" in s:
            vr = beta2 * s["vr"] + (1 - beta2) * g2.mean(dim=-1)
            vc = beta2 * s["vc"] + (1 - beta2) * g2.mean(dim=-2)
            denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
            vhat = (vr / denom)[..., None] * vc[..., None, :]
            new_s = {"vr": vr, "vc": vc}
        else:
            vhat = beta2 * s["v"] + (1 - beta2) * g2
            new_s = {"v": vhat}
        update = gf / torch.sqrt(vhat + eps)
        # relative step clipping (RMS-1)
        rms = torch.sqrt(torch.mean(update * update))
        update = update / torch.clamp(rms, min=1.0)
        p_new = p.float() - lr * update \
            - lr * cfg.weight_decay * p.float()
        return p_new.to(p.dtype), new_s

    out = [upd(g, s, p) for g, s, p in zip(
        tree_leaves(grads), state["v"], tree_leaves(params))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    return new_p, {"v": [o[1] for o in out], "step": step}, \
        {"lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def opt_init(cfg: OptimizerConfig, params):
    return adamw_init(cfg, params) if cfg.name == "adamw" \
        else adafactor_init(cfg, params)


def opt_update(cfg: OptimizerConfig, grads, state, params):
    return adamw_update(cfg, grads, state, params) if cfg.name == "adamw" \
        else adafactor_update(cfg, grads, state, params)
