"""Model assembly for the all-full-attention decoders — counterpart of
``repro.models.model`` (``param_specs`` / ``init``, ``_embed``, ``_logits``,
``forward``, ``loss_fn``, and the dense serving path: ``init_caches``,
``prefill``, ``fill_prefill_cache``, ``decode_step``).

The layer stack is ``prologue + pattern * repeats``; the repeated part keeps
the reference's layout, params (and dense caches) stacked on a leading
"layers" axis under ``["super"]``, and the reference's ``lax.scan`` over it
becomes a Python loop over that axis.  Every prefill attention goes through
``chunked_attention``, the flash prefill attention kernel.

The port carries decoders whose every block is GQA attention (MHA
included), full, local or sliding-window (dense caches of a windowed block
are rings of ``window`` slots), with a dense FFN: RMSNorm, LayerNorm or
the non-parametric LayerNorm; SwiGLU or the plain GELU FFN; tied or untied
embeddings (smollm, olmo, starcoder2, chameleon, gemma3).  MoE, MLA or SSM
blocks and encoder-decoders are not ported yet and raise in
``check_ported``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.utils.checkpoint as ckpt

from ..configs.base import BlockSpec, ModelConfig
from .attention import attn_spec, gqa_cache_init, gqa_decode, gqa_prefill
from .common import (ParamSpec, apply_norm, init_params, map_tree,
                     norm_spec, resolve_device, torch_dtype)
from .moe import ffn_apply, ffn_spec


def check_ported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is in the families the port carries: every
    block GQA attention, full, local or sliding-window, with a dense FFN,
    decoder-only (any norm the reference has, either FFN, tied or untied
    embeddings)."""
    bad = [b for b in cfg.blocks
           if b.kind != "attn" or b.attn not in ("full", "local", "swa")
           or b.moe]
    if (bad or cfg.mla_kv_lora_rank or cfg.is_encoder_decoder
            or cfg.d_ff <= 0):
        raise NotImplementedError(
            f"{cfg.name}: MoE, MLA or SSM blocks and encoder-decoders are "
            "not ported yet; the port carries GQA decoders (full, local or "
            "sliding-window attention) with a dense FFN (ROADMAP queue 1 "
            "item 7)")


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

def _block_spec(cfg: ModelConfig, b: BlockSpec) -> Dict:
    return {"norm1": norm_spec(cfg), "mix": attn_spec(cfg),
            "norm2": norm_spec(cfg), "ffn": ffn_spec(cfg)}


def _stack_specs(tree, n: int):
    return map_tree(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                        init=s.init, scale=s.scale), tree)


def param_specs(cfg: ModelConfig) -> Dict:
    check_ported(cfg)
    d = cfg.d_model
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "embed"), scale=0.02),
        "final_norm": norm_spec(cfg),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, cfg.vocab_size), ("embed", "vocab"),
                                     scale=0.02)
    if cfg.prologue:
        specs["prologue"] = [_block_spec(cfg, b) for b in cfg.prologue]
    specs["super"] = _stack_specs(
        {f"pos{i}": _block_spec(cfg, b) for i, b in enumerate(cfg.pattern)},
        cfg.repeats)
    return specs


def init(cfg: ModelConfig, generator: Union[torch.Generator, int] = 0, *,
         device="cuda"):
    """Random params in ``cfg.param_dtype``.  Leaves are drawn on the CPU
    from ``generator`` (or a CPU generator seeded with the int) and then
    moved to ``device``, so one seed gives the same weights on every
    device."""
    dev = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device="cpu").manual_seed(int(generator))
    params = init_params(param_specs(cfg), generator, cfg.param_dtype)
    return map_tree(lambda t: t.to(dev), params)


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def _embed(cfg, params, tokens, positions):
    return params["embed"][tokens.long()]


def _logits(cfg, params, h):
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", h, params["embed"])
    return torch.einsum("bsd,dv->bsv", h, params["lm_head"])


def super_layers(cfg, params):
    """Block params of every repeated layer, repeat by repeat: views into
    the stacked ``super`` tree.  Each stacked leaf is unbound once, so
    under autograd its gradient is stacked once instead of summed from one
    full-size tensor a layer."""
    def split(tree):
        if isinstance(tree, dict):
            parts = {k: split(v) for k, v in tree.items()}
            return [{k: v[r] for k, v in parts.items()}
                    for r in range(cfg.repeats)]
        return tree.unbind(0)

    per_pos = [split(params["super"][f"pos{i}"])
               for i in range(len(cfg.pattern))]
    for r in range(cfg.repeats):
        for layers in per_pos:
            yield layers[r]


# ---------------------------------------------------------------------------
# Block application (prefill / scoring path)
# ---------------------------------------------------------------------------

def _window(b: BlockSpec) -> int:
    return b.window if b.attn in ("swa", "local") else 0


def _apply_block(cfg, b: BlockSpec, p, h, positions, collect_cache=False):
    """One block over a whole sequence.  Returns (h, cache): the block's
    roped (k, v) when ``collect_cache``, else None.  (The reference also
    returns a MoE aux loss, which is 0 for this family.)"""
    hn = apply_norm(cfg, p["norm1"], h)
    out, cache = gqa_prefill(cfg, p["mix"], hn, positions, window=_window(b))
    h = h + out
    hn = apply_norm(cfg, p["norm2"], h)
    h = h + ffn_apply(p["ffn"], hn)
    return h, (cache if collect_cache else None)


# ---------------------------------------------------------------------------
# Train / scoring forward
# ---------------------------------------------------------------------------

def _blocks(cfg, params):
    """(BlockSpec, block params) for every layer, in stack order; the
    reference's ``lax.scan`` over the super-block is this loop over its
    repeats."""
    for i, b in enumerate(cfg.prologue):
        yield b, params["prologue"][i]
    yield from zip(tuple(cfg.pattern) * cfg.repeats, super_layers(cfg, params))


# remat: how a block keeps its activations for backward — all of them
# ("none"), none (recomputed in backward: "full"), or the outputs of its
# matrix products only ("dots"); numbers equal either way
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _block_out(cfg, b, p, h, positions):
    return _apply_block(cfg, b, p, h, positions)[0]


def _run_block(cfg, b, p, h, positions, remat: str):
    if remat == "none":
        return _block_out(cfg, b, p, h, positions)
    if remat == "full":
        return ckpt.checkpoint(_block_out, cfg, b, p, h, positions,
                               use_reentrant=False)
    if remat == "dots":
        return ckpt.checkpoint(
            _block_out, cfg, b, p, h, positions, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat must be none, full or dots, got {remat!r}")


def _forward(cfg: ModelConfig, params, tokens: torch.Tensor,
             remat: str = "none") -> torch.Tensor:
    check_ported(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    h = _embed(cfg, params, tokens, positions)
    for b, p in _blocks(cfg, params):
        h = _run_block(cfg, b, p, h, positions, remat)
    h = apply_norm(cfg, params["final_norm"], h)
    return _logits(cfg, params, h)


def forward(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B,S) int -> logits (B,S,V).  (The reference also returns a
    MoE aux loss, which is 0 for this family.)"""
    return _forward(cfg, params, tokens)


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            aux_weight: float = 0.01, skip_masked_chunks: bool = False, *,
            remat: str = "none") -> Tuple[torch.Tensor, Dict]:
    """batch: tokens (B,S), labels (B,S) with -100 = ignore.  Mean
    cross-entropy over the labelled tokens, from an fp32 log-softmax of the
    logits.  Returns (loss, {"ce", "aux", "tokens"}); ``aux`` (the MoE
    load-balance loss) is 0 for this family.  ``skip_masked_chunks`` is
    accepted and unused, as in ``chunked_attention`` (K2 skips masked
    tiles by itself); ``remat`` ("none", "full", "dots") sets what each
    block keeps for backward, not the numbers."""
    logits = _forward(cfg, params, batch["tokens"], remat)
    labels = batch["labels"].long()
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.float(), dim=-1)
    del logits      # backward needs only logp: one copy of the logits lives
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    denom = valid.sum().clamp_min(1)
    ce = torch.where(valid, nll, torch.zeros_like(nll)).sum() / denom
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "aux": aux, "tokens": denom.float()}


# ---------------------------------------------------------------------------
# Serving: prefill + decode with dense caches
# ---------------------------------------------------------------------------

def _cache_init_for_block(cfg, b: BlockSpec, batch, max_len, dtype, *,
                          device="cuda"):
    return gqa_cache_init(cfg, batch, max_len, _window(b), dtype,
                          device=device)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                device="cuda"):
    """Dense decode caches: ``prologue`` (one dict per block) and ``super``
    (per pattern position, leaves stacked on a leading repeats axis)."""
    check_ported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    return stacked_caches(cfg, lambda b: _cache_init_for_block(
        cfg, b, batch, max_len, dtype, device=dev))


def stacked_caches(cfg: ModelConfig, block_cache):
    """The cache tree of the stack from ``block_cache(BlockSpec)``, one
    block's cache: ``prologue`` (one per block) and ``super`` (per pattern
    position, leaves stacked on a leading repeats axis)."""
    caches: Dict[str, Any] = {}
    if cfg.prologue:
        caches["prologue"] = [block_cache(b) for b in cfg.prologue]
    caches["super"] = {
        f"pos{i}": map_tree(
            lambda x: x.expand((cfg.repeats,) + x.shape).clone(),
            block_cache(b))
        for i, b in enumerate(cfg.pattern)}
    return caches


def _block_caches(cfg, caches):
    """Cache dict of every layer, in stack order (views into the stacked
    ``super`` leaves, so in-place writes land in ``caches``)."""
    for i in range(len(cfg.prologue)):
        yield caches["prologue"][i]
    for r in range(cfg.repeats):
        for i in range(len(cfg.pattern)):
            yield map_tree(lambda x: x[r], caches["super"][f"pos{i}"])


def _apply_block_decode(cfg, b: BlockSpec, p, h, cache, cache_pos,
                        rows=None):
    hn = apply_norm(cfg, p["norm1"], h)
    out, cache = gqa_decode(cfg, p["mix"], hn, cache, cache_pos,
                            window=_window(b), rows=rows)
    h = h + out
    hn = apply_norm(cfg, p["norm2"], h)
    return h + ffn_apply(p["ffn"], hn), cache


def decode_step(cfg: ModelConfig, params, tokens, caches, cache_pos):
    """One autoregressive step.  tokens: (B,) int; cache_pos: (B,) absolute
    position of this token.  The caches are updated in place.  Returns
    (logits (B,V), caches)."""
    check_ported(cfg)
    h = _embed(cfg, params, tokens[:, None], cache_pos[:, None])
    for (b, p), c in zip(_blocks(cfg, params), _block_caches(cfg, caches)):
        h, _ = _apply_block_decode(cfg, b, p, h, c, cache_pos)
    h = apply_norm(cfg, params["final_norm"], h)
    return _logits(cfg, params, h)[:, 0], caches


def fill_prefill_cache(cfg: ModelConfig, b: BlockSpec, raw_cache, batch: int,
                       seq_len: int, max_len: int, dtype):
    """One block's prefill (k, v) -> its decode cache (ring/dense buffers
    sized max_len): the last ``min(S, W)`` tokens, the token at absolute
    position p in slot p % W (windowed) or p."""
    k, v = raw_cache
    S = seq_len
    window = _window(b)
    tgt = gqa_cache_init(cfg, batch, max_len, window, dtype, device=k.device)
    W = tgt["k"].shape[1]
    n = min(S, W)
    if window:
        last_pos = torch.arange(S - n, S, device=k.device)
        slots = last_pos % W
        tgt["k"][:, slots] = k[:, -n:].to(dtype)
        tgt["v"][:, slots] = v[:, -n:].to(dtype)
        tgt["pos"][:, slots] = last_pos.to(torch.int32)
        return tgt
    # slot = position; slots past W are dropped, as the reference's
    # scatter drops out-of-range indices
    lo, hi = S - n, min(S, W)
    tgt["k"][:, lo:hi] = k[:, lo:hi].to(dtype)
    tgt["v"][:, lo:hi] = v[:, lo:hi].to(dtype)
    tgt["pos"][:, lo:hi] = torch.arange(lo, hi, dtype=torch.int32,
                                        device=k.device)
    return tgt


def prefill(cfg: ModelConfig, params, tokens, *,
            max_len: Optional[int] = None):
    """Process the prompt, returning (last-token logits (B,V), caches) ready
    for decode at position S.  tokens: (B,S)."""
    check_ported(cfg)
    B, S = tokens.shape
    max_len = max_len or S
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    h = _embed(cfg, params, tokens, positions)
    dtype = h.dtype
    per_layer = []
    for b, p in _blocks(cfg, params):
        h, raw = _apply_block(cfg, b, p, h, positions, collect_cache=True)
        per_layer.append(fill_prefill_cache(cfg, b, raw, B, S, max_len,
                                            dtype))
    n_pro = len(cfg.prologue)
    caches: Dict[str, Any] = {}
    if cfg.prologue:
        caches["prologue"] = per_layer[:n_pro]
    pat = len(cfg.pattern)
    caches["super"] = {
        f"pos{i}": {key: torch.stack([per_layer[n_pro + r * pat + i][key]
                                      for r in range(cfg.repeats)])
                    for key in ("k", "v", "pos")}
        for i in range(pat)}
    h = apply_norm(cfg, params["final_norm"], h)
    return _logits(cfg, params, h[:, -1:])[:, 0], caches
