"""The port's dense serving path against the JAX package (f32, CPU).

Model functions on the same weights (the session ``gqa_model`` fixture,
smollm SMOKE in f32, converted with ``params_from_jax``): ``gqa_prefill``,
``gqa_decode``, ``gqa_cache_init``, ``prefill`` + ``decode_step``,
``fill_prefill_cache`` and the stage functions with a mid-node entry.
Logits, activations and K/V are held to atol = rtol = 1e-4 (a few layers
of f32 matmuls summed in another order); cache positions exactly,
including the int32-max sentinel of empty slots and the clamp to slot
W - 1 past the budget.  The single-node engines must give greedy tokens
equal to ``tests/harness.py::reference_outputs`` (the reference's dense
``Engine``) and end drained.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import BlockSpec as JBlockSpec
from repro.core import LayerRange as JLayerRange
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import stage as jstage
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import BlockSpec
from repro_torch.convert import params_from_jax
from repro_torch.core.placement import LayerRange
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models import stage as tstage
from repro_torch.serving.engine import (Engine, EngineConfig, PagedEngine,
                                        Request)

from harness import EC as JEC, random_prompts, reference_outputs

MODEL = dict(atol=1e-4, rtol=1e-4)
EC = EngineConfig(**dataclasses.asdict(JEC))


@pytest.fixture(scope="module")
def both(gqa_model):
    jcfg, jparams = gqa_model
    cfg = dataclasses.replace(get_smoke_config("smollm_360m"),
                              param_dtype=jcfg.param_dtype,
                              compute_dtype=jcfg.compute_dtype)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jcfg, jparams, cfg, params


def t(a):
    return torch.from_numpy(np.array(a))


def assert_cache_equal(tc, jc):
    """K/V to the model tolerance, positions exactly."""
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **MODEL)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), **MODEL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def _layer0(params):
    return {k: v[0] for k, v in params["super"]["pos0"]["mix"].items()}


def test_gqa_prefill_and_decode_match(both):
    """One attention layer: prefill of 11 tokens (out and roped K/V), then
    decode into a max_len = 13 cache past its end: positions 11, 12 fill
    the last free slots, 13 and 14 overwrite slot W - 1."""
    jcfg, jparams, cfg, params = both
    jp = jax.tree.map(lambda a: a[0], jparams["super"]["pos0"]["mix"])
    tp = _layer0(params)
    rng = np.random.RandomState(0)
    B, S, W = 2, 11, 13
    x = rng.randn(B, S, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jo, (jk, jv) = jattn.gqa_prefill(jcfg, jp, jnp.asarray(x),
                                     jnp.asarray(pos))
    to, (tk, tv) = tattn.gqa_prefill(cfg, tp, t(x), t(pos))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **MODEL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **MODEL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **MODEL)

    jc = jattn.gqa_cache_init(jcfg, B, W, 0, jnp.float32)
    tc = tattn.gqa_cache_init(cfg, B, W, 0, torch.float32, device="cpu")
    assert_cache_equal(tc, jc)
    assert int(tc["pos"][0, 0]) == 2 ** 31 - 1
    jc = jmodel.fill_prefill_cache(jcfg, JBlockSpec(), (jk, jv), B, S, W,
                                   jnp.float32)
    tc = tmodel.fill_prefill_cache(cfg, BlockSpec(), (tk, tv), B, S, W,
                                   torch.float32)
    assert_cache_equal(tc, jc)
    for step in range(4):
        xd = rng.randn(B, 1, cfg.d_model).astype(np.float32)
        cp = np.asarray([S + step, S + step - 3], np.int32)
        jo, jc = jattn.gqa_decode(jcfg, jp, jnp.asarray(xd), jc,
                                  jnp.asarray(cp))
        to, tc = tattn.gqa_decode(cfg, tp, t(xd), tc, t(cp))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **MODEL)
        assert_cache_equal(tc, jc)
    assert tc["pos"][0, W - 1] == S + 3          # clamped to the last slot


@pytest.mark.parametrize("window", [5, 16], ids=["ring", "wide"])
def test_fill_prefill_cache_window_matches(both, window):
    """Windowed blocks keep the last min(S, W) tokens in ring order (a
    window at or past max_len is a plain cache of max_len)."""
    jcfg, _, cfg, _ = both
    rng = np.random.RandomState(1)
    B, S, max_len = 2, 11, 13
    k = rng.randn(B, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    v = rng.randn(B, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    k, v = k.astype(np.float32), v.astype(np.float32)
    jc = jmodel.fill_prefill_cache(
        jcfg, JBlockSpec(attn="swa", window=window),
        (jnp.asarray(k), jnp.asarray(v)), B, S, max_len, jnp.float32)
    tc = tmodel.fill_prefill_cache(
        cfg, BlockSpec(attn="swa", window=window), (t(k), t(v)), B, S,
        max_len, torch.float32)
    assert_cache_equal(tc, jc)


@pytest.mark.parametrize("max_len", [24, 9], ids=["fits", "past-budget"])
def test_prefill_then_decode_matches(both, max_len):
    """Whole-model prefill then decode steps: logits and every layer's
    cache.  At max_len 9 < S the prefill keeps slots < W only, as the
    reference's scatter drops out-of-range indices, and decode overwrites
    slot W - 1."""
    jcfg, jparams, cfg, params = both
    tok = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 11))
    jl, jc = jmodel.prefill(jcfg, jparams, jnp.asarray(tok, jnp.int32),
                            max_len=max_len)
    tl, tc = tmodel.prefill(cfg, params, t(tok), max_len=max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL)
    assert_cache_equal(tc["super"]["pos0"], jc["super"]["pos0"])
    nxt = np.asarray(jl).argmax(-1)
    for s in range(3):
        pos = np.full((2,), 11 + s, np.int32)
        jl, jc = jmodel.decode_step(jcfg, jparams, jnp.asarray(nxt, jnp.int32),
                                    jc, jnp.asarray(pos))
        tl, tc = tmodel.decode_step(cfg, params, t(nxt), tc, t(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL)
        nxt = np.asarray(jl).argmax(-1)
    assert_cache_equal(tc["super"]["pos0"], jc["super"]["pos0"])
    init = tmodel.init_caches(cfg, 2, max_len, device="cpu")
    jinit = jmodel.init_caches(jcfg, 2, max_len)
    assert_cache_equal(init["super"]["pos0"], jinit["super"]["pos0"])


def test_forward_goes_through_chunked_attention(both, monkeypatch):
    """Every layer of ``forward`` and ``prefill`` calls the flash prefill
    attention kernel's wrapper once."""
    jcfg, jparams, cfg, params = both
    calls = []
    real = tattn.flash_attention_bshd
    monkeypatch.setattr(tattn, "flash_attention_bshd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tok = np.random.RandomState(3).randint(0, cfg.vocab_size, (1, 9))
    want, _ = jmodel.forward(jcfg, jparams, jnp.asarray(tok, jnp.int32))
    got = tmodel.forward(cfg, params, t(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)
    tmodel.prefill(cfg, params, t(tok))
    assert len(calls) == 2 * cfg.num_layers


def test_stage_prefill_and_decode_mid_node_entry_match(both):
    """Node [0,3) entered at layer 1 by a prompt's activations, then node
    [3,4) ends the model; then one batched decode step on [0,3) with row 0
    entering at layer 0 (a token), row 1 at layer 1 (activations) and row 2
    a pad row (entry past the slice)."""
    jcfg, jparams, cfg, params = both
    rng = np.random.RandomState(4)
    S, max_len = 10, 16
    x = rng.randn(1, S, cfg.d_model).astype(np.float32)
    for (a, b), entry in (((0, 3), 1), ((3, 4), 3)):
        jr, tr = JLayerRange(a, b), LayerRange(a, b)
        jo, jcs = jstage.stage_prefill(
            jcfg, jstage.stage_params(jcfg, jparams, jr), jr,
            jnp.asarray(x), entry, max_len=max_len)
        to, tcs = tstage.stage_prefill(
            cfg, tstage.stage_params(cfg, params, tr), tr, t(x), entry,
            max_len=max_len)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **MODEL)
        assert len(tcs) == b - a
        for tc, jc in zip(tcs, jcs):
            assert_cache_equal(tc, jc)
        x = np.asarray(jo)
    assert to.shape == (1, cfg.vocab_size)

    jr, tr = JLayerRange(0, 3), LayerRange(0, 3)
    B = 3
    jcs = jstage.stage_cache_init(jcfg, jr, B, max_len)
    tcs = tstage.stage_cache_init(cfg, tr, B, max_len, device="cpu")
    for tc, jc in zip(tcs, jcs):
        assert_cache_equal(tc, jc)
    tok = np.asarray([7, 0, 0], np.int32)
    h_in = rng.randn(B, 1, cfg.d_model).astype(np.float32)
    entry = np.asarray([0, 1, 3], np.int32)
    cache_pos = np.asarray([0, 0, 0], np.int32)
    for step in range(2):
        jh, jlog, jcs = jstage.stage_decode(
            jcfg, jstage.stage_params(jcfg, jparams, jr), jr,
            jnp.asarray(tok), jnp.asarray(h_in), jnp.asarray(entry), jcs,
            jnp.asarray(cache_pos + step))
        th, tlog, tcs = tstage.stage_decode(
            cfg, tstage.stage_params(cfg, params, tr), tr, t(tok), t(h_in),
            t(entry), tcs, t(cache_pos + step))
        assert jlog is None and tlog is None
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MODEL)
        for tc, jc in zip(tcs, jcs):
            assert_cache_equal(tc, jc)
    # the pad row passes its input through every (masked) block
    np.testing.assert_allclose(th[2].numpy(), h_in[2], atol=0, rtol=0)


def test_stage_decode_writes_named_cache_rows_in_place(both):
    """A stage engine's decode batch names its cache rows: two steps over
    rows (3, 0, 4) of a 5-row cache give exactly the activations and K/V
    of the same steps on a 3-row cache (held to the reference by the test
    above), and leave rows 1 and 2 as they were."""
    _, _, cfg, params = both
    rng = np.random.RandomState(5)
    tr = LayerRange(0, 3)
    sp = tstage.stage_params(cfg, params, tr)
    B, max_len = 3, 16
    rows = t(np.asarray([3, 0, 4]))
    own = tstage.stage_cache_init(cfg, tr, B, max_len, device="cpu")
    big = tstage.stage_cache_init(cfg, tr, 5, max_len, device="cpu")
    fresh = tstage.stage_cache_init(cfg, tr, 5, max_len, device="cpu")
    tok = t(np.asarray([7, 0, 0], np.int32))
    entry = t(np.asarray([0, 1, 3], np.int32))
    for step in range(2):
        h_in = t(rng.randn(B, 1, cfg.d_model).astype(np.float32))
        cache_pos = t(np.full((B,), step, np.int32))
        h_own, _, own = tstage.stage_decode(cfg, sp, tr, tok, h_in, entry,
                                            own, cache_pos)
        h_big, _, big = tstage.stage_decode(cfg, sp, tr, tok, h_in, entry,
                                            big, cache_pos, rows=rows)
        assert torch.equal(h_big, h_own)
    for co, cb, cf in zip(own, big, fresh):
        for key in co:
            assert torch.equal(cb[key][rows], co[key])
            assert torch.equal(cb[key][1:3], cf[key][1:3])


def _serve(eng, prompts, max_new_tokens=6):
    reqs = [Request(i, p, max_new_tokens=max_new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done(2000)
    assert all(r.done for r in reqs)
    return reqs


def test_engine_matches_reference_tokens(both, reference):
    """The port's dense single-node engine is the reference's oracle: equal
    greedy tokens, one prefill per request, every slot free at the end."""
    _, _, cfg, params = both
    prompts, ref = reference
    eng = Engine(cfg, params, EC, device="cpu")
    reqs = _serve(eng, prompts)
    assert [r.output for r in reqs] == ref
    assert eng.prefills == len(prompts)
    assert not eng.active.any() and all(s is None for s in eng.slots)


def test_paged_engine_chunks_and_preempts_like_reference(both):
    """Prompts past the 8-token chunk, and a pool of one full-budget
    request (plus scratch) that forces preemption and recompute: tokens
    equal the reference's dense engine, the pool drains."""
    jcfg, jparams, cfg, params = both
    prompts = random_prompts(jcfg, (15, 14, 13, 12), seed=5)
    ref = reference_outputs(jcfg, jparams, prompts, ec=JEC, max_new_tokens=8)
    ec = dataclasses.replace(EC, prompt_len=8)
    blocks = -(-ec.max_len // 16)
    eng = PagedEngine(cfg, params, ec, num_pages=1 + blocks * cfg.num_layers,
                      page_size=16, device="cpu")
    reqs = _serve(eng, prompts, max_new_tokens=8)
    assert [r.output for r in reqs] == ref
    assert sum(r.preemptions for r in reqs) > 0
    assert eng.prefills == len(prompts) + sum(r.preemptions for r in reqs)
    assert eng.pool.used == 0 and not eng.active.any()


def test_paged_engine_refuses_hybrid_stack(both):
    _, _, cfg, params = both
    hybrid = dataclasses.replace(cfg, pattern=(BlockSpec(kind="mamba"),))
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        PagedEngine(hybrid, params, EC, device="cpu")
