"""gemma3 (five local layers of window W to each global layer) on the
port's paged paths against the JAX package (f32, CPU, SMOKE size: 6
layers, local, local, full twice; window 16, head_dim 16).

The global layers page their K/V in the node's pool and decode through the
paged attention kernel's plain version; the local layers keep dense ring
caches; every prefill is single-shot, then the global layers' K/V moves
into the pool.  Prompts run past the window (40 tokens) and decode wraps
the rings.  Tolerances are those of ``tests/test_torch_gemma3.py``:
logits, activations, pages and ring caches atol = rtol = 1e-4; tokens,
page ids, block tables, the link ledger, counters and virtual-clock
latencies exactly equal.  Every serving case runs the reference's engine
or runtime beside the port's.
"""
import functools
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MILPOptions as JOpt
from repro.core import LayerRange as JLayerRange
from repro.core import replan_after_failure as j_replan
from repro.models import model as jmodel
from repro.models import paged as jpaged
from repro.models import stage as jstage
from repro.serving import InProcessTransport as JTransport
from repro.serving import engine as jengine
from repro.serving import stage_engine as jse
from repro_torch.convert import params_from_jax
from repro_torch.core import LayerRange, MILPOptions, replan_after_failure
from repro_torch.launch import serve
from repro_torch.launch.worker import run_worker
from repro_torch.models import init as tinit
from repro_torch.models import model as tmodel
from repro_torch.models import paged as tpaged
from repro_torch.models import stage as tstage
from repro_torch.serving import stage_engine as tse
from repro_torch.serving.engine import (PagedEngine, Request, _map2,
                                        _splice_slot)
from repro_torch.serving.runtime import ClusterRuntime, InProcessTransport

from harness import (make_disagg_plan as jmake_disagg_plan,
                     make_plan as jmake_plan, serve_on_cluster)
from test_torch_disagg import port_disagg_plan
from test_torch_gemma3 import (DELAY, EC, FAILOVER, FAILOVER_OPT, JEC,
                               MODEL, NEW_TOKENS, ONE_PREFILL, PLANS,
                               SPEC_COUNTERS, _two_threads,  # noqa: F401
                               assert_cache_equal, assert_same_run, model,
                               reference, t)
from test_torch_gemma3_training import fan_in_scaled
from test_torch_runtime import port_plan

# a pool of 8 blocks of 2 paged layers: the four prompts' admission takes
# all of it, so decode growth preempts (the full rectangle is 33 pages)
PREEMPT_PAGES = 17


# --- helpers -----------------------------------------------------------------

def paged_serve(cfg, params, p, prompts, *, steps=None, **kw):
    rt = ClusterRuntime(cfg, params, p, EC, paged=True, device="cpu", **kw)
    reqs = [Request(i, pr, max_new_tokens=NEW_TOKENS)
            for i, pr in enumerate(prompts)]
    for r in reqs:
        rt.submit(r)
    if steps is None:
        rt.run_until_done()
    else:
        for _ in range(steps):
            rt.step()
    return rt, reqs


def ref_paged_serve(p, prompts, **kw):
    jcfg, jparams, _, _ = model()
    return serve_on_cluster(jcfg, jparams, p, prompts, paged=True, ec=JEC,
                            max_new_tokens=NEW_TOKENS, **kw)


def assert_paged_drained(rt):
    for n, e in rt.engines.items():
        assert e.free_slots == EC.max_batch and e.kv_tokens_used() == 0, n
    assert all(u == 0 for u in rt.pool_pages_used().values())


def engine_kinds(rt):
    return {n: type(e).__name__ for n, e in sorted(rt.engines.items())}


def assert_pages_equal(tk, tv, jk, jv):
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **MODEL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **MODEL)


def assert_tree_equal(tc, jc):
    """Two cache trees of one structure: ``{}`` where the reference has
    ``{}``, ring caches to the model tolerance (positions exactly)."""
    if isinstance(jc, dict) and "k" not in jc:
        assert sorted(tc) == sorted(jc)
        for key in jc:
            assert_tree_equal(tc[key], jc[key])
    elif isinstance(jc, (list, tuple)):
        assert len(tc) == len(jc)
        for a, b in zip(tc, jc):
            assert_tree_equal(a, b)
    else:
        assert_cache_equal(tc, jc)


def shapes(tree):
    """The tree's structure with each leaf replaced by its shape."""
    if isinstance(tree, dict):
        return {k: shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [shapes(v) for v in tree]
    return tuple(tree.shape)


def random_tables(n_layers, B, NP, seed):
    """(n_layers, B, NP) distinct page ids from 1, and a zeroed pool of
    1 + n_layers * B * NP pages."""
    P = 1 + n_layers * B * NP
    ids = np.random.RandomState(seed).permutation(P - 1) + 1
    return P, ids.reshape(n_layers, B, NP).astype(np.int32)


@functools.lru_cache(maxsize=None)
def scaled_model():
    """``model()`` with every stacked block matrix rescaled to its own
    fan-in (``test_torch_gemma3_training.fan_in_scaled``), for both."""
    jcfg, jparams, cfg, _ = model()
    scaled = fan_in_scaled(jax.tree.map(np.asarray, jparams))
    return (jcfg, jax.tree.map(jnp.asarray, scaled), cfg,
            params_from_jax(scaled, cfg, device="cpu"))


# --- cache trees -------------------------------------------------------------

def test_paged_cache_trees_match_reference():
    """``init_caches_paged`` and ``stage_cache_init_paged``: the
    reference's tree, ``{}`` for each global layer, ring caches of 16
    slots for the local ones, the same shapes and contents."""
    jcfg, _, cfg, _ = model()
    jc = jpaged.init_caches_paged(jcfg, 3, 24)
    tc = tpaged.init_caches_paged(cfg, 3, 24, device="cpu")
    assert shapes(tc) == jax.tree.map(lambda a: tuple(a.shape), jc)
    assert tc["super"]["pos2"] == {} and tc["super"]["pos0"]["k"].shape[2] \
        == 16
    assert_tree_equal(tc, jc)
    for a, b in ((0, 3), (1, 6), (3, 6), (2, 3)):
        jsc = jstage.stage_cache_init_paged(jcfg, JLayerRange(a, b), 3, 24)
        tsc = tstage.stage_cache_init_paged(cfg, LayerRange(a, b), 3, 24,
                                            device="cpu")
        assert shapes(tsc) == jax.tree.map(lambda x: tuple(x.shape), jsc)
        assert_tree_equal(tsc, jsc)


# --- model level -------------------------------------------------------------

def test_prefill_absorb_then_paged_decode_matches_reference():
    """Two requests (40 and 23 tokens, past the 16-slot rings) prefilled
    alone, absorbed into slots 0 and 1 of a pool with shuffled tables and
    spliced into the fallback caches; then 8 decode steps of both rows:
    each step's logits, and at the end the pages and the ring caches,
    equal the reference's."""
    jcfg, jparams, cfg, params = model()
    B, max_len, page = 2, 56, 16
    NP = max_len // page + 1
    L = tpaged.num_paged_layers(cfg)
    P, table = random_tables(L, B, NP, seed=6)
    shape = (P, page, cfg.num_kv_heads, cfg.resolved_head_dim)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    tcaches = tpaged.init_caches_paged(cfg, B, max_len, device="cpu")
    jcaches = jpaged.init_caches_paged(jcfg, B, max_len)
    rng = np.random.RandomState(7)
    lens = (40, 23)
    nxt = []
    for slot, S in enumerate(lens):
        prompt = rng.randint(0, cfg.vocab_size, (1, S))
        jl, jc1 = jmodel.prefill(jcfg, jparams, jnp.asarray(prompt),
                                 max_len=max_len)
        tl, tc1 = tmodel.prefill(cfg, params, t(prompt), max_len=max_len)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL)
        jc1, jk, jv, _, _ = jpaged.absorb_dense_prefill(
            jcfg, jc1, jk, jv, table, slot, S, page)
        tc1, tk, tv = tpaged.absorb_dense_prefill(cfg, tc1, tk, tv, table,
                                                  slot, S, page)
        assert_tree_equal(tc1, jc1)
        jcaches = jax.tree.map(
            lambda full, one: jengine._splice_slot(full, one, slot),
            jcaches, jc1)
        _map2(lambda full, one: _splice_slot(full, one, slot), tcaches, tc1)
        nxt.append(int(np.asarray(jl).argmax(-1)[0]))
    assert_pages_equal(tk, tv, jk, jv)
    tp = table[:0]
    ts = table.reshape(cfg.repeats, 1, B, NP)
    jdecode = jax.jit(functools.partial(jpaged.decode_step_paged, jcfg,
                                        interpret=True))
    pos = np.asarray(lens, np.int32)
    tok = np.asarray(nxt, np.int32)
    for _ in range(8):
        jl, jcaches, jk, jv, _, _ = jdecode(
            jparams, jnp.asarray(tok), jcaches, jnp.asarray(pos), jk, jv,
            jnp.asarray(tp), jnp.asarray(ts))
        tl, tcaches, tk, tv = tpaged.decode_step_paged(
            cfg, params, t(tok), tcaches, t(pos), tk, tv, t(tp), t(ts))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + 1
    assert_pages_equal(tk, tv, jk, jv)
    assert_tree_equal(tcaches, jcaches)
    assert int(tcaches["super"]["pos0"]["pos"].max()) == 47


def test_prefill_chunk_refuses_a_hybrid_stack():
    """Chunked prefill needs every block paged, as the reference's
    engines gate it."""
    _, _, cfg, params = model()
    _, table = random_tables(2, 1, 1, seed=0)
    with pytest.raises(ValueError, match="all-paged"):
        tpaged.prefill_chunk_paged(
            cfg, params, torch.zeros((1, 4), dtype=torch.long),
            torch.zeros(1, dtype=torch.long), torch.zeros(5, 16, 2, 16),
            torch.zeros(5, 16, 2, 16), t(table[:0]),
            t(table.reshape(2, 1, 1, 1)))


# --- stage level -------------------------------------------------------------

def test_stage_prefill_absorb_decode_matches_reference():
    """Slices (0,3) and (3,6), the second entered with activations.  Row 0
    is a 40-token prompt entering at layer 0 (3 at the second slice); row
    1 enters the first slice mid-way, at layer 1, with the activations
    layer 0 gives a 23-token prompt (partial inference).  Each slice
    prefills single-shot, absorbs its global layer into the pool and
    decodes 6 steps of both rows (row 1 entering with token embeddings at
    the first slice): activations, logits, pages and ring caches as the
    reference's.  Both sides get the reference's inputs at every slice.
    The weights are fan-in scaled: on ``init``'s the SMOKE stack's
    activations reach ~600 by layer 3 and f32 summed in another order
    moves a few elements near zero by ~5e-3 (the logits still agree:
    ``test_prefill_absorb_then_paged_decode_matches_reference``)."""
    jcfg, jparams, cfg, params = scaled_model()
    B, max_len, page = 2, 56, 16
    NP = max_len // page + 1
    rng = np.random.RandomState(8)
    prompt = rng.randint(0, cfg.vocab_size, (40,))
    h1, _ = jstage.stage_prefill(
        jcfg, jstage.stage_params(jcfg, jparams, JLayerRange(0, 1)),
        JLayerRange(0, 1), jnp.asarray(rng.randint(0, cfg.vocab_size,
                                                   (1, 23))), 0,
        max_len=max_len)
    h1 = np.asarray(h1)
    lens = np.asarray([40, 23], np.int32)
    embed = np.asarray(jparams["embed"])
    dec_h = embed[rng.randint(0, cfg.vocab_size, (6, B, 1))]
    entering = None                      # reference's outputs of slice 0
    for a, b in ((0, 3), (3, 6)):
        jl_r, tl_r = JLayerRange(a, b), LayerRange(a, b)
        jsp = jstage.stage_params(jcfg, jparams, jl_r)
        tsp = tstage.stage_params(cfg, params, tl_r)
        n = tstage.stage_num_paged_layers(cfg, tl_r)
        assert n == 1
        P, table = random_tables(n, B, NP, seed=a)
        shape = (P, page, cfg.num_kv_heads, cfg.resolved_head_dim)
        tk, tv = torch.zeros(shape), torch.zeros(shape)
        jk, jv = jnp.zeros(shape), jnp.zeros(shape)
        jcaches = jstage.stage_cache_init_paged(jcfg, jl_r, B, max_len)
        tcaches = tstage.stage_cache_init_paged(cfg, tl_r, B, max_len,
                                                device="cpu")
        entries = [a, a + 1] if a == 0 else [a, a]
        outs = []
        for slot in range(B):
            if a == 0:
                x = prompt[None] if slot == 0 else h1
            else:
                x = entering[slot]
            jout, jc1 = jstage.stage_prefill(jcfg, jsp, jl_r, jnp.asarray(x),
                                             entries[slot], max_len=max_len)
            tout, tc1 = tstage.stage_prefill(cfg, tsp, tl_r, t(x),
                                             entries[slot], max_len=max_len)
            np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                       **MODEL)
            outs.append(np.asarray(jout))
            S = x.shape[1]
            jc1, jk, jv, _, _ = jstage.stage_absorb_dense_prefill(
                jcfg, jl_r, jc1, jk, jv, table, slot, S, page)
            tc1, tk, tv = tstage.stage_absorb_dense_prefill(
                cfg, tl_r, tc1, tk, tv, table, slot, S, page)
            assert_tree_equal(tc1, jc1)
            jcaches = jax.tree.map(lambda full, one: full.at[slot].set(one[0]),
                                   jcaches, jc1)
            for full, one in zip(tcaches, tc1):
                for key in full:
                    full[key][slot] = one[key][0]
        assert_pages_equal(tk, tv, jk, jv)
        entering = outs
        ent = np.asarray(entries, np.int32)
        tok = np.asarray([int(prompt[-1]), 0], np.int32)
        leaving = []
        for s in range(6):
            pos = lens + s
            jh, jlog, jcaches, jk, jv, _, _ = jstage.stage_decode_paged(
                jcfg, jsp, jl_r, jnp.asarray(tok), jnp.asarray(dec_h[s]),
                jnp.asarray(ent), jcaches, jnp.asarray(pos), jk, jv,
                jnp.asarray(table), interpret=True)
            th, tlog, tcaches, tk, tv = tstage.stage_decode_paged(
                cfg, tsp, tl_r, t(tok), t(dec_h[s]), t(ent), tcaches, t(pos),
                tk, tv, t(table))
            np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MODEL)
            leaving.append(np.asarray(jh))
            assert (tlog is None) == (jlog is None) == (b != 6)
            if jlog is not None:
                np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                           **MODEL)
        assert_pages_equal(tk, tv, jk, jv)
        assert_tree_equal(tcaches, jcaches)
        dec_h = leaving


# --- PagedEngine -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def ref_paged_engine(num_pages):
    """The reference ``PagedEngine``'s tokens and preemptions."""
    jcfg, jparams, _, _ = model()
    prompts, _ = reference()
    eng = jengine.PagedEngine(jcfg, jparams, JEC, num_pages=num_pages)
    reqs = [jengine.Request(i, p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    return [r.output for r in reqs], [r.preemptions for r in reqs]


@pytest.mark.parametrize("num_pages", [None, PREEMPT_PAGES],
                         ids=["rectangle", "preempting"])
def test_paged_engine_matches_reference(num_pages):
    """The port's ``PagedEngine`` on the hybrid stack: the reference
    ``PagedEngine``'s tokens and preemptions, the dense engine's tokens;
    with a pool that preempts, the recompute re-prefills the prompt and
    the tokens so far into the ring caches and the pages.  The pool
    drains."""
    _, _, cfg, params = model()
    prompts, ref = reference()
    eng = PagedEngine(cfg, params, EC, num_pages=num_pages, device="cpu")
    reqs = [Request(i, p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    jtokens, jpre = ref_paged_engine(num_pages)
    assert [r.output for r in reqs] == jtokens == ref
    assert [r.preemptions for r in reqs] == jpre
    assert (sum(jpre) > 0) == (num_pages is not None)
    assert eng.prefills == len(prompts) + sum(jpre)
    assert eng.pool.used == 0 and not eng.active.any()


# --- the paged cluster -------------------------------------------------------

@pytest.mark.parametrize("max_inflight", [1, 2], ids=["depth1", "depth2"])
@pytest.mark.parametrize("layout", list(PLANS))
def test_paged_cluster_matches_reference(layout, max_inflight):
    """The paged ``ClusterRuntime`` on 2- and 3-stage plans with 1 ms
    links: the reference engine's tokens, and the reference paged
    runtime's link ledger (the whole prompt in one hop per stage) and
    virtual-clock latencies; pools drained.  In ``3stage`` n0 = [0, 2)
    holds no global layer, so it gets a dense ``StageEngine``."""
    jcfg, _, cfg, params = model()
    prompts, ref = reference()
    rt, reqs = paged_serve(cfg, params, port_plan(cfg, PLANS[layout]),
                           prompts, max_inflight=max_inflight,
                           transport=InProcessTransport(default_delay_s=DELAY))
    assert [r.output for r in reqs] == ref
    assert_paged_drained(rt)
    jrt, jreqs = ref_paged_serve(jmake_plan(jcfg, PLANS[layout]), prompts,
                                 max_inflight=max_inflight,
                                 transport=JTransport(default_delay_s=DELAY))
    assert_same_run(rt, reqs, jrt, jreqs)
    assert engine_kinds(rt) == {n: type(e).__name__
                                for n, e in sorted(jrt.engines.items())}
    want = {"n0": "PagedStageEngine", "n1": "PagedStageEngine"}
    if layout == "3stage":
        want = {"n0": "StageEngine", "n1": "PagedStageEngine",
                "n2": "PagedStageEngine"}
    assert engine_kinds(rt) == want


@pytest.mark.parametrize("draft", ["target", "other-seed"])
def test_paged_speculation_matches_reference(draft):
    """A coordinator draft on the paged 2-stage plan, γ = 4: the target
    itself (the engine's tokens) and another seed's weights (proposals
    rejected: the ring caches keep the rejected tokens' K/V, as the
    reference's do): the reference runtime's tokens, ledger, latencies and
    spec counters."""
    jcfg, jparams, cfg, params = model()
    _, jdraft, _, tdraft = model(0 if draft == "target" else 1)
    prompts, ref = reference()
    rt, reqs = paged_serve(cfg, params, port_plan(cfg, PLANS["2stage"]),
                           prompts, draft_cfg=cfg, draft_params=tdraft,
                           spec_tokens=4,
                           transport=InProcessTransport(default_delay_s=DELAY))
    if draft == "target":
        assert [r.output for r in reqs] == ref and rt.spec_accepted > 0
    else:
        assert rt.spec_rejected > 0
    assert_paged_drained(rt)
    assert rt.draft.free_slots == EC.max_batch
    jrt, jreqs = ref_paged_serve(jmake_plan(jcfg, PLANS["2stage"]), prompts,
                                 draft_cfg=jcfg, draft_params=jdraft,
                                 spec_tokens=4,
                                 transport=JTransport(default_delay_s=DELAY))
    assert_same_run(rt, reqs, jrt, jreqs)
    for name in SPEC_COUNTERS:
        assert getattr(rt, name) == getattr(jrt, name), name


def test_paged_disaggregated_matches_reference():
    """One full-model prefill node and a paged 2-stage decode replica at
    depth 2: the handoff ships pages of the global layers and ring caches
    of the local ones; tokens, ledger and latencies as the reference's."""
    jcfg, _, cfg, params = model()
    prompts, ref = reference()
    rt, reqs = paged_serve(cfg, params, port_disagg_plan(cfg, *ONE_PREFILL),
                           prompts, max_inflight=2,
                           transport=InProcessTransport(default_delay_s=DELAY))
    assert [r.output for r in reqs] == ref
    assert rt.disaggregated
    assert_paged_drained(rt)
    assert set(engine_kinds(rt).values()) == {"PagedStageEngine"}
    jrt, jreqs = ref_paged_serve(jmake_disagg_plan(jcfg, *ONE_PREFILL),
                                 prompts, max_inflight=2,
                                 transport=JTransport(default_delay_s=DELAY))
    assert_same_run(rt, reqs, jrt, jreqs)


def test_mixed_export_kv_matches_reference():
    """A paged stage engine of the whole stack prefilled with a 40-token
    prompt: ``export_kv`` ships the global layers' live pages and the
    local layers' ring-cache rows, as the reference's (page ids as the
    reference's pool gives them; values within the bound of
    ``test_export_kv_of_ring_caches_matches_reference``); importing layers
    [3, 6) into a [3, 6) engine gives them back bit for bit."""
    jcfg, jparams, cfg, params = model()
    prompt = reference()[0][1]
    S = len(prompt)
    src = tse.PagedStageEngine(cfg, params, LayerRange(0, 6), EC,
                               device="cpu")
    jsrc = jse.PagedStageEngine(jcfg, jparams, JLayerRange(0, 6), JEC)
    slot, jslot = src.alloc_slot(0), jsrc.alloc_slot(0)
    assert src.ensure(slot, S + 1) and jsrc.ensure(jslot, S + 1)
    np.testing.assert_array_equal(src.pool.table, jsrc.pool.table)
    src.prefill_stage(slot, prompt, 0)
    jsrc.prefill_stage(jslot, prompt, 0)
    sent = src.export_kv(slot, S, list(range(6)))
    jsent = jsrc.export_kv(jslot, S, list(range(6)))
    assert sorted(sent) == sorted(jsent) == list(range(6))
    for layer in range(6):
        assert sorted(sent[layer]) == sorted(jsent[layer])
        assert sorted(sent[layer]) == (["k", "v"] if layer in (2, 5)
                                       else ["k", "pos", "v"])
        for key, got in sent[layer].items():
            want = np.asarray(jsent[layer][key])
            assert tuple(got.shape) == want.shape
            if want.dtype.kind in "iu":
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=1e-4,
                    atol=1e-5 + 3e-5 * np.abs(want).max())
    dst = tse.PagedStageEngine(cfg, params, LayerRange(3, 6), EC,
                               device="cpu")
    dslot = dst.alloc_slot(0)
    part = {l: sent[l] for l in range(3, 6)}
    dst.import_kv(dslot, S, part)
    back = dst.export_kv(dslot, S, list(range(3, 6)))
    assert all(torch.equal(back[l][k], part[l][k])
               for l in part for k in part[l])
    with pytest.raises(RuntimeError, match="prefill_stage"):
        src.prefill_chunk(slot, prompt[:16], 0, 0)


def test_paged_failover_replan_matches_reference():
    """n1 holds layers [3, 6) of the paged n0 -> n1 pipeline and n2 the
    whole model; n1 fails with requests in flight at depth 2, the
    survivors are replanned and the requests re-prefill single-shot: the
    reference's placement, preemptions, tokens, ledger and latencies."""
    jcfg, _, cfg, params = model()
    prompts, ref = reference()
    runs = []
    for serve_fn, p, replan, opt in (
            (lambda p: paged_serve(cfg, params, p, prompts, max_inflight=2,
                                   steps=8, transport=InProcessTransport(
                                       default_delay_s=DELAY)),
             port_plan(cfg, FAILOVER), replan_after_failure, MILPOptions),
            (lambda p: ref_paged_serve(p, prompts, max_inflight=2, steps=8,
                                       transport=JTransport(
                                           default_delay_s=DELAY)),
             jmake_plan(jcfg, FAILOVER), j_replan, JOpt)):
        rt, reqs = serve_fn(p)
        assert rt.jobs, "nothing in flight before the failure"
        occupancy = rt.node_occupancy()
        rt.fail_node("n1")
        new = replan(p, "n1", opt(**FAILOVER_OPT))
        rt.apply_plan(new)
        rt.run_until_done()
        assert all(r.done for r in reqs)
        runs.append((rt, reqs, new, occupancy))
    (rt, reqs, new, occ), (jrt, jreqs, jnew, jocc) = runs
    assert [r.output for r in reqs] == ref
    assert occ == jocc and any(v > 0 for v in occ.values())
    assert {n: (r.start, r.end) for n, r in new.placement.assignment.items()} \
        == {n: (r.start, r.end) for n, r in jnew.placement.assignment.items()}
    assert sum(r.preemptions for r in reqs) > 0
    assert_same_run(rt, reqs, jrt, jreqs)
    assert_paged_drained(rt)


# --- entry points ------------------------------------------------------------

@pytest.mark.parametrize("flags", [["--paged"],
                                   ["--cluster", "A100,L4", "--stages", "2"]],
                         ids=["paged", "cluster"])
def test_serve_main_serves_gemma3_paged(flags, monkeypatch, capsys):
    """``launch/serve.py --paged`` and ``--cluster`` without ``--dense``
    serve gemma3 SMOKE on the CPU (prompts of 40 tokens, past the window)
    and drain; their tokens equal those of a ``PagedEngine`` / paged
    ``ClusterRuntime`` built by hand on the same weights, prompts and
    plan."""
    argv = ["--arch", "gemma3_12b", "--smoke", "--device", "cpu",
            "--prompt", "40,9", "--new-tokens", "6"] + flags
    seen = {}
    for name in ("run_paged", "run_cluster"):
        orig = getattr(serve, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            seen[_name] = _orig(*a, **kw)
            return seen[_name]
        monkeypatch.setattr(serve, name, spy)
    serve.main(argv)
    out = capsys.readouterr().out
    args = serve.parse_args(argv)
    cfg = serve.build_config(args)
    params = tinit(cfg, args.seed, device="cpu")
    reqs = serve.make_requests(cfg, args)
    if "--paged" in flags:
        assert "pool drained" in out
        got = [r.output for r in seen["run_paged"][1]]
        eng = PagedEngine(cfg, params, serve.engine_config(args),
                          page_size=args.page_size, device="cpu")
    else:
        assert "pools drained on every node" in out
        rt, got_reqs, p, _ = seen["run_cluster"]
        got = [r.output for r in got_reqs]
        assert len(p.placement.assignment) == 2
        assert "PagedStageEngine" in engine_kinds(rt).values()
        eng = ClusterRuntime(cfg, params, p, serve.engine_config(args),
                             paged=True, device="cpu")
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert got == [r.output for r in reqs]
    assert all(len(o) == args.new_tokens for o in got)


def test_paged_cluster_over_thread_workers_matches_inprocess():
    """The paged 2-stage plan over two workers (``run_worker`` on threads
    of this process, dialing ``spawn_workers(connect=...)``) with direct
    links at depth 2: each worker builds the hybrid ``PagedStageEngine``
    and the tokens equal the in-process run's (the reference engine's:
    ``test_paged_cluster_matches_reference``); the remote pools drain."""
    _, _, cfg, params = model()
    prompts, ref = reference()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    errors = []

    def worker():
        for _ in range(600):
            try:
                run_worker("127.0.0.1", port, timeout_s=60.0, device="cpu")
                return
            except ConnectionRefusedError:
                time.sleep(0.05)    # the coordinator is not listening yet
            except BaseException as e:
                errors.append(e)
                return
        errors.append(RuntimeError("never connected"))

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(2)]
    for th in threads:
        th.start()
    rt = ClusterRuntime.spawn_workers(
        cfg, params, port_plan(cfg, PLANS["2stage"]), EC, paged=True,
        device="cpu", stall_timeout_s=120.0, worker_timeout_s=120.0,
        connect=f"127.0.0.1:{port}", direct_links=True, max_inflight=2)
    try:
        reqs = [Request(i, pr, max_new_tokens=NEW_TOKENS)
                for i, pr in enumerate(prompts)]
        for r in reqs:
            rt.submit(r)
        rt.run_until_done()
        assert [r.output for r in reqs] == ref
        # both remote engines hold a pool: the workers built paged ones
        assert rt.pool_pages_used() == {"n0": 0, "n1": 0}
        assert all(e.kv_tokens_used() == 0 for e in rt.engines.values())
    finally:
        rt.shutdown()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads) and not errors, errors
