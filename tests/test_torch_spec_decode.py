"""The port's speculative decoding against the JAX package (f32, CPU).

A coordinator-side draft model proposing γ tokens per verify pass must
leave the port's greedy tokens equal to the reference's non-speculative
tokens for any draft: a perfect draft (the target's own weights) and a bad
one (the reference's ``harness.draft_model(cfg, seed=7)``), dense and
paged targets, in-flight depth 1 and 2, with every pool and draft slot
drained.  On one case the reference's own runtime runs beside the port's
with the same plan and draft, and the speculation counters must be equal.
At the stage-engine level, a verify item (several tokens in one
``decode_stage`` call, batched with an ordinary item) and the rollback that
follows a rejection are held against the reference's stage engines.
"""
import dataclasses

import jax
import numpy as np
import pytest
from repro.core import LayerRange as JLayerRange
from repro.serving import stage_engine as jse
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import LayerRange
from repro_torch.serving import stage_engine as tse
from repro_torch.serving.engine import EngineConfig, Request
from repro_torch.serving.runtime import ClusterRuntime, InProcessTransport

from harness import (draft_model, make_plan as jmake_plan,
                     random_prompts, reference_outputs, serve_on_cluster)
from test_torch_runtime import EC, port_model, port_plan  # noqa: F401

SPEC_COUNTERS = ("spec_proposed", "spec_accepted", "spec_rejected",
                 "spec_rounds", "spec_confirmed")


@pytest.fixture(scope="module")
def bad_draft(gqa_model, port_model):
    """The reference's low-acceptance draft (same architecture, another
    init), and its weights carried into the port."""
    jdraft = draft_model(gqa_model[0], seed=7)
    return jdraft, params_from_jax(jax.tree.map(np.asarray, jdraft[1]),
                                   port_model[0], device="cpu")


def spec_serve(cfg, params, p, prompts, draft, gamma, *, max_new_tokens=6,
               **kw):
    rt = ClusterRuntime(cfg, params, p, EC, device="cpu", draft_cfg=cfg,
                        draft_params=draft, spec_tokens=gamma, **kw)
    if isinstance(max_new_tokens, int):
        max_new_tokens = [max_new_tokens] * len(prompts)
    reqs = [Request(i, pr, max_new_tokens=m)
            for i, (pr, m) in enumerate(zip(prompts, max_new_tokens))]
    for r in reqs:
        rt.submit(r)
    rt.run_until_done()
    assert all(r.done for r in reqs)
    return rt, reqs


def assert_drained(rt):
    """Every paged node's pool holds no page, every dense node's slots
    hold no token, and every draft slot is free."""
    assert all(u == 0 for u in rt.pool_pages_used().values())
    for e in rt.engines.values():
        assert e.free_slots == EC.max_batch and e.kv_tokens_used() == 0
    assert rt.draft.free_slots == EC.max_batch
    assert rt.draft.kv_tokens_used() == 0


@pytest.mark.parametrize("max_inflight", [1, 2], ids=["depth1", "depth2"])
@pytest.mark.parametrize("quality", ["perfect", "bad"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_matches_reference(port_model, reference, bad_draft, paged,
                                quality, max_inflight):
    cfg, params = port_model
    prompts, ref = reference
    p = port_plan(cfg, {"n0": (0, 2), "n1": (2, 4)})
    draft = params if quality == "perfect" else bad_draft[1]
    rt, reqs = spec_serve(cfg, params, p, prompts, draft, 4, paged=paged,
                          max_inflight=max_inflight)
    assert [r.output for r in reqs] == ref
    assert_drained(rt)
    assert rt.spec_rounds > 0 and rt.spec_proposed > 0
    if quality == "perfect":
        # the target's own weights: every draft accepted
        assert rt.spec_rejected == 0
        assert rt.spec_tokens_per_round_trip > 1.5
    else:
        # every draft rejected: one token per round trip, through the
        # rollback every round
        assert rt.spec_accepted == 0
        assert rt.spec_rejected == rt.spec_proposed
    assert "spec[" in rt.transport.describe()


def test_spec_three_stage_with_delay_counters_match_reference(
        gqa_model, port_model, reference, bad_draft):
    """3 uneven stages, a modelled link delay and an in-flight window with
    the bad draft at γ = 3: tokens equal to the reference's; the reference's
    own runtime on the same plan and draft gives the same speculation
    counters, cancellations and virtual-clock latency."""
    cfg, params = port_model
    prompts, ref = reference
    assignment = {"n0": (0, 2), "n1": (2, 3), "n2": (3, 4)}
    rt, reqs = spec_serve(cfg, params, port_plan(cfg, assignment), prompts,
                          bad_draft[1], 3, paged=True, max_inflight=2,
                          transport=InProcessTransport(default_delay_s=2e-3))
    assert [r.output for r in reqs] == ref
    assert_drained(rt)
    assert rt.spec_rejected > 0
    jcfg, jparams = gqa_model
    jdcfg, jdparams = bad_draft[0]
    from repro.serving import InProcessTransport as JTransport
    jrt, jreqs = serve_on_cluster(
        jcfg, jparams, jmake_plan(jcfg, assignment), prompts, paged=True,
        max_inflight=2, transport=JTransport(default_delay_s=2e-3),
        draft_cfg=jdcfg, draft_params=jdparams, spec_tokens=3)
    assert [r.output for r in jreqs] == ref
    for name in SPEC_COUNTERS + ("cancelled_inflight", "tokens_produced",
                                 "completed"):
        assert getattr(rt, name) == getattr(jrt, name), name
    assert rt.mean_decode_latency() == jrt.mean_decode_latency()
    assert rt.decode_latencies == jrt.decode_latencies
    assert dict(rt.transport.transfers) == dict(jrt.transport.transfers)


def test_spec_early_eos_mid_window(gqa_model, port_model):
    """max_new_tokens reached inside the accepted prefix: the request
    completes from the partial window without a rollback, releasing slots
    (the draft's included) and pages everywhere."""
    jcfg, jparams = gqa_model
    cfg, params = port_model
    prompts = random_prompts(jcfg, (10, 5, 16, 12), seed=0)
    lens = [1, 2, 3, 6]
    ref = reference_outputs(jcfg, jparams, prompts, max_new_tokens=lens)
    rt, reqs = spec_serve(cfg, params,
                          port_plan(cfg, {"n0": (0, 2), "n1": (2, 4)}),
                          prompts, params, 4, paged=True,
                          max_new_tokens=lens)
    assert [r.output for r in reqs] == ref
    assert [r.finish_reason for r in reqs] == ["length"] * 4
    assert_drained(rt)


def test_verify_item_and_rollback_match_reference(gqa_model, port_model):
    """Two paged stage engines split at layer 2: a verify item of 4 tokens
    batched with an ordinary one-token item of another request gives (4,V)
    and (V,) logits (and (4,1,d) / (1,1,d) activations between the
    stages) equal to the reference's; a rollback to 2 kept tokens leaves
    the pool's tables and free list equal to the reference's, and the next
    decode at the kept frontier gives the reference's logits."""
    jcfg, jparams = gqa_model
    cfg, params = port_model
    spec = dict(max_batch=2, max_len=32, prompt_len=16)
    prompts = random_prompts(jcfg, (6, 9), seed=5)
    P = [len(x) for x in prompts]

    def engines(mod, c, prm, ec, rng, **kw):
        return [mod.PagedStageEngine(c, prm, rng(a, b), ec, page_size=4,
                                     **kw) for a, b in ((0, 2), (2, 4))]

    port = engines(tse, cfg, params, EngineConfig(**spec), LayerRange,
                   device="cpu")
    ref = engines(jse, jcfg, jparams, JEngineConfig(**spec), JLayerRange)

    def run(engs, item_cls, as_h):
        slots = []
        for rid, pr in enumerate(prompts):
            x = pr
            for e in engs:
                slot = e.alloc_slot(rid)
                assert e.ensure(slot, len(pr) + 4)
                x = e.prefill_chunk(slot, x, e.layers.start, 0)
            slots.append(slot)
        items = [item_cls(slot=slots[0], pos=P[0], entry=0,
                          tokens=[7, 11, 13, 17]),
                 item_cls(slot=slots[1], pos=P[1], entry=0, token=5)]
        mid = engs[0].decode_stage(items)
        hs = [o.h for o in mid]
        outs = engs[1].decode_stage(
            [item_cls(slot=it.slot, pos=it.pos, entry=2, h=as_h(o.h))
             for it, o in zip(items, mid)])
        for e in engs:
            e.rollback(slots[0], P[0] + 2)
        after = []
        for e in engs:
            x = e.decode_stage([item_cls(slot=slots[0], pos=P[0] + 2,
                                         entry=e.layers.start, token=19,
                                         h=None if not after else
                                         as_h(after[-1].h))])[0]
            after.append(x)
        return hs, [o.logits for o in outs], after[-1].logits

    hs, logits, nxt = run(port, tse.DecodeItem, lambda h: h)
    jhs, jlogits, jnxt = run(ref, jse.DecodeItem, np.asarray)
    assert [tuple(h.shape) for h in hs] == [(4, 1, cfg.d_model),
                                            (1, 1, cfg.d_model)]
    assert [x.shape for x in logits] == [(4, cfg.vocab_size),
                                         (cfg.vocab_size,)]
    for a, b in zip([h.numpy() for h in hs] + logits + [nxt],
                    jhs + jlogits + [jnxt]):
        # f32 in another summation order: the error scales with the
        # activations' magnitude (hundreds here)
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-5 + 1e-6 * np.abs(b).max())
    for e, je in zip(port, ref):
        assert e.kv_tokens_used() == je.kv_tokens_used()
        np.testing.assert_array_equal(e.pool.table, je.pool.table)
        np.testing.assert_array_equal(e.pool._free[:e.pool._free_top],
                                      je.pool._free[:je.pool._free_top])
        assert e.decode_steps == 4 + 1     # one step per verify sub-step


def test_spec_refusals(port_model):
    """Sampled requests are refused on a runtime with a draft, and so is a
    draft whose vocabulary differs from the target's."""
    cfg, params = port_model
    p = port_plan(cfg, {"n0": (0, 2), "n1": (2, 4)})
    rt = ClusterRuntime(cfg, params, p, EC, device="cpu", draft_cfg=cfg,
                        draft_params=params)
    with pytest.raises(ValueError, match="temperature"):
        rt.submit(Request(0, np.arange(5), max_new_tokens=2,
                          temperature=0.7))
    small = dataclasses.replace(cfg, vocab_size=cfg.vocab_size // 2)
    with pytest.raises(ValueError, match="vocab"):
        ClusterRuntime(cfg, params, p, EC, device="cpu", draft_cfg=small,
                       draft_params=params)
    with pytest.raises(ValueError, match="spec_tokens"):
        ClusterRuntime(cfg, params, p, EC, device="cpu", draft_cfg=cfg,
                       draft_params=params, spec_tokens=0)
