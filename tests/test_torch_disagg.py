"""The port's disaggregated prefill/decode serving and node failover
against the JAX package (f32, CPU).

Disaggregated placements (``disaggregated_placement``: prefill and decode
replica groups, a node in both is ``mixed``) run prompt passes on the
prefill group and decode passes on the decode group, with the filled KV
handed over between them.  Every serving case runs the reference's
``ClusterRuntime`` beside the port's on the same plan and link delays:
greedy tokens equal the ``reference`` fixture, and the link ledger, the
counters and the virtual-clock latency equal the reference runtime's.
Failover (``fail_node``, ``replan_after_failure``, ``apply_plan``) must
re-prefill the requests in flight and keep their tokens.  Below the
runtime: compiled routes against the reference's, and ``export_kv`` /
``import_kv`` on both stage engines (byte-exact round trip, snapshot
semantics, values against the reference's export).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import (LayerRange as JLayerRange, MILPOptions as JOpt,
                        replan_after_failure as j_replan)
from repro.serving import ClusterRuntime as JClusterRuntime
from repro.serving import InProcessTransport as JTransport
from repro.serving import stage_engine as jse
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.runtime import _Job as JJob
from repro_torch.core import (LayerRange, MILPOptions, ModelProfile,
                              disaggregated_placement, plan,
                              replan_after_failure)
from repro_torch.core.cluster import full_mesh_cluster
from repro_torch.serving import stage_engine as tse
from repro_torch.serving.engine import EngineConfig, Request
from repro_torch.serving.runtime import (ClusterRuntime, InProcessTransport,
                                         _Job)

from harness import (make_disagg_plan as jmake_disagg_plan,
                     make_plan as jmake_plan, random_prompts,
                     serve_on_cluster)
from test_torch_runtime import EC, port_model, port_plan  # noqa: F401

DELAY = 1e-3
FAILOVER_OPT = dict(time_limit_s=5.0, lns_rounds=0, fgls_rounds=10)
SPEC_COUNTERS = ("spec_proposed", "spec_accepted", "spec_rejected",
                 "spec_rounds", "spec_confirmed")
ONE_PREFILL = ({"n0": (0, 4)}, {"n1": (0, 2), "n2": (2, 4)})
MIXED = ({"n0": (0, 2), "n1": (2, 4)}, {"n2": (0, 2), "n1": (2, 4)})


def port_disagg_plan(cfg, prefill, decode):
    """The port's counterpart of ``harness.make_disagg_plan``: the copied
    ``disaggregated_placement`` on a full-mesh A100 cluster (10 Gb/s, 1
    ms links), planned by the copied core."""
    placement = disaggregated_placement(
        {n: LayerRange(*r) for n, r in prefill.items()},
        {n: LayerRange(*r) for n, r in decode.items()}, cfg.num_layers)
    profile = ModelProfile.from_dims(
        cfg.name, cfg.num_layers, cfg.d_model, max(cfg.d_ff, 1),
        cfg.vocab_size, cfg.num_kv_heads, cfg.resolved_head_dim)
    cluster = full_mesh_cluster(len(placement.assignment),
                                bandwidth=10e9 / 8, latency_s=1e-3)
    return plan(cluster, profile, placement=placement)


def port_serve(cfg, params, p, prompts, *, steps=None, **kw):
    rt = ClusterRuntime(cfg, params, p, EC, device="cpu", **kw)
    reqs = [Request(i, pr, max_new_tokens=6) for i, pr in enumerate(prompts)]
    for r in reqs:
        rt.submit(r)
    if steps is None:
        rt.run_until_done()
    else:
        for _ in range(steps):
            rt.step()
    return rt, reqs


def assert_same_run(rt, reqs, jrt, jreqs):
    """Equal tokens, link ledger, counters and virtual-clock latency."""
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert dict(rt.transport.transfers) == dict(jrt.transport.transfers)
    assert dict(rt.transport.bytes_sent) == dict(jrt.transport.bytes_sent)
    for name in ("completed", "cancelled_inflight", "tokens_produced"):
        assert getattr(rt, name) == getattr(jrt, name), name
    assert [r.preemptions for r in reqs] == [r.preemptions for r in jreqs]
    assert rt.decode_latencies == jrt.decode_latencies
    assert rt.mean_decode_latency() == jrt.mean_decode_latency()


def assert_drained(rt):
    """No page held on a paged node, no slot or token on a dense one."""
    assert all(u == 0 for u in rt.pool_pages_used().values())
    for e in rt.engines.values():
        assert e.free_slots == EC.max_batch and e.kv_tokens_used() == 0


@pytest.mark.parametrize("max_inflight", [1, 2], ids=["depth1", "depth2"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_disaggregated_matches_reference(gqa_model, port_model, reference,
                                         paged, max_inflight):
    """One prefill node holding the whole model, a 2-stage decode
    replica: prompts run on n0, the KV ships to n1 and n2, decode runs
    only there."""
    jcfg, jparams = gqa_model
    cfg, params = port_model
    prompts, ref = reference
    rt, reqs = port_serve(cfg, params, port_disagg_plan(cfg, *ONE_PREFILL),
                          prompts, paged=paged, max_inflight=max_inflight,
                          transport=InProcessTransport(default_delay_s=DELAY))
    assert [r.output for r in reqs] == ref
    assert rt.disaggregated
    assert_drained(rt)
    tr = rt.transport
    assert tr.transfers[("n0", "n1")] >= len(prompts)
    assert tr.transfers[("n0", "n2")] >= len(prompts)
    for pipe in rt.served.values():
        assert {st.node for st in pipe.stages} <= {"n1", "n2"}
    jrt, jreqs = serve_on_cluster(
        jcfg, jparams, jmake_disagg_plan(jcfg, *ONE_PREFILL), prompts,
        paged=paged, max_inflight=max_inflight,
        transport=JTransport(default_delay_s=DELAY))
    assert_same_run(rt, reqs, jrt, jreqs)
    # every handoff moved the prompt's KV of two layers: the profile's
    # bytes, not the payload's size
    kv = rt.profile.kv_bytes_per_token_layer
    assert tr.bytes_sent[("n0", "n1")] == sum(kv * len(x) * 2
                                              for x in prompts)


def test_disaggregated_mixed_node_keeps_kv_home(gqa_model, port_model,
                                                reference):
    """n1 plays both parts (``mixed``): only n0's layers ship to n2, and
    n1's peer traffic to n2 is tokens only."""
    jcfg, jparams = gqa_model
    cfg, params = port_model
    prompts, ref = reference
    p = port_disagg_plan(cfg, *MIXED)
    assert p.placement.meta["roles"] == {"n0": "prefill", "n1": "mixed",
                                         "n2": "decode"}
    rt, reqs = port_serve(cfg, params, p, prompts, max_inflight=2,
                          transport=InProcessTransport(default_delay_s=DELAY))
    assert [r.output for r in reqs] == ref
    assert_drained(rt)
    tr = rt.transport
    assert tr.transfers[("n0", "n2")] >= len(prompts)
    assert tr.bytes_sent[("n1", "n2")] == \
        tr.transfers[("n1", "n2")] * rt.profile.token_bytes
    jrt, jreqs = serve_on_cluster(
        jcfg, jparams, jmake_disagg_plan(jcfg, *MIXED), prompts, paged=True,
        max_inflight=2, transport=JTransport(default_delay_s=DELAY))
    assert jrt.placement.meta["roles"] == p.placement.meta["roles"]
    assert_same_run(rt, reqs, jrt, jreqs)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_disaggregated(gqa_model, port_model, reference, paged):
    """A perfect draft (the target's own weights) on the disaggregated
    plan: verify passes wait for the handoff like any decode launch."""
    jcfg, jparams = gqa_model
    cfg, params = port_model
    prompts, ref = reference
    rt, reqs = port_serve(cfg, params, port_disagg_plan(cfg, *ONE_PREFILL),
                          prompts, paged=paged, draft_cfg=cfg,
                          draft_params=params, spec_tokens=4)
    assert [r.output for r in reqs] == ref
    assert_drained(rt)
    assert rt.draft.free_slots == EC.max_batch
    assert rt.spec_rounds > 0
    jrt, jreqs = serve_on_cluster(
        jcfg, jparams, jmake_disagg_plan(jcfg, *ONE_PREFILL), prompts,
        paged=paged, draft_cfg=jcfg, draft_params=jparams, spec_tokens=4)
    assert_same_run(rt, reqs, jrt, jreqs)
    for name in SPEC_COUNTERS:
        assert getattr(rt, name) == getattr(jrt, name), name


def _failover(gqa_model, port_model, reference, first, decode, steps,
              delay):
    """Kill n1 with requests in flight at depth 2, replan on the survivors
    and adopt the plan: the requests re-prefill (keeping their tokens) and
    finish with the reference's tokens; the reference's runtime, failed
    at the same step, shows the same ``node_occupancy`` before the
    failure, preempts as often and adopts the same placement.  Returns
    the port's runtime."""
    jcfg, jparams = gqa_model
    cfg, params = port_model
    prompts, ref = reference
    if decode is None:
        p, jp = port_plan(cfg, first), jmake_plan(jcfg, first)
    else:
        p = port_disagg_plan(cfg, first, decode)
        jp = jmake_disagg_plan(jcfg, first, decode)
    runs = []
    for serve, mk, replan, opt in (
            (lambda: port_serve(cfg, params, p, prompts, max_inflight=2,
                                steps=steps, transport=InProcessTransport(
                                    default_delay_s=delay)),
             p, replan_after_failure, MILPOptions),
            (lambda: serve_on_cluster(jcfg, jparams, jp, prompts,
                                      paged=True, max_inflight=2,
                                      steps=steps, transport=JTransport(
                                          default_delay_s=delay)),
             jp, j_replan, JOpt)):
        rt, reqs = serve()
        assert rt.jobs, "nothing in flight before the failure"
        occupancy = rt.node_occupancy()
        rt.fail_node("n1")
        assert "n1" not in rt.engines
        new = replan(mk, "n1", opt(**FAILOVER_OPT))
        rt.apply_plan(new)
        rt.run_until_done()
        assert all(r.done for r in reqs)
        runs.append((rt, reqs, new, occupancy))
    (rt, reqs, new, occ), (jrt, jreqs, jnew, jocc) = runs
    assert [r.output for r in reqs] == ref
    # mid-run KV occupancy, per node
    assert occ == jocc and any(v > 0 for v in occ.values())
    assert {n: (r.start, r.end) for n, r in new.placement.assignment.items()} \
        == {n: (r.start, r.end) for n, r in jnew.placement.assignment.items()}
    assert rt.disaggregated == jrt.disaggregated
    assert sorted(rt.engines) == sorted(jrt.engines)
    assert sum(r.preemptions for r in reqs) > 0
    assert_same_run(rt, reqs, jrt, jreqs)
    assert_drained(rt)
    return rt


def test_failover_replan_re_prefills_in_flight(gqa_model, port_model,
                                               reference):
    """A plain placement (ref tests/test_runtime.py:371): n1 holds layers
    [2, 4) of the n0 -> n1 pipeline, n2 the whole model."""
    rt = _failover(gqa_model, port_model, reference,
                   {"n0": (0, 2), "n1": (2, 4), "n2": (0, 4)}, None, 6, 0.0)
    assert not rt.disaggregated


def test_disaggregated_failover_replans_to_mixed(gqa_model, port_model,
                                                 reference):
    """A decode node of a disaggregated placement fails (ref
    tests/test_runtime.py:228): the generic replan is role-less, so the
    runtime serves mixed from then on."""
    rt = _failover(gqa_model, port_model, reference, {"n0": (0, 4)},
                   {"n1": (0, 2), "n2": (2, 4), "n3": (0, 4)}, 8, DELAY)
    assert not rt.disaggregated and "roles" not in rt.placement.meta


# --- routes -------------------------------------------------------------------

ROUTES = {
    "one-prefill": ONE_PREFILL,
    "mixed": MIXED,
    "uneven": ({"n0": (0, 3), "n1": (3, 4)}, {"n2": (0, 1), "n3": (1, 4)}),
    "replicas": ({"n0": (0, 4), "n1": (0, 4)},
                 {"n2": (0, 4), "n3": (0, 2), "n4": (2, 4)}),
    "mixed-uneven": ({"n0": (0, 1), "n1": (1, 4)},
                     {"n0": (0, 1), "n2": (1, 2), "n3": (2, 4)}),
}


def _route_key(route):
    def stages(pipe):
        return [(st.node, st.layers.start, st.layers.end)
                for st in pipe.stages]
    return (stages(route.prefill), stages(route.decode),
            {si: [(d, list(ls)) for d, ls in hs]
             for si, hs in route.handoffs.items()}, route.disaggregated)


@pytest.mark.parametrize("case", list(ROUTES))
def test_routes_match_reference(gqa_model, port_model, case):
    """Six routes compiled in a row (the schedulers' IWRR state carries
    over) equal the reference's: prefill and decode stages by node and
    range, and the handoffs."""
    cfg, _ = port_model
    p = port_disagg_plan(cfg, *ROUTES[case])
    jp = jmake_disagg_plan(gqa_model[0], *ROUTES[case])
    rt = ClusterRuntime.__new__(ClusterRuntime)
    rt._build_role_schedulers(p)
    jrt = JClusterRuntime.__new__(JClusterRuntime)
    jrt._build_role_schedulers(jp)
    assert rt.disaggregated and jrt.disaggregated
    for i in range(6):
        job, jjob = _Job(req=None), JJob(req=None)
        rt._compile_route(job)
        jrt._compile_route(jjob)
        assert _route_key(job.route) == _route_key(jjob.route)
        assert job.pipe is job.route.decode


def test_role_group_must_cover_the_model(gqa_model, port_model):
    """Roles whose decode group leaves layers uncovered are refused with
    the reference's message."""
    cfg, params = port_model
    roles = {"n0": "prefill", "n1": "decode"}
    p = port_plan(cfg, {"n0": (0, 4), "n1": (0, 2)})
    p.placement.meta["roles"] = roles
    jp = jmake_plan(gqa_model[0], {"n0": (0, 4), "n1": (0, 2)})
    jp.placement.meta["roles"] = roles
    with pytest.raises(ValueError, match="does not cover") as err:
        ClusterRuntime(cfg, params, p, EC, device="cpu")
    with pytest.raises(ValueError) as jerr:
        JClusterRuntime(gqa_model[0], gqa_model[1], jp, JEngineConfig(
            **dataclasses.asdict(EC)))
    assert str(err.value) == str(jerr.value)


# --- export_kv / import_kv ------------------------------------------------------

HANDOFF_EC = dict(max_batch=2, max_len=32, prompt_len=16)


def _engines(mod, cfg, params, rng_cls, paged, **kw):
    """A 4-layer engine (the prefill side) and a [1, 3) engine (a decode
    node's slice), paged with page 4, or dense."""
    ec = (EngineConfig if mod is tse else JEngineConfig)(**HANDOFF_EC)
    if paged:
        return [mod.PagedStageEngine(cfg, params, rng_cls(a, b), ec,
                                     page_size=4, **kw)
                for a, b in ((0, 4), (1, 3))]
    return [mod.StageEngine(cfg, params, rng_cls(a, b), ec, **kw)
            for a, b in ((0, 4), (1, 3))]


def _prefill(eng, slot, prompt, paged):
    """The whole prompt through ``eng``: single-shot (dense) or in
    16-token chunks (paged)."""
    if not paged:
        return eng.prefill_stage(slot, prompt, 0)
    assert eng.ensure(slot, len(prompt))
    for off in range(0, len(prompt), 16):
        eng.prefill_chunk(slot, prompt[off:off + 16], 0, off)


def _snapshot(payload):
    return {l: {k: t.clone() for k, t in p.items()}
            for l, p in payload.items()}


def _equal(a, b):
    return a.keys() == b.keys() and all(
        a[l].keys() == b[l].keys() and
        all(torch.equal(a[l][k], b[l][k]) for k in a[l]) for l in a)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_export_import_kv(gqa_model, port_model, paged):
    """(1) Export layers 1-2 of a prefilled slot, import them into slot 1
    of a [1, 3) engine and export again: byte-exact.  (2) The export is a
    snapshot: releasing the source slot and prefilling another prompt into
    it leaves the payload unchanged.  (3) The export equals the
    reference's export after the same prefill (f32, other summation
    order: atol 1e-5 + 1e-6 x max|ref|)."""
    jcfg, jparams = gqa_model
    cfg, params = port_model
    prompts = random_prompts(jcfg, (21, 9), seed=11)
    src, dst = _engines(tse, cfg, params, LayerRange, paged, device="cpu")
    S = len(prompts[0])
    slot = src.alloc_slot(0)
    _prefill(src, slot, prompts[0], paged)
    sent = src.export_kv(slot, S, [1, 2])
    assert sorted(sent) == [1, 2]
    kept = _snapshot(sent)
    assert dst.alloc_slot(7) == 0            # import into another slot id
    dslot = dst.alloc_slot(0)
    assert dslot == 1
    if paged:
        assert dst.ensure(dslot, S + 1)
    dst.import_kv(dslot, S, sent)
    assert _equal(dst.export_kv(dslot, S, [1, 2]), sent)
    assert dst.kv_tokens_used() == (
        dst.pool.tokens_used if paged else S)
    src.release(slot)
    assert src.alloc_slot(1) == slot
    _prefill(src, slot, prompts[1], paged)
    assert not _equal(src.export_kv(slot, S, [1, 2]), kept)
    assert _equal(sent, kept)

    jsrc = _engines(jse, jcfg, jparams, JLayerRange, paged)[0]
    jslot = jsrc.alloc_slot(0)
    _prefill(jsrc, jslot, prompts[0], paged)
    jsent = jsrc.export_kv(jslot, S, [1, 2])
    for l in (1, 2):
        assert sorted(jsent[l]) == sorted(kept[l])
        for key, t in kept[l].items():
            b = np.asarray(jsent[l][key])
            if b.dtype.kind in "iu":
                np.testing.assert_array_equal(t.numpy(), b)
            else:
                np.testing.assert_allclose(
                    t.numpy(), b, rtol=1e-4,
                    atol=1e-5 + 1e-6 * np.abs(b).max())


def test_import_kv_raises_when_the_pool_is_full(port_model):
    """A paged import that cannot get its pages raises."""
    cfg, params = port_model
    src = _engines(tse, cfg, params, LayerRange, True, device="cpu")[0]
    slot = src.alloc_slot(0)
    _prefill(src, slot, np.arange(20) % cfg.vocab_size, True)
    sent = src.export_kv(slot, 20, [1, 2])
    # room for one full request (8 blocks x 2 layers + scratch), taken
    small = tse.PagedStageEngine(cfg, params, LayerRange(1, 3),
                                 EngineConfig(**HANDOFF_EC), page_size=4,
                                 num_pages=1 + 8 * 2, device="cpu")
    assert small.ensure(small.alloc_slot(0), 32)
    with pytest.raises(RuntimeError, match="cannot hold 20 tokens"):
        small.import_kv(small.alloc_slot(1), 20, sent)
