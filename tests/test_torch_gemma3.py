"""gemma3 (five local layers of window W to each global layer) on the
port's dense paths against the JAX package (f32, CPU, SMOKE size: 6
layers, window 16, head_dim 16).

The reference's weights (JAX ``init``) go to the port through
``convert.params_from_jax``; prompts run past the window, so prefill
drops keys and decode wraps the local layers' ring caches.  Tolerances:
logits, activations and K/V atol = rtol = 1e-4 (a few layers of f32
matmuls summed in another order); cache positions, greedy tokens, the
per-link ledger, counters and virtual-clock latencies exactly equal.
Every serving case runs the reference's runtime beside the port's on the
same plan and links.  The paged paths of a hybrid stack are ROADMAP queue
1 item 7 (c2): each paged entry point raises naming it.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.core import MILPOptions as JOpt
from repro.core import LayerRange as JLayerRange
from repro.core import replan_after_failure as j_replan
from repro.models import attention as jattn
from repro.models import init as jinit
from repro.models import model as jmodel
from repro.serving import InProcessTransport as JTransport
from repro.serving import stage_engine as jse
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import LayerRange, MILPOptions, replan_after_failure
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models import stage as tstage
from repro_torch.serving import stage_engine as tse
from repro_torch.serving.engine import (Engine, EngineConfig, PagedEngine,
                                        Request)
from repro_torch.serving.runtime import ClusterRuntime, InProcessTransport

from harness import (f32, make_disagg_plan as jmake_disagg_plan,
                     make_plan as jmake_plan, random_prompts,
                     reference_outputs, serve_on_cluster)
from test_torch_disagg import port_disagg_plan
from test_torch_runtime import port_plan

ARCH = "gemma3_12b"
MODEL = dict(atol=1e-4, rtol=1e-4)
# prompts of 5 tokens (decode runs past the 16-slot rings) and of 40 (the
# dense Engine's bucket; prefill drops keys), 12 new tokens each; two
# lengths, since each length compiles the reference's prefill anew
JEC = JEngineConfig(max_batch=4, max_len=56, prompt_len=40)
EC = EngineConfig(**dataclasses.asdict(JEC))
PROMPT_LENS = (5, 40, 5, 40)
NEW_TOKENS = 12
DELAY = 1e-3
PLANS = {"2stage": {"n0": (0, 3), "n1": (3, 6)},
         "3stage": {"n0": (0, 2), "n1": (2, 4), "n2": (4, 6)}}
ONE_PREFILL = ({"n0": (0, 6)}, {"n1": (0, 3), "n2": (3, 6)})
FAILOVER = {"n0": (0, 3), "n1": (3, 6), "n2": (0, 6)}
FAILOVER_OPT = dict(time_limit_s=5.0, lns_rounds=0, fgls_rounds=10)
SPEC_COUNTERS = ("spec_proposed", "spec_accepted", "spec_rejected",
                 "spec_rounds", "spec_confirmed")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """SMOKE ops are tiny: more intra-op threads only add overhead."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def model(seed=0):
    """(reference cfg, reference params, port cfg, port params), f32, the
    port's params converted from the reference's; built once per seed."""
    jcfg = f32(jget_smoke_config(ARCH))
    jparams = jinit(jcfg, jax.random.key(seed))
    cfg = f32(get_smoke_config(ARCH))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jcfg, jparams, cfg, params


@functools.lru_cache(maxsize=None)
def reference():
    """Prompts past the window and the reference's greedy tokens from its
    dense ``Engine``, the anchor of every serving path."""
    jcfg, jparams, _, _ = model()
    prompts = random_prompts(jcfg, PROMPT_LENS, seed=0)
    return prompts, reference_outputs(jcfg, jparams, prompts, ec=JEC,
                                      max_new_tokens=NEW_TOKENS)


def t(a):
    return torch.from_numpy(np.array(a))


def port_serve(cfg, params, p, prompts, *, steps=None, **kw):
    rt = ClusterRuntime(cfg, params, p, EC, paged=False, device="cpu", **kw)
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


def ref_serve(p, prompts, **kw):
    jcfg, jparams, _, _ = model()
    return serve_on_cluster(jcfg, jparams, p, prompts, paged=False, ec=JEC,
                            max_new_tokens=NEW_TOKENS, **kw)


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
    for e in rt.engines.values():
        assert e.free_slots == EC.max_batch and e.kv_tokens_used() == 0


# --- the model ---------------------------------------------------------------

def test_stack_is_hybrid_and_windowed():
    """SMOKE keeps the full config's shape: local layers of a window and
    full layers, so prompts of 17-40 tokens cross the window."""
    _, _, cfg, _ = model()
    assert [b.attn for b in cfg.blocks] == ["local", "local", "full"] * 2
    assert {tmodel._window(b) for b in cfg.blocks} == {0, 16}
    assert max(PROMPT_LENS) + NEW_TOKENS > 16


def test_forward_logits_match_reference():
    jcfg, jparams, cfg, params = model()
    tokens = np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 40))
    want, _ = jmodel.forward(jcfg, jparams, jnp.asarray(tokens))
    got = tmodel.forward(cfg, params, t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)


def assert_cache_equal(tc, jc):
    """K/V to the model tolerance, positions exactly."""
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **MODEL)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), **MODEL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("window", [5, 16])
def test_windowed_gqa_decode_matches_reference(window):
    """A local layer: prefill of 11 tokens into a ring of ``window`` slots
    (max_len 24), then 8 decode steps past the ring's end, the two batch
    rows at different positions: out, K/V and slot positions each step."""
    jcfg, jparams, cfg, params = model()
    jp = jax.tree.map(lambda a: a[0], jparams["super"]["pos0"]["mix"])
    tp = {k: v[0] for k, v in params["super"]["pos0"]["mix"].items()}
    block = cfg.pattern[0]
    jblock = jcfg.pattern[0]
    rng = np.random.RandomState(window)
    B, S, max_len = 2, 11, 24
    x = rng.randn(B, S, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jo, jraw = jattn.gqa_prefill(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                 window=window)
    to, traw = tattn.gqa_prefill(cfg, tp, t(x), t(pos), window=window)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **MODEL)
    jb = dataclasses.replace(jblock, window=window)
    tb = dataclasses.replace(block, window=window)
    jc = jmodel.fill_prefill_cache(jcfg, jb, jraw, B, S, max_len, jnp.float32)
    tc = tmodel.fill_prefill_cache(cfg, tb, traw, B, S, max_len,
                                   torch.float32)
    assert tc["k"].shape[1] == min(window, max_len)
    assert_cache_equal(tc, jc)
    jdecode = jax.jit(functools.partial(jattn.gqa_decode, jcfg,
                                        window=window))
    for step in range(8):
        xd = rng.randn(B, 1, cfg.d_model).astype(np.float32)
        cp = np.asarray([S + step, S + step - 3], np.int32)
        jo, jc = jdecode(jp, jnp.asarray(xd), jc, jnp.asarray(cp))
        to, tc = tattn.gqa_decode(cfg, tp, t(xd), tc, t(cp), window=window)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **MODEL)
        assert_cache_equal(tc, jc)
    assert int(tc["pos"][0].max()) == S + 7 > window


def test_prefill_then_decode_matches_reference():
    """Whole-model prefill of 20 tokens (past the window), then 6 decode
    steps: each step's logits equal the reference's and the port's own
    forward at that position."""
    jcfg, jparams, cfg, params = model()
    tokens = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 26))
    full = tmodel.forward(cfg, params, t(tokens))
    jl, jcaches = jmodel.prefill(jcfg, jparams, jnp.asarray(tokens[:, :20]),
                                 max_len=40)
    tl, tcaches = tmodel.prefill(cfg, params, t(tokens[:, :20]), max_len=40)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL)
    np.testing.assert_allclose(tl.numpy(), full[:, 19].numpy(), **MODEL)
    jdecode = jax.jit(functools.partial(jmodel.decode_step, jcfg))
    for s in range(20, 26):
        jl, jcaches = jdecode(jparams, jnp.asarray(tokens[:, s]), jcaches,
                              jnp.full((2,), s, jnp.int32))
        tl, tcaches = tmodel.decode_step(
            cfg, params, t(tokens[:, s]), tcaches,
            torch.full((2,), s, dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL)
        np.testing.assert_allclose(tl.numpy(), full[:, s].numpy(), **MODEL)


# --- serving -----------------------------------------------------------------

def test_engine_matches_reference_tokens():
    """The dense ``Engine`` gives the reference engine's greedy tokens for
    prompts of 5 and 40 tokens, and ends with no slot active."""
    _, _, cfg, params = model()
    prompts, ref = reference()
    eng = Engine(cfg, params, EC, device="cpu")
    reqs = [Request(i, p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert [r.output for r in reqs] == ref
    assert not eng.active.any()


@pytest.mark.parametrize("max_inflight", [1, 2], ids=["depth1", "depth2"])
@pytest.mark.parametrize("layout", list(PLANS))
def test_dense_cluster_matches_reference(layout, max_inflight):
    """The dense ``ClusterRuntime`` on 2- and 3-stage plans with 1 ms
    links: the reference engine's tokens, and the reference runtime's
    link ledger and virtual-clock decode latencies; slots released."""
    _, _, cfg, params = model()
    prompts, ref = reference()
    rt, reqs = port_serve(cfg, params, port_plan(cfg, PLANS[layout]),
                          prompts, max_inflight=max_inflight,
                          transport=InProcessTransport(default_delay_s=DELAY))
    assert [r.output for r in reqs] == ref
    assert_drained(rt)
    jrt, jreqs = ref_serve(jmake_plan(model()[0], PLANS[layout]), prompts,
                           max_inflight=max_inflight,
                           transport=JTransport(default_delay_s=DELAY))
    assert_same_run(rt, reqs, jrt, jreqs)


@pytest.mark.parametrize("draft", ["target", "other-seed"])
def test_speculation_matches_reference(draft):
    """A coordinator draft on the 2-stage plan, γ = 4: the target itself
    (every proposal accepted: the reference engine's tokens) and the
    target's config at another seed (proposals rejected): the reference
    runtime's tokens, ledger, latencies and spec counters.  With rejected
    proposals the reference runtime itself departs from its engine's
    tokens: a rejected token's K/V was written into a ring slot that a key
    still inside the window held, and the reference's dense ``rollback``
    is bookkeeping only.  The port does as the reference does."""
    jcfg, jparams, cfg, params = model()
    _, jdraft, _, tdraft = model(0 if draft == "target" else 1)
    prompts, ref = reference()
    rt, reqs = port_serve(cfg, params, port_plan(cfg, PLANS["2stage"]),
                          prompts, draft_cfg=cfg, draft_params=tdraft,
                          spec_tokens=4,
                          transport=InProcessTransport(default_delay_s=DELAY))
    assert ([r.output for r in reqs] == ref) == (draft == "target")
    assert_drained(rt)
    assert rt.draft.free_slots == EC.max_batch
    assert (rt.spec_rejected if draft == "other-seed"
            else rt.spec_accepted) > 0
    jrt, jreqs = ref_serve(jmake_plan(jcfg, PLANS["2stage"]), prompts,
                           draft_cfg=jcfg, draft_params=jdraft,
                           spec_tokens=4,
                           transport=JTransport(default_delay_s=DELAY))
    assert_same_run(rt, reqs, jrt, jreqs)
    for name in SPEC_COUNTERS:
        assert getattr(rt, name) == getattr(jrt, name), name


def test_disaggregated_matches_reference():
    """One prefill node holding the whole model, a 2-stage decode replica
    at depth 2: the ring caches are handed off by ``export_kv`` and
    decode runs on n1 and n2 only; tokens, ledger (each handoff the
    profile's KV bytes of the prompt) and latencies as the reference's."""
    jcfg, _, cfg, params = model()
    prompts, ref = reference()
    rt, reqs = port_serve(cfg, params, port_disagg_plan(cfg, *ONE_PREFILL),
                          prompts, max_inflight=2,
                          transport=InProcessTransport(default_delay_s=DELAY))
    assert [r.output for r in reqs] == ref
    assert rt.disaggregated
    assert_drained(rt)
    for pipe in rt.served.values():
        assert {st.node for st in pipe.stages} <= {"n1", "n2"}
    kv = rt.profile.kv_bytes_per_token_layer
    assert rt.transport.bytes_sent[("n0", "n1")] == sum(
        kv * len(x) * 3 for x in prompts)
    jrt, jreqs = ref_serve(jmake_disagg_plan(jcfg, *ONE_PREFILL), prompts,
                           max_inflight=2,
                           transport=JTransport(default_delay_s=DELAY))
    assert_same_run(rt, reqs, jrt, jreqs)


def test_export_kv_of_ring_caches_matches_reference():
    """A dense stage engine prefilled with a 40-token prompt (past the
    16-slot rings of the local layers): ``export_kv`` of every layer
    equals the reference's export (slot positions exactly; K/V within
    rtol 1e-4 and 1e-5 + 3e-5 x max|ref| of each tensor: K/V values reach
    ~20 and f32 rounding, summed in another order, grows with depth, to
    1.5e-5 x max|ref| at layer 5 of this prompt), and importing it into a
    [1, 6) engine gives it back bit for bit."""
    jcfg, jparams, cfg, params = model()
    prompt = reference()[0][1]
    S = len(prompt)
    src = tse.StageEngine(cfg, params, LayerRange(0, 6), EC, device="cpu")
    slot = src.alloc_slot(0)
    src.prefill_stage(slot, prompt, 0)
    sent = src.export_kv(slot, S, list(range(6)))
    jsrc = jse.StageEngine(jcfg, jparams, JLayerRange(0, 6), JEC)
    jslot = jsrc.alloc_slot(0)
    jsrc.prefill_stage(jslot, prompt, 0)
    jsent = jsrc.export_kv(jslot, S, list(range(6)))
    assert sorted(sent) == sorted(jsent) == list(range(6))
    for layer in range(6):
        assert sorted(sent[layer]) == sorted(jsent[layer])
        for key, got in sent[layer].items():
            want = np.asarray(jsent[layer][key])
            if want.dtype.kind in "iu":
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=1e-4,
                    atol=1e-5 + 3e-5 * np.abs(want).max())
    dst = tse.StageEngine(cfg, params, LayerRange(1, 6), EC, device="cpu")
    dslot = dst.alloc_slot(0)
    part = {l: sent[l] for l in range(1, 6)}
    dst.import_kv(dslot, S, part)
    back = dst.export_kv(dslot, S, list(range(1, 6)))
    assert all(torch.equal(back[l][k], part[l][k])
               for l in part for k in part[l])


def test_failover_replan_matches_reference():
    """n1 holds layers [3, 6) of the n0 -> n1 pipeline and n2 the whole
    model; n1 fails with requests in flight at depth 2, the survivors are
    replanned and the requests re-prefill: the reference's placement,
    preemptions, tokens, ledger and latencies."""
    jcfg, jparams, cfg, params = model()
    prompts, ref = reference()
    runs = []
    for serve_fn, p, replan, opt in (
            (lambda p: port_serve(cfg, params, p, prompts, max_inflight=2,
                                  steps=8, transport=InProcessTransport(
                                      default_delay_s=DELAY)),
             port_plan(cfg, FAILOVER), replan_after_failure, MILPOptions),
            (lambda p: ref_serve(p, prompts, max_inflight=2, steps=8,
                                 transport=JTransport(default_delay_s=DELAY)),
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
    assert_drained(rt)


# --- the paged paths: item 7 (c2) -------------------------------------------

def _paged_entry(name, cfg, params):
    if name == "PagedEngine":
        return PagedEngine(cfg, params, EC, device="cpu")
    if name == "PagedStageEngine":
        return tse.PagedStageEngine(cfg, params, LayerRange(0, 6), EC,
                                    device="cpu")
    if name == "stage_cache_init_paged":
        return tstage.stage_cache_init_paged(cfg, LayerRange(0, 6), 2, 32)
    if name == "ClusterRuntime(paged=True)":
        return ClusterRuntime(cfg, params, port_plan(cfg, PLANS["2stage"]),
                              EC, paged=True, device="cpu")
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu"]
    return serve.main(argv + (["--paged"] if name == "serve --paged" else
                              ["--cluster", "A100,L4", "--stages", "2"]))


@pytest.mark.parametrize("name", [
    "PagedEngine", "PagedStageEngine", "stage_cache_init_paged",
    "ClusterRuntime(paged=True)", "serve --paged",
    "serve --cluster (no --dense)"])
def test_paged_entry_points_raise_item_7c2(name):
    """Every paged path of the hybrid stack raises, naming item 7 (c2);
    ``launch/serve.py`` raises before it draws any weights."""
    _, _, cfg, params = model()
    with pytest.raises(NotImplementedError, match=r"item 7 \(c2\)"):
        _paged_entry(name, cfg, params)
