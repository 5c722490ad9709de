"""mixtral (a routed MoE of E experts top-K in every layer, sliding-window
attention) on the port against the JAX package: f32, CPU, SMOKE size (4
layers, window 32, 4 experts top-2, capacity factor 4.0).

The reference's weights (JAX ``init``) go to the port through
``convert.params_from_jax``.  ``moe_apply`` is held against the
reference's over capacity factors that drop (0.5, 1.0, 1.25) and one that
does not (4.0), grouped dispatch on and off, a shared expert or none;
SMOKE's factor of 4.0 never drops (C = 2 x Tg >= the Tg x K rows), so one
serving run sets 1.0, which drops in prefill.  Tolerances: ``y`` and
``aux_loss`` within 1e-5 of their largest magnitude, logits atol = rtol =
1e-4 (f32 matmuls summed in another order); ``drop_frac``, routing, greedy tokens, counters and the
link ledger exactly equal; gradients under ``tests/
test_torch_gemma3_training.py``'s two gates (1e-4 on fan-in-scaled
weights, 2x the reference's own one-rounding gap on ``init``'s).  The
reference runs four runtimes: its ``Engine``, the dense cluster at
capacity factor 1.0, the cluster with a draft at another seed, and the
paged cluster.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.models import init as jinit
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.serving import InProcessTransport as JTransport
from repro.serving import PagedEngine as JPagedEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models.common import map_tree, tree_leaves
from repro_torch.serving.engine import (Engine, EngineConfig, PagedEngine,
                                        Request)
from repro_torch.serving.runtime import ClusterRuntime, InProcessTransport

from harness import (f32, make_plan as jmake_plan, random_prompts,
                     reference_outputs, serve_on_cluster)
from test_torch_gemma3 import assert_drained, assert_same_run
from test_torch_gemma3_training import batch, gap, one_rounding_apart
from test_torch_runtime import port_plan
from test_torch_training import np_tree

ARCH = "mixtral_8x22b"
MODEL = dict(atol=1e-4, rtol=1e-4)
MOE_REL = 1e-5
ROUNDING_FACTOR = 2
# prompts of 5 tokens (decode runs past the 32-slot rings) and of 40 (the
# dense Engine's bucket; prefill masks keys past the window), 12 new
# tokens each; two lengths, since each compiles the reference's prefill
JEC = JEngineConfig(max_batch=4, max_len=56, prompt_len=40)
EC = EngineConfig(**dataclasses.asdict(JEC))
PROMPT_LENS = (5, 40, 5, 40)
NEW_TOKENS = 12
DELAY = 1e-3
PLANS = {"2stage": {"n0": (0, 2), "n1": (2, 4)},
         "3stage": {"n0": (0, 1), "n1": (1, 3), "n2": (3, 4)}}
DROPPING = 1.0                 # a capacity factor at which prefill drops
SPEC_COUNTERS = ("spec_proposed", "spec_accepted", "spec_rejected",
                 "spec_rounds", "spec_confirmed")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """SMOKE ops are tiny: more intra-op threads only add overhead."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def t(a):
    return torch.from_numpy(np.array(a))


def both(jcfg, **kw):
    """(reference cfg, port cfg) with the fields ``kw`` replaced."""
    return (dataclasses.replace(jcfg, **kw),
            dataclasses.replace(f32(get_smoke_config(ARCH)), **kw))


@functools.lru_cache(maxsize=None)
def model(seed=0, capacity_factor=None):
    """(reference cfg, reference params, port cfg, port params), f32, the
    port's params converted from the reference's; built once per seed and
    capacity factor (SMOKE's own when None)."""
    jcfg = f32(jget_smoke_config(ARCH))
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=capacity_factor)
    jparams = jinit(jcfg, jax.random.key(seed))
    cfg = dataclasses.replace(f32(get_smoke_config(ARCH)),
                              moe_capacity_factor=jcfg.moe_capacity_factor)
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


def moe_params(seed=0, shared=0):
    """One layer's MoE params (reference numpy, port torch): SMOKE's
    layer 0, plus a shared expert drawn from ``seed`` when ``shared``."""
    jcfg, jparams, _, params = model()
    jp = {k: np.asarray(v[0]) for k, v in
          jparams["super"]["pos0"]["moe"].items()}
    if shared:
        rng = np.random.RandomState(seed)
        d, ff = jcfg.d_model, jcfg.moe_d_ff * shared
        jp["shared"] = {
            n: (rng.randn(*shape) / np.sqrt(shape[0])).astype(np.float32)
            for n, shape in (("w_gate", (d, ff)), ("w_up", (d, ff)),
                             ("w_down", (ff, d)))}
    return jp, map_tree(t, jp)


def assert_moe_close(got, want):
    """Within MOE_REL of the output's scale (``init``'s expert stacks at
    std 1/sqrt(repeats) = 0.5 give outputs of ~100, where one f32 ulp is
    ~1e-5)."""
    err = np.abs(got - want).max()
    assert err <= MOE_REL * max(1.0, np.abs(want).max()), err


def run_both(jcfg, cfg, jp, tp, x):
    """The reference's ``moe_apply`` op by op (under ``jax.jit`` XLA fuses
    ``drop_frac``'s mean into other roundings) and the port's."""
    jy, ja = jmoe.moe_apply(jcfg, jax.tree.map(jnp.asarray, jp),
                            jnp.asarray(x))
    ty, ta = tmoe.moe_apply(cfg, tp, t(x))
    return (np.asarray(jy), ja), (ty.numpy(), ta)


# --- the registry and the specs ----------------------------------------------

def test_registry_and_specs_match_reference():
    """The full config and SMOKE equal the reference's; every block is a
    windowed MoE block whose params hold the router and the (E, d, ff)
    expert stacks in the reference's layout; the full config counts
    2.504 B params a layer."""
    assert ARCH in ARCH_IDS
    for get, jget in ((get_config, jget_config),
                      (get_smoke_config, jget_smoke_config)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(jget(ARCH))
    jcfg, jparams, cfg, params = model()
    assert all(b.moe and b.attn == "swa" for b in cfg.blocks)
    spec = tmodel.param_specs(cfg)["super"]["pos0"]
    jspec = jmodel.param_specs(jcfg)["super"]["pos0"]
    assert sorted(spec) == sorted(jspec) == ["mix", "moe", "norm1", "norm2"]
    assert {k: (s.shape, s.scale) for k, s in spec["moe"].items()} == \
        {k: (s.shape, s.scale) for k, s in jspec["moe"].items()}
    assert params["super"]["pos0"]["moe"]["w_down"].shape == (4, 4, 128, 64)
    full = get_config(ARCH)
    per_layer = (full.param_count() - 2 * full.vocab_size * full.d_model) \
        / full.num_layers
    assert round(per_layer / 1e9, 3) == 2.504


# --- moe_apply ---------------------------------------------------------------

# (capacity factor, grouped, shared experts): every factor on the flat
# dispatch without a shared expert; grouped dispatch and the shared branch
# each at factors that drop, and once together
MOE_CASES = [(0.5, 0, 0), (1.0, 0, 0), (1.25, 0, 0), (4.0, 0, 0),
             (1.0, 1, 0), (0.5, 0, 1), (1.25, 1, 1)]
# (S, B): decode (S == 1, drop-free at every factor) and two prefills
MOE_SHAPES = [(1, 3), (7, 1), (7, 3), (40, 1), (40, 3)]


@pytest.mark.parametrize(
    "cf,grouped,shared", MOE_CASES,
    ids=[f"{cf}-{('flat', 'grouped')[g]}-{('no-shared', 'shared')[n]}"
         for cf, g, n in MOE_CASES])
def test_moe_apply_matches_reference(cf, grouped, shared):
    """``y`` and ``aux_loss`` within 1e-5 of their scale, ``drop_frac``
    exactly equal, at (S, B) in MOE_SHAPES; capacity factors under 4.0
    drop rows past capacity at S > 1 (decode, S == 1, is drop-free)."""
    jcfg, cfg = both(model()[0], moe_groups=grouped, moe_num_shared=shared,
                     moe_capacity_factor=cf)
    jp, tp = moe_params(shared=shared)
    drops = []
    for S, B in MOE_SHAPES:
        x = np.random.RandomState(10 * S + B).randn(
            B, S, cfg.d_model).astype(np.float32)
        (jy, ja), (ty, ta) = run_both(jcfg, cfg, jp, tp, x)
        assert_moe_close(ty, jy)
        assert_moe_close(float(ta["aux_loss"]), float(ja["aux_loss"]))
        assert float(ta["drop_frac"]) == float(ja["drop_frac"]), (S, B)
        drops.append(float(ta["drop_frac"]))
        if S == 1:
            assert float(ta["drop_frac"]) == 0.0
    assert (max(drops) > 0) == (cf < 4.0)


@pytest.mark.parametrize("place", ["first", "second"])
def test_top_k_ties_pick_the_reference_experts(place):
    """Router columns 1 and 3 equal, so every token's probabilities of
    experts 1 and 3 tie exactly: tied for the first place (column 0 and
    2 far below), or for the second behind expert 0.  The lower index
    wins as in ``jax.lax.top_k``, and the same rows drop at capacity
    factor 0.5 (the order of a token's experts sets the dispatch
    order)."""
    jp, _ = moe_params()
    d = model()[2].d_model
    router = np.random.RandomState(1).randn(d, 4).astype(
        np.float32) * 0.02
    lead, low = ([0], [2]) if place == "second" else ([1, 3], [0, 2])
    router[:, lead], router[:, low] = 0.5, -0.5
    router[:, 3] = router[:, 1]
    jp = dict(jp, router=router)
    tp = map_tree(t, jp)
    x = np.abs(np.random.RandomState(2).randn(2, 9, d)).astype(
        np.float32)           # positive: the 0.5 columns lead every token
    probs = torch.softmax(torch.einsum("btd,de->bte", t(x), t(router)), -1)
    assert torch.equal(probs[..., 1], probs[..., 3])
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    tv, ti = tmoe.top_k(probs, 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert set(np.unique(ti.numpy())) == ({0, 1} if place == "second"
                                          else {1, 3})
    for cf in (0.5, 4.0):
        jcfg, cfg = both(model()[0], moe_capacity_factor=cf)
        (jy, ja), (ty, ta) = run_both(jcfg, cfg, jp, tp, x)
        assert_moe_close(ty, jy)
        assert float(ta["drop_frac"]) == float(ja["drop_frac"])
        assert (float(ta["drop_frac"]) > 0) == (cf < 1)


def test_inverse_gather_and_its_gradient_match_reference():
    """Forward and gradient of ``inverse_gather`` against ``jax.vjp`` of
    the reference's, exactly: the gradient gathers ``g`` through the
    inverse mapping, zero where it is invalid."""
    rng = np.random.RandomState(3)
    G, M, P, D = 2, 7, 5, 4
    x = rng.randn(G, M, D).astype(np.float32)
    idx = rng.randint(0, M, (G, P))
    inv_idx = rng.randint(0, P, (G, M))
    inv_valid = rng.rand(G, M) > 0.4
    g = rng.randn(G, P, D).astype(np.float32)
    jy, vjp = jax.vjp(lambda a: jmoe.inverse_gather(
        a, jnp.asarray(idx), jnp.asarray(inv_idx), jnp.asarray(inv_valid)),
        jnp.asarray(x))
    (jgx,) = vjp(jnp.asarray(g))
    tx = t(x).requires_grad_(True)
    ty = tmoe.inverse_gather(tx, t(idx), t(inv_idx), t(inv_valid))
    ty.backward(t(g))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jgx))
    assert not tx.grad[t(~inv_valid)].any()


# --- the model ---------------------------------------------------------------

@pytest.mark.parametrize("S", [24, 80])
def test_forward_logits_match_reference(S):
    """Logits at S = 24 and at 80, past the window of 32."""
    jcfg, jparams, cfg, params = model()
    tokens = np.random.RandomState(S).randint(0, cfg.vocab_size, (2, S))
    want, _ = jmodel.forward(jcfg, jparams, jnp.asarray(tokens))
    got = tmodel.forward(cfg, params, t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)


def test_prefill_then_decode_past_the_ring_matches_reference():
    """Prefill of 20 tokens (max_len 56), then 26 decode steps, past the
    32-slot rings' end: each step's logits equal the reference's."""
    jcfg, jparams, cfg, params = model()
    tokens = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 46))
    jl, jcaches = jmodel.prefill(jcfg, jparams, jnp.asarray(tokens[:, :20]),
                                 max_len=56)
    tl, tcaches = tmodel.prefill(cfg, params, t(tokens[:, :20]), max_len=56)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL)
    jdecode = jax.jit(functools.partial(jmodel.decode_step, jcfg))
    for s in range(20, 46):
        jl, jcaches = jdecode(jparams, jnp.asarray(tokens[:, s]), jcaches,
                              jnp.full((2,), s, jnp.int32))
        tl, tcaches = tmodel.decode_step(
            cfg, params, t(tokens[:, s]), tcaches,
            torch.full((2,), s, dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL)
    assert int(tcaches["super"]["pos0"]["pos"].max()) == 45 > 32


# --- the loss and its gradients ----------------------------------------------

def fan_in_scaled(tree):
    """A numpy params tree with every stacked block matrix rescaled from
    ``init``'s std 1/sqrt(repeats) to 1/sqrt(its own fan-in): H x D for
    ``o``, the axis after the expert axis for the expert stacks, the
    second axis for the others; the router keeps its own std (0.02)."""
    def scale(part, name, a):
        if a.ndim < 3 or name == "router":
            return a
        fan = (a.shape[1] * a.shape[2] if name == "o"
               else a.shape[2] if part == "moe" else a.shape[1])
        return (a * np.sqrt(a.shape[0] / fan)).astype(a.dtype)
    return dict(tree, super={
        pos: {part: {n: scale(part, n, a) for n, a in leaves.items()}
              for part, leaves in block.items()}
        for pos, block in tree["super"].items()})


@functools.lru_cache(maxsize=None)
def weights():
    raw = np_tree(model()[1])
    return {"init": raw, "fan-in": fan_in_scaled(raw)}


@functools.lru_cache(maxsize=None)
def _reference_grad(jcfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(jcfg, p, b), has_aux=True))


def reference_grads(params, b):
    jcfg = model()[0]
    (loss, aux), grads = _reference_grad(jcfg)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v.numpy()) for k, v in b.items()})
    return (float(loss), float(aux["aux"]),
            [np.asarray(g) for g in jax.tree.leaves(grads)])


def port_grads(params, b, remat="none"):
    cfg = model()[2]
    live = map_tree(lambda x: x.clone().requires_grad_(True),
                    params_from_jax(params, cfg, device="cpu"))
    loss, aux = tmodel.loss_fn(cfg, live, b, remat=remat)
    loss.backward()
    return (loss.item(), aux["aux"].item(),
            [x.grad.numpy() for x in tree_leaves(live)])


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_aux_and_every_gradient_match_reference(remat):
    """Fan-in-scaled weights, under each remat policy (the aux loss passes
    through ``checkpoint``): the loss, the summed aux loss and every
    gradient (the router's and each expert stack's among them) at atol =
    rtol = 1e-4; the aux term is in the loss (nonzero), and every
    gradient is nonzero."""
    b = batch(40)
    jl, jaux, jg = reference_grads(weights()["fan-in"], b)
    tl, taux, tg = port_grads(weights()["fan-in"], b, remat)
    np.testing.assert_allclose(tl, jl, **MODEL)
    np.testing.assert_allclose(taux, jaux, **MODEL)
    assert taux > 0.5 * model()[0].num_layers
    assert len(tg) == len(jg)
    for i, (g, w) in enumerate(zip(tg, jg)):
        assert np.abs(g).max() > 0, i
        np.testing.assert_allclose(g, w, **MODEL, err_msg=f"leaf {i}")


def test_raw_init_gradients_within_the_reference_rounding_gap():
    """``init``'s raw weights: the port's gap to the reference (the loss's
    relative difference and the relative norm of the difference of all
    gradients) within ROUNDING_FACTOR x the reference's own gap to a copy
    of its weights one rounding apart."""
    b = batch(40)
    raw = weights()["init"]
    ref = reference_grads(raw, b)
    apart = reference_grads(one_rounding_apart(raw, 40), b)
    port = port_grads(raw, b)
    rounding = gap((apart[0], apart[2]), (ref[0], ref[2]))
    assert 0 < rounding
    got = gap((port[0], port[2]), (ref[0], ref[2]))
    assert got <= ROUNDING_FACTOR * rounding, (got, rounding)


# --- serving -----------------------------------------------------------------

def port_serve(cfg, params, p, prompts, **kw):
    rt = ClusterRuntime(cfg, params, p, EC, device="cpu", **kw)
    reqs = [Request(i, pr, max_new_tokens=NEW_TOKENS)
            for i, pr in enumerate(prompts)]
    for r in reqs:
        rt.submit(r)
    rt.run_until_done()
    return rt, reqs


def ref_serve(jcfg, jparams, p, prompts, **kw):
    return serve_on_cluster(jcfg, jparams, p, prompts, ec=JEC,
                            max_new_tokens=NEW_TOKENS, **kw)


def test_engine_matches_reference_tokens():
    """The dense ``Engine``: the reference engine's greedy tokens, one
    prefill a request, every slot released."""
    _, _, cfg, params = model()
    prompts, ref = reference()
    eng = Engine(cfg, params, EC, device="cpu")
    reqs = [Request(i, p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert [r.output for r in reqs] == ref
    assert eng.prefills == len(prompts)
    assert not eng.active.any()


@pytest.mark.parametrize("max_inflight", [1, 2], ids=["depth1", "depth2"])
@pytest.mark.parametrize("layout", list(PLANS))
def test_dense_cluster_matches_reference_tokens(layout, max_inflight):
    """The dense ``ClusterRuntime`` on 2- and 3-stage plans with 1 ms
    links: the reference engine's tokens, every request completed with
    its tokens counted, slots released."""
    _, _, cfg, params = model()
    prompts, ref = reference()
    rt, reqs = port_serve(cfg, params, port_plan(cfg, PLANS[layout]),
                          prompts, paged=False, max_inflight=max_inflight,
                          transport=InProcessTransport(default_delay_s=DELAY))
    assert [r.output for r in reqs] == ref
    assert rt.completed == len(prompts)
    assert rt.tokens_produced == len(prompts) * NEW_TOKENS
    assert_drained(rt)


def recording_drops(monkeypatch):
    """Record ``drop_frac`` of every MoE call the port's blocks make."""
    drops = []
    real = tmodel.moe_apply

    def rec(cfg, p, x, *a, **kw):
        y, aux = real(cfg, p, x, *a, **kw)
        drops.append((x.shape[1], float(aux["drop_frac"])))
        return y, aux
    monkeypatch.setattr(tmodel, "moe_apply", rec)
    return drops


def test_dropping_cluster_matches_reference_run(monkeypatch):
    """Capacity factor 1.0, 3-stage plan at depth 2: prefill drops rows
    past capacity (decode never does), and the port's run is the
    reference runtime's: tokens, link ledger, counters and virtual-clock
    latencies."""
    jcfg, jparams, cfg, params = model(capacity_factor=DROPPING)
    prompts, _ = reference()
    drops = recording_drops(monkeypatch)
    rt, reqs = port_serve(cfg, params, port_plan(cfg, PLANS["3stage"]),
                          prompts, paged=False, max_inflight=2,
                          transport=InProcessTransport(default_delay_s=DELAY))
    assert max(f for s, f in drops if s > 1) > 0
    assert all(f == 0 for s, f in drops if s == 1)
    assert_drained(rt)
    jrt, jreqs = ref_serve(jcfg, jparams, jmake_plan(jcfg, PLANS["3stage"]),
                           prompts, paged=False, max_inflight=2,
                           transport=JTransport(default_delay_s=DELAY))
    assert_same_run(rt, reqs, jrt, jreqs)


def test_speculation_with_another_seed_matches_reference(monkeypatch):
    """A coordinator draft at another seed on the 2-stage plan, γ = 4, at
    capacity factor 1.0, so that verify passes (S = γ + 1, pad rows
    included) drop as prefill does: the reference runtime's tokens,
    ledger, latencies and spec counters."""
    jcfg, jparams, cfg, params = model(capacity_factor=DROPPING)
    _, jdraft, _, tdraft = model(1, DROPPING)
    prompts, _ = reference()
    drops = recording_drops(monkeypatch)
    rt, reqs = port_serve(cfg, params, port_plan(cfg, PLANS["2stage"]),
                          prompts, paged=False, draft_cfg=cfg,
                          draft_params=tdraft, spec_tokens=4,
                          transport=InProcessTransport(default_delay_s=DELAY))
    assert any(f > 0 for s, f in drops if s == 5)
    assert rt.spec_rejected > 0
    assert_drained(rt)
    assert rt.draft.free_slots == EC.max_batch
    jrt, jreqs = ref_serve(jcfg, jparams, jmake_plan(jcfg, PLANS["2stage"]),
                           prompts, paged=False, draft_cfg=jcfg,
                           draft_params=jdraft, spec_tokens=4,
                           transport=JTransport(default_delay_s=DELAY))
    assert_same_run(rt, reqs, jrt, jreqs)
    for name in SPEC_COUNTERS:
        assert getattr(rt, name) == getattr(jrt, name), name


def test_paged_entry_points_behave_as_the_reference():
    """No mixtral layer is paged (every one is windowed): ``PagedEngine``
    refuses the stack with the reference's ValueError, and the paged
    ``ClusterRuntime`` gives every node a dense ``StageEngine`` and
    serves the reference paged cluster's tokens (its engine's); the
    port's ``serve.py --paged`` refuses too, and ``--cluster`` without
    ``--dense`` serves."""
    jcfg, jparams, cfg, params = model()
    prompts, ref = reference()
    for cls, c, p in ((JPagedEngine, jcfg, jparams),
                      (PagedEngine, cfg, params)):
        with pytest.raises(ValueError, match="nothing to page"):
            cls(c, p, JEC if cls is JPagedEngine else EC,
                **({} if cls is JPagedEngine else {"device": "cpu"}))
    rt, reqs = port_serve(cfg, params, port_plan(cfg, PLANS["3stage"]),
                          prompts, paged=True)
    assert {type(e).__name__ for e in rt.engines.values()} == {"StageEngine"}
    jrt, jreqs = ref_serve(jcfg, jparams, jmake_plan(jcfg, PLANS["3stage"]),
                           prompts, paged=True)
    assert [r.output for r in reqs] == [r.output for r in jreqs] == ref
    assert_drained(rt)
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--new-tokens",
            "2", "--prompt", "40"]
    with pytest.raises(ValueError, match="nothing to page"):
        serve.run_paged(cfg, serve.parse_args(argv + ["--paged"]),
                        verbose=False)
    srt, sreqs, _, _ = serve.run_cluster(get_smoke_config(ARCH),
                                         serve.parse_args(argv + [
                                             "--cluster", "A100,L4",
                                             "--stages", "2"]),
                                         verbose=False)
    assert all(r.done and len(r.output) == 2 for r in sreqs)
    assert len(srt.engines) >= 2
