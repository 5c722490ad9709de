"""deepseek-v2 (MLA attention: a compressed cache of kv latents and one
shared rope key; a dense-FFN prologue layer before MoE layers with shared
experts) on the port against the JAX package: f32, CPU, SMOKE size (1 +
3 layers, 4 heads, kv_lora 32, q_lora 48, nope 16 / rope 8, v 16; 8
experts top-2 and one shared expert).

The reference's weights (JAX ``init``) go to the port through
``convert.params_from_jax``.  MLA's prefill attends with q/k of dim
nope + rope = 24 against v of dim 16 through the port's prefill kernel
(its plain version here); its decode is the absorbed form over the
compressed cache.  Tolerances: logits, activations and caches atol =
rtol = 1e-4 (f32 matmuls summed in another order; the latents of
``init``'s std-1/sqrt(repeats) weights reach ~10, so their atol scales
with their largest value); cache positions, greedy tokens, the per-link
ledger, counters and virtual-clock latencies exactly equal.  Every
serving case runs against the reference's ``Engine`` tokens, and the
runtime cases against the reference's runtime on the same plan and
links.
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
from repro.core import MILPOptions as JOpt
from repro.core import LayerRange as JLayerRange
from repro.core import ModelProfile as JModelProfile
from repro.core import replan_after_failure as j_replan
from repro.models import attention as jattn
from repro.models import init as jinit
from repro.models import model as jmodel
from repro.serving import InProcessTransport as JTransport
from repro.serving import PagedEngine as JPagedEngine
from repro.serving import stage_engine as jse
from repro.serving import transport as jtransport
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import LayerRange, MILPOptions, replan_after_failure
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models import stage as tstage
from repro_torch.models.common import tree_leaves
from repro_torch.serving import stage_engine as tse
from repro_torch.serving import transport as ttransport
from repro_torch.serving.engine import (Engine, EngineConfig, PagedEngine,
                                        Request)
from repro_torch.serving.runtime import ClusterRuntime, InProcessTransport

from harness import (f32, make_disagg_plan as jmake_disagg_plan,
                     make_plan as jmake_plan, random_prompts,
                     reference_outputs, serve_on_cluster)
from test_torch_disagg import port_disagg_plan
from test_torch_gemma3 import assert_drained, assert_same_run
from test_torch_runtime import port_plan

ARCH = "deepseek_v2_236b"
MODEL = dict(atol=1e-4, rtol=1e-4)
# prompts of 5 and 40 tokens (the dense Engine's bucket), 12 new tokens;
# two lengths, since each compiles the reference's prefill anew
JEC = JEngineConfig(max_batch=4, max_len=56, prompt_len=40)
EC = EngineConfig(**dataclasses.asdict(JEC))
PROMPT_LENS = (5, 40, 5, 40)
NEW_TOKENS = 12
DELAY = 1e-3
# layer 0 is the dense prologue; 2stage cuts right after it, 3stage cuts
# inside the repeats
PLANS = {"2stage": {"n0": (0, 1), "n1": (1, 4)},
         "3stage": {"n0": (0, 2), "n1": (2, 3), "n2": (3, 4)}}
ONE_PREFILL = ({"n0": (0, 4)}, {"n1": (0, 1), "n2": (1, 4)})
FAILOVER = {"n0": (0, 1), "n1": (1, 4), "n2": (0, 4)}
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


def t(a):
    return torch.from_numpy(np.array(a))


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


def fan_in_scaled(tree):
    """A numpy params tree with every stacked block matrix rescaled from
    ``init``'s std 1/sqrt(repeats) to 1/sqrt(its own fan-in): H x v_dim
    for ``o``, the axis after the expert axis for the expert stacks, the
    second axis for the others (the shared experts' among them); the
    router keeps its own std (0.02).  The prologue is drawn unstacked, at
    its first axis's fan-in, right but for ``o``, whose first axis is H:
    that takes 1/sqrt(H x v_dim) too (``chip_smoke.fan_in_scaled``)."""
    def scale(part, name, a):
        if isinstance(a, dict):
            return {n: scale("shared", n, x) for n, x in a.items()}
        if a.ndim < 3 or name == "router":
            return a
        fan = (a.shape[1] * a.shape[2] if name == "o"
               else a.shape[2] if part == "moe" else a.shape[1])
        return (a * np.sqrt(a.shape[0] / fan)).astype(a.dtype)

    def prologue(block):
        o = block["mix"]["o"]
        return dict(block, mix=dict(block["mix"], o=(
            o / np.sqrt(o.shape[1])).astype(o.dtype)))
    tree = jax.tree.map(np.asarray, tree)
    return dict(tree, prologue=[prologue(b) for b in tree["prologue"]],
                super={pos: {part: {n: scale(part, n, a)
                                    for n, a in leaves.items()}
                             for part, leaves in block.items()}
                       for pos, block in tree["super"].items()})


@functools.lru_cache(maxsize=None)
def scaled_model():
    """``model()``'s weights rescaled by ``fan_in_scaled``: (reference
    params, port params).  At ``init``'s std 1/sqrt(3) each of MLA's five
    projections amplifies its input, and f32 rounding alone moves the
    logits of a near-one-hot softmax by ~1e-2; float comparisons of whole
    layers run on these, greedy serving on ``init``'s own."""
    _, jparams, cfg, _ = model()
    tree = fan_in_scaled(jparams)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, cfg, device="cpu"))


@functools.lru_cache(maxsize=None)
def reference():
    """Prompts and the reference's greedy tokens from its dense
    ``Engine``, the anchor of every serving path."""
    jcfg, jparams, _, _ = model()
    prompts = random_prompts(jcfg, PROMPT_LENS, seed=0)
    return prompts, reference_outputs(jcfg, jparams, prompts, ec=JEC,
                                      max_new_tokens=NEW_TOKENS)


def mix(layer):
    """Layer ``layer``'s MLA params on ``scaled_model``'s weights:
    (reference jnp tree, port tree)."""
    jparams, params = scaled_model()
    if layer == 0:
        return jparams["prologue"][0]["mix"], params["prologue"][0]["mix"]
    r = layer - 1
    return (jax.tree.map(lambda a: a[r], jparams["super"]["pos0"]["mix"]),
            {k: v[r] for k, v in params["super"]["pos0"]["mix"].items()})


def assert_close_scaled(got, want):
    """allclose at MODEL with atol grown to 1e-5 x max|want| where that is
    larger (latents of ``init``'s weights reach ~10)."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=MODEL["rtol"],
        atol=max(MODEL["atol"], 1e-5 * float(np.abs(want).max())))


# --- the registry, the specs and the conversion ------------------------------

def _spec_tree(specs):
    if isinstance(specs, dict):
        return {k: _spec_tree(v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_spec_tree(v) for v in specs]
    return (tuple(specs.shape), tuple(specs.axes), specs.init, specs.scale)


def test_registry_and_specs_match_reference():
    """The full config and SMOKE equal the reference's field by field; the
    port's param specs, prologue included, equal the reference's (paths,
    shapes, logical axes, init kinds and scales): MLA's q_down, q_up,
    kv_down, kv_up and o, the prologue's dense FFN and the repeats' MoE
    with its shared expert.  The full config holds 235.7 B params."""
    assert ARCH in ARCH_IDS
    for get, jget in ((get_config, jget_config),
                      (get_smoke_config, jget_smoke_config)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(jget(ARCH))
    jcfg, _, cfg, _ = model()
    assert _spec_tree(tmodel.param_specs(cfg)) == \
        _spec_tree(jmodel.param_specs(jcfg))
    pro = tmodel.param_specs(cfg)["prologue"][0]
    assert sorted(pro) == ["ffn", "mix", "norm1", "norm2"]
    assert sorted(pro["mix"]) == ["kv_down", "kv_up", "o", "q_down", "q_up"]
    assert pro["mix"]["kv_up"].shape == (32, 4, 32)
    assert "shared" in tmodel.param_specs(cfg)["super"]["pos0"]["moe"]
    assert round(get_config(ARCH).param_count() / 1e9, 1) == 235.7


def test_conversion_round_trip():
    """``params_from_jax`` gives the reference's every leaf exactly, in
    the spec's order, the prologue list included."""
    _, jparams, _, params = model()
    jleaves = [np.asarray(a) for a in jax.tree.leaves(jparams)]
    leaves = tree_leaves(params)
    assert len(leaves) == len(jleaves)
    for got, want in zip(leaves, jleaves):
        np.testing.assert_array_equal(got.numpy(), want)
    assert isinstance(params["prologue"], list)
    assert len(params["prologue"]) == 1


# --- MLA attention -----------------------------------------------------------

@pytest.mark.parametrize("layer,S", [(0, 12), (2, 40)])
def test_mla_prefill_matches_reference(layer, S):
    """``mla_prefill``'s output and its cache (c_kv, the roped shared key)
    on a block's own params, at S = 12 and 40."""
    jcfg, _, cfg, _ = model()
    jp, tp = mix(layer)
    x = np.random.RandomState(S).randn(2, S, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S))
    want, (jc, jr) = jattn.mla_prefill(jcfg, jp, jnp.asarray(x),
                                       jnp.asarray(pos))
    got, (c, r) = tattn.mla_prefill(cfg, tp, t(x), t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)
    assert c.shape == (2, S, 32) and r.shape == (2, S, 8)
    assert_close_scaled(c.numpy(), jc)
    assert_close_scaled(r.numpy(), jr)


def test_mla_decode_over_steps_matches_reference():
    """Fourteen absorbed decode steps on a cache of 8 slots from empty:
    past step 8 the last slot is overwritten (slot = min(pos, W-1)), as in
    the reference; each step's output and the cache, positions exactly.
    The same steps on a cache of 5 rows through ``rows`` (batch rows 3 and
    1) give the same outputs and write only those rows."""
    jcfg, _, cfg, _ = model()
    jp, tp = mix(1)
    rng = np.random.RandomState(7)
    jcache = jattn.mla_cache_init(jcfg, 2, 8, jnp.float32)
    cache = tattn.mla_cache_init(cfg, 2, 8, torch.float32, device="cpu")
    wide = tattn.mla_cache_init(cfg, 5, 8, torch.float32, device="cpu")
    rows = torch.tensor([3, 1])
    for s in range(14):
        x = rng.randn(2, 1, cfg.d_model).astype(np.float32)
        cpos = np.array([s, s + 1], np.int32)
        want, jcache = jattn.mla_decode(jcfg, jp, jnp.asarray(x), jcache,
                                        jnp.asarray(cpos))
        got, cache = tattn.mla_decode(cfg, tp, t(x), cache, t(cpos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)
        for key in ("c", "r"):
            assert_close_scaled(cache[key].numpy(), jcache[key])
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        via_rows, _ = tattn.mla_decode(cfg, tp, t(x), wide, t(cpos),
                                       rows=rows)
        torch.testing.assert_close(via_rows, got, atol=0, rtol=0)
    assert cache["pos"][:, -1].tolist() == [13, 14]
    for key in ("c", "r", "pos"):
        assert torch.equal(wide[key][rows], cache[key])
    assert (wide["pos"][[0, 2, 4]] == 2 ** 31 - 1).all()


@pytest.mark.parametrize("S,max_len", [(10, 16), (20, 12)])
def test_fill_prefill_cache_layout_matches_reference(S, max_len):
    """MLA's prefill cache: the last n = min(S, max_len) tokens in slots
    0..n-1 with positions S-n..S-1 (not GQA's slot = position), the rest
    empty (position int32 max); latents and keys as the reference's."""
    jcfg, _, cfg, _ = model()
    jp, tp = mix(0)
    b = cfg.blocks[0]
    x = np.random.RandomState(S).randn(2, S, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S))
    _, jraw = jattn.mla_prefill(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    _, raw = tattn.mla_prefill(cfg, tp, t(x), t(pos))
    want = jmodel.fill_prefill_cache(jcfg, b, jraw, 2, S, max_len,
                                     jnp.float32)
    got = tmodel.fill_prefill_cache(cfg, b, raw, 2, S, max_len,
                                    torch.float32)
    n = min(S, max_len)
    np.testing.assert_array_equal(got["pos"].numpy(),
                                  np.asarray(want["pos"]))
    assert got["pos"][0, :n].tolist() == list(range(S - n, S))
    assert (got["pos"][:, n:] == 2 ** 31 - 1).all()
    for key in ("c", "r"):
        assert got[key].shape[1] == max_len
        assert_close_scaled(got[key].numpy(), want[key])
        assert not got[key][:, n:].any()


# --- the model ---------------------------------------------------------------

@pytest.mark.parametrize("S", [24, 40])
def test_forward_logits_match_reference(S):
    """Logits through the prologue and the MoE repeats
    (``scaled_model``'s weights)."""
    jcfg, _, cfg, _ = model()
    jparams, params = scaled_model()
    tokens = np.random.RandomState(S).randint(0, cfg.vocab_size, (2, S))
    want, _ = jmodel.forward(jcfg, jparams, jnp.asarray(tokens))
    got = tmodel.forward(cfg, params, t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)


def test_prefill_then_decode_past_max_len_matches_reference():
    """Prefill of 20 tokens into caches of max_len 24, then 10 decode
    steps, past max_len (the last slot overwritten): each step's logits
    and the stacked caches' positions equal the reference's
    (``scaled_model``'s weights)."""
    jcfg, _, cfg, _ = model()
    jparams, params = scaled_model()
    tokens = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 30))
    jl, jcaches = jmodel.prefill(jcfg, jparams, jnp.asarray(tokens[:, :20]),
                                 max_len=24)
    tl, tcaches = tmodel.prefill(cfg, params, t(tokens[:, :20]), max_len=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL)
    assert sorted(tcaches["super"]["pos0"]) == ["c", "pos", "r"]
    assert tcaches["super"]["pos0"]["c"].shape == (3, 2, 24, 32)
    jdecode = jax.jit(functools.partial(jmodel.decode_step, jcfg))
    for s in range(20, 30):
        jl, jcaches = jdecode(jparams, jnp.asarray(tokens[:, s]), jcaches,
                              jnp.full((2,), s, jnp.int32))
        tl, tcaches = tmodel.decode_step(
            cfg, params, t(tokens[:, s]), tcaches,
            torch.full((2,), s, dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL)
    for got, want in ((tcaches["prologue"][0], jcaches["prologue"][0]),
                      (tcaches["super"]["pos0"], jcaches["super"]["pos0"])):
        np.testing.assert_array_equal(got["pos"].numpy(),
                                      np.asarray(want["pos"]))
        assert_close_scaled(got["c"].numpy(), want["c"])
    assert int(tcaches["prologue"][0]["pos"][0, -1]) == 29


@pytest.mark.parametrize("cut", [1, 2])
def test_stage_slices_at_the_prologue_boundary_match_the_model(cut):
    """``stage_prefill`` over [0, cut) then [cut, 4), and three
    ``stage_decode`` steps with entry masking (row 1 enters the second
    slice at its first layer): logits as the reference's whole-model
    prefill and decode; the first slice's caches are the prologue's
    (``scaled_model``'s weights)."""
    jcfg, _, cfg, _ = model()
    jparams, params = scaled_model()
    tokens = np.random.RandomState(11).randint(0, cfg.vocab_size, (2, 16))
    slices = [LayerRange(0, cut), LayerRange(cut, 4)]
    sp = [tstage.stage_params(cfg, params, r) for r in slices]
    h, c0 = tstage.stage_prefill(cfg, sp[0], slices[0], t(tokens[:, :13]),
                                 0, max_len=20)
    logits, c1 = tstage.stage_prefill(cfg, sp[1], slices[1], h, cut,
                                      max_len=20)
    jl, jcaches = jmodel.prefill(jcfg, jparams, jnp.asarray(tokens[:, :13]),
                                 max_len=20)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **MODEL)
    assert len(c0) == cut and len(c1) == 4 - cut
    assert sorted(c0[0]) == ["c", "pos", "r"]
    assert_close_scaled(c0[0]["c"].numpy(), jcaches["prologue"][0]["c"])
    for s in range(13, 16):
        pos = torch.full((2,), s, dtype=torch.int32)
        tok = t(tokens[:, s])
        h, _, _ = tstage.stage_decode(cfg, sp[0], slices[0], tok,
                                      torch.zeros(2, 1, cfg.d_model),
                                      torch.zeros(2, dtype=torch.long), c0,
                                      pos)
        _, logits, _ = tstage.stage_decode(
            cfg, sp[1], slices[1], tok, h, torch.full((2,), cut), c1, pos)
        jl, jcaches = jmodel.decode_step(jcfg, jparams, jnp.asarray(
            tokens[:, s]), jcaches, jnp.full((2,), s, jnp.int32))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **MODEL)


# --- serving -----------------------------------------------------------------

def port_serve(cfg, params, p, prompts, *, steps=None, paged=False, **kw):
    rt = ClusterRuntime(cfg, params, p, EC, paged=paged, device="cpu", **kw)
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


def ref_serve(p, prompts, *, paged=False, **kw):
    jcfg, jparams, _, _ = model()
    return serve_on_cluster(jcfg, jparams, p, prompts, paged=paged,
                            ec=JEC, max_new_tokens=NEW_TOKENS, **kw)


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
    assert sorted(eng.caches["prologue"][0]) == ["c", "pos", "r"]


@pytest.mark.parametrize("max_inflight", [1, 2], ids=["depth1", "depth2"])
@pytest.mark.parametrize("layout", list(PLANS))
def test_dense_cluster_matches_reference_tokens(layout, max_inflight):
    """The dense ``ClusterRuntime`` on a 2-stage plan cut right after the
    prologue and a 3-stage one cut inside the repeats, 1 ms links: the
    reference engine's tokens, every request completed, slots released;
    at depth 2 the reference runtime's own run (ledger, counters,
    virtual-clock latencies)."""
    jcfg, _, cfg, params = model()
    prompts, ref = reference()
    rt, reqs = port_serve(cfg, params, port_plan(cfg, PLANS[layout]),
                          prompts, max_inflight=max_inflight,
                          transport=InProcessTransport(default_delay_s=DELAY))
    assert [r.output for r in reqs] == ref
    assert rt.completed == len(prompts)
    assert rt.tokens_produced == len(prompts) * NEW_TOKENS
    assert_drained(rt)
    if max_inflight == 2:
        jrt, jreqs = ref_serve(jmake_plan(jcfg, PLANS[layout]), prompts,
                               max_inflight=2,
                               transport=JTransport(default_delay_s=DELAY))
        assert_same_run(rt, reqs, jrt, jreqs)


def test_speculation_with_another_seed_matches_reference():
    """A coordinator draft at another seed on the 2-stage plan, γ = 4
    (proposals rejected): the reference runtime's tokens, ledger,
    latencies and spec counters; MLA's dense ``rollback`` is bookkeeping,
    as the reference's."""
    jcfg, _, cfg, params = model()
    _, jdraft, _, tdraft = model(1)
    prompts, _ = reference()
    rt, reqs = port_serve(cfg, params, port_plan(cfg, PLANS["2stage"]),
                          prompts, draft_cfg=cfg, draft_params=tdraft,
                          spec_tokens=4,
                          transport=InProcessTransport(default_delay_s=DELAY))
    assert rt.spec_rejected > 0
    assert_drained(rt)
    assert rt.draft.free_slots == EC.max_batch
    jrt, jreqs = ref_serve(jmake_plan(jcfg, PLANS["2stage"]), prompts,
                           draft_cfg=jcfg, draft_params=jdraft,
                           spec_tokens=4,
                           transport=JTransport(default_delay_s=DELAY))
    assert_same_run(rt, reqs, jrt, jreqs)
    for name in SPEC_COUNTERS:
        assert getattr(rt, name) == getattr(jrt, name), name


def test_disaggregated_matches_reference():
    """One prefill node holding the whole model, a 2-stage decode replica
    cut after the prologue, at depth 2: the compressed caches are handed
    off by ``export_kv`` and decode runs on n1 and n2 only; tokens, ledger
    (each handoff the MILP profile's KV bytes of the prompt, as the
    reference reckons them) and latencies as the reference's."""
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
    assert rt.transport.bytes_sent[("n0", "n2")] == sum(
        kv * len(x) * 3 for x in prompts)
    jrt, jreqs = ref_serve(jmake_disagg_plan(jcfg, *ONE_PREFILL), prompts,
                           max_inflight=2,
                           transport=JTransport(default_delay_s=DELAY))
    assert_same_run(rt, reqs, jrt, jreqs)


def test_export_kv_carries_the_compressed_cache_and_the_wire_takes_it():
    """A dense stage engine prefilled with a 40-token prompt: ``export_kv``
    of every layer ships ``{c, r, pos}`` equal to the reference's export
    (positions exactly); importing it into a [1, 4) engine gives it back
    bit for bit; and the port's wire frame of it decodes, through the
    reference's ``decode_payload``, to the same arrays, and the
    reference's frame of its own export through the port's
    (``scaled_model``'s weights)."""
    jcfg, _, cfg, _ = model()
    jparams, params = scaled_model()
    prompt = reference()[0][1]
    S = len(prompt)
    src = tse.StageEngine(cfg, params, LayerRange(0, 4), EC, device="cpu")
    slot = src.alloc_slot(0)
    src.prefill_stage(slot, prompt, 0)
    sent = src.export_kv(slot, S, list(range(4)))
    jsrc = jse.StageEngine(jcfg, jparams, JLayerRange(0, 4), JEC)
    jslot = jsrc.alloc_slot(0)
    jsrc.prefill_stage(jslot, prompt, 0)
    jsent = jsrc.export_kv(jslot, S, list(range(4)))
    assert sorted(sent) == sorted(jsent) == list(range(4))
    for layer in range(4):
        assert sorted(sent[layer]) == sorted(jsent[layer]) == \
            ["c", "pos", "r"]
        assert sent[layer]["c"].shape == (EC.max_len, 32)
        np.testing.assert_array_equal(sent[layer]["pos"].numpy(),
                                      np.asarray(jsent[layer]["pos"]))
        for key in ("c", "r"):
            assert_close_scaled(sent[layer][key].numpy(), jsent[layer][key])
    dst = tse.StageEngine(cfg, params, LayerRange(1, 4), EC, device="cpu")
    dslot = dst.alloc_slot(0)
    part = {l: sent[l] for l in range(1, 4)}
    dst.import_kv(dslot, S, part)
    back = dst.export_kv(dslot, S, list(range(1, 4)))
    assert all(torch.equal(back[l][k], part[l][k])
               for l in part for k in part[l])
    theirs = jtransport.decode_payload(ttransport.payload_bytes(sent))
    ours = ttransport.decode_payload(jtransport.payload_bytes(
        jax.tree.map(np.asarray, jsent)))
    for layer in range(4):
        for key in ("c", "r", "pos"):
            np.testing.assert_array_equal(np.asarray(theirs[layer][key]),
                                          sent[layer][key].numpy())
            np.testing.assert_array_equal(
                np.asarray(ours[layer][key]),
                np.asarray(jsent[layer][key]))


def test_failover_replan_matches_reference():
    """n1 holds the repeats [1, 4) of the n0 -> n1 pipeline and n2 the
    whole model; n1 fails with requests in flight at depth 2, the
    survivors are replanned and the requests re-prefill: the reference's
    placement, preemptions, tokens, ledger and latencies."""
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


def test_paged_entry_points_behave_as_the_reference():
    """MLA blocks are never paged: ``PagedEngine`` refuses deepseek with
    the reference's ValueError "nothing to page", and the paged
    ``ClusterRuntime`` gives every node a dense ``StageEngine`` and serves
    the reference paged cluster's tokens (its engine's); the port's
    ``serve.py --paged`` refuses too, and ``--cluster`` without
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
    jrt, jreqs = ref_serve(jmake_plan(jcfg, PLANS["3stage"]), prompts,
                           paged=True)
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


def test_make_plan_profile_matches_reference():
    """``serve.make_plan``'s MILP profile of the full config is the one
    ``repro/launch/serve.py:91-94`` builds, field by field:
    KV bytes reckoned as 2 x 128 kv heads x head dim 40 x 2 B = 20,480 a
    token and layer, where MLA's cache holds (512 + 64) x 2 B = 1,152
    (a known difference the port copies)."""
    cfg = get_config(ARCH)
    args = serve.parse_args(["--arch", ARCH, "--cluster", "A100,L4",
                             "--stages", "2", "--device", "cpu"])
    got = serve.make_plan(dataclasses.replace(cfg, repeats=4), args).model
    jcfg = jget_config(ARCH)
    want = JModelProfile.from_dims(
        jcfg.name, 5, jcfg.d_model, max(jcfg.d_ff, 1), jcfg.vocab_size,
        jcfg.num_kv_heads, jcfg.resolved_head_dim,
        kv_dtype="param", kv_page_size=args.page_size)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.kv_bytes_per_token_layer == 20480
    cache = tattn.mla_cache_init(cfg, 1, 1, torch.bfloat16, device="meta")
    assert sum(cache[k].numel() * 2 for k in ("c", "r")) == 1152
