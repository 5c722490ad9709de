"""The LayerNorm, non-parametric-LN and plain-GELU decoder families of the
port against the JAX package (f32, CPU, SMOKE size).

olmo (non-parametric LayerNorm, MHA, tied embeddings), starcoder2
(LayerNorm with scale and bias, the plain GELU FFN, GQA, untied) and
chameleon (RMSNorm, SwiGLU, GQA, untied): the reference's weights (JAX
``init``) go to the port through ``convert.params_from_jax``, and every
test is parametrised over the three.  Tolerances: the FFN atol = rtol =
1e-5 (the same fp32 formulas); the norms atol = rtol = 1e-4, on inputs of
mean 100 whose centred values carry fp32 rounding of 100 (~1e-5 after
scaling; a biased variance at d = 64 is off by 0.8%); logits, the loss and
gradients atol = rtol = 1e-4 (four layers of f32 matmuls summed in another
order); greedy tokens of every serving path exactly equal to the
reference's single dense ``Engine``; checkpoints and wire frames exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.models import common as jcommon
from repro.models import init as jinit
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.serving import transport as jtransport
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import BlockSpec
from repro_torch.convert import params_from_jax
from repro_torch.core import LayerRange, ModelProfile, Placement, plan
from repro_torch.core.cluster import full_mesh_cluster
from repro_torch.models import common as tcommon
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models.common import map_tree, tree_leaves, tree_paths
from repro_torch.serving import transport as ttransport
from repro_torch.serving.engine import (Engine, EngineConfig, PagedEngine,
                                        Request)
from repro_torch.serving.runtime import ClusterRuntime
from repro_torch.training import restore, save

from harness import EC as JEC, f32, random_prompts, reference_outputs

ARCHS = ["olmo_1b", "starcoder2_7b", "chameleon_34b"]
EXACT = dict(atol=1e-5, rtol=1e-5)
NORM = dict(atol=1e-4, rtol=1e-4)
MODEL = dict(atol=1e-4, rtol=1e-4)
EC = EngineConfig(**dataclasses.asdict(JEC))
PROMPT_LENS = (10, 5, 16, 12)
NEW_TOKENS = 6


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """SMOKE ops are tiny: more intra-op threads only add overhead."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def model(arch):
    """(reference cfg, reference params, port cfg, port params), f32, the
    port's params converted from the reference's; built once per arch."""
    jcfg = f32(jget_smoke_config(arch))
    jparams = jinit(jcfg, jax.random.key(0))
    cfg = f32(get_smoke_config(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jcfg, jparams, cfg, params


@functools.lru_cache(maxsize=None)
def reference(arch):
    """Prompts and the reference's greedy tokens from its dense
    ``Engine``, the anchor of every serving path."""
    jcfg, jparams, _, _ = model(arch)
    prompts = random_prompts(jcfg, PROMPT_LENS, seed=0)
    return prompts, reference_outputs(jcfg, jparams, prompts, ec=JEC,
                                      max_new_tokens=NEW_TOKENS)


def t(a):
    return torch.from_numpy(np.array(a))


def shifted_inputs(d, seed):
    """Activations far from zero mean (mean 100, std 3): a biased (n - 1)
    variance or a variance without the mean taken out would show."""
    rng = np.random.RandomState(seed)
    return (100.0 + 3.0 * rng.randn(2, 7, d)).astype(np.float32)


# --- the registry ------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm_360m"] + ARCHS + ["gemma3_12b"])
def test_registry_names_the_ported_archs(arch):
    """The full config and SMOKE of each ported arch equal the
    reference's, field by field."""
    from repro.configs import get_config as jget_config
    assert arch in ARCH_IDS
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == \
        dataclasses.asdict(jget_smoke_config(arch))


UNPORTED = {
    "moe": dict(pattern=(BlockSpec(kind="attn", attn="full", moe=True),)),
    "mla": dict(mla_kv_lora_rank=16),
    "windowed": dict(pattern=(BlockSpec(kind="attn", attn="swa",
                                        window=16),)),
    "ssm": dict(pattern=(BlockSpec(kind="mamba"),)),
    "encoder-decoder": dict(encoder_layers=2),
}


def _serve_tokens(eng, prompts):
    reqs = [Request(i, p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    return [r.output for r in reqs]


@pytest.mark.parametrize("kind", list(UNPORTED))
def test_unported_blocks_still_raise(kind):
    """MoE, MLA, SSM blocks and encoder-decoders raise in ``param_specs``.
    Windowed GQA is ported on the dense and the paged paths: a stack of
    windowed blocks only has nothing to page, so ``PagedEngine`` refuses
    it as the reference's does and the paged ``ClusterRuntime`` gives
    every node a dense engine; with full-attention blocks beside the
    windowed ones (a hybrid stack) ``PagedEngine`` pages those.  Each
    paged path serves the dense ``Engine``'s greedy tokens (f32, prompts
    filling the 16-slot rings)."""
    cfg = dataclasses.replace(get_smoke_config("starcoder2_7b"),
                              **UNPORTED[kind])
    if kind != "windowed":
        with pytest.raises(NotImplementedError, match="queue 1 item 7"):
            tmodel.param_specs(cfg)
        return
    cfg = f32(cfg)
    hybrid = dataclasses.replace(cfg, repeats=2, pattern=(
        cfg.pattern[0], BlockSpec(kind="attn", attn="full")))
    prompts = random_prompts(cfg, (16, 9, 12), seed=3)
    for c in (cfg, hybrid):
        params = tmodel.init(c, 0, device="cpu")
        want = _serve_tokens(Engine(c, params, EC, device="cpu"), prompts)
        rt = ClusterRuntime(c, params, two_node_plan(c), EC, paged=True,
                            device="cpu")
        assert _serve_tokens(rt, prompts) == want
        kinds = {type(e).__name__ for e in rt.engines.values()}
        if c is cfg:
            assert kinds == {"StageEngine"}
            with pytest.raises(ValueError, match="nothing to page"):
                PagedEngine(c, params, EC, device="cpu")
        else:
            assert kinds == {"PagedStageEngine"}
            eng = PagedEngine(c, params, EC, device="cpu")
            assert _serve_tokens(eng, prompts) == want
            assert eng.pool.num_layers == 2 and eng.pool.used == 0


def test_unknown_norm_and_ffn_raise():
    cfg = get_smoke_config("olmo_1b")
    with pytest.raises(ValueError):
        tcommon.norm_spec(dataclasses.replace(cfg, norm="groupnorm"))
    with pytest.raises(ValueError):
        tcommon.apply_norm(dataclasses.replace(cfg, norm="groupnorm"), {},
                           torch.zeros(1, 64))
    with pytest.raises(ValueError, match="queue 1 item 7"):
        tmoe.ffn_spec(dataclasses.replace(cfg, mlp_kind="moe"))


# --- specs, norms, FFN -------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_init_match_reference(arch):
    """Same leaves (paths, shapes, init kinds) as the reference, empty
    norm dicts and all; LayerNorm scales start at one, biases at zero."""
    jcfg, jparams, cfg, params = model(arch)
    jspecs = jmodel.param_specs(jcfg)
    tspecs = tmodel.param_specs(cfg)
    jflat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))[0]
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path) for path, _ in jflat]
    assert tree_paths(tspecs) == jpaths
    assert [(s.shape, s.init, s.scale) for s in tree_leaves(tspecs)] == \
        [(s.shape, s.init, s.scale) for _, s in jflat]
    assert tree_paths(params) == jpaths
    assert ("lm_head" in params) == (not cfg.tie_embeddings)
    norm = tmodel.init(cfg, 0, device="cpu")["super"]["pos0"]["norm1"]
    if cfg.norm == "nonparam_ln":
        assert norm == {} and params["final_norm"] == {}
    elif cfg.norm == "layernorm":
        assert bool((norm["scale"] == 1).all())
        assert bool((norm["bias"] == 0).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_norm_matches_reference(arch):
    """``apply_norm`` of the arch's norm, and ``layernorm`` with and
    without scale and bias, against the reference on inputs of mean 100,
    with a random scale and bias."""
    jcfg, _, cfg, _ = model(arch)
    d = cfg.d_model
    x = shifted_inputs(d, 1)
    rng = np.random.RandomState(2)
    p = {k: rng.randn(d).astype(np.float32)
         for k in tcommon.norm_spec(cfg)}
    got = tcommon.apply_norm(cfg, {k: t(v) for k, v in p.items()}, t(x))
    want = jcommon.apply_norm(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **NORM)
    scale, bias = rng.randn(d).astype(np.float32), rng.randn(d).astype(
        np.float32)
    for s, b in ((scale, bias), (None, None)):
        got = tcommon.layernorm(t(x), None if s is None else t(s),
                                None if b is None else t(b))
        want = jcommon.layernorm(jnp.asarray(x), s, b)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **NORM)
    # population variance: unit variance and zero mean per row
    y = tcommon.layernorm(t(x), None, None).double()
    np.testing.assert_allclose(y.mean(-1).numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(y.var(-1, correction=0).numpy(), 1.0,
                               atol=1e-4)
    # bf16 in, bf16 out
    xb = t(x).to(torch.bfloat16)
    assert tcommon.apply_norm(cfg, {k: t(v) for k, v in p.items()},
                              xb).dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_ffn_matches_reference(arch):
    """The arch's FFN (SwiGLU when its params hold ``w_gate``, else the
    tanh GELU) against ``repro.models.moe.ffn_apply``."""
    jcfg, _, cfg, _ = model(arch)
    spec = tmoe.ffn_spec(cfg)
    assert set(spec) == set(jmoe.ffn_spec(jcfg))
    assert ("w_gate" in spec) == (cfg.mlp_kind == "gated")
    rng = np.random.RandomState(3)
    p = {k: (rng.randn(*s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
         for k, s in spec.items()}
    x = (2.0 * rng.randn(2, 9, cfg.d_model)).astype(np.float32)
    got = tmoe.ffn_apply({k: t(v) for k, v in p.items()}, t(x))
    want = jmoe.ffn_apply({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)


# --- the model ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    jcfg, jparams, cfg, params = model(arch)
    tokens = np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 13))
    want, _ = jmodel.forward(jcfg, jparams, jnp.asarray(tokens))
    got = tmodel.forward(cfg, params, t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_reference(arch):
    """Prefill of 8 tokens, then 4 decode steps, as
    ``tests/test_models_smoke.py`` does: each step's logits equal the
    reference's step, and the port's own forward at that position."""
    jcfg, jparams, cfg, params = model(arch)
    tokens = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 12))
    full = tmodel.forward(cfg, params, t(tokens))
    jl, jcaches = jmodel.prefill(jcfg, jparams, jnp.asarray(tokens[:, :8]),
                                 max_len=32)
    tl, tcaches = tmodel.prefill(cfg, params, t(tokens[:, :8]), max_len=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL)
    np.testing.assert_allclose(tl.numpy(), full[:, 7].numpy(), **MODEL)
    for s in range(8, 12):
        jl, jcaches = jmodel.decode_step(
            jcfg, jparams, jnp.asarray(tokens[:, s]), jcaches,
            jnp.full((2,), s, jnp.int32))
        tl, tcaches = tmodel.decode_step(
            cfg, params, t(tokens[:, s]), tcaches,
            torch.full((2,), s, dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL)
        np.testing.assert_allclose(tl.numpy(), full[:, s].numpy(), **MODEL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    """``loss_fn`` and two gradient leaves: a block's FFN up projection
    and the last one the logits read (the embedding when tied, else
    ``lm_head``); LayerNorm's bias gets a gradient where it exists."""
    jcfg, jparams, cfg, params = model(arch)
    rng = np.random.RandomState(6)
    tokens = rng.randint(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[0, :3] = -100
    batch = {"tokens": t(tokens), "labels": t(labels)}
    jbatch = {k: jnp.asarray(v) for k, v in
              {"tokens": tokens, "labels": labels}.items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(jcfg, p, jbatch), has_aux=True))(jparams)
    live = map_tree(lambda x: x.clone().requires_grad_(True), params)
    loss, _ = tmodel.loss_fn(cfg, live, batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **MODEL)
    head = "embed" if cfg.tie_embeddings else "lm_head"
    np.testing.assert_allclose(live[head].grad.numpy(),
                               np.asarray(jg[head]), **MODEL)
    np.testing.assert_allclose(
        live["super"]["pos0"]["ffn"]["w_up"].grad.numpy(),
        np.asarray(jg["super"]["pos0"]["ffn"]["w_up"]), **MODEL)
    if cfg.norm == "layernorm":
        np.testing.assert_allclose(
            live["final_norm"]["bias"].grad.numpy(),
            np.asarray(jg["final_norm"]["bias"]), **MODEL)


# --- serving -----------------------------------------------------------------

def _serve(engine, prompts):
    reqs = [Request(i, p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_engines_match_reference_tokens(arch):
    """``Engine`` and ``PagedEngine`` give the reference engine's greedy
    tokens; the paged pool drains."""
    _, _, cfg, params = model(arch)
    prompts, ref = reference(arch)
    assert _serve(Engine(cfg, params, EC, device="cpu"), prompts) == ref
    eng = PagedEngine(cfg, params, EC, page_size=16, device="cpu")
    assert _serve(eng, prompts) == ref
    assert eng.pool.used == 0


def two_node_plan(cfg):
    """n0 = [0, 2), n1 = [2, 4) on a full mesh of two A100s."""
    placement = Placement({"n0": LayerRange(0, 2), "n1": LayerRange(2, 4)},
                          cfg.num_layers)
    profile = ModelProfile.from_dims(
        cfg.name, cfg.num_layers, cfg.d_model, max(cfg.d_ff, 1),
        cfg.vocab_size, cfg.num_kv_heads, cfg.resolved_head_dim)
    cluster = full_mesh_cluster(2, bandwidth=10e9 / 8, latency_s=1e-3)
    return plan(cluster, profile, placement=placement)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cluster_matches_reference_tokens(arch, paged):
    """The paged and the dense ``ClusterRuntime`` on a 2-node plan: the
    reference engine's greedy tokens, both nodes on every route, pools or
    slots released; the last stage holds ``final_norm`` and, untied,
    ``lm_head`` and no ``embed``."""
    _, _, cfg, params = model(arch)
    prompts, ref = reference(arch)
    rt = ClusterRuntime(cfg, params, two_node_plan(cfg), EC, paged=paged,
                        device="cpu")
    assert _serve(rt, prompts) == ref
    for i in range(len(prompts)):
        assert [s.node for s in rt.served[i].stages] == ["n0", "n1"]
    if paged:
        used = rt.pool_pages_used()
        assert used and all(u == 0 for u in used.values()), used
    else:
        assert all(e.free_slots == len(e.slots) and e.kv_tokens_used() == 0
                   for e in rt.engines.values())
    first, last = rt.engines["n0"].sparams, rt.engines["n1"].sparams
    assert "embed" in first and "lm_head" not in first
    assert "final_norm" in last
    assert ("lm_head" in last) == (not cfg.tie_embeddings)
    assert ("embed" in last) == cfg.tie_embeddings
    if cfg.norm == "nonparam_ln":
        assert last["final_norm"] == {}
        assert all(b["norm1"] == {} == b["norm2"] for b in last["blocks"])


# --- checkpoints and the wire ------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_round_trip(arch, tmp_path):
    """save then restore gives the same tree: every leaf bit-equal and
    every empty norm dict carried through."""
    _, _, cfg, params = model(arch)
    save(str(tmp_path), 3, params)
    template = map_tree(torch.zeros_like, params)
    back, step, _ = restore(str(tmp_path), None, template)
    assert step == 3
    assert tree_paths(back) == tree_paths(params)
    assert map_tree(lambda _: 0, back) == map_tree(lambda _: 0, params)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                  tree_leaves(params)))


@pytest.mark.parametrize("arch", ARCHS)
def test_wire_round_trip(arch):
    """``decode_payload(encode_payload(params))`` gives the params back
    (bf16, as the workers' init ships them), empty dicts included; the
    port decodes the reference's frame of the same weights to the same
    tree, leaf for leaf."""
    jcfg, jparams, cfg, params = model(arch)
    bf = map_tree(lambda x: x.to(torch.bfloat16), params)
    back = ttransport.decode_payload(ttransport.payload_bytes(bf))
    jback = ttransport.decode_payload(jtransport.payload_bytes(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.bfloat16)), jparams)))
    for tree in (back, jback):
        assert map_tree(lambda _: 0, tree) == map_tree(lambda _: 0, bf)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tree),
                                                      tree_leaves(bf)))
