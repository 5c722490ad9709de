"""Model code of the port against the JAX package, on the same weights.

Inputs come from numpy seeds; the reference's parameters (the session
``gqa_model`` fixture: smollm SMOKE in f32) are converted with
``repro_torch.convert.params_from_jax``.  Tolerances (f32 on the CPU):
elementwise numerics at 1e-5, and whole-model logits / activations at
atol = rtol = 1e-4 — four layers of f32 matmuls summed in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LayerRange as JLayerRange
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models import forward as jforward
from repro.models import paged as jpaged
from repro.models import stage as jstage
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.placement import LayerRange
from repro_torch.models import common as tcommon
from repro_torch.models import forward as tforward
from repro_torch.models import init as tinit
from repro_torch.models import moe as tmoe
from repro_torch.models import paged as tpaged
from repro_torch.models import param_specs
from repro_torch.models import stage as tstage

ELEM = dict(atol=1e-5, rtol=1e-5)
MODEL = dict(atol=1e-4, rtol=1e-4)


def port_cfg(jcfg):
    cfg = dataclasses.replace(port_smoke_config("smollm_360m"),
                              param_dtype=jcfg.param_dtype,
                              compute_dtype=jcfg.compute_dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg


@pytest.fixture(scope="module")
def both(gqa_model):
    jcfg, jparams = gqa_model
    cfg = port_cfg(jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jcfg, jparams, cfg, params


def t(a):
    return torch.from_numpy(np.array(a))


def test_rmsnorm_rope_silu_match():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 64).astype(np.float32)
    scale = rng.randn(64).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        tcommon.rmsnorm(t(x), t(scale)).numpy(),
        np.asarray(jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(scale))),
        **ELEM)
    pos = rng.randint(0, 4000, size=(2, 5)).astype(np.int32)
    cos, sin = tcommon.rope_angles(t(pos), 16, 10000.0)
    jcos, jsin = jcommon.rope_angles(jnp.asarray(pos), 16, 10000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), **ELEM)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), **ELEM)
    xh = rng.randn(2, 5, 4, 16).astype(np.float32)
    np.testing.assert_allclose(
        tcommon.apply_rope(t(xh), cos, sin).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(xh), jcos, jsin)), **ELEM)
    np.testing.assert_allclose(tcommon.silu(t(x)).numpy(),
                               np.asarray(jcommon.silu(jnp.asarray(x))),
                               **ELEM)


def test_rmsnorm_bf16_casts_back():
    x = torch.randn(3, 8, dtype=torch.bfloat16)
    y = tcommon.rmsnorm(x, torch.zeros(8, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16
    want = jcommon.rmsnorm(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                           jnp.zeros(8, jnp.bfloat16))
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(want, np.float32))


def test_ffn_apply_matches(both):
    jcfg, jparams, cfg, params = both
    x = np.random.RandomState(1).randn(2, 3, 64).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], jparams["super"]["pos0"]["ffn"])
    tp = {k: v[1] for k, v in params["super"]["pos0"]["ffn"].items()}
    np.testing.assert_allclose(tmoe.ffn_apply(tp, t(x)).numpy(),
                               np.asarray(jmoe.ffn_apply(jp, jnp.asarray(x))),
                               **MODEL)


def test_param_specs_and_init_shapes(both):
    jcfg, jparams, cfg, params = both
    got = tinit(cfg, 0, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat_j) == 11
    for path, leaf in flat_j:
        node = got
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
    # same seed -> same weights; another seed -> other weights
    again = tinit(cfg, 0, device="cpu")
    assert torch.equal(again["embed"], got["embed"])
    assert not torch.equal(tinit(cfg, 1, device="cpu")["embed"], got["embed"])
    assert set(param_specs(cfg)) == set(jparams)


def test_forward_matches(both):
    jcfg, jparams, cfg, params = both
    tok = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 11))
    want, _ = jforward(jcfg, jparams, jnp.asarray(tok, jnp.int32))
    got = tforward(cfg, params, t(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)


def _pool_and_tables(cfg, B, NP, page, seed):
    """Zeroed pools and scrambled block tables (repeats, 1, B, NP)."""
    rng = np.random.RandomState(seed)
    L = cfg.num_layers
    P = 1 + L * B * NP
    tables = (rng.permutation(P - 1) + 1).astype(np.int32)
    tables = tables.reshape(cfg.repeats, 1, B, NP)
    shape = (P, page, cfg.num_kv_heads, cfg.resolved_head_dim)
    return np.zeros(shape, np.float32), tables


def test_chunked_prefill_then_paged_decode_matches(both):
    """Two prefill chunks (the second attends over the first through the
    block table) then three decode steps: logits and pools match."""
    jcfg, jparams, cfg, params = both
    B, NP, page, C = 2, 3, 16, 12
    kp0, tsup = _pool_and_tables(cfg, B, NP, page, seed=3)
    tpro = np.zeros((0, B, NP), np.int32)
    rng = np.random.RandomState(4)
    prompt = rng.randint(0, cfg.vocab_size, (B, 2 * C))
    jk, jv = jnp.asarray(kp0), jnp.asarray(kp0)
    tk, tv = t(kp0), t(kp0)
    for c in range(2):
        tok = prompt[:, c * C:(c + 1) * C]
        start = np.full((B,), c * C, np.int32)
        jl, jk, jv, _, _ = jpaged.prefill_chunk_paged(
            jcfg, jparams, jnp.asarray(tok, jnp.int32), jnp.asarray(start),
            jk, jv, jnp.asarray(tpro), jnp.asarray(tsup), active_blocks=2)
        tl, tk, tv = tpaged.prefill_chunk_paged(
            cfg, params, t(tok), t(start), tk, tv, t(tpro), t(tsup),
            active_blocks=2)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL)
    caches = jpaged.init_caches_paged(jcfg, B, NP * page)
    tcaches = tpaged.init_caches_paged(cfg, B, NP * page, device="cpu")
    assert tcaches == caches       # all-paged: {} for every block
    nxt = np.asarray(jl).argmax(-1)
    for s in range(3):
        pos = np.full((B,), 2 * C + s, np.int32)
        jl, caches, jk, jv, _, _ = jpaged.decode_step_paged(
            jcfg, jparams, jnp.asarray(nxt, jnp.int32), caches,
            jnp.asarray(pos), jk, jv, jnp.asarray(tpro), jnp.asarray(tsup),
            interpret=True)
        tl, tcaches, tk, tv = tpaged.decode_step_paged(
            cfg, params, t(nxt), tcaches, t(pos), tk, tv, t(tpro), t(tsup))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL)
        nxt = np.asarray(jl).argmax(-1)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **MODEL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **MODEL)


def test_stage_split_with_mid_node_entry_matches(both):
    """Two nodes [0,2) and [2,4).  On node 0 row 0 enters at layer 0 (a
    token), row 1 at layer 1 (incoming activations: partial inference) and
    row 2 is a pad row (entry past the slice, scratch table -> page 0).
    Masked rows still write their K/V; only h is masked."""
    jcfg, jparams, cfg, params = both
    rng = np.random.RandomState(5)
    page, NP, B = 16, 2, 3
    P = 1 + 2 * 2 * NP
    shape = (P, page, cfg.num_kv_heads, cfg.resolved_head_dim)
    pools = rng.randn(2, *shape).astype(np.float32)        # prior context
    tables = np.zeros((2, B, NP), np.int32)                 # row 2: scratch
    tables[:, :2] = (rng.permutation(P - 1)[:8] + 1).reshape(2, 2, NP)
    tok = np.asarray([7, 0, 0], np.int32)
    h_in = rng.randn(B, 1, cfg.d_model).astype(np.float32)
    cache_pos = np.asarray([20, 9, 0], np.int32)
    outs = []
    for node, (a, b), entry in (("n0", (0, 2), [0, 1, 2]),
                                ("n1", (2, 4), [2, 2, 4])):
        jl_r, tl_r = JLayerRange(a, b), LayerRange(a, b)
        jsp = jstage.stage_params(jcfg, jparams, jl_r)
        tsp = tstage.stage_params(cfg, params, tl_r)
        caches = jstage.stage_cache_init_paged(jcfg, jl_r, B, NP * page)
        assert tstage.stage_cache_init_paged(cfg, tl_r, B, NP * page) \
            == caches
        ent = np.asarray(entry, np.int32)
        jh, jlog, _, jk, jv, _, _ = jstage.stage_decode_paged(
            jcfg, jsp, jl_r, jnp.asarray(tok), jnp.asarray(h_in),
            jnp.asarray(ent), caches, jnp.asarray(cache_pos),
            jnp.asarray(pools[0]), jnp.asarray(pools[1]),
            jnp.asarray(tables), interpret=True)
        th, tlog, _, tk, tv = tstage.stage_decode_paged(
            cfg, tsp, tl_r, t(tok), t(h_in), t(ent), [{}, {}], t(cache_pos),
            t(pools[0]), t(pools[1]), t(tables))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MODEL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **MODEL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **MODEL)
        assert (tlog is None) == (jlog is None)
        if jlog is not None:
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       **MODEL)
        outs.append(th.numpy())
        h_in = np.asarray(jh)
    # the row entering at layer 1 kept its input through layer 0's mask
    assert not np.allclose(outs[0][1], 0)


def test_stage_prefill_chunk_mid_node_entry_matches(both):
    """A chunk entering node [0,3) at layer 1 (activations in), appending
    to the pool, then the rest of the stack on node [3,4) emits logits."""
    jcfg, jparams, cfg, params = both
    rng = np.random.RandomState(6)
    page, NP, C = 16, 2, 10
    P = 1 + 4 * NP
    shape = (P, page, cfg.num_kv_heads, cfg.resolved_head_dim)
    kp = np.zeros(shape, np.float32)
    tables = (np.arange(1, P).reshape(4, 1, NP)).astype(np.int32)
    x = rng.randn(1, C, cfg.d_model).astype(np.float32)
    start = np.asarray([3], np.int32)
    jk, jv, tk, tv = jnp.asarray(kp), jnp.asarray(kp), t(kp), t(kp)
    for (a, b), entry in (((0, 3), 1), ((3, 4), 3)):
        jr, tr = JLayerRange(a, b), LayerRange(a, b)
        tb = tables[a:b]
        jo, jk, jv, _, _ = jstage.stage_prefill_chunk_paged(
            jcfg, jstage.stage_params(jcfg, jparams, jr), jr,
            jnp.asarray(x), entry, jnp.asarray(start), jk, jv,
            jnp.asarray(tb), active_blocks=1)
        to, tk, tv = tstage.stage_prefill_chunk_paged(
            cfg, tstage.stage_params(cfg, params, tr), tr, t(x), entry,
            t(start), tk, tv, t(tb), active_blocks=1)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **MODEL)
        x = np.asarray(jo)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **MODEL)
