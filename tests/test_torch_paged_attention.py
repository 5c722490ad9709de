"""Paged decode attention (kernel K1) of the port against the JAX package.

The port's wrapper on CPU tensors runs its plain version; it is held against
the Pallas kernel (``interpret=True``, as ``tests/test_kernels.py`` runs it)
and against the reference's jnp oracle, on the same numpy inputs, in f32 at
atol = rtol = 1e-5 (different summation orders of f32 dot products; both
sides compute in f32).  The CUDA kernel itself is held against the same
plain version on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.paged_attention import (paged_attention as pallas_paged,
                                           paged_attention_ref as jax_ref,
                                           quantize_kv_pages,
                                           streamed_pages_per_step as jax_spps)
from repro_torch.kernels.paged_attention import (dense_to_pages,
                                                 paged_attention,
                                                 paged_attention_ref,
                                                 streamed_pages_per_step)
from repro_torch.kernels.paged_attention import kernel as k1

TOL = dict(atol=1e-5, rtol=1e-5)

SHAPES = {
    # B, H, KH, D, page, NP
    "smoke": (3, 4, 2, 16, 16, 4),
    "smollm": (3, 15, 5, 64, 16, 4),       # full widths: G=3, D=64
    "page8": (2, 15, 5, 64, 8, 6),
}


def _inputs(shape, lengths, *, seed=0, scramble=True):
    """numpy q, pools, block tables (a random permutation of the pool when
    ``scramble``) and lengths."""
    B, H, KH, D, page, NP = shape
    rng = np.random.RandomState(seed)
    P = B * NP + 1                                   # + a scratch page
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(P, page, KH, D).astype(np.float32)
    vp = rng.randn(P, page, KH, D).astype(np.float32)
    ids = rng.permutation(P - 1) + 1 if scramble else np.arange(1, P)
    tables = ids.reshape(B, NP).astype(np.int32)
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


def _ragged(shape):
    B, H, KH, D, page, NP = shape
    lens = [1, page, page + 1, NP * page]
    return (lens * B)[:B] if B <= 4 else lens + [7] * (B - 4)


def _port(q, kp, vp, tables, lengths, ks=None, vs=None):
    t = torch.from_numpy
    out = paged_attention(t(q), t(kp), t(vp), t(tables), t(lengths),
                          k_scales=None if ks is None else t(ks),
                          v_scales=None if vs is None else t(vs))
    return out.numpy()


def _pallas(q, kp, vp, tables, lengths, ks=None, vs=None):
    j = jnp.asarray
    return np.asarray(pallas_paged(
        j(q), j(kp), j(vp), j(tables), j(lengths),
        k_scales=None if ks is None else j(ks),
        v_scales=None if vs is None else j(vs), interpret=True))


@pytest.mark.parametrize("scramble", [False, True], ids=["ordered", "scrambled"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_plain_matches_pallas_and_oracle(name, scramble):
    shape = SHAPES[name]
    B, H, KH, D, page, NP = shape
    for lens in (_ragged(shape), [NP * page] * B,
                 list(np.random.RandomState(1).randint(1, NP * page + 1, B))):
        args = _inputs(shape, lens, scramble=scramble)
        got = _port(*args)
        np.testing.assert_allclose(got, _pallas(*args), **TOL)
        j = [jnp.asarray(a) for a in args]
        np.testing.assert_allclose(got, np.asarray(jax_ref(*j)), **TOL)


def test_ragged_lengths_cover_page_edges():
    """Lengths 1, page, page+1 and the full NP*page in one batch, with
    garbage page ids past each row's live pages (the kernels never read
    them: the Pallas index map clamps, the port loops over live pages)."""
    shape = (4, 15, 5, 64, 16, 4)
    q, kp, vp, tables, lengths = _inputs(shape, [1, 16, 17, 64], seed=3)
    want = _pallas(q, kp, vp, tables, lengths)
    live = -(-lengths // 16)
    dead = np.arange(4)[None, :] >= live[:, None]
    tables_junk = np.where(dead, tables[::-1], tables).astype(np.int32)
    np.testing.assert_allclose(_port(q, kp, vp, tables_junk, lengths),
                               want, **TOL)


@pytest.mark.parametrize("name", ["smoke", "smollm"])
def test_int8_pages_with_scales(name):
    """int8 pages + (P, KH) f32 scales, dequantized in fp32 (the Pallas
    kernel's numerics); same int8 bytes and scales on both sides."""
    shape = SHAPES[name]
    q, kp, vp, tables, lengths = _inputs(shape, _ragged(shape), seed=5)
    kq, ks = quantize_kv_pages(jnp.asarray(kp))
    vq, vs = quantize_kv_pages(jnp.asarray(vp))
    kq, ks, vq, vs = (np.array(a) for a in (kq, ks, vq, vs))
    got = _port(q, kq, vq, tables, lengths, ks, vs)
    np.testing.assert_allclose(got, _pallas(q, kq, vq, tables, lengths,
                                            ks, vs), **TOL)
    j = [jnp.asarray(a) for a in (q, kq, vq, tables, lengths, ks, vs)]
    np.testing.assert_allclose(got, np.asarray(jax_ref(*j)), **TOL)


def test_length_zero_gives_zero():
    """A length-0 row (no live page) gives 0, as the Pallas kernel does; the
    jnp oracle would give a uniform average instead."""
    shape = SHAPES["smollm"]
    q, kp, vp, tables, _ = _inputs(shape, [0, 0, 0])
    lengths = np.asarray([0, 5, 0], np.int32)
    got = _port(q, kp, vp, tables, lengths)
    np.testing.assert_allclose(got, _pallas(q, kp, vp, tables, lengths),
                               **TOL)
    assert np.all(got[[0, 2]] == 0)
    # a row with no live page reads no table entry at all
    tables[[0, 2]] = 10 ** 6
    np.testing.assert_array_equal(_port(q, kp, vp, tables, lengths), got)


def test_dense_to_pages_matches_reference():
    rng = np.random.RandomState(2)
    k = rng.randn(2, 64, 2, 16).astype(np.float32)
    v = rng.randn(2, 64, 2, 16).astype(np.float32)
    from repro.kernels.paged_attention import dense_to_pages as jax_d2p
    want = jax_d2p(jnp.asarray(k), jnp.asarray(v), None, 16)
    got = dense_to_pages(torch.from_numpy(k), torch.from_numpy(v), None, 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", range(3))
def test_streamed_pages_per_step_exact(seed):
    rng = np.random.RandomState(seed)
    for page in (8, 16, 64):
        lengths = rng.randint(0, 300, size=rng.randint(1, 9))
        assert streamed_pages_per_step(lengths, page) == \
            jax_spps(lengths, page)


def test_wrapper_takes_plain_path_only_on_cpu():
    """CPU tensors: the plain version, bit for bit, and no launch counted.
    A tensor on any other non-CUDA device raises instead of falling back."""
    args = _inputs(SHAPES["smoke"], [3, 17, 40])
    t = [torch.from_numpy(a) for a in args]
    before = k1.launches
    got = paged_attention(*t)
    assert k1.launches == before
    assert torch.equal(got, paged_attention_ref(*t))
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError):
        paged_attention(*meta)
    with pytest.raises(ValueError):                  # mixed devices
        paged_attention(meta[0], *t[1:])


def test_scales_must_come_in_pairs():
    args = [torch.from_numpy(a) for a in _inputs(SHAPES["smoke"], [1, 2, 3])]
    ks = torch.ones(args[1].shape[0], args[1].shape[2])
    with pytest.raises(ValueError):
        paged_attention(*args, k_scales=ks)
