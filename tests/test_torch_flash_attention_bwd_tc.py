"""The tensor-core design of K2's backward (bf16), on the CPU, and the
forward's log-sum-exp that it takes.

The bf16 kernels in ``repro_torch/csrc/flash_attention_bwd.cu`` run only on
the card.  Here a tile-level model of their arithmetic in plain torch is
held to the bound ``chip_smoke.py`` holds them to, each element within
2**-7 * |plain| + 2**-10 * max|plain| + 1e-5 of ``flash_attention_bwd_ref``
(the port's plain backward, fp32 throughout): the forward's log2-domain
lse, P = exp2(s * log2(e) / sqrt(D) - lse) in fp32, delta = rowsum(dO * o)
in fp32; dK and dV over 128-key tiles, summed over the kv head's query
heads and their query tiles (64 rows, 32 at D = 128) in the kernel's
order (64-key tiles at D = 256, where the CTA's two warpgroups hold dV
and dK apart: the same sums); dQ over 128-row query tiles and 64-key
tiles (32 at D = 256); P (in dV) and dS (in dK and dQ) split into bf16
hi and lo parts, two bf16 products into one fp32 accumulator; one bf16
rounding at the end.  The same model with P or
dS rounded to bf16 once misses that bound, which is why the kernels split
them.  Last, the plain forward's ``lse`` against ``jax.nn.logsumexp``, and
the plain backward given it against the one that recomputes it and against
``jax.vjp`` of the reference's ``chunked_attention``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import chunked_attention as j_chunked
from repro_torch.kernels.flash_attention import (attention_lse_ref,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_ref)

LOG2E = 1.4426950408889634
ROWS = 128                               # query rows of a dQ CTA


def dkdv_keys(D):
    """Keys of a dK/dV CTA (DkdvCfg<D>::kBN in the source): 64 at D = 256,
    where the CTA's two warpgroups split one tile's work."""
    return 64 if D == 256 else 128


def dkdv_rows(D):
    """Query rows of a dK/dV ring stage (DkdvCfg<D>::kBM in the source)."""
    return 32 if D == 128 else 64


def dq_keys(D):
    """Keys of a dQ ring stage (DqCfg<D>::kBN in the source)."""
    return 32 if D == 256 else 64


def _mask(i0, i1, j0, j1, causal, window, Sq, Sk):
    i = torch.arange(i0, i1)[:, None]
    j = torch.arange(j0, j1)[None, :]
    vis = (i < Sq) & (j < Sk)
    if causal:
        vis &= j <= i
    if window:
        vis &= i - j < window
    return vis


def _parts(x, split):
    """x (fp32) as the bf16 A operands the kernel feeds to wgmma."""
    hi = x.bfloat16().float()
    return [hi, (x - hi).bfloat16().float()] if split else [hi]


def _p(s, sc, lse, vis):
    """P = exp2(s * sc - lse) from one FMA rounded to fp32, 0 where masked
    (and for rows with lse = +inf)."""
    z = (s.double() * sc - lse.double()).float()
    return torch.where(vis, torch.exp2(z), torch.zeros(()))


def tc_bwd_model(q, k, v, o, do, lse, *, causal, window, split_p=True,
                 split_ds=True):
    """The bf16 kernels' arithmetic, tile by tile.  q, o, do: (B,H,Sq,D),
    k/v: (B,KH,Sk,D), bf16; lse (B,H,Sq) fp32 -> (dq, dk, dv) bf16."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    sc = scale * LOG2E
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = (dof * o.float()).sum(-1)
    dq = torch.zeros(B, H, Sq, D)
    dk = torch.zeros(B, KH, Sk, D)
    dv = torch.zeros(B, KH, Sk, D)
    bm, bn = dkdv_rows(D), dkdv_keys(D)
    for k0 in range(0, Sk, bn):              # fa_bwd_dkdv_tc_kernel
        k1 = min(k0 + bn, Sk)
        kt, vt = kf[:, :, k0:k1], vf[:, :, k0:k1]
        acc_k = torch.zeros(B, KH, k1 - k0, D)
        acc_v = torch.zeros(B, KH, k1 - k0, D)
        for g in range(G):
            heads = [kh * G + g for kh in range(KH)]   # head g of each kv head
            for q0 in range(0, Sq, bm):
                q1 = min(q0 + bm, Sq)
                vis = _mask(q0, q1, k0, k1, causal, window, Sq, Sk).T
                qt, dot = qf[:, heads, q0:q1], dof[:, heads, q0:q1]
                st = torch.einsum("bhkd,bhqd->bhkq", kt, qt)
                dpt = torch.einsum("bhkd,bhqd->bhkq", vt, dot)
                pt = _p(st, sc, lse[:, heads, None, q0:q1], vis)
                for part in _parts(pt, split_p):
                    acc_v += torch.einsum("bhkq,bhqd->bhkd", part, dot)
                dst = pt * (dpt - delta[:, heads, None, q0:q1])
                for part in _parts(dst, split_ds):
                    acc_k += torch.einsum("bhkq,bhqd->bhkd", part, qt)
        dk[:, :, k0:k1] = acc_k * scale
        dv[:, :, k0:k1] = acc_v
    kr, vr = (t.repeat_interleave(G, dim=1) for t in (kf, vf))
    for q0 in range(0, Sq, ROWS):            # fa_bwd_dq_tc_kernel
        q1 = min(q0 + ROWS, Sq)
        acc = torch.zeros(B, H, q1 - q0, D)
        for k0 in range(0, Sk, dq_keys(D)):
            k1 = min(k0 + dq_keys(D), Sk)
            vis = _mask(q0, q1, k0, k1, causal, window, Sq, Sk)
            s = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, q0:q1],
                             kr[:, :, k0:k1])
            dp = torch.einsum("bhqd,bhkd->bhqk", dof[:, :, q0:q1],
                              vr[:, :, k0:k1])
            p = _p(s, sc, lse[:, :, q0:q1, None], vis)
            ds = p * (dp - delta[:, :, q0:q1, None])
            for part in _parts(ds, split_ds):
                acc += torch.einsum("bhqk,bhkd->bhqd", part, kr[:, :, k0:k1])
        dq[:, :, q0:q1] = acc * scale
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _inputs(B, H, KH, Sq, Sk, D, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16()
            for shape in ((B, H, Sq, D), (B, KH, Sk, D), (B, KH, Sk, D),
                          (B, H, Sq, D))]


def _worst(got, want):
    """Largest error over its per-element limit of each gradient (<= 1
    passes): chip_smoke.py's bf16 bound for K2's backward."""
    out = []
    for g, w in zip(got, want):
        ref = w.float().abs()
        limit = 2.0 ** -7 * ref + 2.0 ** -10 * ref.max() + 1e-5
        out.append(((g.float() - w.float()).abs() / limit).max().item())
    return out


def _case(B, H, KH, Sq, Sk, D, mask, seed, **split):
    q, k, v, do = _inputs(B, H, KH, Sq, Sk, D, seed)
    o = flash_attention_ref(q, k, v, **mask)           # bf16, as the kernel
    lse = attention_lse_ref(q, k, **mask)
    want = flash_attention_bwd_ref(q, k, v, o, do, **mask)
    got = tc_bwd_model(q, k, v, o, do, lse, **mask, **split)
    return got, want


MASKS = {"causal": dict(causal=True, window=0),
         "window100": dict(causal=True, window=100),
         "bidirectional": dict(causal=False, window=0)}

# S crosses the 128-key and 128-row tiles and the 32 / 64-row stages; KH = 2;
# D = 256 (gemma3): 64-key dK/dV tiles and 32-key dQ stages, G 1 and 2
CASES = [(G, S, D) for G in (1, 3) for D in (64, 128) for S in (129, 300)]
CASES += [(G, S, 256) for G in (1, 2) for S in (129, 300)]


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("G,S,D", CASES, ids=str)
def test_split_model_within_the_bound(G, S, D, mask):
    got, want = _case(1, 2 * G, 2, S, S, D, MASKS[mask], seed=S + G + D)
    assert max(_worst(got, want)) <= 1.0, _worst(got, want)


@pytest.mark.parametrize("Sq,Sk", [(300, 65), (65, 300)], ids=str)
def test_split_model_sq_ne_sk(Sq, Sk):
    """Sq != Sk both ways under a window: with Sq = 300, Sk = 65 the rows
    past Sk + 99 see no key (lse = +inf) and get exactly 0."""
    mask = MASKS["window100"]
    got, want = _case(1, 6, 2, Sq, Sk, 64, mask, seed=Sq)
    assert max(_worst(got, want)) <= 1.0, _worst(got, want)
    if Sq > Sk + 99:
        assert not got[0][:, :, Sk + 99:].float().any()


def test_split_model_d256_rows_that_see_no_key():
    """D = 256 at gemma3's G = 2, Sq = 300 over Sk = 65 under a window of
    100: within the bound, and the rows past Sk + 99 get exactly 0."""
    got, want = _case(1, 4, 2, 300, 65, 256, MASKS["window100"], seed=5)
    assert max(_worst(got, want)) <= 1.0, _worst(got, want)
    assert not got[0][:, :, 65 + 99:].float().any()


def test_rounding_p_or_ds_once_misses_the_bound():
    """Why the kernels split: at smollm's heads (B=1, H=15, KH=5, S=511,
    D=64, causal), P rounded once to bf16 (dS split) or dS rounded once (P
    split) leaves dq, dk or dv outside the bound, the split model inside."""
    mask = MASKS["causal"]
    split = max(_worst(*_case(1, 15, 5, 511, 511, 64, mask, seed=11)))
    p_once = max(_worst(*_case(1, 15, 5, 511, 511, 64, mask, seed=11,
                               split_p=False)))
    ds_once = max(_worst(*_case(1, 15, 5, 511, 511, 64, mask, seed=11,
                                split_ds=False)))
    assert split <= 1.0 < max(p_once, ds_once), (split, p_once, ds_once)


# -- the forward's log-sum-exp against JAX, and the backward that takes it --

# B, H, KH, Sq, Sk, D, causal, window
LSE_SHAPES = [(2, 4, 2, 37, 37, 16, True, 0),
              (1, 6, 3, 80, 80, 64, True, 16),
              (1, 4, 2, 40, 70, 16, False, 0),
              (1, 4, 2, 65, 17, 16, True, 8)]      # rows that see no key


def _seen(Sq, Sk, causal, window):
    i = np.arange(Sq)[:, None]
    j = np.arange(Sk)[None, :]
    vis = np.ones((Sq, Sk), bool)
    if causal:
        vis &= i >= j
    if window:
        vis &= i - j < window
    return vis


@pytest.mark.parametrize("shape", LSE_SHAPES, ids=str)
def test_plain_lse_matches_jax_logsumexp(shape):
    """flash_attention(..., lse=) on CPU tensors fills the log2-domain
    log-sum-exp of the scaled, masked scores: jax.nn.logsumexp of the same
    scores (from the same numpy inputs) times log2(e), atol 1e-5; a row
    that sees no key gets +inf (its P is 0)."""
    B, H, KH, Sq, Sk, D, causal, window = shape
    rng = np.random.RandomState(3)
    q = rng.randn(B, H, Sq, D).astype(np.float32)
    k = rng.randn(B, KH, Sk, D).astype(np.float32)
    lse = torch.empty(B, H, Sq)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(k), causal=causal, window=window,
                          lse=lse)
    assert out.shape == (B, H, Sq, D)
    vis = _seen(Sq, Sk, causal, window)
    kr = np.repeat(k, H // KH, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, kr) / np.sqrt(D)
    want = np.asarray(jax.nn.logsumexp(jnp.where(vis, s, -jnp.inf), axis=-1)
                      * LOG2E)
    seen = vis.any(axis=1)
    np.testing.assert_allclose(lse.numpy()[:, :, seen], want[:, :, seen],
                               atol=1e-5, rtol=0)
    assert np.all(np.isposinf(lse.numpy()[:, :, ~seen]))


@pytest.mark.parametrize("shape", [LSE_SHAPES[1], LSE_SHAPES[2],
                                   LSE_SHAPES[3]], ids=str)
def test_plain_backward_given_lse(shape):
    """The plain backward given the forward's lse equals the one that
    recomputes it, and both equal jax.vjp of the reference's
    ``chunked_attention`` (f32, atol = rtol = 1e-5; rows that see no key
    get do = 0 there, as in test_torch_flash_attention_bwd.py)."""
    B, H, KH, Sq, Sk, D, causal, window = shape
    mask = dict(causal=causal, window=window)
    rng = np.random.RandomState(4)
    q, do = (rng.randn(B, Sq, H, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, Sk, KH, D).astype(np.float32) for _ in range(2))
    do[:, ~_seen(Sq, Sk, causal, window).any(axis=1)] = 0.0
    hm = [torch.from_numpy(t).transpose(1, 2) for t in (q, k, v, do)]
    lse = torch.empty(B, H, Sq)
    o = flash_attention(*hm[:3], lse=lse, **mask)
    given = flash_attention_bwd(*hm[:3], o, hm[3], lse=lse, **mask)
    recomputed = flash_attention_bwd_ref(*hm[:3], o, hm[3], **mask)
    _, vjp = jax.vjp(lambda a, b, c: j_chunked(
        a, b, c, causal=causal, window=window, q_chunk=32, kv_chunk=32),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    for name, g, r, w in zip("qkv", given, recomputed, want):
        np.testing.assert_array_equal(g.numpy(), r.numpy(), err_msg=name)
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
