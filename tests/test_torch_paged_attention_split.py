"""The split-K design of paged decode attention (K1), on the CPU.

The CUDA kernel in ``repro_torch/csrc/paged_attention.cu`` runs only on the
card.  Here a model of its arithmetic in plain torch is held in f32 at
atol = rtol = 1e-5 against the port's plain version and against the Pallas
kernel (``interpret=True``), on the same numpy inputs: each split owns the
contiguous table entries ``split_bounds`` gives it and reads only the live
ones, keeps an fp32 running max m, denominator l and unnormalised
accumulator over its tokens (m = -1e30, l = 0, acc = 0 when it has none),
and the splits are merged with the log-sum-exp rescale.  Then the host's
split choice (``num_splits``, from shapes alone) and the wrapper's
refusals, on plain numbers.  The card-only tests are marked ``cuda``;
they import no JAX, so they run on a card without it
(``pytest --noconftest -m cuda`` on this file).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import kernel as k1
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_ref)
from repro_torch.kernels.paged_attention.kernel import (
    BLOCKS_PER_SM, MIN_SPLIT_TOKENS, check_launch, num_splits, split_bounds)

TOL = dict(atol=1e-5, rtol=1e-5)
NEG_INF = -1e30
NP = 12
SPLITS = (1, 2, 3, 7, NP)


def split_model(q, kp, vp, tables, lengths, splits, ks=None, vs=None):
    """The kernel's arithmetic, split by split: per-split partials (m, l,
    acc) over the split's live tokens, then the log-sum-exp combine.
    Table entries past a row's live pages are never indexed."""
    B, H, D = q.shape
    _, page, KH, _ = kp.shape
    np_ = tables.shape[1]
    G = H // KH
    qg = q.float().reshape(B, KH, G, D) * (1.0 / math.sqrt(D))
    lengths = lengths.long().clamp(0, np_ * page)
    out = torch.zeros(B, KH, G, D)
    for b in range(B):
        ms, ls, accs = [], [], []
        for lo, hi in split_bounds(np_, splits):
            t0, t1 = lo * page, min(hi * page, int(lengths[b]))
            if t1 <= t0:
                ms.append(torch.full((KH, G), NEG_INF))
                ls.append(torch.zeros(KH, G))
                accs.append(torch.zeros(KH, G, D))
                continue
            ids = tables[b, lo:-(-t1 // page)].long()   # live entries only
            k = kp[ids].float()
            v = vp[ids].float()
            if ks is not None:
                k = k * ks[ids][:, None, :, None]
                v = v * vs[ids][:, None, :, None]
            k = k.reshape(-1, KH, D)[:t1 - t0]
            v = v.reshape(-1, KH, D)[:t1 - t0]
            s = torch.einsum("hgd,thd->hgt", qg[b], k)
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            ms.append(m)
            ls.append(p.sum(-1))
            accs.append(torch.einsum("hgt,thd->hgd", p, v))
        m = torch.stack(ms)                       # (splits, KH, G)
        w = torch.exp(m - m.amax(0))
        den = (w * torch.stack(ls)).sum(0).clamp_min(1e-30)
        out[b] = (w[..., None] * torch.stack(accs)).sum(0) / den[..., None]
    return out.reshape(B, H, D).to(q.dtype)


def _lengths(page):
    """0, 1, page - 1, page, page + 1, NP * page, and every split boundary
    of SPLITS with its two neighbours."""
    lens = {0, 1, page - 1, page, page + 1, NP * page}
    for s in SPLITS:
        for lo, _ in split_bounds(NP, s)[1:]:
            lens |= {lo * page - 1, lo * page, lo * page + 1}
    return sorted(x for x in lens if 0 <= x <= NP * page)


def _inputs(G, page, lengths, *, D=16, KH=2, int8=False, seed=0):
    """numpy q, pools (f32, or int8 with (P, KH) f32 scales), a shuffled
    block table and the lengths; entries past each row's live pages are
    returned twice: as other valid ids (for the Pallas kernel) and as ids
    far outside the pool (for the port, which must never read them)."""
    rng = np.random.RandomState(seed)
    B = len(lengths)
    P = B * NP + 1
    q = rng.randn(B, KH * G, D).astype(np.float32)
    if int8:
        kp = rng.randint(-127, 128, (P, page, KH, D)).astype(np.int8)
        vp = rng.randint(-127, 128, (P, page, KH, D)).astype(np.int8)
        ks = (rng.rand(P, KH) * 0.02 + 1e-3).astype(np.float32)
        vs = (rng.rand(P, KH) * 0.02 + 1e-3).astype(np.float32)
    else:
        kp = rng.randn(P, page, KH, D).astype(np.float32)
        vp = rng.randn(P, page, KH, D).astype(np.float32)
        ks = vs = None
    tables = (rng.permutation(P - 1) + 1).reshape(B, NP).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    dead = np.arange(NP)[None, :] >= (-(-lengths // page))[:, None]
    far = np.where(dead, 2 ** 31 - 1, tables).astype(np.int32)
    other = np.where(dead, tables[::-1], tables).astype(np.int32)
    return q, kp, vp, ks, vs, lengths, far, other


def _pallas(q, kp, vp, tables, lengths, ks=None, vs=None):
    import jax.numpy as jnp
    from repro.kernels.paged_attention import paged_attention as pallas
    j = jnp.asarray
    return np.asarray(pallas(j(q), j(kp), j(vp), j(tables), j(lengths),
                             k_scales=None if ks is None else j(ks),
                             v_scales=None if vs is None else j(vs),
                             interpret=True))


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _check_against_both(G, page, *, D=16, int8=False, seed=0):
    q, kp, vp, ks, vs, lengths, far, other = _inputs(
        G, page, _lengths(page), D=D, int8=int8, seed=seed)
    want = _pallas(q, kp, vp, other, lengths, ks, vs)
    tq, tk, tv, tks, tvs, tl, tfar = _t(q, kp, vp, ks, vs, lengths, far)
    plain = paged_attention_ref(tq, tk, tv, tfar, tl, tks, tvs).numpy()
    np.testing.assert_allclose(plain, want, **TOL)
    for splits in SPLITS:
        got = split_model(tq, tk, tv, tfar, tl, splits, tks, tvs).numpy()
        np.testing.assert_allclose(got, plain, **TOL, err_msg=f"{splits}")
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"{splits}")
        assert np.all(got[lengths == 0] == 0)


@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("G", [1, 2, 3, 8])
def test_split_model_matches_plain_and_pallas(G, page):
    """Split counts 1, 2, 3, 7 and NP; lengths 0, 1, page - 1, page,
    page + 1, NP * page and on and next to every split boundary; dead
    table entries far outside the pool."""
    _check_against_both(G, page, seed=G + page)


@pytest.mark.parametrize("page", [8, 16])
def test_split_model_int8_pages(page):
    """int8 pages times their (page, kv head) fp32 scales, at G = 3."""
    _check_against_both(3, page, int8=True, seed=page)


def test_split_model_full_head_dim():
    """The serving shape's head dim (D = 64, G = 3)."""
    _check_against_both(3, 16, D=64, seed=5)


def test_wrapper_on_cpu_takes_num_splits_and_runs_plain():
    """On CPU tensors ``num_splits`` is accepted, the plain version runs
    (bit for bit) and no launch is counted."""
    q, kp, vp, _, _, lengths, far, _ = _inputs(3, 16, [0, 17, 100, 192])
    t = _t(q, kp, vp, far, lengths)
    before = (k1.launches, k1.split_launches)
    got = paged_attention(*t, num_splits=3)
    assert (k1.launches, k1.split_launches) == before
    assert torch.equal(got, paged_attention_ref(*t))


# -- the split choice ------------------------------------------------------

@pytest.mark.parametrize("np_", [1, 2, 3, 4, 7, 12, 37, 128])
def test_split_bounds_partition_the_table(np_):
    """Every table entry belongs to exactly one split, in order, and no
    split is empty when NP >= splits."""
    for splits in range(1, np_ + 1):
        bounds = split_bounds(np_, splits)
        assert len(bounds) == splits
        owned = [i for lo, hi in bounds for i in range(lo, hi)]
        assert owned == list(range(np_))
        assert all(hi > lo for lo, hi in bounds)


def test_num_splits_is_one_on_the_serving_decode():
    """The paged cluster's decode: B <= 5 rows (4 requests and a pad row),
    KH = 5, NP = 4 at page 16, on an H100's 132 SMs."""
    for B in range(1, 6):
        assert num_splits(B, 5, 4, 16, 132) == 1


def test_num_splits_fills_the_card_at_long_context():
    """One sequence of 32768 tokens (KH = 5, page 16): enough blocks for
    every SM, no more than one wave of BLOCKS_PER_SM per SM, no split
    shorter than MIN_SPLIT_TOKENS of capacity."""
    sms, KH, np_, page = 132, 5, 2048, 16
    s = num_splits(1, KH, np_, page, sms)
    assert sms <= KH * s <= BLOCKS_PER_SM * sms
    assert min(hi - lo for lo, hi in split_bounds(np_, s)) * page >= \
        MIN_SPLIT_TOKENS


@pytest.mark.parametrize("B,KH,np_,page", [
    (1, 5, 2048, 16), (32, 5, 128, 16), (4, 5, 36, 16), (1, 1, 1, 16),
    (64, 8, 512, 8), (200, 5, 128, 16), (3, 2, 9, 8)])
def test_num_splits_bounds_and_determinism(B, KH, np_, page):
    """1 <= splits <= NP, one wave at most unless a split count of 1 is
    already more, and the same answer for the same shapes."""
    s = num_splits(B, KH, np_, page, 132)
    assert 1 <= s <= np_
    assert s == 1 or B * KH * s <= BLOCKS_PER_SM * 132
    assert all(num_splits(B, KH, np_, page, 132) == s for _ in range(3))


# -- what the kernel takes ---------------------------------------------------

@pytest.mark.parametrize("D,G,itemsize", [
    (16, 1, 1), (64, 3, 2), (128, 8, 4), (256, 2, 2), (256, 16, 4)])
def test_check_launch_accepts(D, G, itemsize):
    check_launch(D, G, itemsize, (0, 16, 4096))


@pytest.mark.parametrize("D,G,itemsize,ptrs,what", [
    (20, 3, 2, (), "multiple of 16"),
    (24, 3, 2, (), "head_dim"),
    (32, 3, 2, (), "head_dim"),
    (512, 1, 2, (), "head_dim"),
    (64, 0, 2, (), "query heads"),
    (64, 17, 2, (), "query heads"),
    (64, 3, 2, (0, 8), "aligned base"),
    (64, 3, 1, (2,), "aligned base"),
], ids=["words", "d24", "d32", "d512", "g0", "g17", "v-base", "k-base"])
def test_check_launch_refuses(D, G, itemsize, ptrs, what):
    with pytest.raises(ValueError, match=what):
        check_launch(D, G, itemsize, ptrs)


def test_check_launch_refuses_a_misaligned_pool():
    """A pool view one element into its storage is refused."""
    flat = torch.empty(2 * 16 * 2 * 64 + 1, dtype=torch.bfloat16)
    pool = flat[1:].view(2, 16, 2, 64)
    with pytest.raises(ValueError, match="aligned base"):
        check_launch(64, 3, pool.element_size(), (pool.data_ptr(),))


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_forced_splits_match_plain_version():
    """On the card: the kernel with forced split counts against the plain
    version (f32 within 1e-5; bf16 each element within 2**-7 * |plain| +
    1e-5), lengths across the split boundaries, dead entries far outside
    the pool; every call with more than one split counted in
    ``split_launches``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    q, kp, vp, _, _, lengths, far, _ = _inputs(3, 16, _lengths(16), D=64)
    args = [t.cuda() for t in _t(q, kp, vp, far, lengths)]
    for dtype in (torch.float32, torch.bfloat16):
        a = [t.to(dtype) if t.is_floating_point() else t for t in args]
        ref = paged_attention_ref(*a).float()
        for splits in SPLITS:
            before = (k1.launches, k1.split_launches)
            out = paged_attention(*a, num_splits=splits).float()
            assert (k1.launches, k1.split_launches) == (
                before[0] + 1, before[1] + (splits > 1))
            diff = (out - ref).abs()
            if dtype == torch.float32:
                assert diff.max().item() <= 1e-5
            else:
                assert (diff <= 2.0 ** -7 * ref.abs() + 1e-5).all()
    with pytest.raises(ValueError):
        paged_attention(*args, num_splits=NP + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("G,KH", [(9, 4), (1, 16)], ids=["G9", "G1"])
def test_cuda_head_groups_at_d128_match_plain_version(G, KH):
    """On the card, D = 128 in bf16 at starcoder2's G = 9 (H = 36, KH =
    4: head groups of 3, 3, 3 and an idle one) and olmo's G = 1 (H = KH =
    16): each element within 2**-7 * |plain| + 1e-5 of the plain version,
    at the splits ``num_splits`` chooses and at 3."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    q, kp, vp, _, _, lengths, far, _ = _inputs(G, 16, _lengths(16), D=128,
                                               KH=KH)
    a = [t.cuda() for t in _t(q, kp, vp, far, lengths)]
    a = [t.to(torch.bfloat16) if t.is_floating_point() else t for t in a]
    ref = paged_attention_ref(*a).float()
    for splits in (None, 3):
        before = k1.launches
        out = paged_attention(*a, num_splits=splits).float()
        assert k1.launches == before + 1
        assert (((out - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-5).all())
