"""The tensor-core design of flash prefill attention (K2, bf16), on the CPU.

The bf16 kernel in ``repro_torch/csrc/flash_attention.cu`` runs only on the
card (its tests here are marked ``cuda``, with one for the backward
beside them; this file imports no JAX, so they
run on a card without it: ``pytest --noconftest -m cuda`` on this file).  Here a tile-level model of its arithmetic in plain torch (kv tiles
of 128 keys, 64 at D = 128 and 256; fp32 online softmax in exp2 form; P split into
bf16 hi and lo parts for two P.V products into one fp32 accumulator; one
bf16 rounding at the end) is held to the bound ``chip_smoke.py`` holds the kernel to: each
element within 2**-7 * |plain| + 1e-5 of ``flash_attention_ref``, the port's
plain version (which follows the Pallas kernel: fp32 probabilities in
P.V).  The same model with P rounded to bf16 once misses that bound, which
is why the kernel splits P.  Last, the wrapper's check of what TMA needs
(16-byte aligned bases and strides) on stride tuples, as torch gives them
for the layouts the model uses.
"""
import math
import threading

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as k2
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention.kernel import tma_strides

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def tile(D):
    """Keys per kv tile (Cfg<D>::kBN in the source)."""
    return 64 if D >= 128 else 128


def tc_model(q, k, v, *, causal, window, split=True):
    """The bf16 kernel's arithmetic, tile by tile.  q: (B,H,Sq,D), k/v:
    (B,KH,Sk,D), bf16 -> (B,H,Sq,D) bf16."""
    B, H, Sq, D = q.shape
    n = tile(D)
    KH, Sk = k.shape[1], k.shape[2]
    G = H // KH
    sc = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32) * LOG2E
    qg = q.float().reshape(B, KH, G, Sq, D)
    m = torch.full((B, KH, G, Sq), NEG_INF)      # running max, raw scores
    ms = torch.zeros(B, KH, G, Sq)               # m * sc as used
    l = torch.zeros(B, KH, G, Sq)
    acc = torch.zeros(B, KH, G, Sq, D)
    qpos = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, n):
        kt = k[:, :, k0:k0 + n].float()
        vt = v[:, :, k0:k0 + n].float()
        # bf16 products are exact in fp32; the sum is fp32
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kt)
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        vis = torch.ones(Sq, kt.shape[2], dtype=torch.bool)
        if causal:
            vis &= kpos <= qpos
        if window:
            vis &= qpos - kpos < window
        s = torch.where(vis, s, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        mu = torch.where(m_new == NEG_INF, 0.0, m_new * sc)
        corr = torch.where(m == NEG_INF, 1.0, torch.exp2(ms - mu))
        # one FMA: s * sc - mu, rounded once to fp32
        p = torch.exp2((s.double() * sc.double() - mu.double()[..., None])
                       .float())
        hi = p.bfloat16().float()
        parts = [hi, (p - hi).bfloat16().float()] if split else [hi]
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None]
        for part in parts:
            acc = acc + torch.einsum("bhgqk,bhkd->bhgqd", part, vt)
        m, ms = m_new, mu
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, Sq, D).bfloat16()


def _inputs(B, H, KH, S, D, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32))
            .bfloat16() for shape in ((B, H, S, D), (B, KH, S, D),
                                      (B, KH, S, D))]


def _worst(out, ref):
    """Largest error over its per-element limit (<= 1 passes)."""
    diff = (out.float() - ref.float()).abs()
    limit = 2.0 ** -7 * ref.float().abs() + 1e-5
    return (diff / limit).max().item()


MASKS = {"causal": dict(causal=True, window=0),
         "window100": dict(causal=True, window=100),
         "bidirectional": dict(causal=False, window=0)}

# S crosses the 128-row query tiles and the kv tiles; KH = 2
CASES = [(G, S, 64) for G in (1, 3) for S in (1, 127, 128, 129, 511)]
CASES += [(3, 129, 16), (3, 129, 128), (2, 129, 256)]


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("G,S,D", CASES, ids=str)
def test_split_p_model_within_one_ulp(G, S, D, mask):
    q, k, v = _inputs(1, 2 * G, 2, S, D, seed=S + G)
    ref = flash_attention_ref(q, k, v, **MASKS[mask])
    worst = _worst(tc_model(q, k, v, **MASKS[mask]), ref)
    assert worst <= 1.0, worst


@pytest.mark.parametrize("mask", MASKS)
def test_split_p_model_within_one_ulp_long(mask):
    """S = 2048, 16 kv tiles, at one narrow head count (H = 3, KH = 1)."""
    q, k, v = _inputs(1, 3, 1, 2048, 64, seed=7)
    ref = flash_attention_ref(q, k, v, **MASKS[mask])
    worst = _worst(tc_model(q, k, v, **MASKS[mask]), ref)
    assert worst <= 1.0, worst


def test_bf16_p_once_misses_the_bound():
    """Why the kernel splits P: rounded to bf16 once, P.V leaves the one-ulp
    bound far behind at S = 2048 (causal, H = KH = 3)."""
    q, k, v = _inputs(1, 3, 3, 2048, 64, seed=8)
    ref = flash_attention_ref(q, k, v, causal=True)
    split = _worst(tc_model(q, k, v, causal=True, window=0), ref)
    once = _worst(tc_model(q, k, v, causal=True, window=0, split=False), ref)
    assert split <= 1.0 < once, (split, once)


# -- what TMA takes -----------------------------------------------------------

def _strides(t):
    return tma_strides(t.shape, t.stride(), t.element_size(), t.data_ptr())


def test_tma_strides_accept_the_kernel_layouts():
    """(B,H,S,D) tensors, the (B,S,H,D) views of ops.flash_attention_bshd
    and slices of one fused qkv tensor pass with their own strides."""
    x = torch.empty(2, 15, 37, 64, dtype=torch.bfloat16)
    assert _strides(x) == (15 * 37 * 64, 37 * 64, 64)
    y = torch.empty(2, 37, 15, 64, dtype=torch.bfloat16).transpose(1, 2)
    assert _strides(y) == (37 * 15 * 64, 64, 15 * 64)
    S, H, KH, D = 65, 4, 2, 16
    qkv = torch.empty(2, S, H + 2 * KH, D, dtype=torch.bfloat16)
    q, k, v = (qkv[:, :, :H], qkv[:, :, H:H + KH], qkv[:, :, H + KH:])
    for t in (q, k, v):
        t = t.transpose(1, 2)
        assert _strides(t) == (S * (H + 2 * KH) * D, D, (H + 2 * KH) * D)
    assert k.data_ptr() - qkv.data_ptr() == H * D * 2


def test_tma_strides_normalise_size_one_dims():
    """A dim of size 1 is never stepped over, so its stride (anything torch
    chose) becomes that of a contiguous tensor."""
    assert tma_strides((1, 4, 8, 64), (3, 512, 64, 1), 2, 0) == \
        (4 * 8 * 64, 512, 64)
    assert tma_strides((2, 4, 1, 64), (256, 64, 7, 1), 2, 4096) == \
        (256, 64, 64)
    assert tma_strides((1, 1, 1, 16), (0, 0, 0, 1), 2, 32) == (16, 16, 16)
    x = torch.empty(1, 37, 15, 64, dtype=torch.bfloat16).transpose(1, 2)
    assert _strides(x[:, :, :1]) == (15 * 64, 64, 64)


@pytest.mark.parametrize("shape,strides,ptr,what", [
    ((2, 4, 8, 64), (2048, 512, 64, 1), 2, "aligned base"),
    ((2, 4, 8, 64), (2048, 512, 68, 1), 0, "multiple of 16"),
    ((2, 4, 8, 64), (2048, 0, 64, 1), 0, "multiple of 16"),
    ((2, 4, 8, 64), (2048, -512, 64, 1), 0, "multiple of 16"),
    ((2, 4, 8, 16), (2052, 512, 16, 1), 0, "multiple of 16"),
], ids=["base", "row", "expanded", "negative", "batch"])
def test_tma_strides_refuse_what_tma_cannot_read(shape, strides, ptr, what):
    with pytest.raises(ValueError, match=what):
        tma_strides(shape, strides, 2, ptr)


def test_tma_strides_refuse_a_misaligned_slice():
    """A view one element into its storage, and rows padded to 68
    elements (136 bytes), are refused: the kernel has no other route."""
    flat = torch.empty(2 * 4 * 8 * 64 + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned base"):
        _strides(flat[1:].view(2, 4, 8, 64))
    padded = torch.empty(2, 4, 8, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiple of 16"):
        _strides(padded)


@pytest.mark.cuda
def test_cuda_bf16_refuses_what_tma_cannot_read():
    """On the card: a bf16 tensor TMA cannot read raises ValueError and
    launches nothing; there is no route to another kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    k = torch.randn(1, 2, 8, 64, device="cuda").bfloat16()
    flat = torch.randn(1 * 4 * 8 * 64 + 1, device="cuda").bfloat16()
    padded = torch.randn(1, 4, 8, 68, device="cuda").bfloat16()[..., :64]
    before = k2.launches
    for q in (flat[1:].view(1, 4, 8, 64), padded):
        with pytest.raises(ValueError, match="TMA"):
            flash_attention(q, k, k)
    assert k2.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 64, 128, 256])
def test_cuda_tc_kernel_within_one_ulp(D):
    """On the card: the tensor-core kernel against the plain version, each
    element within 2**-7 * |plain| + 1e-5, across the tile edges (S = 129,
    300) and every mask; every launch counted as a tensor-core launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    before = k2.tc_launches
    n = 0
    for S in (129, 300):
        q, k, v = (t.cuda() for t in _inputs(2, 6, 2, S, D, seed=S))
        for mask in MASKS.values():
            out = flash_attention(q, k, v, **mask)
            n += 1
            assert _worst(out, flash_attention_ref(q, k, v, **mask)) <= 1.0
    assert k2.tc_launches == before + n


@pytest.mark.cuda
def test_cuda_bf16_bwd_refuses_what_tma_cannot_read():
    """On the card: the bf16 backward (tensor-core kernels, q, k, v and dO
    read by TMA) refuses with ValueError a tensor TMA cannot read, and
    launches nothing; without the forward's lse it refuses too.  The f32
    backward refuses a dO its 16-byte loads cannot read."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    q, k, v = (t.cuda() for t in _inputs(1, 4, 2, 8, 64, seed=1))
    lse = torch.empty(1, 4, 8, device="cuda")
    o = flash_attention(q, k, v, lse=lse)
    flat = torch.randn(1 * 4 * 8 * 64 + 1, device="cuda").bfloat16()
    padded = torch.randn(1, 4, 8, 68, device="cuda").bfloat16()[..., :64]
    before = k2.bwd_launches
    for do in (flat[1:].view(1, 4, 8, 64), padded):
        with pytest.raises(ValueError, match="TMA"):
            k2.flash_attention_bwd(q, k, v, o, do, lse=lse)
    with pytest.raises(ValueError, match="lse"):
        k2.flash_attention_bwd(q, k, v, o, o)
    # f32 runs on the CUDA cores, but its delta kernel reads o and dO in
    # 16-byte loads too: a dO those cannot read raises the same way.
    q, k, v, o = (t.float() for t in (q, k, v, o))
    flat = torch.randn(1 * 4 * 8 * 64 + 1, device="cuda")
    padded = torch.randn(1, 4, 8, 66, device="cuda")[..., :64]
    for do in (flat[1:].view(1, 4, 8, 64), padded):
        with pytest.raises(ValueError, match="16-byte loads"):
            k2.flash_attention_bwd(q, k, v, o, do, lse=lse)
    assert k2.bwd_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_cuda_bwd_head_dim_256_matches_plain(dt):
    """On the card: K2's backward at D = 256 (gemma3's heads, G = 2; the
    dK/dV kernel's split warpgroups and the dQ kernel's 32-key ring in
    bf16, 32-row tiles in f32) against its plain version, causal, with a
    window that cuts the 64-key tiles, bidirectional, and Sq > Sk + window
    - 1 (rows that see no key get exactly 0): f32 within atol = rtol =
    1e-4, bf16 each element within 2**-7 x |plain| + 2**-10 x max|plain|
    + 1e-5 (chip_smoke.py's bounds); three launches a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dtype = getattr(torch, dt)
    for (Sq, Sk), mask in (((300, 300), MASKS["causal"]),
                           ((300, 300), MASKS["window100"]),
                           ((129, 129), MASKS["bidirectional"]),
                           ((300, 65), MASKS["window100"])):
        q = _inputs(2, 16, 8, Sq, 256, seed=Sq)[0].cuda().to(dtype)
        k, v = (t.cuda().to(dtype)
                for t in _inputs(2, 16, 8, Sk, 256, seed=Sk + 1)[1:])
        do = torch.randn(q.shape, device="cuda").to(dtype)
        lse = torch.empty(q.shape[:3], device="cuda")
        o = flash_attention(q, k, v, lse=lse, **mask)
        before = k2.bwd_launches
        got = k2.flash_attention_bwd(q, k, v, o, do, lse=lse, **mask)
        want = flash_attention_bwd_ref(q, k, v, o, do, **mask)
        torch.cuda.synchronize()
        assert k2.bwd_launches == before + k2.BWD_KERNELS
        for g, w in zip(got, want):
            ref = w.float().abs()
            if dtype == torch.float32:
                limit = 1e-4 + 1e-4 * ref
            else:
                limit = 2.0 ** -7 * ref + 2.0 ** -10 * ref.max() + 1e-5
            assert ((g.float() - w.float()).abs() <= limit).all()
        if mask["window"] and Sq > Sk + mask["window"] - 1:
            assert not got[0][:, :, Sk + mask["window"] - 1:].any()


@pytest.mark.cuda
def test_cuda_tensor_maps_from_a_fresh_thread():
    """The repair (ROADMAP queue 3): a host thread that has made no
    CUDA runtime call has no current context, and the bf16 kernels' tensor
    maps (cuTensorMapEncodeTiled) were refused there with error -1; the
    backward of ``flash_attention_bshd`` first in autograd's device thread
    is such a call.  The forward and the backward from a new thread now run
    and equal the same calls from this one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    q, k, v = (t.cuda() for t in _inputs(2, 4, 2, 129, 64, seed=3))
    do = torch.randn(q.shape, device="cuda").bfloat16()

    def calls():
        lse = torch.empty(q.shape[:3], device="cuda")
        o = flash_attention(q, k, v, lse=lse)
        return (o,) + tuple(k2.flash_attention_bwd(q, k, v, o, do, lse=lse))

    res = {}
    thread = threading.Thread(target=lambda: res.update(out=calls()))
    thread.start()
    thread.join(timeout=120)
    assert "out" in res
    torch.cuda.synchronize()
    for a, b in zip(res["out"], calls()):
        assert torch.equal(a, b)
