"""The gradient of the port's flash prefill attention (K2's backward)
against the JAX package.

The reference has no backward kernel: it differentiates the jnp
``chunked_attention`` with autodiff.  So the plain backward
(``flash_attention_bwd_ref``, what the wrapper runs for CPU tensors and
what ``chip_smoke.py`` holds the CUDA kernels against on the card) is held
against ``jax.vjp`` of the reference's ``chunked_attention``, and against
torch autograd of the port's plain forward, in f32: causal, windowed and
bidirectional masks, G 1, 2 and 4, Sq != Sk both ways, rows that see no
key, and head dims 16, 64 and 256 (gemma3's).  Rows that see no key are 0
in the port and a uniform average in the jnp oracle, so against JAX their
incoming gradient is set to 0 (then both give them, and their keys,
nothing).  Tolerance: atol = rtol = 1e-5, f32 sums in another order.

The repair test: ``flash_attention_bshd`` (every forward path of the
model) passes gradients to q, k and v, equal to the plain backward's, and
under ``torch.no_grad()`` saves nothing for backward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import chunked_attention as j_chunked
from repro_torch.kernels.flash_attention import (flash_attention_bshd,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention import kernel as k2

TOL = dict(atol=1e-5, rtol=1e-5)

# B, H, KH, Sq, Sk, D, causal, window
SHAPES = [
    (2, 4, 4, 37, 37, 16, True, 0),          # G = 1
    (1, 4, 2, 65, 65, 16, True, 0),          # G = 2
    (2, 8, 2, 70, 70, 16, True, 0),          # G = 4
    (1, 4, 2, 50, 50, 16, False, 0),         # bidirectional
    (1, 6, 3, 80, 80, 16, True, 16),         # window
    (1, 4, 2, 40, 70, 16, False, 0),         # Sq < Sk
    (1, 4, 2, 70, 40, 16, True, 0),          # Sq > Sk
    (1, 4, 1, 17, 65, 16, True, 8),          # Sq < Sk, window
    (1, 4, 2, 65, 17, 16, True, 8),          # rows with no key
    (1, 4, 2, 1, 1, 16, True, 0),            # one token
    (1, 6, 2, 33, 33, 64, True, 0),          # smollm's head dim
    (1, 4, 2, 40, 40, 256, True, 16),        # gemma3's head dim, window
    (1, 4, 2, 40, 17, 256, True, 8),         # D = 256, rows with no key
]
# each axis once against JAX (every jit of the jnp oracle's vjp compiles
# for ~2 s): G 1 and 4, bidirectional, window, Sq < Sk, Sq > Sk, no key,
# D = 256 with a window
JAX_SHAPES = [SHAPES[i] for i in (0, 2, 3, 4, 5, 6, 8, 11)]


def _seen(shape) -> np.ndarray:
    """(Sq,) bool: the query row sees at least one key."""
    *_, Sq, Sk, _, causal, window = shape
    i = np.arange(Sq)[:, None]
    j = np.arange(Sk)[None, :]
    vis = np.ones((Sq, Sk), bool)
    if causal:
        vis &= i >= j
    if window:
        vis &= i - j < window
    return vis.any(axis=1)


def _inputs(shape, seed=0):
    """q, k, v, do in the model layout (B,S,H,D), f32."""
    B, H, KH, Sq, Sk, D, _, _ = shape
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, H, D).astype(np.float32),
            rng.randn(B, Sk, KH, D).astype(np.float32),
            rng.randn(B, Sk, KH, D).astype(np.float32),
            rng.randn(B, Sq, H, D).astype(np.float32))


def _bwd_ref_bshd(q, k, v, do, causal, window):
    """flash_attention_bwd_ref in the model layout (torch in, torch out)."""
    hm = [t.transpose(1, 2) for t in (q, k, v)]
    o = flash_attention_ref(*hm, causal=causal, window=window)
    grads = flash_attention_bwd_ref(*hm, o, do.transpose(1, 2),
                                    causal=causal, window=window)
    return [g.transpose(1, 2) for g in grads]


def _vjp_impl(q, k, v, do, causal, window):
    _, vjp = jax.vjp(lambda a, b, c: j_chunked(
        a, b, c, causal=causal, window=window, q_chunk=32, kv_chunk=32),
        q, k, v)
    return vjp(do)


_vjp_impl = jax.jit(_vjp_impl, static_argnums=(4, 5))


def _jax_vjp(q, k, v, do, causal, window):
    """jax.vjp of the reference's ``chunked_attention`` (q and kv chunks of
    32, so the online softmax crosses chunks) at ``do``."""
    return _vjp_impl(*map(jnp.asarray, (q, k, v, do)), causal, window)


@pytest.mark.parametrize("shape", JAX_SHAPES, ids=str)
def test_plain_backward_matches_jax_vjp(shape):
    *_, causal, window = shape
    q, k, v, do = _inputs(shape)
    do[:, ~_seen(shape)] = 0.0
    want = _jax_vjp(q, k, v, do, causal, window)
    got = _bwd_ref_bshd(*map(torch.from_numpy, (q, k, v, do)), causal,
                        window)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_matches_autograd_of_plain_forward(shape):
    *_, causal, window = shape
    q, k, v, do = map(torch.from_numpy, _inputs(shape, seed=1))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention_ref(*(t.transpose(1, 2) for t in leaves),
                              causal=causal, window=window).transpose(1, 2)
    want = torch.autograd.grad(out, leaves, do)
    got = _bwd_ref_bshd(q, k, v, do, causal, window)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL,
                                   err_msg=f"d{name}")
    # rows that see no key get no gradient
    np.testing.assert_array_equal(got[0].numpy()[:, ~_seen(shape)], 0)


@pytest.mark.parametrize("shape", [SHAPES[2], SHAPES[4], SHAPES[8]],
                         ids=str)
def test_attention_passes_gradients_to_q_k_v(shape):
    """The repair: a loss over ``flash_attention_bshd`` (the model's every
    forward path) gives q, k and v their gradient through attention, equal
    to the plain backward's, and the plain backward is what the wrapper
    runs for CPU tensors (no launch counted)."""
    *_, causal, window = shape
    q, k, v, do = map(torch.from_numpy, _inputs(shape, seed=2))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = k2.bwd_launches
    out = flash_attention_bshd(*leaves, causal=causal, window=window)
    # the gradient goes through K2's backward (the kernels on CUDA), not
    # through the CPU route's ``out.copy_``, which the card never takes
    assert type(out.grad_fn).__name__ == "_FlashAttentionBSHDBackward"
    (out * do).sum().backward()
    want = _bwd_ref_bshd(q, k, v, do, causal, window)
    for name, t, w in zip("qkv", leaves, want):
        assert t.grad is not None and t.grad.abs().max() > 0, name
        np.testing.assert_array_equal(t.grad.numpy(), w.numpy(),
                                      err_msg=f"d{name}")
    assert k2.bwd_launches == before


def test_no_grad_saves_nothing_for_backward():
    """Serving runs under ``torch.no_grad()``: the forward saves no tensor
    there, and with grad enabled it saves q, k, v, the output and each
    row's log-sum-exp (the backward takes it instead of recomputing it)."""
    q, k, v, _ = map(torch.from_numpy, _inputs(SHAPES[1]))
    q.requires_grad_(True)
    packed = []

    def pack(t):
        packed.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with torch.no_grad():
            flash_attention_bshd(q, k, v)
        assert packed == []
        flash_attention_bshd(q, k, v)
    assert len(packed) == 5
    assert packed[4].shape == (1, 4, 65) and packed[4].dtype == torch.float32


def test_bwd_wrapper_writes_strided_out_and_handles_empty_q():
    """``out`` may be strided views (the model layout); an empty q gives
    zero dk and dv."""
    shape = SHAPES[5]
    q, k, v, do = map(torch.from_numpy, _inputs(shape, seed=3))
    hm = [t.transpose(1, 2) for t in (q, k, v, do)]
    o = flash_attention_ref(*hm[:3])
    outs = tuple(torch.empty_like(t) for t in (q, k, v))
    flash_attention_bwd(*hm[:3], o, hm[3],
                        out=tuple(t.transpose(1, 2) for t in outs))
    want = flash_attention_bwd_ref(*hm[:3], o, hm[3])
    for g, w in zip(outs, want):
        np.testing.assert_array_equal(g.transpose(1, 2).numpy(), w.numpy())
    dq, dk, dv = flash_attention_bwd(hm[0][:, :, :0], hm[1], hm[2],
                                     o[:, :, :0], hm[3][:, :, :0])
    assert dq.shape == (1, 4, 0, 16)
    assert not dk.any() and not dv.any()


@pytest.mark.parametrize("S", [40, 70])
def test_plain_backward_at_mla_value_dim_matches_jax_vjp(S):
    """The plain backward at a value dim unlike the query dim (deepseek
    SMOKE's MLA: q/k of 24, v of 16, 4 heads, causal) against ``jax.vjp``
    of the reference's ``chunked_attention``, through the model-layout
    autograd function on CPU tensors.  (On CUDA tensors the backward
    refuses this value dim: ``tests/test_torch_flash_attention_tc.py``.)"""
    rng = np.random.RandomState(S)
    q, k = (rng.randn(2, S, 4, 24).astype(np.float32) for _ in range(2))
    v, do = (rng.randn(2, S, 4, 16).astype(np.float32) for _ in range(2))
    want = _jax_vjp(q, k, v, do, True, 0)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = flash_attention_bshd(*leaves, causal=True)
    assert out.shape == (2, S, 4, 16)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"d{name}")
