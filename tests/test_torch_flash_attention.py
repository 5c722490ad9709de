"""Flash prefill attention of the port (K2) against the JAX package.

The kernel's plain version (``flash_attention_ref``, what the wrapper runs
for CPU tensors) is held against the Pallas kernel run in interpret mode,
as ``tests/test_kernels.py`` runs it, on a few shapes (interpret mode is
slow), and against the reference's jnp oracle on all of them; the port's
``chunked_attention`` against the reference's.  Tolerances are the
reference's own: 2e-4 in f32, 3e-2 in bf16 (``tests/test_kernels.py``
``TOL``); ``chunked_attention`` in f32 at 1e-5.  Rows that see no key
(window with Sq > Sk + window - 1) are not compared: the port defines them
as 0, the Pallas kernel's value depends on its tile size.

The CUDA kernel itself is compared with its plain version by the test
marked ``cuda`` (it skips without a card) and by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import flash_attention_ref as j_flash_ref
from repro.models.attention import chunked_attention as j_chunked
from repro_torch.kernels.flash_attention import kernel as k2
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bshd,
                                                 flash_attention_ref)
from repro_torch.models.attention import chunked_attention

TOL = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=3e-2, atol=3e-2)}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}

# B, H, KH, Sq, Sk, D, causal, window: ``FLASH_SHAPES`` of
# tests/test_kernels.py, then G = 3, B = 3 and Sq in {1, 17, 65}
SHAPES = [
    (1, 4, 4, 128, 128, 64, True, 0),
    (2, 8, 2, 256, 256, 128, True, 0),       # GQA
    (1, 4, 1, 128, 128, 128, True, 0),       # MQA
    (2, 4, 4, 128, 128, 64, False, 0),       # bidirectional
    (1, 4, 2, 256, 256, 64, True, 100),      # sliding window
    (1, 2, 2, 200, 200, 64, True, 0),        # ragged (pad to blocks)
    (1, 2, 2, 96, 160, 64, False, 0),        # cross lengths
    (3, 15, 5, 65, 65, 64, True, 0),         # smollm heads: G = 3, B = 3
    (2, 6, 2, 1, 1, 16, True, 0),            # one token
    (1, 6, 2, 17, 17, 16, True, 0),
    (1, 6, 2, 65, 65, 16, False, 0),
    (1, 6, 2, 17, 65, 16, True, 8),          # Sq < Sk, window
    (1, 6, 2, 65, 17, 16, True, 0),          # Sq > Sk
    (1, 4, 2, 65, 17, 16, True, 8),          # rows with no key (ignored)
]
# interpret mode is slow: the Pallas kernel itself on these
INTERPRET = [SHAPES[i] for i in (4, 6, 7, 11, 12, 13)]


def _qkv(shape, dt, seed=0):
    B, H, KH, Sq, Sk, D, _, _ = shape
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, Sq, D).astype(np.float32)
    k = rng.randn(B, KH, Sk, D).astype(np.float32)
    v = rng.randn(B, KH, Sk, D).astype(np.float32)
    # round through the working dtype once, so both packages see the same
    # values
    return [np.array(jnp.asarray(a, JDT[dt]).astype(jnp.float32))
            for a in (q, k, v)]


def _seen_rows(shape):
    """Query rows that see at least one key (the rest are compared to
    nothing)."""
    B, H, KH, Sq, Sk, D, causal, window = shape
    if not window:
        return slice(None)
    return slice(0, min(Sq, Sk + window - 1))


def _port(arrays, dt, shape):
    *_, causal, window = shape
    q, k, v = (torch.from_numpy(a).to(TDT[dt]) for a in arrays)
    out = flash_attention(q, k, v, causal=causal, window=window)
    return out.float().numpy()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_version_matches_reference_oracle(shape, dt):
    arrays = _qkv(shape, dt)
    *_, causal, window = shape
    want = j_flash_ref(*(jnp.asarray(a, JDT[dt]) for a in arrays),
                       causal=causal, window=window)
    rows = _seen_rows(shape)
    np.testing.assert_allclose(
        _port(arrays, dt, shape)[:, :, rows],
        np.asarray(want, np.float32)[:, :, rows], **TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", INTERPRET, ids=str)
def test_plain_version_matches_pallas_kernel(shape, dt):
    arrays = _qkv(shape, dt, seed=1)
    *_, causal, window = shape
    want = j_flash(*(jnp.asarray(a, JDT[dt]) for a in arrays),
                   causal=causal, window=window, block_q=64, block_kv=64,
                   interpret=True)
    rows = _seen_rows(shape)
    np.testing.assert_allclose(
        _port(arrays, dt, shape)[:, :, rows],
        np.asarray(want, np.float32)[:, :, rows], **TOL[dt])


def test_rows_that_see_no_key_are_zero():
    """Window 8, Sq 65 > Sk 17 + 8 - 1: rows 24.. see no key and give 0."""
    shape = (1, 4, 2, 65, 17, 16, True, 8)
    out = _port(_qkv(shape, "f32"), "f32", shape)
    assert np.abs(out[:, :, :24]).max() > 0
    np.testing.assert_array_equal(out[:, :, 24:], 0)


@pytest.mark.parametrize("mask", [dict(causal=True, window=0),
                                  dict(causal=True, window=100),
                                  dict(causal=False, window=0)],
                         ids=["causal", "window", "bidirectional"])
@pytest.mark.parametrize("skip", [False, True], ids=["all", "skip"])
def test_chunked_attention_matches_reference(mask, skip):
    """S = 300 across q chunks of 64 and kv chunks of 128 on the reference
    side (the port tiles by itself), smollm SMOKE heads (4 q / 2 kv, 16)."""
    rng = np.random.RandomState(2)
    q = rng.randn(2, 300, 4, 16).astype(np.float32)
    k = rng.randn(2, 300, 2, 16).astype(np.float32)
    v = rng.randn(2, 300, 2, 16).astype(np.float32)
    want = j_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     q_chunk=64, kv_chunk=128, skip_masked_chunks=skip,
                     **mask)
    got = chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), q_chunk=64, kv_chunk=128,
                            skip_masked_chunks=skip, **mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_chunked_attention_refuses_mla_value_dim():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        chunked_attention(q, q, torch.zeros(1, 4, 2, 8))


def test_bshd_layout_matches_bhsd():
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(2, 37, 6, 16).astype(np.float32))
    k = torch.from_numpy(rng.randn(2, 37, 2, 16).astype(np.float32))
    out = flash_attention_bshd(q, k, k, causal=True)
    want = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               k.transpose(1, 2)).transpose(1, 2)
    assert out.is_contiguous() and out.shape == q.shape
    torch.testing.assert_close(out, want, atol=0, rtol=0)


def test_wrapper_rule_cpu_plain_version_and_device_checks():
    """CPU tensors take the plain version and launch nothing; a call that
    is not all-CPU and not CUDA raises, as do inputs the kernel does not
    take."""
    k2.launches = 0
    q = torch.randn(1, 4, 8, 16)
    k = torch.randn(1, 2, 8, 16)
    torch.testing.assert_close(flash_attention(q, k, k),
                               flash_attention_ref(q, k, k), atol=0, rtol=0)
    assert k2.launches == 0
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention(q.to("meta"), k, k)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention(q, k.to("meta"), k)
    k32 = torch.randn(1, 2, 8, 32)
    for args, match in (
            ((torch.randn(1, 4, 8, 32), k32, k32), "instances"),
            ((q, torch.randn(1, 3, 8, 16), torch.randn(1, 3, 8, 16)),
             "multiple"),
            ((q, k.to(torch.bfloat16), k.to(torch.bfloat16)),
             "share a dtype"),
            ((torch.randn(1, 4, 16, 8).transpose(2, 3), k, k),
             "contiguous"),
            ((q, k[:, :, :0], k[:, :, :0]), "at least one key")):
        with pytest.raises((ValueError, TypeError), match=match):
            k2._check(*args, torch.empty_like(args[0]), 0)
    with pytest.raises(ValueError, match="window"):
        k2._check(q, k, k, torch.empty_like(q), -1)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cuda_kernel_matches_plain_version(dt):
    """On the card: the kernel against its plain version (f32 <= 1e-5;
    bf16 within one output ulp, 2**-7 x max|plain|), and it counts its
    launch (bf16 launches as tensor-core launches too)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32))
               .to("cuda", TDT[dt])
               for s in ((2, 15, 300, 64), (2, 5, 300, 64), (2, 5, 300, 64)))
    before, tc_before = k2.launches, k2.tc_launches
    out = flash_attention(q, k, v, causal=True, window=100)
    assert k2.launches == before + 1
    assert k2.tc_launches == tc_before + (dt == "bf16")
    ref = flash_attention_ref(q, k, v, causal=True, window=100)
    err = (out.float() - ref.float()).abs().max().item()
    limit = 1e-5 if dt == "f32" else 2 ** -7 * ref.float().abs().max().item()
    assert err <= limit, (err, limit)
