"""The port's ``PagePool`` against the reference's, op for op.

The same random sequence of ensure / release / truncate calls runs on both
pools; return values, block tables, the free stack and every counter must
be exactly equal after each call (integer host state: no tolerance).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.serving import kv_pool as jpool
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.serving import kv_pool as tpool


def _pair(jcfg, cfg, **kw):
    return (jpool.PagePool(jcfg, **kw),
            tpool.PagePool(cfg, device="cpu", **kw))


def _same_state(a, b):
    np.testing.assert_array_equal(a.table, b.table)
    assert a._free_top == b._free_top
    np.testing.assert_array_equal(a._free[:a._free_top],
                                  b._free[:b._free_top])
    np.testing.assert_array_equal(a._nblocks, b._nblocks)
    assert (a.used, a.tokens_used, a.tokens_capacity, a.alloc_ops) == \
        (b.used, b.tokens_used, b.tokens_capacity, b.alloc_ops)


@pytest.mark.parametrize("seed", range(4))
def test_same_op_sequence_same_state(gqa_model, seed):
    jcfg, _ = gqa_model
    cfg = dataclasses.replace(get_smoke_config("smollm_360m"),
                              param_dtype=jcfg.param_dtype,
                              compute_dtype=jcfg.compute_dtype)
    rng = np.random.RandomState(seed)
    layers = int(rng.randint(1, 5))
    kw = dict(num_pages=int(rng.randint(1 + 4 * layers, 60)), page_size=16,
              max_batch=4, max_seq_len=64, paged_layers=layers)
    a, b = _pair(jcfg, cfg, **kw)
    _same_state(a, b)
    for _ in range(80):
        op = rng.randint(3)
        slot = int(rng.randint(4))
        tokens = int(rng.randint(0, 72))
        if op == 0:
            outs = []
            for pool in (a, b):
                try:
                    outs.append(pool.ensure(slot, tokens))
                except Exception as e:      # PoolExhausted past the budget
                    outs.append(type(e).__name__)
            assert outs[0] == outs[1]
        elif op == 1:
            a.release(slot)
            b.release(slot)
        else:
            a.truncate(slot, tokens)
            b.truncate(slot, tokens)
        _same_state(a, b)
        assert a.can_fit(slot, tokens) == b.can_fit(slot, tokens)
        assert a.pages_needed(slot, tokens) == b.pages_needed(slot, tokens)
        assert a.capacity_tokens(slot) == b.capacity_tokens(slot)


def test_pages_live_on_device_in_param_dtype(gqa_model):
    jcfg, _ = gqa_model
    cfg = get_smoke_config("smollm_360m")
    pool = tpool.PagePool(cfg, num_pages=9, page_size=16, max_batch=2,
                          max_seq_len=32, paged_layers=2, device="cpu")
    assert pool.k.dtype == torch.bfloat16 and pool.k.shape == (9, 16, 2, 16)
    assert isinstance(pool.table, np.ndarray)
    with pytest.raises(NotImplementedError, match="int8"):
        tpool.PagePool(cfg, num_pages=9, page_size=16, max_batch=2,
                       max_seq_len=32, paged_layers=2, kv_dtype="int8",
                       device="cpu")
    with pytest.raises(ValueError):
        tpool.PagePool(cfg, num_pages=4, page_size=16, max_batch=2,
                       max_seq_len=32, paged_layers=2, device="cpu")


@pytest.mark.parametrize("layers", [None, 5, 32])
def test_sizing_helpers_match(layers):
    jcfg = jget_config("smollm_360m")
    cfg = get_config("smollm_360m")
    for vram in (2e9, 24e9, 80e9):
        for cap in (None, 300):
            assert tpool.pages_for_vram(cfg, vram, page_size=16,
                                        layers_on_node=layers,
                                        max_pages=cap) == \
                jpool.pages_for_vram(jcfg, vram, page_size=16,
                                     layers_on_node=layers, max_pages=cap)
    assert tpool.full_rectangle_pages(cfg, max_batch=4, max_len=64,
                                      page_size=16, paged_layers=layers) == \
        jpool.full_rectangle_pages(jcfg, max_batch=4, max_len=64,
                                   page_size=16, paged_layers=layers)
    for page in (8, 16):
        assert tpool.page_bytes(cfg, page) == jpool.page_bytes(jcfg, page)
