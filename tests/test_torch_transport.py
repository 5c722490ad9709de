"""The port's wire format, socket transport and delivery guards against the
JAX package (f32, CPU).

1. **Wire** — ``repro_torch.serving.transport`` frames must be byte-equal
   to ``repro.serving.transport``'s for the same payload tree: scalars,
   strings, bytes, nested lists/tuples/dicts, ``StagedRef`` and f32, bf16
   and int32 arrays (0-d and empty ones too), with the port's arrays given
   as torch tensors or numpy arrays and the reference's bf16 as
   ``ml_dtypes``.  Each side decodes the other's frames to the same dtype,
   shape and bytes.  The reference's own round-trip, truncation and
   malformed-frame tests run against the port's codec.
2. **Backpressure** — a ``SocketTransport`` link to a worker that stops
   acking blocks senders at its bounded queue, raises ``TransportStalled``
   naming the link, and shows up in the runtime's ``_state()``.
3. **Chaos** — a port copy of the reference's ``FlakyTransport`` (delays,
   reorders, duplicates, drops then retransmits) over the port's
   ``InProcessTransport``: greedy tokens equal to the reference's single
   engine (the ``reference`` fixture) and pools drained, paged and dense,
   at depths 1-3, disaggregated, and under preemption.  A transport that
   delivers everything twice leaves speculative output unchanged.
"""
import dataclasses
import socket
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.serving import transport as jt
from repro_torch.core.cluster import COORDINATOR
from repro_torch.serving import transport as tt
from repro_torch.serving.engine import Request
from repro_torch.serving.runtime import ClusterRuntime, InProcessTransport
from repro_torch.serving.transport import (FrameError, SocketTransport,
                                           StagedRef, TransportStalled,
                                           WorkerChannel, decode_payload,
                                           encode_payload, payload_bytes,
                                           recv_frame, send_frame)

from harness import EC as JEC, pool_for_one_request
from test_torch_disagg import ONE_PREFILL, port_disagg_plan
from test_torch_runtime import EC, port_model, port_plan  # noqa: F401
from test_torch_spec_decode import bad_draft  # noqa: F401

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                      # only the property tests skip
    HAVE_HYPOTHESIS = False

BF16 = np.dtype(ml_dtypes.bfloat16)


# ---------------------------------------------------------------------------
# wire: byte equality with the reference
# ---------------------------------------------------------------------------

def _ref_array(dtype, shape, seed):
    """A reference-side array: float32 / int32 numpy, or bf16 through
    ml_dtypes, from random bits (NaNs and infinities included)."""
    rng = np.random.RandomState(seed)
    if dtype == "int32":
        return rng.randint(-2**31, 2**31 - 1, size=shape, dtype=np.int32)
    if dtype == "bfloat16":
        return rng.randint(0, 2**16, size=shape).astype(np.uint16).view(BF16)
    return rng.randint(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32).view(np.float32)


def _as_tensor(a):
    """The same bits as a torch tensor (bf16 through its 16-bit words)."""
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _same_array(port, ref):
    """A decoded port array and a reference array: same dtype, shape and
    bytes."""
    if ref.dtype == BF16:
        assert isinstance(port, torch.Tensor)
        assert port.dtype == torch.bfloat16
        raw = port.view(torch.int16).numpy().tobytes()
    else:
        assert isinstance(port, np.ndarray) and port.dtype == ref.dtype
        raw = port.tobytes()
    assert tuple(port.shape) == ref.shape
    assert raw == ref.tobytes()


SHAPES = [(), (0,), (5,), (3, 4), (2, 1, 4), (2, 3, 2, 2), (0, 3)]


@pytest.mark.parametrize("dtype,as_tensor", [
    ("float32", False), ("float32", True), ("bfloat16", True),
    ("int32", False), ("int32", True)],
    ids=["f32-numpy", "f32-tensor", "bf16-tensor", "i32-numpy",
         "i32-tensor"])
def test_array_frames_equal_reference(dtype, as_tensor):
    """Every shape, numpy or torch on the port's side (bf16 as torch
    only: numpy has none without ml_dtypes): the frame equals the
    reference's byte for byte, and each codec decodes the other's."""
    for i, shape in enumerate(SHAPES):
        ref = _ref_array(dtype, shape, seed=i)
        port = _as_tensor(ref) if as_tensor else ref.copy()
        frame = jt.payload_bytes(ref)
        assert payload_bytes(port) == frame, shape
        _same_array(decode_payload(frame), ref)
        back = jt.decode_payload(payload_bytes(port))
        assert back.dtype == ref.dtype and back.shape == ref.shape
        assert back.tobytes() == ref.tobytes()


def _jref(obj):
    """The reference's side of a port payload tree: its own StagedRef."""
    if isinstance(obj, StagedRef):
        return jt.StagedRef(obj.tag)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_jref(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _jref(v) for k, v in obj.items()}
    return obj


def _tree(bf16, f32, i32):
    """A runtime-shaped payload tree over the given leaves."""
    return ("decode_stage", [
        [(2, 17, 0, 0, bf16, None), (0, 3, 2, 441, None, i32)],
        {"h": f32, 7: [None, True, False, -1, 1 << 40, 3.5, "tøkens",
                       b"\x00\xff", (), [], {}, StagedRef(9)]},
        ("n1", 12), None])


def test_tree_frames_equal_reference():
    """A nested tree mixing every scalar kind, StagedRef and the three
    array dtypes — the decode RPC's shape, scratch-padded bf16
    activations included — frames identically on both sides, and each
    side decodes the other's frame to equal leaves."""
    rng = np.random.RandomState(3)
    h = rng.randn(JEC.max_batch + 1, 1, 64).astype(BF16)
    f = rng.randn(2, 5).astype(np.float32)
    t = np.arange(13, dtype=np.int32)
    ref = _jref(_tree(h, f, t))
    port = _tree(_as_tensor(h), torch.from_numpy(f), t)
    frame = jt.payload_bytes(ref)
    assert payload_bytes(port) == frame
    got = decode_payload(frame)
    assert got[0] == "decode_stage"
    items, meta, fwd, none = got[1]
    _same_array(items[0][4], h)
    _same_array(items[1][5], t)
    _same_array(meta["h"], f)
    assert meta[7] == port[1][1][7] and fwd == ("n1", 12) and none is None
    back = jt.decode_payload(payload_bytes(port))
    assert back[1][0][0][4].tobytes() == h.tobytes()
    assert back[1][0][0][4].dtype == BF16


def test_scalar_frames_equal_reference():
    cases = [None, True, False, 0, -1, 1 << 40, -(1 << 63), 3.5,
             float("inf"), float("nan"), "", "tøkens", b"", b"\x00\xff",
             (), [], {}, StagedRef(0), StagedRef(2**40),
             np.int32(-7), np.float64(2.5), np.bool_(True),
             {"cfg": {"layers": (0, 4), "paged": True},
              "xs": [1, 2.0, None]}]
    for obj in cases:
        assert payload_bytes(obj) == jt.payload_bytes(_jref(obj)), obj


def test_tensor_views_frame_their_values():
    """Non-contiguous and sliced tensors frame as their values (the
    reference's ascontiguousarray), and a 0-d tensor stays 0-d."""
    a = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    assert payload_bytes(a.t()) == jt.payload_bytes(a.t().numpy().copy())
    assert payload_bytes(a[1:3, ::2]) == \
        jt.payload_bytes(np.ascontiguousarray(a.numpy()[1:3, ::2]))
    z = torch.tensor(2.5)
    assert payload_bytes(z) == jt.payload_bytes(np.array(2.5, np.float32))
    assert decode_payload(payload_bytes(z)).shape == ()


# ---------------------------------------------------------------------------
# wire: the reference's fixed cases against the port's codec
# ---------------------------------------------------------------------------

def _roundtrip(obj):
    return decode_payload(payload_bytes(obj))


def test_wire_roundtrip_scalars_and_trees():
    cases = [
        None, True, False, 0, -1, 1 << 40, 3.5, float("inf"), "",
        "tøkens", b"\x00\xff", (), [], {},
        ("prefill_stage", [3, StagedRef(7), 0]),
        {"cfg": {"layers": (0, 4), "paged": True}, "xs": [1, 2.0, None]},
    ]
    for obj in cases:
        got = _roundtrip(obj)
        assert got == obj and type(got) is type(obj), obj
    assert np.isnan(_roundtrip(float("nan")))
    assert _roundtrip(np.int32(-7)) == -7
    assert _roundtrip(np.float64(2.5)) == 2.5
    assert _roundtrip(np.bool_(True)) is True


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("shape", [(), (0,), (5,), (3, 4), (2, 1, 4),
                                   (2, 3, 2, 2)])
def test_wire_roundtrip_arrays_bit_exact(dtype, shape):
    ref = _ref_array(dtype, shape, seed=hash((dtype, shape)) % (1 << 31))
    arr = _as_tensor(ref) if dtype == "bfloat16" else ref
    _same_array(_roundtrip(arr), ref)


def test_wire_normalizes_byte_order():
    be = np.array([1.0, 2.0, -3.5], dtype=">f8")
    assert payload_bytes(be) == jt.payload_bytes(be)
    assert np.array_equal(_roundtrip(be), be.astype("<f8"))
    assert np.array_equal(_roundtrip(np.array([7, -9], dtype=">i4")),
                          np.array([7, -9], np.int32))


def test_wire_rejects_malformed():
    with pytest.raises(FrameError):
        decode_payload(b"")
    with pytest.raises(FrameError):
        decode_payload(b"Z")
    with pytest.raises(FrameError):
        decode_payload(payload_bytes(7) + b"x")
    with pytest.raises(FrameError):
        encode_payload(object())
    with pytest.raises(FrameError):
        encode_payload(1 << 64)
    body = payload_bytes(np.zeros(4, np.float32))
    corrupt = bytearray(body)
    corrupt[-17] ^= 0xFF                           # a length byte
    with pytest.raises(FrameError):
        decode_payload(bytes(corrupt))
    bad_dtype = jt.payload_bytes(np.zeros(2, np.float32)).replace(
        b"float32", b"float99")
    with pytest.raises(FrameError, match="dtype"):
        decode_payload(bad_dtype)


def test_wire_truncation_always_raises():
    payloads = [
        {"a": [1, 2.5, "x"], "b": np.arange(6, dtype=np.int32)},
        ("stage", [9, torch.zeros((2, 3), dtype=torch.bfloat16)]),
        [None, True, b"bytes", StagedRef(3)],
    ]
    for obj in payloads:
        frame = payload_bytes(obj)
        for cut in range(len(frame)):
            with pytest.raises(FrameError):
                decode_payload(frame[:cut])


def test_frame_layer_rejects_bad_magic_and_truncation():
    assert tt.MAX_FRAME_BYTES == jt.MAX_FRAME_BYTES
    a, b = socket.socketpair()
    try:
        a.sendall(b"GARBAGE!")
        with pytest.raises(FrameError, match="magic"):
            recv_frame(b)
    finally:
        a.close()
        b.close()
    a, b = socket.socketpair()
    b.settimeout(30)
    try:
        send_frame(a, encode_payload(np.arange(100)))
        a.close()
        whole = b.recv(1 << 16)
        b2, c = socket.socketpair()
        c.settimeout(30)
        try:
            b2.sendall(whole[:40])
            b2.close()
            with pytest.raises(FrameError, match="closed mid-frame"):
                recv_frame(c)
        finally:
            b2.close()
            c.close()
    finally:
        a.close()
        b.close()


def test_frame_roundtrip_over_socketpair_with_the_reference():
    """A frame the port sends is read by the reference's frame layer and
    the other way round."""
    a, b = socket.socketpair()
    a.settimeout(30)
    b.settimeout(30)
    try:
        h = np.random.RandomState(1).randn(2, 5).astype(np.float32)
        obj = {"h": torch.from_numpy(h), "meta": ("ok", [1, 2, 3])}
        send_frame(a, encode_payload(obj))
        got = jt.decode_payload(jt.recv_frame(b))
        assert got["meta"] == obj["meta"] and np.array_equal(got["h"], h)
        jt.send_frame(b, jt.encode_payload({"h": h.astype(BF16)}))
        got = decode_payload(recv_frame(a))
        _same_array(got["h"], h.astype(BF16))
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# wire: hypothesis round-trip and truncation properties
# ---------------------------------------------------------------------------

if HAVE_HYPOTHESIS:
    _dtypes = st.sampled_from(["float32", "bfloat16", "int32"])
    _shapes = st.lists(st.integers(0, 4), min_size=0, max_size=4)

    @st.composite
    def _arrays(draw):
        dtype = draw(_dtypes)
        shape = tuple(draw(_shapes))
        return _ref_array(dtype, shape, draw(st.integers(0, 2**16)))

    _leaves = st.one_of(
        st.none(), st.booleans(), st.integers(-2**62, 2**62), st.floats(
            allow_nan=False), st.text(max_size=20),
        st.binary(max_size=32),
        st.builds(jt.StagedRef, st.integers(0, 2**40)), _arrays())

    _payloads = st.recursive(
        _leaves,
        lambda inner: st.one_of(
            st.lists(inner, max_size=4),
            st.lists(inner, max_size=4).map(tuple),
            st.dictionaries(st.text(max_size=8), inner, max_size=4)),
        max_leaves=12)

    def _port_tree(obj):
        """The port's side of a reference tree: bf16 leaves as tensors."""
        if isinstance(obj, jt.StagedRef):
            return StagedRef(obj.tag)
        if isinstance(obj, np.ndarray):
            return _as_tensor(obj) if obj.dtype == BF16 else obj
        if isinstance(obj, (list, tuple)):
            return type(obj)(_port_tree(x) for x in obj)
        if isinstance(obj, dict):
            return {k: _port_tree(v) for k, v in obj.items()}
        return obj

    def _eq(port, ref):
        if isinstance(ref, np.ndarray):
            _same_array(port, ref)
            return True
        if isinstance(ref, (list, tuple)):
            return (type(port) is type(ref) and len(port) == len(ref)
                    and all(_eq(x, y) for x, y in zip(port, ref)))
        if isinstance(ref, dict):
            return (isinstance(port, dict) and port.keys() == ref.keys()
                    and all(_eq(port[k], ref[k]) for k in ref))
        if isinstance(ref, jt.StagedRef):
            return port == StagedRef(ref.tag)
        return type(port) is type(ref) and port == ref

    @settings(max_examples=120, deadline=None)
    @given(obj=_payloads)
    def test_property_wire_roundtrip_bit_exact(obj):
        frame = payload_bytes(_port_tree(obj))
        assert frame == jt.payload_bytes(obj)
        assert _eq(decode_payload(frame), obj)

    @settings(max_examples=60, deadline=None)
    @given(obj=_payloads, data=st.data())
    def test_property_truncated_frames_raise(obj, data):
        frame = payload_bytes(_port_tree(obj))
        cut = data.draw(st.integers(0, max(0, len(frame) - 1)),
                        label="cut")
        with pytest.raises(FrameError):
            decode_payload(frame[:cut])


# ---------------------------------------------------------------------------
# backpressure
# ---------------------------------------------------------------------------

def _silent_worker_link(node="n9", *, queue_depth=2, send_timeout_s=0.5):
    """A SocketTransport wired to a 'worker' that never acks: the pump
    thread wedges in its first staging call and the bounded queue backs
    up."""
    a, b = socket.socketpair()
    ch = WorkerChannel(a, node=node, timeout_s=60.0)
    tr = SocketTransport({node: ch}, queue_depth=queue_depth,
                         send_timeout_s=send_timeout_s,
                         stalled_after_s=0.05)
    tr.bind(lambda d, fn: fn())
    return tr, b


def _wait_busy(tr, link):
    deadline = time.monotonic() + 5.0
    while link not in tr._busy_since:
        assert time.monotonic() < deadline, "pump never started"
        time.sleep(0.01)


def test_socket_backpressure_blocks_and_reports():
    tr, peer = _silent_worker_link()
    delivered = []
    payload = torch.zeros(4096)
    try:
        for _ in range(1 + tr.queue_depth):
            tr.send("c", "n9", payload, 4 * 4096, delivered.append)
        _wait_busy(tr, ("c", "n9"))
        assert tr._queues[("c", "n9")].qsize() <= tr.queue_depth
        t0 = time.monotonic()
        with pytest.raises(TransportStalled, match=r"c->n9"):
            tr.send("c", "n9", payload, 4 * 4096, delivered.append)
        assert time.monotonic() - t0 >= tr.send_timeout_s * 0.9
        assert delivered == []
        desc = tr.describe()
        assert "c->n9" in desc and "STALLED" in desc
    finally:
        tr.close()
        peer.close()


def test_runtime_state_reports_stalled_link(port_model):
    """The port's runtime stall diagnostics name the wedged link."""
    cfg, params = port_model
    tr, peer = _silent_worker_link()
    try:
        p = port_plan(cfg, {"n0": (0, 4)})
        rt = ClusterRuntime(cfg, params, p, EC, paged=False, transport=tr,
                            stall_timeout_s=0.1, device="cpu")
        assert rt.realtime
        payload = np.zeros(16, np.float32)
        for _ in range(1 + tr.queue_depth):
            tr.send("c", "n9", payload, payload.nbytes, lambda x: None)
        _wait_busy(tr, ("c", "n9"))
        time.sleep(0.1)                            # past stalled_after_s
        state = rt._state()
        assert "c->n9" in state and "STALLED" in state
    finally:
        tr.close()
        peer.close()


def test_socket_transport_delivers_after_ack():
    """A peer that acks staging frames gets each array staged once (the
    runtime is delivered the StagedRef); scalars deliver by value; a
    reference worker's frame loop reads what the port's pump sends."""
    a, b = socket.socketpair()
    b.settimeout(30)
    ch = WorkerChannel(a, node="n0", timeout_s=10.0)
    tr = SocketTransport({"n0": ch}, queue_depth=4)
    got = []
    tr.bind(lambda d, fn: fn())
    staged = {}

    def fake_worker():
        while True:
            try:
                method, args = jt.decode_payload(jt.recv_frame(b))
            except (jt.FrameError, OSError):
                return
            assert method == "stage"
            staged[args[0]] = args[1]
            jt.send_frame(b, jt.encode_payload(("ok", None)))

    t = threading.Thread(target=fake_worker, daemon=True)
    t.start()
    try:
        arr = torch.arange(12, dtype=torch.bfloat16).reshape(3, 4)
        tr.send(COORDINATOR, "n0", arr, 24, got.append)
        tr.send("n0", COORDINATOR, (3, 1234), 8.0, got.append)
        deadline = time.monotonic() + 10.0
        while len(got) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(got) == 2
        ref = next(g for g in got if isinstance(g, StagedRef))
        val = next(g for g in got if not isinstance(g, StagedRef))
        assert staged[ref.tag].dtype == BF16
        assert staged[ref.tag].tobytes() == \
            arr.view(torch.int16).numpy().tobytes()
        assert val == (3, 1234)
        assert tr.transfers[(COORDINATOR, "n0")] == 1
        assert tr.transfers[("n0", COORDINATOR)] == 1
    finally:
        tr.close()
        b.close()
        t.join(timeout=10)


# ---------------------------------------------------------------------------
# chaos transport double
# ---------------------------------------------------------------------------

class FlakyTransport(InProcessTransport):
    """Delivers every payload at least once, but badly: random jitter
    (reordering), random duplication, and random first-copy drops followed
    by a retransmission after a retry timeout."""

    def __init__(self, seed: int = 0, *, base_delay_s: float = 1e-3,
                 jitter_s: float = 4e-3, dup_p: float = 0.25,
                 drop_p: float = 0.25, retry_s: float = 8e-3):
        super().__init__(default_delay_s=base_delay_s)
        self._chaos_rng = np.random.RandomState(seed)
        self.jitter_s = jitter_s
        self.dup_p = dup_p
        self.drop_p = drop_p
        self.retry_s = retry_s
        self.duplicated = 0
        self.dropped = 0

    def send(self, src, dst, payload, nbytes, deliver):
        self.transfers[(src, dst)] += 1
        rng = self._chaos_rng
        d = self.delay(src, dst, nbytes) + rng.uniform(0.0, self.jitter_s)
        if rng.rand() < self.drop_p:
            self.dropped += 1               # first copy lost; retransmit
            d += self.retry_s
        self._schedule(d, lambda: deliver(payload))
        if rng.rand() < self.dup_p:
            self.duplicated += 1
            self._schedule(d + rng.uniform(0.0, self.jitter_s),
                           lambda: deliver(payload))


class DuplicatingTransport(InProcessTransport):
    """Delivers every payload twice: work messages and verify results."""

    def send(self, src, dst, payload, nbytes, deliver):
        super().send(src, dst, payload, nbytes, deliver)
        super().send(src, dst, payload, nbytes, deliver)


# prompt_len=4 forces multi-chunk prefill (the prompts are 5-16 tokens), so
# chunk reordering across stage hops is exercised
CHAOS_EC = dataclasses.replace(EC, prompt_len=4)


def chaos_serve(cfg, params, p, prompts, *, ec=CHAOS_EC, draft=None, **kw):
    if draft is not None:
        kw.update(draft_cfg=cfg, draft_params=draft, spec_tokens=3)
    rt = ClusterRuntime(cfg, params, p, ec, device="cpu", **kw)
    reqs = [Request(i, pr, max_new_tokens=6) for i, pr in enumerate(prompts)]
    for r in reqs:
        rt.submit(r)
    rt.run_until_done()
    assert all(r.done for r in reqs)
    return rt, reqs


def assert_drained(rt):
    assert all(u == 0 for u in rt.pool_pages_used().values())
    for e in rt.engines.values():
        assert e.free_slots == EC.max_batch and e.kv_tokens_used() == 0
    if rt.draft is not None:
        assert rt.draft.free_slots == EC.max_batch


@pytest.mark.parametrize("paged,depth",
                         [(True, 1), (True, 2), (True, 3), (False, 3)],
                         ids=["paged-d1", "paged-d2", "paged-d3",
                              "dense-d3"])
def test_chaos_transport_keeps_outputs_identical(port_model, reference,
                                                 paged, depth):
    cfg, params = port_model
    prompts, ref = reference
    p = port_plan(cfg, {"n0": (0, 2), "n1": (2, 3), "n2": (3, 4)})
    tr = FlakyTransport(seed=17 * depth + paged)
    rt, reqs = chaos_serve(cfg, params, p, prompts, paged=paged,
                           max_inflight=depth, transport=tr)
    assert [r.output for r in reqs] == ref
    assert_drained(rt)
    assert tr.duplicated > 0 and tr.dropped > 0


@pytest.mark.parametrize("paged,depth", [(True, 1), (True, 2), (False, 2)],
                         ids=["paged-d1", "paged-d2", "dense-d2"])
def test_chaos_disaggregated_keeps_outputs_identical(port_model, reference,
                                                     paged, depth):
    """Chaos over the KV handoff too: a duplicated handoff never imports
    twice, a delayed one never lets decode start on an empty cache."""
    cfg, params = port_model
    prompts, ref = reference
    p = port_disagg_plan(cfg, *ONE_PREFILL)
    tr = FlakyTransport(seed=29 * depth + paged)
    rt, reqs = chaos_serve(cfg, params, p, prompts, paged=paged,
                           max_inflight=depth, transport=tr)
    assert rt.disaggregated
    assert [r.output for r in reqs] == ref
    assert_drained(rt)
    assert tr.duplicated > 0 and tr.dropped > 0
    assert tr.transfers[("n0", "n1")] >= len(prompts)


def test_chaos_transport_with_preemption(gqa_model, port_model, reference):
    """Chaos and a pool that fits one full-budget request: the epoch bumps
    of preemption and the delivery guards compose."""
    from repro.core import LayerRange as JLayerRange
    cfg, params = port_model
    prompts, ref = reference
    p = port_plan(cfg, {"n0": (0, 2), "n1": (2, 3), "n2": (3, 4)})
    small = pool_for_one_request(gqa_model[0], JLayerRange(2, 3),
                                 ec=dataclasses.replace(JEC, prompt_len=4))
    rt, reqs = chaos_serve(cfg, params, p, prompts, paged=True,
                           max_inflight=2, pool_pages={"n1": small},
                           transport=FlakyTransport(seed=5))
    assert [r.output for r in reqs] == ref
    assert any(r.preemptions > 0 for r in reqs)
    assert_drained(rt)


def test_spec_duplicate_delivery_rollback_race(port_model, reference,
                                               bad_draft):
    """Every payload delivered twice, verify results included: the
    epoch-aware dedup keys drop the copies, so a duplicate verify result
    never confirms tokens of a window a rollback cancelled."""
    cfg, params = port_model
    prompts, ref = reference
    p = port_plan(cfg, {"n0": (0, 2), "n1": (2, 4)})
    rt, reqs = chaos_serve(cfg, params, p, prompts, ec=EC, paged=True,
                           max_inflight=2, draft=bad_draft[1],
                           transport=DuplicatingTransport(
                               default_delay_s=1e-3))
    assert [r.output for r in reqs] == ref
    assert rt.spec_rejected > 0
    assert_drained(rt)
