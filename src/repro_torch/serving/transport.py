"""SocketTransport: the real RPC plane behind the runtime's transport seam —
counterpart of ``repro.serving.transport``.

The ``ClusterRuntime`` moves stage payloads (prompt-token chunks,
activations, sampled tokens, KV handoffs) between nodes through
``transport.send``; the in-process transport hands references over a
virtual clock.  This module is the other side of that seam: per-node stage
worker processes (``repro_torch.launch.worker``) own the stage engines,
and the pieces here move real bytes to them:

  wire format       ``encode_payload`` / ``decode_payload``: the
                    reference's tagged binary codec, frame for frame.
                    numpy arrays and torch tensors travel as a dtype/shape
                    header plus their raw little-endian buffer; a CUDA
                    tensor is copied to the host first.  bf16 tensors are
                    written under the reference's dtype name ``bfloat16``
                    as raw 2-byte words and decode to ``torch.bfloat16``
                    tensors (numpy has no bf16); every other dtype decodes
                    to a numpy view into the frame, as in the reference.
                    Malformed or truncated input raises ``FrameError`` —
                    never hangs, never guesses.
  frames            ``send_frame`` / ``recv_frame``: length-prefixed TCP
                    frames (8-byte magic+length header).  A peer closing
                    mid-frame raises ``FrameError`` instead of blocking.
  WorkerChannel     one lock-serialized request/response socket to a stage
                    worker; every call gets an ``("ok", result)`` or
                    ``("err", traceback)`` reply.  A socket failure raises
                    ``WorkerDied`` and poisons the channel.
  SocketTransport   the transport over worker channels.  Each (src, dst)
                    link gets a bounded send queue drained by its own pump
                    thread: array payloads are staged into the destination
                    worker (the runtime is delivered a ``StagedRef`` the
                    next engine RPC resolves worker-side), scalar payloads
                    round-trip through the codec and deliver by value.  A
                    full queue blocks the sender and raises
                    ``TransportStalled`` naming the link past
                    ``send_timeout_s``; ``describe()`` reports per-link
                    depth, stalled transmissions and the hop ledger.
  RemoteStageEngine the coordinator-side proxy speaking the stage-engine
                    API over a ``WorkerChannel``.  Final-stage sampling
                    stays at the coordinator (``sampling.sample_token`` on
                    the logits the reply carries).

Nothing here imports the runtime; ``runtime.ClusterRuntime.spawn_workers``
wires these pieces to the worker processes it launches (or to workers
started by hand with ``python -m repro_torch.launch.worker --connect
host:port``).
"""
from __future__ import annotations

import dataclasses
import itertools
import queue
import socket
import struct
import sys
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.cluster import COORDINATOR
from .sampling import sample_token
from .stage_engine import DecodeItem, DecodeOut


class FrameError(ValueError):
    """Malformed, truncated, or unreadable wire data."""


class WorkerDied(RuntimeError):
    """The socket to a stage worker failed (process killed, link down)."""


class WorkerError(RuntimeError):
    """The worker received the call but raised executing it."""


class TransportStalled(RuntimeError):
    """A bounded per-link send queue stayed full past the send timeout."""


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

_MAGIC = b"HLXF"
_HEADER = struct.Struct("!4sI")
MAX_FRAME_BYTES = 1 << 31               # anything larger is a corrupt header


@dataclasses.dataclass(frozen=True)
class StagedRef:
    """Handle to a payload already staged in a worker's memory: the
    transport ships the bytes once, the next engine RPC resolves the tag."""

    tag: int


_I64 = struct.Struct("!q")
_F64 = struct.Struct("!d")
_U32 = struct.Struct("!I")
_U64 = struct.Struct("!Q")
_U8 = struct.Struct("!B")
_BF16 = "bfloat16"


def encode_payload(obj: Any) -> List[Any]:
    """Encode a payload tree into a list of buffer segments (bytes /
    memoryview).  Array bodies are memoryviews of a host buffer: zero-copy
    for C-contiguous host arrays."""
    parts: List[Any] = []
    _enc(obj, parts)
    return parts


def payload_bytes(obj: Any) -> bytes:
    return b"".join(bytes(p) for p in encode_payload(obj))


def _host_words(t: torch.Tensor) -> Tuple[str, np.ndarray]:
    """A tensor's dtype name on the wire and its host buffer as a numpy
    array of the same byte layout (bf16 as its raw 16-bit words)."""
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    t = t.contiguous()
    name = str(t.dtype).rsplit(".", 1)[-1]
    if t.dtype == torch.bfloat16:
        return _BF16, t.view(torch.int16).numpy()
    return name, t.numpy()


def _enc_array(name: str, arr: np.ndarray, parts: List[Any]) -> None:
    raw = name.encode("ascii")
    head = b"a" + _U32.pack(len(raw)) + raw + _U8.pack(arr.ndim)
    for dim in arr.shape:
        head += _U64.pack(dim)
    head += _U64.pack(arr.nbytes)
    parts.append(head)
    parts.append(arr.reshape(-1).view(np.uint8).data)   # zero-copy view


def _enc(obj: Any, parts: List[Any]) -> None:
    if obj is None:
        parts.append(b"N")
    elif obj is True:
        parts.append(b"T")
    elif obj is False:
        parts.append(b"F")
    elif isinstance(obj, (int, np.integer)):
        try:
            parts.append(b"i" + _I64.pack(int(obj)))
        except struct.error:
            raise FrameError(f"int {obj} outside the int64 wire range") \
                from None
    elif isinstance(obj, (float, np.floating)):
        parts.append(b"f" + _F64.pack(float(obj)))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        parts.append(b"s" + _U32.pack(len(raw)) + raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        parts.append(b"b" + _U32.pack(len(obj)))
        parts.append(bytes(obj))
    elif isinstance(obj, StagedRef):
        parts.append(b"r" + _U64.pack(obj.tag))
    elif isinstance(obj, list):
        parts.append(b"l" + _U32.pack(len(obj)))
        for it in obj:
            _enc(it, parts)
    elif isinstance(obj, tuple):
        parts.append(b"t" + _U32.pack(len(obj)))
        for it in obj:
            _enc(it, parts)
    elif isinstance(obj, dict):
        parts.append(b"d" + _U32.pack(len(obj)))
        for k, v in obj.items():
            _enc(k, parts)
            _enc(v, parts)
    elif isinstance(obj, np.bool_):
        parts.append(b"T" if obj else b"F")
    elif isinstance(obj, torch.Tensor):
        _enc_array(*_host_words(obj), parts)
    elif isinstance(obj, np.ndarray) or hasattr(obj, "__array__"):
        arr = np.asarray(obj)
        if arr.dtype.byteorder == ">" or (arr.dtype.byteorder == "="
                                          and sys.byteorder == "big"):
            # the wire is little-endian; dtype.name drops byte order, so a
            # big-endian buffer must be swapped, not silently reinterpreted
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        if not arr.flags["C_CONTIGUOUS"]:
            # NB ascontiguousarray would also promote 0-d to 1-d, so only
            # copy when the layout requires it
            arr = np.ascontiguousarray(arr)
        _enc_array(arr.dtype.name, arr, parts)
    else:
        raise FrameError(f"unserializable payload type {type(obj).__name__}")


class _Reader:
    """Bounds-checked cursor over a frame body: running past the end (a
    truncated frame) raises FrameError instead of returning garbage."""

    def __init__(self, data):
        self.view = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if n < 0 or self.pos + n > len(self.view):
            raise FrameError(
                f"truncated frame: wanted {n} bytes at offset {self.pos}, "
                f"frame holds {len(self.view)}")
        out = self.view[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]


def decode_payload(data) -> Any:
    """Decode one payload tree; raises FrameError on malformed or truncated
    input or trailing garbage.  Arrays other than bf16 are zero-copy numpy
    views into ``data`` (read-only when ``data`` is bytes); bf16 arrays
    are ``torch.bfloat16`` tensors over a copy of their bytes."""
    r = _Reader(data)
    out = _dec(r)
    if r.pos != len(r.view):
        raise FrameError(f"{len(r.view) - r.pos} trailing bytes after "
                         "payload")
    return out


def _dec(r: _Reader) -> Any:
    tag = bytes(r.take(1))
    if tag == b"N":
        return None
    if tag == b"T":
        return True
    if tag == b"F":
        return False
    if tag == b"i":
        return r.unpack(_I64)
    if tag == b"f":
        return r.unpack(_F64)
    if tag == b"s":
        return bytes(r.take(r.unpack(_U32))).decode("utf-8")
    if tag == b"b":
        return bytes(r.take(r.unpack(_U32)))
    if tag == b"r":
        return StagedRef(r.unpack(_U64))
    if tag in (b"l", b"t"):
        n = r.unpack(_U32)
        items = [_dec(r) for _ in range(n)]
        return items if tag == b"l" else tuple(items)
    if tag == b"d":
        n = r.unpack(_U32)
        return {_dec(r): _dec(r) for _ in range(n)}
    if tag == b"a":
        return _dec_array(r)
    raise FrameError(f"unknown payload tag {tag!r}")


def _dec_array(r: _Reader):
    name = bytes(r.take(r.unpack(_U32))).decode("ascii")
    bf16 = name == _BF16
    try:
        dtype = np.dtype(np.int16 if bf16 else name)
    except TypeError as e:
        raise FrameError(f"unknown dtype {name!r}") from e
    if dtype.byteorder == "=" and sys.byteorder == "big":
        dtype = dtype.newbyteorder("<")        # wire bytes are little-endian
    ndim = r.unpack(_U8)
    shape = tuple(r.unpack(_U64) for _ in range(ndim))
    nbytes = r.unpack(_U64)
    expect = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if nbytes != expect:
        raise FrameError(f"array header inconsistent: shape {shape} x "
                         f"{name} needs {expect} bytes, frame says {nbytes}")
    body = r.take(nbytes)
    if not bf16:
        return np.frombuffer(body, dtype=dtype).reshape(shape)
    if nbytes == 0:
        return torch.empty(shape, dtype=torch.bfloat16)
    # a copy: an aligned, writable buffer whatever the frame's offset
    return torch.frombuffer(bytearray(body),
                            dtype=torch.bfloat16).reshape(shape)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

def _recv_exact(sock: socket.socket, n: int) -> memoryview:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise FrameError(
                f"connection closed mid-frame ({got}/{n} bytes)")
        got += r
    return memoryview(buf)


def send_frame(sock: socket.socket, parts: List[Any]) -> int:
    """Write one length-prefixed frame; returns the body size."""
    total = sum(len(p) for p in parts)
    if total > MAX_FRAME_BYTES:
        raise FrameError(f"frame of {total} bytes exceeds the "
                         f"{MAX_FRAME_BYTES}-byte cap")
    sock.sendall(_HEADER.pack(_MAGIC, total))
    for p in parts:
        sock.sendall(p)
    return total


def recv_frame(sock: socket.socket) -> memoryview:
    """Read one frame body.  Raises FrameError on a bad magic, an oversized
    length, or a peer that closed mid-frame — a torn frame can never make
    the reader hang or mis-sync."""
    head = _recv_exact(sock, _HEADER.size)
    magic, length = _HEADER.unpack(head)
    if magic != _MAGIC:
        raise FrameError(f"bad frame magic {bytes(magic)!r}")
    if length > MAX_FRAME_BYTES:
        raise FrameError(f"frame length {length} exceeds the "
                         f"{MAX_FRAME_BYTES}-byte cap")
    return _recv_exact(sock, length)


# ---------------------------------------------------------------------------
# worker channel (RPC)
# ---------------------------------------------------------------------------

class WorkerChannel:
    """One request/response socket to a stage worker.  ``call`` is
    lock-serialized: the runtime thread (engine RPCs) and the transport's
    pump threads (payload staging) share it safely."""

    def __init__(self, sock: socket.socket, node: str = "?",
                 timeout_s: float = 300.0):
        sock.settimeout(timeout_s)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass                        # socketpairs have no TCP options
        self.sock = sock
        self.node = node
        self._lock = threading.Lock()
        self._dead: Optional[str] = None

    @property
    def alive(self) -> bool:
        return self._dead is None

    def call(self, method: str, *args):
        with self._lock:
            if self._dead is not None:
                raise WorkerDied(f"worker {self.node} is down: {self._dead}")
            try:
                send_frame(self.sock, encode_payload((method, list(args))))
                reply = decode_payload(recv_frame(self.sock))
            except (OSError, FrameError) as e:
                self._dead = repr(e)
                raise WorkerDied(
                    f"worker {self.node} died during {method!r}: {e}") from e
        status, value = reply
        if status != "ok":
            raise WorkerError(f"worker {self.node} failed {method!r}: "
                              f"{value}")
        return value

    def close(self) -> None:
        if self._dead is None:
            self._dead = "closed"
        try:
            self.sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# socket transport
# ---------------------------------------------------------------------------

def _is_scalar(payload: Any) -> bool:
    """Scalar control payloads (sampled tokens and (index, token) pairs)
    deliver by value: staging a single int in a worker would cost a round
    trip; the value rides the next engine RPC instead."""
    if isinstance(payload, (bool, int, float, np.integer, np.floating)):
        return True
    if isinstance(payload, tuple):
        return all(_is_scalar(p) for p in payload)
    return False


class SocketTransport:
    """Real-byte transport over per-worker channels (see the module
    docstring).

    ``realtime = True`` tells the runtime to run its loop on the wall clock
    (deliveries arrive through a thread-safe mailbox) instead of the
    virtual clock of the in-process transport.

    ``direct_links`` marks the routed worker-to-worker topology: stage
    workers hold peer channels and forward activation frames directly
    (``launch.worker``), so a stage->stage ``send`` arrives carrying a
    ``StagedRef`` whose bytes are already at the destination — the
    transport counts the (src, dst) hop and delivers the ref.  In the
    default star topology every stage->stage payload rides the RPC reply
    back to the coordinator and is then staged to the next worker; the
    hop and byte counters charge that as (src, coordinator) +
    (coordinator, dst).
    """

    realtime = True

    def __init__(self, channels: Optional[Dict[str, WorkerChannel]] = None,
                 *, queue_depth: int = 8, send_timeout_s: float = 60.0,
                 stalled_after_s: float = 0.2, direct_links: bool = False):
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        self.channels: Dict[str, WorkerChannel] = dict(channels or {})
        self.queue_depth = queue_depth
        self.send_timeout_s = send_timeout_s
        self.stalled_after_s = stalled_after_s
        self.direct_links = direct_links
        self.transfers: Dict[Tuple[str, str], int] = defaultdict(int)
        self.bytes_sent: Dict[Tuple[str, str], int] = defaultdict(int)
        self.dead: set = set()
        # runtime-maintained one-liners appended to describe() (the
        # speculation counters)
        self.annotations: Dict[str, str] = {}
        self._queues: Dict[Tuple[str, str], queue.Queue] = {}
        self._busy_since: Dict[Tuple[str, str], float] = {}
        self._tags = itertools.count(1)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._schedule: Callable[[float, Callable[[], None]], None] = \
            lambda d, fn: fn()

    def bind(self, schedule: Callable[[float, Callable[[], None]], None]
             ) -> None:
        """The runtime binds a thread-safe scheduler (a mailbox put)."""
        self._schedule = schedule

    def alloc_tag(self) -> int:
        """A staging tag, from the counter the pumps share, so a worker-side
        forward never collides with a pump-staged payload in the
        destination's stash."""
        return next(self._tags)

    # -- sending ---------------------------------------------------------
    def send(self, src: str, dst: str, payload: Any, nbytes: float,
             deliver: Callable[[Any], None]) -> None:
        if self._stop.is_set():
            return
        if isinstance(payload, StagedRef):
            # routed path: the source worker pushed the bytes to the
            # destination's staging area over a peer channel (and got its
            # ack) before its RPC replied — one (src, dst) hop, nothing
            # left to move
            self.transfers[(src, dst)] += 1
            self.bytes_sent[(src, dst)] += int(nbytes)
            self._schedule(0.0, lambda p=payload: deliver(p))
            return
        if src != COORDINATOR and dst != COORDINATOR:
            # star path: the payload reached the coordinator as an RPC
            # reply and is re-sent below — charge both hops
            self.transfers[(src, COORDINATOR)] += 1
            self.bytes_sent[(src, COORDINATOR)] += int(nbytes)
            self.transfers[(COORDINATOR, dst)] += 1
            self.bytes_sent[(COORDINATOR, dst)] += int(nbytes)
        else:
            self.transfers[(src, dst)] += 1
            self.bytes_sent[(src, dst)] += int(nbytes)
        link = (src, dst)
        q = self._link_queue(link)
        try:
            # bounded: a slow receiver blocks the sender here instead of
            # growing an unbounded buffer
            q.put((payload, deliver), timeout=self.send_timeout_s)
        except queue.Full:
            raise TransportStalled(
                f"link {src}->{dst}: send queue full ({self.queue_depth} "
                f"deep) for {self.send_timeout_s:.1f}s — receiver not "
                f"draining; {self.describe()}") from None

    def _link_queue(self, link: Tuple[str, str]) -> queue.Queue:
        with self._lock:
            q = self._queues.get(link)
            if q is None:
                q = queue.Queue(maxsize=self.queue_depth)
                self._queues[link] = q
                t = threading.Thread(target=self._pump, args=(link, q),
                                     name=f"transport-{link[0]}-{link[1]}",
                                     daemon=True)
                t.start()
            return q

    def _pump(self, link: Tuple[str, str], q: queue.Queue) -> None:
        _, dst = link
        while not self._stop.is_set():
            try:
                payload, deliver = q.get(timeout=0.2)
            except queue.Empty:
                continue
            self._busy_since[link] = time.monotonic()
            try:
                ch = self.channels.get(dst)
                if ch is None or _is_scalar(payload):
                    # coordinator-bound or scalar payload: round-trip
                    # through the codec, deliver by value
                    out = decode_payload(payload_bytes(payload))
                    self._schedule(0.0, lambda o=out, dv=deliver: dv(o))
                else:
                    # stage the bytes in the destination worker (a device
                    # tensor is copied to the host while the queue still
                    # holds it); the next engine RPC resolves the ref
                    tag = next(self._tags)
                    ch.call("stage", tag, payload)
                    self._schedule(
                        0.0, lambda rf=StagedRef(tag), dv=deliver: dv(rf))
            except (WorkerDied, WorkerError, OSError):
                # receiver gone: drop — the runtime's failover requeues the
                # affected requests and their epochs kill stale deliveries
                self.dead.add(dst)
            finally:
                self._busy_since.pop(link, None)
                q.task_done()

    # -- diagnostics -----------------------------------------------------
    def pending(self) -> int:
        busy = len(self._busy_since)
        return sum(q.qsize() for q in self._queues.values()) + busy

    def describe(self) -> str:
        now = time.monotonic()
        frags = []
        for link, q in sorted(self._queues.items()):
            since = self._busy_since.get(link)
            stalled = ""
            if since is not None and now - since > self.stalled_after_s:
                stalled = f" STALLED {now - since:.1f}s"
            if q.qsize() or stalled:
                frags.append(f"{link[0]}->{link[1]} queued={q.qsize()}"
                             f"{stalled}")
        dead = f" dead={sorted(self.dead)}" if self.dead else ""
        mode = "direct" if self.direct_links else "star"
        hops = ", ".join(
            f"{s}->{d}={n}/{self.bytes_sent[(s, d)]}B"
            for (s, d), n in sorted(self.transfers.items()))
        extra = "".join(f" {v}" for _, v in sorted(self.annotations.items()))
        return ("links[" + ", ".join(frags) + "]" + dead
                + f" hops[{mode}: {hops}]" + extra)

    def close(self) -> None:
        self._stop.set()
        for ch in self.channels.values():
            ch.close()


# ---------------------------------------------------------------------------
# remote stage engine (coordinator-side proxy)
# ---------------------------------------------------------------------------

class RemoteStageEngine:
    """Stage-engine API over a WorkerChannel.  The worker owns the params,
    caches and page pool; this proxy owns only the final-stage sampling RNG
    (sampling runs at the coordinator on the logits the reply carries, so
    one RNG stream drives the pipeline as a local engine's would).

    ``forward_capable``: compute RPCs accept a forward spec ``fwd=(dst
    node, staging tag)``.  The worker then pushes the stage output straight
    to the destination worker's staging area over a peer channel before
    replying, and the proxy returns ``StagedRef(tag)`` in place of the
    payload — the runtime ships that ref through ``transport.send``, which
    counts it as one (src, dst) hop."""

    forward_capable = True

    def __init__(self, channel: WorkerChannel, node: str, *,
                 rng_seed: int = 0):
        self.channel = channel
        self.node = node
        self._rng = np.random.RandomState(rng_seed)

    # -- slots / pool ----------------------------------------------------
    def alloc_slot(self, request_id: int) -> Optional[int]:
        return self.channel.call("alloc_slot", request_id)

    def free_slot(self, slot: int) -> None:
        self.channel.call("free_slot", slot)

    def ensure(self, slot: int, tokens: int) -> bool:
        return self.channel.call("ensure", slot, tokens)

    def release(self, slot: int) -> None:
        self.channel.call("release", slot)

    def kv_tokens_used(self) -> int:
        return self.channel.call("kv_tokens_used")

    def kv_tokens_capacity(self) -> int:
        return self.channel.call("kv_tokens_capacity")

    def pool_used(self) -> Optional[int]:
        return self.channel.call("pool_used")

    def pool_num_pages(self) -> Optional[int]:
        return self.channel.call("pool_num_pages")

    # -- compute ---------------------------------------------------------
    def prefill_stage(self, slot: int, x, entry: int,
                      fwd: Optional[Tuple[str, int]] = None):
        out = self.channel.call("prefill_stage", slot, x, entry, fwd)
        return StagedRef(fwd[1]) if fwd is not None else out

    def prefill_chunk(self, slot: int, x, entry: int, start: int,
                      fwd: Optional[Tuple[str, int]] = None):
        out = self.channel.call("prefill_chunk", slot, x, entry, start, fwd)
        return StagedRef(fwd[1]) if fwd is not None else out

    def decode_stage(self, items: List[DecodeItem],
                     fwds: Optional[List[Optional[Tuple[str, int]]]] = None
                     ) -> List[DecodeOut]:
        # 6-tuples: ``tokens`` (a verify pass's token vector, or None)
        # rides last; the worker resolves StagedRefs in ``h`` and ``tokens``
        wire = [(it.slot, it.pos, it.entry, it.token, it.h, it.tokens)
                for it in items]
        outs = self.channel.call("decode_stage", wire,
                                 list(fwds) if fwds else None)
        res = []
        for i, (h, logits) in enumerate(outs):
            if fwds and fwds[i] is not None:
                h = StagedRef(fwds[i][1])
            res.append(DecodeOut(h=h, logits=logits))
        return res

    def rollback(self, slot: int, tokens: int) -> None:
        """Synchronous KV rollback after a rejected verify: returns once
        the worker's pool has truncated the slot, so the relaunch cannot
        race the rollback."""
        self.channel.call("rollback", slot, tokens)

    # -- KV handoff (disaggregated prefill -> decode) --------------------
    def export_kv(self, slot: int, tokens: int, layers: List[int],
                  fwd: Optional[Tuple[str, int]] = None):
        out = self.channel.call("export_kv", slot, tokens, list(layers), fwd)
        return StagedRef(fwd[1]) if fwd is not None else out

    def import_kv(self, slot: int, tokens: int, payload) -> None:
        self.channel.call("import_kv", slot, tokens, payload)

    def sample(self, logits, temperature: float) -> int:
        return int(sample_token(np.asarray(logits), temperature, self._rng))

    # -- lifecycle -------------------------------------------------------
    def close(self) -> None:
        try:
            if self.channel.alive:
                self.channel.call("shutdown")
        except (WorkerDied, WorkerError):
            pass
        self.channel.close()
