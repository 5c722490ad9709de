"""StageWorker: one Helix compute node as its own OS process —
counterpart of ``repro.launch.worker``.

  python -m repro_torch.launch.worker --connect HOST:PORT [--device cuda]

The worker dials the coordinator (``--connect host:port``), then speaks the
length-prefixed frame protocol of ``repro_torch.serving.transport``: every
frame is ``(method, args)`` and gets an ``("ok", result)`` or ``("err",
traceback)`` reply.  The first call is ``init``, which carries everything
the node needs — the model config, the full parameter tree (host
tensors), the assigned ``LayerRange``, the engine config, the pool sizing
the coordinator derived from this node's VRAM and the device to build on —
and builds the ``PagedStageEngine`` / ``StageEngine`` the remaining calls
drive:

  stage(tag, payload)          stash an in-flight payload (prompt chunk,
                               activations, KV handoff) shipped by the
                               SocketTransport; a later engine call
                               resolves the StagedRef, moving float
                               tensors to the device (token ids stay on
                               the host, where the engine reads them)
  prefill_stage / prefill_chunk / decode_stage
                               the stage-engine API, argument for argument;
                               each compute call accepts a trailing forward
                               spec ``(dst_node, tag)``: the worker pushes
                               the output straight into the destination
                               worker's staging area over a peer channel
                               before replying
  export_kv / import_kv        the KV handoff of disaggregated serving;
                               export honours the same forward spec
  peer_addr / set_peers        worker-to-worker wiring: ``peer_addr`` opens
                               a lazy listening socket and returns its
                               port; ``set_peers`` installs the routed
                               topology ({node: (host, port)})
  alloc_slot / free_slot / ensure / release / rollback / kv_tokens_* /
  pool_used / pool_num_pages   slot and KV bookkeeping
  init                         (re)build the engine — a replan that moves
                               this node's slice re-inits over the same
                               connection
  ping / shutdown              liveness and clean exit

``--device`` is the device this worker serves on (CUDA by default; a
worker asked for CUDA on a host without it raises before it dials).  The
coordinator's ``init`` names the device too, and a worker refuses an init
for another device.

Concurrency: the coordinator connection and every accepted peer connection
run their own frame loop against one shared ``StageWorker``; engine calls
and staging are serialized by a worker lock.  Peer pushes happen outside
that lock, so a worker waiting on a peer's ack never blocks the peer's own
compute — forwards only point down the layer order (and prefill -> decode
for KV handoffs), so the forwarding graph is acyclic and cannot deadlock.
"""
from __future__ import annotations

import argparse
import socket
import threading
import traceback
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import BlockSpec, ModelConfig
from ..core.placement import LayerRange
from ..models.common import map_tree, resolve_device
from ..serving.engine import EngineConfig
from ..serving.stage_engine import DecodeItem, PagedStageEngine, StageEngine
from ..serving.transport import (FrameError, StagedRef, WorkerChannel,
                                 WorkerDied, decode_payload, encode_payload,
                                 recv_frame, send_frame)

# staged payloads whose pass got cancelled (epoch bump) are never resolved;
# cap the stash so they can't accumulate across a long-lived worker
MAX_STAGED = 1024


def config_from_wire(d: Dict[str, Any]) -> ModelConfig:
    d = dict(d)
    d["pattern"] = tuple(BlockSpec(**dict(b)) for b in d["pattern"])
    d["prologue"] = tuple(BlockSpec(**dict(b)) for b in d["prologue"])
    return ModelConfig(**d)


def _host_tensor(x) -> torch.Tensor:
    """A decoded wire array as a host tensor (numpy views into a frame may
    be read-only or unaligned: copy those)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if not (a.flags.aligned and a.flags.writeable):
        a = a.copy()
    return torch.from_numpy(a)


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


class StageWorker:
    """Owns one node's stage engine plus the staging area for in-flight
    transport payloads, and (when the coordinator wires a routed topology)
    the peer channels direct forwards travel over."""

    def __init__(self, device=None):
        self.device = None if device is None else resolve_device(device)
        self.engine = None
        self.staged: "OrderedDict[int, Any]" = OrderedDict()
        self.node = "?"
        self._lock = threading.RLock()      # engine + staging serialization
        self._peer_lock = threading.Lock()  # peer wiring
        self.peer_addrs: Dict[str, Tuple[str, int]] = {}
        self.peers: Dict[str, WorkerChannel] = {}
        self._listener: Optional[socket.socket] = None

    # -- peer wiring -----------------------------------------------------
    def do_peer_addr(self) -> int:
        """Open (once) the listening socket other workers forward into;
        returns its port.  The coordinator learns the host from this
        worker's connection address and distributes {node: (host, port)}
        maps through ``set_peers``."""
        with self._peer_lock:
            if self._listener is None:
                srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                srv.bind(("0.0.0.0", 0))
                srv.listen(16)
                self._listener = srv
                threading.Thread(target=self._accept_peers,
                                 name=f"peers-{self.node}",
                                 daemon=True).start()
            return self._listener.getsockname()[1]

    def _accept_peers(self) -> None:
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.settimeout(300.0)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=serve_connection, args=(conn,),
                             kwargs={"worker": self}, daemon=True).start()

    def do_set_peers(self, addrs: Dict[str, Any]) -> None:
        """Install the routed topology.  Channels to nodes whose address
        changed (a replan moved or respawned them) are dropped and re-dialed
        lazily."""
        with self._peer_lock:
            new = {n: (str(h), int(p)) for n, (h, p) in addrs.items()}
            for n, ch in list(self.peers.items()):
                if self.peer_addrs.get(n) != new.get(n):
                    ch.close()
                    del self.peers[n]
            self.peer_addrs = new

    def _peer(self, node: str) -> WorkerChannel:
        with self._peer_lock:
            ch = self.peers.get(node)
            if ch is not None and ch.alive:
                return ch
            addr = self.peer_addrs.get(node)
            if addr is None:
                raise RuntimeError(
                    f"{self.node}: no peer address for {node} — "
                    "coordinator never sent set_peers for this topology")
            s = socket.create_connection(addr, timeout=60.0)
            ch = WorkerChannel(s, node=f"{self.node}->{node}",
                               timeout_s=60.0)
            self.peers[node] = ch
            return ch

    def close_peers(self) -> None:
        with self._peer_lock:
            for ch in self.peers.values():
                ch.close()
            self.peers.clear()
            if self._listener is not None:
                self._listener.close()
                self._listener = None

    # -- staged payloads -------------------------------------------------
    def _on_device(self, x):
        """A resolved payload tree with its arrays as tensors: floating
        ones on the engine's device, integer ones (token ids) on the
        host."""
        if isinstance(x, dict):
            return {k: self._on_device(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(self._on_device(v) for v in x)
        if not _is_array(x):
            return x
        t = _host_tensor(x)
        return t.to(self.engine.device) if t.is_floating_point() else t

    def _resolve(self, x):
        if isinstance(x, StagedRef):
            try:
                x = self.staged.pop(x.tag)
            except KeyError:
                raise RuntimeError(
                    f"staged payload {x.tag} missing on {self.node} "
                    "(never arrived, or evicted past the "
                    f"{MAX_STAGED}-entry cap)") from None
        return self._on_device(x)

    def do_stage(self, tag: int, payload) -> None:
        self.staged[tag] = payload
        while len(self.staged) > MAX_STAGED:
            self.staged.popitem(last=False)     # oldest = cancelled passes

    # -- lifecycle -------------------------------------------------------
    def do_init(self, spec: Dict[str, Any]) -> str:
        device = resolve_device(spec["device"])
        if self.device is not None and device.type != self.device.type:
            raise RuntimeError(
                f"init for device {spec['device']!r} on a worker started "
                f"for {self.device}")
        cfg = config_from_wire(spec["cfg"])
        ec = EngineConfig(**dict(spec["ec"]))
        layers = LayerRange(*spec["layers"])
        self.node = spec.get("node", "?")
        params = map_tree(_host_tensor, spec["params"])
        self.engine = None                  # drop the old slice first
        if spec["paged"]:
            self.engine = PagedStageEngine(
                cfg, params, layers, ec, num_pages=spec["num_pages"],
                page_size=spec["page_size"], rng_seed=spec["rng_seed"],
                device=device)
        else:
            self.engine = StageEngine(cfg, params, layers, ec,
                                      rng_seed=spec["rng_seed"],
                                      device=device)
        self.staged.clear()
        return f"{self.node}: layers [{layers.start}, {layers.end})"

    # -- dispatch --------------------------------------------------------
    def handle(self, method: str, args: List[Any]):
        if method == "ping":
            return "pong"
        if method == "peer_addr":
            return self.do_peer_addr()
        if method == "set_peers":
            return self.do_set_peers(dict(args[0]))
        pushes: List[Tuple[str, int, Any]] = []
        with self._lock:
            result = self._dispatch(method, args, pushes)
        # peer pushes run outside the worker lock: waiting on a peer's ack
        # must never block that peer's own compute against us
        for dst, tag, payload in pushes:
            try:
                self._peer(dst).call("stage", tag, payload)
            except (WorkerDied, OSError):
                # peer gone: drop the frame — the coordinator's failover
                # requeues the pass and epoch guards kill the stale
                # delivery, as the transport pump drops
                pass
        return result

    def _dispatch(self, method: str, args: List[Any],
                  pushes: List[Tuple[str, int, Any]]):
        if method == "stage":
            return self.do_stage(args[0], args[1])
        if method == "init":
            return self.do_init(args[0])
        eng = self.engine
        if eng is None:
            raise RuntimeError(f"{method!r} before init")
        if method == "prefill_stage":
            slot, x, entry = args[:3]
            fwd = args[3] if len(args) > 3 else None
            out = eng.prefill_stage(slot, self._resolve(x), entry)
            if fwd is not None:
                pushes.append((fwd[0], fwd[1], out))
                return None
            return out
        if method == "prefill_chunk":
            slot, x, entry, start = args[:4]
            fwd = args[4] if len(args) > 4 else None
            out = eng.prefill_chunk(slot, self._resolve(x), entry, start)
            if fwd is not None:
                pushes.append((fwd[0], fwd[1], out))
                return None
            return out
        if method == "decode_stage":
            # 6-tuple items: a trailing ``tokens`` vector marks a
            # multi-token verify pass; both ``h`` and ``tokens`` may arrive
            # as StagedRefs pushed by a peer
            items = []
            for w in args[0]:
                s, p, e, t, h = w[:5]
                tk = self._resolve(w[5]) if len(w) > 5 and w[5] is not None \
                    else None
                items.append(DecodeItem(
                    slot=s, pos=p, entry=e, token=t, h=self._resolve(h),
                    tokens=None if tk is None else [int(x) for x in tk]))
            fwds = args[1] if len(args) > 1 else None
            outs = eng.decode_stage(items)
            reply = []
            for i, o in enumerate(outs):
                f = fwds[i] if fwds else None
                if f is not None:
                    pushes.append((f[0], f[1], o.h))
                    reply.append((None, o.logits))
                else:
                    reply.append((o.h, o.logits))
            return reply
        if method == "export_kv":
            slot, tokens, layers = args[:3]
            fwd = args[3] if len(args) > 3 else None
            out = eng.export_kv(slot, tokens, list(layers))
            if fwd is not None:
                pushes.append((fwd[0], fwd[1], out))
                return None
            return out
        if method == "import_kv":
            slot, tokens, payload = args
            return eng.import_kv(slot, tokens, self._resolve(payload))
        if method == "alloc_slot":
            return eng.alloc_slot(args[0])
        if method == "free_slot":
            return eng.free_slot(args[0])
        if method == "ensure":
            return eng.ensure(args[0], args[1])
        if method == "release":
            return eng.release(args[0])
        if method == "rollback":
            return eng.rollback(args[0], args[1])
        if method == "kv_tokens_used":
            return eng.kv_tokens_used()
        if method == "kv_tokens_capacity":
            return eng.kv_tokens_capacity()
        if method == "pool_used":
            return eng.pool_used()
        if method == "pool_num_pages":
            pool = getattr(eng, "pool", None)
            return pool.num_pages if pool is not None else None
        raise RuntimeError(f"unknown method {method!r}")


def serve_connection(sock: socket.socket,
                     worker: Optional[StageWorker] = None) -> None:
    """Frame loop: one request, one reply, until shutdown or the peer goes
    away.  The coordinator connection creates the worker; accepted peer
    connections share it (so peer-staged payloads land in the stash the
    engine RPCs resolve from)."""
    if worker is None:
        worker = StageWorker()
    while True:
        try:
            frame = recv_frame(sock)
        except socket.timeout:
            continue                     # idle coordinator, not a dead one
        except (FrameError, OSError):
            return                       # coordinator gone: exit quietly
        try:
            method, args = decode_payload(frame)
        except (FrameError, ValueError) as e:
            _reply(sock, ("err", f"undecodable request: {e}"))
            continue
        if method == "shutdown":
            _reply(sock, ("ok", None))
            return
        try:
            result = worker.handle(method, args)
        except Exception:
            _reply(sock, ("err", traceback.format_exc(limit=20)))
        else:
            _reply(sock, ("ok", result))


def _reply(sock: socket.socket, payload) -> None:
    try:
        send_frame(sock, encode_payload(payload))
    except (OSError, FrameError):
        pass                             # coordinator gone mid-reply


def run_worker(host: str, port: int, timeout_s: float = 300.0,
               device="cuda") -> None:
    """Dial the coordinator and serve its connection until it shuts this
    worker down or goes away.  ``device`` is checked before dialing: a
    worker asked for CUDA on a host without it raises."""
    worker = StageWorker(device)
    sock = socket.create_connection((host, port), timeout=timeout_s)
    sock.settimeout(timeout_s)
    # replies go out as a header and body segments: without this, Nagle
    # holds each segment for the coordinator's delayed ack
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        serve_connection(sock, worker)
    finally:
        worker.close_peers()
        sock.close()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--connect", required=True, metavar="HOST:PORT",
                    help="coordinator address to dial (the coordinator "
                         "assigns this worker a node and layer slice over "
                         "the wire)")
    ap.add_argument("--timeout-s", type=float, default=300.0,
                    help="socket timeout for connect and mid-frame reads; "
                         "an idle but open connection waits forever (a "
                         "dead coordinator closes the socket, which exits "
                         "the worker)")
    ap.add_argument("--device", default="cuda",
                    help="device the stage engine runs on (cuda | cpu)")
    args = ap.parse_args()
    host, _, port = args.connect.rpartition(":")
    run_worker(host or "127.0.0.1", int(port), timeout_s=args.timeout_s,
               device=args.device)


if __name__ == "__main__":
    main()
