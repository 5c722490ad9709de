"""The online front door: an OpenAI-compatible HTTP API over ClusterRuntime —
counterpart of ``repro.serving.frontend``.

Helix evaluates an *online* setting — requests arrive on the wall clock and
per-request latency (TTFT, TPOT, SLO attainment) is the headline metric —
so this module turns the offline trace-replay runtime into a server:

  POST /v1/completions        OpenAI completions (``stream: true`` → SSE)
  POST /v1/chat/completions   OpenAI chat completions (SSE likewise)
  GET  /v1/models             the single served model
  GET  /healthz               liveness + runtime ``_state()`` diagnostics
                              + the server-side latency summary so far

Streaming semantics: one SSE ``data:`` chunk per token the coordinator
*confirms* — the runtime's ``on_token`` callback fires in strict output
order, so pipelined ``max_inflight`` windows and speculative verify rounds
never leak unconfirmed (cancellable) tokens into a stream.  Each chunk
carries ``token_id`` and ``output_index``; the terminal chunk carries
``finish_reason``, followed by ``data: [DONE]``.

Admission: requests the runtime rejects up front (empty prompt, prompt >
``max_len``, sampling × speculation) map to HTTP 400; when accepted-but-
unfinished work reaches ``max_pending`` the server answers 429 with a
``Retry-After`` hint instead of letting queues grow without bound.  During
a drain (``shutdown(drain=True)``) new requests get 503 while in-flight
streams run to completion.

Tokenisation: the repo has no text tokenizer, so the API accepts either a
raw token-id list (exact control — used by the byte-identity tests and the
open-loop client) or a string, encoded as UTF-8 bytes (every config here
has vocab_size >= 256, so byte ids are always in-vocab; ids < 256 decode
back through latin-1, larger ids render as ``<id>``).

Everything is stdlib: ``http.server.ThreadingHTTPServer`` handlers call
the runtime's thread-safe ``submit()`` and block on a per-request queue
fed from the loop thread.  The runtime decides the device: a
``ClusterRuntime`` built for CUDA (the default) on a host without it
raises before a front door can wrap it.
"""
from __future__ import annotations

import dataclasses
import json
import queue as _queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .engine import Request
from .runtime import ClusterRuntime

# ---------------------------------------------------------------------------
# tokenizer-less text codec


def encode_text(text: str, vocab_size: int) -> List[int]:
    """UTF-8 bytes as token ids (folded into the vocab for tiny vocabs)."""
    return [b % vocab_size for b in text.encode("utf-8")]


def decode_token(tok: int) -> str:
    if 0 <= tok < 256:
        return bytes([tok]).decode("latin-1")
    return f"<{tok}>"


def decode_tokens(toks: Sequence[int]) -> str:
    return "".join(decode_token(int(t)) for t in toks)


# ---------------------------------------------------------------------------
# per-request latency metrics


def percentiles(xs: Sequence[float],
                qs: Tuple[int, ...] = (50, 95, 99)) -> Dict[str, float]:
    if not xs:
        return {f"p{q}": float("nan") for q in qs}
    a = np.asarray(list(xs), np.float64)
    return {f"p{q}": float(np.percentile(a, q)) for q in qs}


@dataclasses.dataclass
class RequestStats:
    """Server-side latency record, all on the runtime's monotonic clock."""
    request_id: int
    ttft_s: float                # submit -> first confirmed token
    tpot_s: float                # mean per-token time after the first
    e2e_s: float                 # submit -> finish
    tokens: int
    finish_reason: str

    @classmethod
    def from_request(cls, req: Request) -> "RequestStats":
        first = req.first_token_s if req.first_token_s is not None \
            else req.finished_s
        n = len(req.output)
        tpot = ((req.finished_s - first) / (n - 1)) if n > 1 else 0.0
        return cls(request_id=req.request_id,
                   ttft_s=first - req.submitted_s,
                   tpot_s=tpot,
                   e2e_s=req.finished_s - req.submitted_s,
                   tokens=n,
                   finish_reason=req.finish_reason or "")


def summarize(stats: Sequence[RequestStats], *,
              slo_ttft_s: Optional[float] = None,
              slo_tpot_s: Optional[float] = None) -> Dict[str, Any]:
    """TTFT/TPOT/E2E percentiles + SLO attainment.  A request attains its
    SLO when TTFT <= slo_ttft_s AND (for multi-token outputs) mean TPOT <=
    slo_tpot_s; with no SLO configured attainment is reported over an
    always-true predicate (1.0) so the field is uniformly present."""
    out: Dict[str, Any] = {
        "requests": len(stats),
        "ttft_s": percentiles([s.ttft_s for s in stats]),
        "tpot_s": percentiles([s.tpot_s for s in stats if s.tokens > 1]),
        "e2e_s": percentiles([s.e2e_s for s in stats]),
    }
    if stats:
        ok = 0
        for s in stats:
            good = True
            if slo_ttft_s is not None:
                good = good and s.ttft_s <= slo_ttft_s
            if slo_tpot_s is not None and s.tokens > 1:
                good = good and s.tpot_s <= slo_tpot_s
            ok += bool(good)
        out["slo_attainment"] = ok / len(stats)
    else:
        out["slo_attainment"] = float("nan")
    out["slo"] = {"ttft_s": slo_ttft_s, "tpot_s": slo_tpot_s}
    return out


# ---------------------------------------------------------------------------
# the server


class Frontend:
    """OpenAI-compatible HTTP front door over a ``ClusterRuntime``.

    ``serve(host, port)`` starts two threads: the runtime's
    ``serve_forever`` loop and the ``ThreadingHTTPServer``; handlers feed
    the loop through ``runtime.submit(..., on_token=..., on_done=...)``.
    The runtime should be constructed with ``realtime=True`` (or a
    realtime transport) so arrivals land on the wall clock.
    """

    def __init__(self, runtime: ClusterRuntime, *,
                 model_name: Optional[str] = None,
                 max_pending: int = 64,
                 default_max_tokens: int = 16,
                 request_timeout_s: float = 300.0,
                 slo_ttft_s: Optional[float] = None,
                 slo_tpot_s: Optional[float] = None):
        self.rt = runtime
        self.model = model_name or runtime.cfg.name
        self.max_pending = max_pending
        self.default_max_tokens = default_max_tokens
        self.request_timeout_s = request_timeout_s
        self.slo_ttft_s = slo_ttft_s
        self.slo_tpot_s = slo_tpot_s
        self.stats: List[RequestStats] = []
        self.draining = False
        self.loop_error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._next_id = 0
        # live traffic signals for the autoscaler: arrival timestamps on
        # the runtime clock, and completed (input_len, output_len) pairs
        # feeding TrafficProfile.from_requests
        self.arrivals: deque = deque(maxlen=4096)
        self.lengths: deque = deque(maxlen=4096)
        self.autoscaler = None       # attached by Autoscaler.attach()
        self._loop: Optional[threading.Thread] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._httpd_thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    def serve(self, host: str = "127.0.0.1", port: int = 0
              ) -> Tuple[str, int]:
        """Start the runtime loop + HTTP server; returns the bound
        (host, port) — port 0 picks an ephemeral port."""
        def loop():
            try:
                self.rt.serve_forever()
            except BaseException as e:   # surfaced via /healthz + shutdown
                self.loop_error = e
        self._loop = threading.Thread(target=loop, daemon=True,
                                      name="runtime-loop")
        self._loop.start()

        fe = self

        class Handler(_Handler):
            frontend = fe

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._httpd_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="http-accept")
        self._httpd_thread.start()
        return self._httpd.server_address[:2]

    def begin_drain(self) -> None:
        """Stop accepting new requests (503) while in-flight ones finish."""
        self.draining = True

    def shutdown(self, drain: bool = True, timeout_s: float = 60.0) -> None:
        """Graceful stop: refuse new work, optionally wait for in-flight
        requests to finish streaming, then stop the loop and the HTTP
        server.  The runtime itself (worker processes etc.) is left to the
        caller's ``runtime.shutdown()``."""
        self.begin_drain()
        deadline = time.monotonic() + timeout_s
        if drain:
            while (self.rt.pending() > 0 and self.loop_error is None
                   and time.monotonic() < deadline):
                time.sleep(0.02)
        self.rt.stop_serving()
        if self._loop is not None:
            self._loop.join(timeout=max(0.0, deadline - time.monotonic()))
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()

    # -- request plumbing ---------------------------------------------------
    def alloc_request_id(self) -> int:
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            return rid

    def note_arrival(self, prompt_len: int) -> None:
        with self._lock:
            self.arrivals.append(self.rt.clock())

    def arrival_rate(self, window_s: float = 30.0) -> float:
        """Accepted requests/s over the trailing window (runtime clock).
        Cancelled requests stopped consuming capacity when they were torn
        down, so arrivals — not completions — are the demand signal."""
        now = self.rt.clock()
        with self._lock:
            n = sum(1 for t in self.arrivals if now - t <= window_s)
        return n / window_s if window_s > 0 else 0.0

    def record(self, req: Request) -> None:
        with self._lock:
            self.stats.append(RequestStats.from_request(req))
            self.lengths.append((int(len(req.prompt)),
                                 max(1, len(req.output))))

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            stats = list(self.stats)
        return summarize(stats, slo_ttft_s=self.slo_ttft_s,
                         slo_tpot_s=self.slo_tpot_s)

    def parse_prompt(self, body: Dict[str, Any], chat: bool) -> List[int]:
        """Token ids from an OpenAI request body.  Raises ValueError."""
        vocab = self.rt.cfg.vocab_size
        if chat:
            msgs = body.get("messages")
            if not isinstance(msgs, list) or not msgs:
                raise ValueError("messages must be a non-empty list")
            text = "".join(f"{m.get('role', 'user')}: {m.get('content', '')}\n"
                           for m in msgs) + "assistant:"
            return encode_text(text, vocab)
        p = body.get("prompt")
        if isinstance(p, str):
            return encode_text(p, vocab)
        if isinstance(p, list) and all(isinstance(t, int) for t in p):
            bad = [t for t in p if not 0 <= t < vocab]
            if bad:
                raise ValueError(f"token ids {bad[:4]} out of vocab "
                                 f"[0, {vocab})")
            return [int(t) for t in p]
        raise ValueError("prompt must be a string or a list of token ids")


class _Handler(BaseHTTPRequestHandler):
    """One handler thread per connection (ThreadingHTTPServer)."""

    frontend: Frontend = None    # set by the per-Frontend subclass
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):   # keep test/CI output clean
        pass

    # -- plumbing -----------------------------------------------------------
    def _json(self, code: int, obj: Dict[str, Any],
              headers: Sequence[Tuple[str, str]] = ()) -> None:
        body = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str,
               headers: Sequence[Tuple[str, str]] = ()) -> None:
        self._json(code, {"error": {"message": message,
                                    "type": "invalid_request_error"
                                    if code == 400 else "server_error",
                                    "code": code}}, headers)

    def _read_body(self) -> Optional[Dict[str, Any]]:
        try:
            n = int(self.headers.get("Content-Length", "0"))
            raw = self.rfile.read(n) if n else b"{}"
            obj = json.loads(raw.decode("utf-8"))
            if not isinstance(obj, dict):
                raise ValueError("body must be a JSON object")
            return obj
        except (ValueError, UnicodeDecodeError) as e:
            self._error(400, f"invalid JSON body: {e}")
            return None

    # -- routes -------------------------------------------------------------
    def do_GET(self) -> None:
        fe = self.frontend
        if self.path == "/v1/models":
            self._json(200, {"object": "list", "data": [
                {"id": fe.model, "object": "model", "owned_by": "repro"}]})
        elif self.path == "/healthz":
            try:
                state = fe.rt._state()   # loop may mutate under us: best-effort
            except Exception as e:
                state = f"unavailable: {e}"
            status = "error" if fe.loop_error is not None else \
                "draining" if fe.draining else "ok"
            try:
                pool = fe.rt.pool_pages_used()
            except Exception:
                pool = {}
            self._json(200 if status != "error" else 500, {
                "status": status,
                "model": fe.model,
                "pending": fe.rt.pending(),
                "completed": fe.rt.completed,
                "tokens_produced": fe.rt.tokens_produced,
                "cancelled_requests": fe.rt.cancelled_requests,
                "pool_pages_used": pool,
                "arrival_rate_rps": fe.arrival_rate(),
                "autoscaler": (fe.autoscaler.describe()
                               if fe.autoscaler is not None else None),
                "error": repr(fe.loop_error) if fe.loop_error else None,
                "state": state,
                "metrics": fe.summary(),
            })
        else:
            self._error(404, f"no route {self.path}")

    def do_POST(self) -> None:
        if self.path == "/v1/completions":
            self._completion(chat=False)
        elif self.path == "/v1/chat/completions":
            self._completion(chat=True)
        else:
            self._error(404, f"no route {self.path}")

    # -- completions --------------------------------------------------------
    def _completion(self, chat: bool) -> None:
        fe = self.frontend
        body = self._read_body()
        if body is None:
            return
        if fe.draining:
            self._error(503, "server is draining")
            return
        if fe.loop_error is not None:
            self._error(500, f"runtime loop died: {fe.loop_error!r}")
            return
        try:
            prompt = fe.parse_prompt(body, chat)
        except ValueError as e:
            self._error(400, str(e))
            return
        max_tokens = int(body.get("max_tokens", fe.default_max_tokens))
        temperature = float(body.get("temperature", 0.0))
        stream = bool(body.get("stream", False))
        # admission: bounded accepted-but-unfinished work
        if fe.rt.pending() >= fe.max_pending:
            self._error(429, f"at capacity ({fe.max_pending} pending "
                        "requests); retry later",
                        headers=[("Retry-After", "1")])
            return
        rid = fe.alloc_request_id()
        req = Request(request_id=rid,
                      prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_tokens,
                      temperature=temperature)
        ch: "_queue.Queue" = _queue.Queue()
        try:
            fe.rt.submit(req,
                         on_token=lambda t: ch.put(("tok", t)),
                         on_done=lambda r: ch.put(("done", r)))
        except ValueError as e:
            self._error(400, str(e))
            return
        fe.note_arrival(len(prompt))
        if stream:
            self._stream_response(req, ch, chat)
        else:
            self._full_response(req, ch, chat)

    def _chunk(self, req: Request, chat: bool, *, idx: int,
               tok: Optional[int], finish: Optional[str]) -> bytes:
        text = decode_token(tok) if tok is not None else ""
        if chat:
            choice: Dict[str, Any] = {
                "index": 0,
                "delta": ({"role": "assistant", "content": text}
                          if tok is not None else {}),
                "finish_reason": finish,
            }
            obj_type = "chat.completion.chunk"
        else:
            choice = {"index": 0, "text": text, "finish_reason": finish}
            obj_type = "text_completion"
        if tok is not None:
            choice["token_id"] = int(tok)
            choice["output_index"] = idx
        obj = {"id": f"cmpl-{req.request_id}", "object": obj_type,
               "created": int(time.time()), "model": self.frontend.model,
               "choices": [choice]}
        return b"data: " + json.dumps(obj).encode("utf-8") + b"\n\n"

    def _stream_response(self, req: Request, ch: "_queue.Queue",
                         chat: bool) -> None:
        fe = self.frontend
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        idx = 0
        try:
            while True:
                kind, val = ch.get(timeout=fe.request_timeout_s)
                if kind == "tok":
                    self.wfile.write(self._chunk(req, chat, idx=idx,
                                                 tok=val, finish=None))
                    self.wfile.flush()
                    idx += 1
                else:
                    fe.record(val)   # before the socket: stats never
                    #                  depend on the client reading DONE
                    self.wfile.write(self._chunk(
                        req, chat, idx=idx, tok=None,
                        finish=val.finish_reason or "stop"))
                    self.wfile.write(b"data: [DONE]\n\n")
                    self.wfile.flush()
                    return
        except _queue.Empty:
            # runtime wedged (or died): end the stream; diagnostics live
            # in /healthz
            try:
                self.wfile.write(b"data: [DONE]\n\n")
            except OSError:
                pass
        except (BrokenPipeError, ConnectionResetError):
            # client went away: cancel so the runtime frees KV/slots on
            # every stage node instead of decoding into a dead socket.
            # on_done still fires (finish_reason "cancelled" — or a real
            # finish if the request won the race), so stats record the
            # truncated request either way.
            fe.rt.cancel(req.request_id)
            try:
                while True:
                    kind, val = ch.get(timeout=fe.request_timeout_s)
                    if kind == "done":
                        fe.record(val)
                        return
            except _queue.Empty:
                pass

    def _full_response(self, req: Request, ch: "_queue.Queue",
                       chat: bool) -> None:
        fe = self.frontend
        try:
            while True:
                kind, val = ch.get(timeout=fe.request_timeout_s)
                if kind == "done":
                    break
        except _queue.Empty:
            self._error(504, "request timed out in the runtime")
            return
        fe.record(val)
        text = decode_tokens(req.output)
        if chat:
            choice: Dict[str, Any] = {
                "index": 0,
                "message": {"role": "assistant", "content": text},
                "finish_reason": req.finish_reason,
            }
            obj_type = "chat.completion"
        else:
            choice = {"index": 0, "text": text,
                      "finish_reason": req.finish_reason}
            obj_type = "text_completion"
        choice["token_ids"] = [int(t) for t in req.output]
        self._json(200, {
            "id": f"cmpl-{req.request_id}", "object": obj_type,
            "created": int(time.time()), "model": fe.model,
            "choices": [choice],
            "usage": {"prompt_tokens": int(len(req.prompt)),
                      "completion_tokens": len(req.output),
                      "total_tokens": int(len(req.prompt))
                      + len(req.output)},
        })
