"""The port's front door and wall-clock loop against the JAX package (f32,
CPU).

``repro_torch.serving.frontend.Frontend`` over the port's realtime
``ClusterRuntime``: streamed greedy tokens equal the reference's offline
single-engine outputs (the ``reference`` fixture) with SSE chunks in
confirmation order; HTTP 400 / 429 / 503 mapping; graceful drain;
cancel-on-disconnect releasing every page; an idle server that does not
stall; the wall clock never read by the runtime or engines; sampling x
speculation refused with 400; the autoscaler fed by the front door's
arrival rate; and ``launch/serve.py --serve`` end to end.  The pure
helpers (``summarize``, ``percentiles``, the text codec) equal the
reference's on the same inputs.
"""
import json
import os
import queue as _queue
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro.serving import frontend as jfe
from repro_torch.serving import frontend as tfe
from repro_torch.serving.autoscaler import Autoscaler
from repro_torch.serving.engine import Request
from repro_torch.serving.frontend import Frontend
from repro_torch.serving.runtime import ClusterRuntime, InProcessTransport

from test_torch_runtime import EC, ROOT, port_model, port_plan  # noqa: F401

TWO = {"n0": (0, 2), "n1": (2, 4)}
HTTP_TIMEOUT = 60


# ---------------------------------------------------------------------------
# helpers


def _post(url, path, body, timeout=HTTP_TIMEOUT):
    req = urllib.request.Request(
        url + path, data=json.dumps(body).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.load(resp)


def _get(url, path, timeout=HTTP_TIMEOUT):
    with urllib.request.urlopen(url + path, timeout=timeout) as resp:
        return json.load(resp)


def _stream(url, body, timeout=HTTP_TIMEOUT):
    """POST a streaming completion; returns (token_ids, output_indices,
    finish_reason)."""
    req = urllib.request.Request(
        url + "/v1/completions", data=json.dumps(body).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    toks, idxs, finish = [], [], None
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        for raw in resp:
            line = raw.strip()
            if not line.startswith(b"data: "):
                continue
            data = line[len(b"data: "):]
            if data == b"[DONE]":
                break
            choice = json.loads(data)["choices"][0]
            if choice.get("token_id") is not None:
                toks.append(choice["token_id"])
                idxs.append(choice["output_index"])
            if choice.get("finish_reason"):
                finish = choice["finish_reason"]
    return toks, idxs, finish


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.01)


def assert_drained(rt):
    used = rt.pool_pages_used()
    assert used and all(u == 0 for u in used.values()), used
    if rt.draft is not None:
        assert rt.draft.free_slots == rt.ec.max_batch


def served(rt, **kw):
    """A started front door over ``rt``: (frontend, url)."""
    fe = Frontend(rt, **kw)
    host, port = fe.serve("127.0.0.1", 0)
    return fe, f"http://{host}:{port}"


def realtime_rt(cfg, params, assignment=TWO, delay=2e-3, **kw):
    return ClusterRuntime(cfg, params, port_plan(cfg, assignment), EC,
                          paged=True, realtime=True, device="cpu",
                          transport=InProcessTransport(default_delay_s=delay),
                          **kw)


@pytest.fixture
def online_frontend(port_model):
    """A served 2-stage front door (wall clock over the in-process
    transport, in-flight window 2)."""
    cfg, params = port_model
    rt = realtime_rt(cfg, params, max_inflight=2)
    fe, url = served(rt, max_pending=8)
    try:
        yield cfg, rt, fe, url
    finally:
        fe.shutdown(drain=True, timeout_s=60)
        rt.shutdown()
    assert fe.loop_error is None, f"runtime loop died: {fe.loop_error!r}"


# ---------------------------------------------------------------------------
# wall-clock streaming ingest


def test_streamed_output_matches_offline_reference(online_frontend,
                                                   reference):
    """Requests submitted over HTTP while the loop steps (staggered, so
    later ones arrive mid-run) stream the reference's greedy tokens, with
    SSE chunks in confirmation order across the depth-2 window."""
    cfg, rt, fe, url = online_frontend
    prompts, refs = reference
    results = {}

    def fire(i):
        results[i] = _stream(url, {"prompt": [int(t) for t in prompts[i]],
                                   "max_tokens": 6, "stream": True})

    threads = []
    for i in range(len(prompts)):
        th = threading.Thread(target=fire, args=(i,), daemon=True)
        th.start()
        threads.append(th)
        time.sleep(0.03)
    for th in threads:
        th.join(timeout=120)
    assert sorted(results) == list(range(len(prompts)))
    for i, (toks, idxs, finish) in sorted(results.items()):
        assert toks == refs[i], (i, toks, refs[i])
        assert idxs == list(range(len(refs[i])))
        assert finish == "length"
    _wait(lambda: rt.pending() == 0)
    assert_drained(rt)
    s = fe.summary()
    assert s["requests"] == len(prompts)
    for key in ("ttft_s", "tpot_s", "e2e_s"):
        assert all(not (v < 0) for v in s[key].values()), s


def test_non_streaming_and_chat(online_frontend):
    cfg, rt, fe, url = online_frontend
    status, obj = _post(url, "/v1/completions",
                        {"prompt": "hello world", "max_tokens": 4})
    assert status == 200
    assert len(obj["choices"][0]["token_ids"]) == 4
    assert obj["usage"]["completion_tokens"] == 4
    assert obj["usage"]["prompt_tokens"] == len("hello world")
    status, obj = _post(url, "/v1/chat/completions",
                        {"messages": [{"role": "user", "content": "hi"}],
                         "max_tokens": 3})
    assert status == 200
    assert obj["choices"][0]["message"]["role"] == "assistant"
    assert obj["object"] == "chat.completion"


def test_models_and_healthz(online_frontend):
    cfg, rt, fe, url = online_frontend
    assert _get(url, "/v1/models")["data"][0]["id"] == cfg.name
    h = _get(url, "/healthz")
    assert h["status"] == "ok"
    assert "queued=" in h["state"] and "hops[" in h["state"]
    assert h["autoscaler"] is None and h["pool_pages_used"] == \
        {"n0": 0, "n1": 0}
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(url, "/nope")
    assert ei.value.code == 404


# ---------------------------------------------------------------------------
# HTTP error mapping


def test_http_400_mapping(online_frontend):
    cfg, rt, fe, url = online_frontend
    cases = [
        {"prompt": [0] * (EC.max_len + 10), "max_tokens": 2},
        {"prompt": "", "max_tokens": 2},
        {"prompt": [0, 1, cfg.vocab_size + 7], "max_tokens": 2},
        {"prompt": {"nested": 1}, "max_tokens": 2},
        {"messages": [], "max_tokens": 2, "_chat": True},
    ]
    for body in cases:
        path = "/v1/chat/completions" if body.pop("_chat", False) \
            else "/v1/completions"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, path, body)
        assert ei.value.code == 400, body
        assert json.load(ei.value)["error"]["message"], body


def test_http_429_at_capacity(port_model):
    """Past ``max_pending`` accepted but unfinished requests the server
    answers 429 with Retry-After."""
    cfg, params = port_model
    rt = realtime_rt(cfg, params, delay=20e-3)
    fe, url = served(rt, max_pending=1)
    try:
        done = {}
        th = threading.Thread(
            target=lambda: done.setdefault(
                "r", _stream(url, {"prompt": [1] * 8, "max_tokens": 24,
                                   "stream": True})), daemon=True)
        th.start()
        _wait(lambda: rt.pending() > 0)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, "/v1/completions", {"prompt": [2] * 8,
                                           "max_tokens": 2})
        assert ei.value.code == 429
        assert ei.value.headers["Retry-After"]
        th.join(timeout=120)
        assert done["r"][2] == "length"
    finally:
        fe.shutdown(drain=True, timeout_s=60)
        rt.shutdown()


def test_graceful_drain(port_model):
    """During a drain new requests get 503 while the stream in flight runs
    to completion; shutdown then stops the loop."""
    cfg, params = port_model
    rt = realtime_rt(cfg, params, delay=20e-3)
    fe, url = served(rt)
    try:
        done = {}
        th = threading.Thread(
            target=lambda: done.setdefault(
                "r", _stream(url, {"prompt": [3] * 8, "max_tokens": 16,
                                   "stream": True})), daemon=True)
        th.start()
        _wait(lambda: rt.pending() > 0)
        fe.begin_drain()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, "/v1/completions", {"prompt": [4] * 8,
                                           "max_tokens": 2})
        assert ei.value.code == 503
        fe.shutdown(drain=True, timeout_s=60)
        th.join(timeout=120)
        toks, idxs, finish = done["r"]
        assert finish == "length" and len(toks) == 16
        assert fe.loop_error is None
        assert_drained(rt)
    finally:
        fe.shutdown(drain=False, timeout_s=10)
        rt.shutdown()


# ---------------------------------------------------------------------------
# cancel-on-disconnect


def test_mid_stream_disconnect_cancels_and_frees(port_model, reference):
    """A streaming client that resets its socket mid-generation cancels
    its request (``cancelled_requests`` 1, every page free on every node,
    as ``/healthz`` reports) while another stream in flight finishes with
    the reference's tokens."""
    cfg, params = port_model
    prompts, refs = reference
    rt = realtime_rt(cfg, params, delay=5e-3, max_inflight=2)
    fe, url = served(rt, max_pending=8)
    host, port = url[len("http://"):].split(":")
    try:
        done = {}
        th = threading.Thread(
            target=lambda: done.setdefault(
                "r", _stream(url, {"prompt": [int(t) for t in prompts[0]],
                                   "max_tokens": 6, "stream": True})),
            daemon=True)
        th.start()
        body = json.dumps({"prompt": [7] * 8, "max_tokens": 30,
                           "stream": True}).encode()
        s = socket.create_connection((host, int(port)), timeout=60)
        s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\n" +
                  f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        buf = b""
        while buf.count(b"data: ") < 2:     # tokens streamed
            chunk = s.recv(4096)
            assert chunk, "server closed the stream early"
            buf += chunk
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     struct.pack("ii", 1, 0))    # RST on close
        s.close()
        _wait(lambda: rt.cancelled_requests > 0, timeout=60)
        assert rt.cancelled_requests == 1
        th.join(timeout=120)
        assert done["r"][0] == refs[0] and done["r"][2] == "length"
        _wait(lambda: rt.pending() == 0)
        assert_drained(rt)
        h = _get(url, "/healthz")
        assert h["cancelled_requests"] == 1
        assert all(v == 0 for v in h["pool_pages_used"].values())
        assert fe.summary()["requests"] == 2   # the cancelled one recorded
    finally:
        fe.shutdown(drain=True, timeout_s=60)
        rt.shutdown()
    assert fe.loop_error is None


# ---------------------------------------------------------------------------
# the runtime's clock


def test_ttft_non_negative_under_wall_clock_step(port_model, monkeypatch):
    """Request stamps come from the runtime's monotonic clock: a wall clock
    that steps back a minute on every read changes no stamp."""
    cfg, params = port_model
    base = time.time()
    calls = [0]

    def broken_wall_clock():
        calls[0] += 1
        return base - 60.0 * calls[0]

    monkeypatch.setattr(time, "time", broken_wall_clock)
    rt = ClusterRuntime(cfg, params, port_plan(cfg, TWO), EC, paged=True,
                        device="cpu",
                        transport=InProcessTransport(default_delay_s=1e-3))
    rng = np.random.RandomState(3)
    reqs = [Request(i, rng.randint(0, cfg.vocab_size, size=(n,)),
                    max_new_tokens=4) for i, n in enumerate((8, 6))]
    for r in reqs:
        rt.submit(r)
    rt.run_until_done()
    for r in reqs:
        assert r.done and r.first_token_s is not None
        assert r.submitted_s <= r.first_token_s <= r.finished_s
        assert r.finished_s > 0


def test_serving_paths_never_read_wall_clock():
    """No ``time.time()`` call in the request-stamping modules (the
    front door reads it only for the OpenAI ``created`` field)."""
    import inspect

    from repro_torch.serving import engine, runtime, stage_engine, transport
    for mod in (engine, runtime, stage_engine, transport):
        assert "time.time()" not in inspect.getsource(mod), mod.__name__


def test_realtime_clock_is_monotonic_wall_time(port_model):
    cfg, params = port_model
    rt = realtime_rt(cfg, params)
    a = rt.clock()
    time.sleep(0.05)
    b = rt.clock()
    assert rt.realtime and 0.04 <= b - a < 5.0


# ---------------------------------------------------------------------------
# idle vs stalled


def test_idle_server_does_not_stall(port_model):
    """An idle server waiting for requests does not trip the stall timer;
    a submission wakes it and is served."""
    cfg, params = port_model
    rt = ClusterRuntime(cfg, params, port_plan(cfg, {"n0": (0, 4)}), EC,
                        paged=True, realtime=True, stall_timeout_s=0.3,
                        device="cpu")
    err = []

    def loop():
        try:
            rt.serve_forever()
        except BaseException as e:
            err.append(e)

    th = threading.Thread(target=loop, daemon=True)
    th.start()
    try:
        time.sleep(1.0)              # idle for > 3x the stall budget
        assert th.is_alive() and not err, f"idle server stalled: {err}"
        got = _queue.Queue()
        req = Request(0, np.array([5, 6, 7], np.int32), max_new_tokens=3)
        rt.submit(req, on_done=lambda r: got.put(r))
        r = got.get(timeout=60)
        assert r is req and r.done and len(r.output) == 3
    finally:
        rt.stop_serving()
        th.join(timeout=30)
    assert not th.is_alive() and not err, err


def test_stop_serving_exits_cleanly_when_idle(port_model):
    cfg, params = port_model
    rt = ClusterRuntime(cfg, params, port_plan(cfg, {"n0": (0, 4)}), EC,
                        paged=True, realtime=True, device="cpu")
    th = threading.Thread(target=rt.serve_forever, daemon=True)
    th.start()
    time.sleep(0.1)
    rt.stop_serving()
    th.join(timeout=30)
    assert not th.is_alive()


def test_realtime_run_until_done_matches_reference(port_model, reference):
    """The wall-clock loop over the in-process transport (link delays as
    real timers) gives the reference's tokens through ``run_until_done``
    as well as through the front door."""
    cfg, params = port_model
    prompts, ref = reference
    rt = realtime_rt(cfg, params, assignment={"n0": (0, 1), "n1": (1, 3),
                                              "n2": (3, 4)},
                     delay=1e-3, max_inflight=2)
    reqs = [Request(i, p, max_new_tokens=6) for i, p in enumerate(prompts)]
    for r in reqs:
        rt.submit(r)
    rt.run_until_done()
    assert [r.output for r in reqs] == ref
    assert_drained(rt)
    assert rt._now > 0 and not rt._events      # the heap stays unused


# ---------------------------------------------------------------------------
# sampling x speculation


def test_temperature_rejected_with_draft(port_model):
    """temperature > 0 beside a draft is refused (400 at the front door);
    greedy requests on the same runtime serve speculatively."""
    cfg, params = port_model
    rt = realtime_rt(cfg, params, delay=0.0, draft_cfg=cfg,
                     draft_params=params, spec_tokens=3)
    with pytest.raises(ValueError, match="speculative"):
        rt.submit(Request(0, np.array([1, 2, 3], np.int32),
                          max_new_tokens=2, temperature=0.8))
    fe, url = served(rt)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, "/v1/completions",
                  {"prompt": [1, 2, 3], "max_tokens": 2,
                   "temperature": 0.8})
        assert ei.value.code == 400
        assert "speculative" in json.load(ei.value)["error"]["message"]
        toks, idxs, finish = _stream(url, {"prompt": [1, 2, 3],
                                           "max_tokens": 4,
                                           "stream": True})
        assert len(toks) == 4 and finish == "length"
        assert rt.spec_rounds > 0
    finally:
        fe.shutdown(drain=True, timeout_s=60)
        rt.shutdown()


def test_temperature_plumbed_through_front_door(port_model):
    cfg, params = port_model
    rt = realtime_rt(cfg, params, assignment={"n0": (0, 4)}, delay=0.0)
    fe, url = served(rt)
    try:
        a = _stream(url, {"prompt": [9] * 6, "max_tokens": 4,
                          "stream": True, "temperature": 0.0})
        b = _stream(url, {"prompt": [9] * 6, "max_tokens": 4,
                          "stream": True, "temperature": 0.0})
        assert a[0] == b[0]
        c = _stream(url, {"prompt": [9] * 6, "max_tokens": 4,
                          "stream": True, "temperature": 0.9})
        assert len(c[0]) == 4 and c[2] == "length"
    finally:
        fe.shutdown(drain=True, timeout_s=60)
        rt.shutdown()


# ---------------------------------------------------------------------------
# the autoscaler's live signal


def test_autoscaler_reads_the_front_door(port_model):
    """``Autoscaler(frontend=fe)`` registers as ``fe.autoscaler`` (shown
    on ``/healthz``) and measures the front door's arrivals and completed
    lengths."""
    cfg, params = port_model
    p = port_plan(cfg, TWO)
    rt = ClusterRuntime(cfg, params, p, EC, paged=True, realtime=True,
                        device="cpu")
    fe, url = served(rt)
    try:
        sc = Autoscaler(rt, p, frontend=fe, window_s=30.0)
        assert fe.autoscaler is sc and sc.measure_traffic() is None
        for n in (5, 7):
            _post(url, "/v1/completions", {"prompt": [3] * n,
                                           "max_tokens": 2})
        assert fe.arrival_rate(30.0) == pytest.approx(2 / 30.0)
        traffic = sc.measure_traffic()
        assert traffic is not None and traffic.rate_rps == \
            pytest.approx(2 / 30.0)
        assert _get(url, "/healthz")["autoscaler"]["nodes"] == {"A100": 2}
    finally:
        fe.shutdown(drain=True, timeout_s=60)
        rt.shutdown()


# ---------------------------------------------------------------------------
# pure helpers against the reference


def test_metrics_and_codec_match_reference():
    rng = np.random.RandomState(0)
    for n in (0, 1, 7):
        xs = list(rng.rand(n))
        got, want = tfe.percentiles(xs), jfe.percentiles(xs)
        assert got.keys() == want.keys()
        assert all(got[k] == want[k] or (np.isnan(got[k]) and
                                         np.isnan(want[k])) for k in got)
    reqs = []
    for i, (sub, first, fin, n) in enumerate(
            [(0.0, 0.2, 1.0, 5), (0.1, 0.4, 0.4, 1), (0.3, None, 0.9, 0)]):
        reqs.append(dict(request_id=i, prompt=np.zeros(3, np.int32),
                         output=list(range(n)), done=True,
                         finish_reason="length", submitted_s=sub,
                         first_token_s=first, finished_s=fin))
    from repro.serving.engine import Request as JRequest
    tstats = [tfe.RequestStats.from_request(Request(**r)) for r in reqs]
    jstats = [jfe.RequestStats.from_request(JRequest(**r)) for r in reqs]
    assert [vars(s) for s in tstats] == [vars(s) for s in jstats]
    for slo in ({}, {"slo_ttft_s": 0.25, "slo_tpot_s": 0.1}):
        got = json.dumps(tfe.summarize(tstats, **slo), sort_keys=True)
        assert got == json.dumps(jfe.summarize(jstats, **slo),
                                 sort_keys=True)
    for text, vocab in (("héllo", 49152), ("abc", 64)):
        assert tfe.encode_text(text, vocab) == jfe.encode_text(text, vocab)
    toks = [104, 300, 0, 255]
    assert tfe.decode_tokens(toks) == jfe.decode_tokens(toks)


# ---------------------------------------------------------------------------
# launch/serve.py


def test_serve_cli_front_door_on_cpu():
    """``launch/serve.py --serve`` on the CPU: it prints its address,
    streams a completion, drains on SIGINT and prints the summary."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm_360m", "--smoke", "--device", "cpu", "--cluster",
         "A100,L4", "--stages", "2", "--serve", "127.0.0.1:0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    out = []
    try:
        url = None
        deadline = time.monotonic() + 120
        while url is None:
            assert time.monotonic() < deadline, "".join(out)
            line = proc.stdout.readline()
            assert line, "".join(out)
            out.append(line)
            if line.startswith("serving ") and "http://" in line:
                url = line.split("http://")[1].split()[0]
        toks, idxs, finish = _stream(f"http://{url}",
                                     {"prompt": [1, 2, 3], "max_tokens": 3,
                                      "stream": True})
        assert len(toks) == 3 and finish == "length"
        proc.send_signal(signal.SIGINT)
        rest, _ = proc.communicate(timeout=60)
        out.append(rest)
        assert proc.returncode == 0, "".join(out)
        assert "served summary" in rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_front_door_driver_defaults_to_cuda(monkeypatch):
    """Without a card launch/serve.py's default device raises before it
    serves: no fallback to the CPU."""
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "smollm_360m", "--smoke", "--cluster",
                    "A100,L4", "--stages", "2", "--serve", "127.0.0.1:0"])
