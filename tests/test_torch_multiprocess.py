"""The port's multi-process serving against the JAX package (f32, CPU;
marked slow, as the reference's is: it spawns real worker processes).

``ClusterRuntime.spawn_workers`` launches one ``repro_torch.launch.worker``
subprocess per placed node (``device="cpu"`` here); the stage engines live
in the workers, payloads move over loopback TCP through the port's
``SocketTransport``, and the coordinator keeps the control plane.  The
anchors, as in ``tests/test_multiprocess.py``:

* greedy tokens across process boundaries equal the reference's
  single-engine outputs (the ``reference`` fixture), at depths 1 and 2,
  over the star and over direct worker-to-worker links, paged and dense;
* every remote pool drains to zero, checked over RPC;
* SIGKILLing a worker mid-decode is survivable: ``fail_node`` + replan +
  ``apply_plan`` re-prefill the requests in flight on the survivors, which
  finish with unchanged tokens — disaggregated too;
* a node that enters the placement later (a scale-up) gets a worker
  through the factory; workers started by hand (``connect=``) serve like
  spawned ones; the front door streams from workers; a worker asked for
  CUDA on a host without it raises.

Every worker runs with one intra-op thread (``OMP_NUM_THREADS=1``) so
parallel test runs do not oversubscribe the CPU.
"""
import json
import socket
import threading
import time
import urllib.request

import pytest
import torch

from repro_torch.core import MILPOptions, replan_after_failure
from repro_torch.launch.worker import run_worker
from repro_torch.serving.engine import Request
from repro_torch.serving.frontend import Frontend
from repro_torch.serving.runtime import ClusterRuntime
from repro_torch.serving.transport import RemoteStageEngine

from test_torch_disagg import port_disagg_plan
from test_torch_runtime import EC, port_model, port_plan  # noqa: F401

pytestmark = pytest.mark.slow

REPLAN_OPT = MILPOptions(time_limit_s=5.0, lns_rounds=0, fgls_rounds=10)


@pytest.fixture(autouse=True)
def one_thread_workers(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def spawn(port_model, p, **kw):
    cfg, params = port_model
    kw.setdefault("paged", True)
    return ClusterRuntime.spawn_workers(cfg, params, p, EC, device="cpu",
                                        stall_timeout_s=120.0,
                                        worker_timeout_s=120.0, **kw)


def submit_all(rt, prompts, max_new_tokens=6):
    reqs = [Request(i, p, max_new_tokens=max_new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        rt.submit(r)
    return reqs


def assert_drained(rt):
    """Every remote pool (paged) or slot set (dense) holds nothing, over
    RPC."""
    used = rt.pool_pages_used()
    assert all(u == 0 for u in used.values()), used
    assert all(e.kv_tokens_used() == 0 for e in rt.engines.values())


def step_until(rt, pred, max_steps=4000):
    for _ in range(max_steps):
        if pred():
            return
        if not rt.step():
            rt._await_delivery(30.0)
    raise AssertionError("predicate never held")


@pytest.mark.parametrize("max_inflight", [1, 2], ids=["depth1", "depth2"])
def test_multiprocess_two_stage_matches_reference(port_model, reference,
                                                  max_inflight):
    prompts, ref = reference
    prompts, ref = prompts[:2], ref[:2]
    rt = spawn(port_model, port_plan(port_model[0], {"n0": (0, 2),
                                                     "n1": (2, 4)}),
               max_inflight=max_inflight)
    try:
        assert len(rt.workers) == 2 and rt.realtime
        assert all(proc.poll() is None for proc in rt.workers.values())
        assert all(isinstance(e, RemoteStageEngine)
                   for e in rt.engines.values())
        reqs = submit_all(rt, prompts)
        rt.run_until_done()
        assert [r.output for r in reqs] == ref
        assert set(rt.pool_pages_used()) == {"n0", "n1"}
        assert_drained(rt)
        for i in range(len(prompts)):
            assert len(rt.served[i].stages) == 2
        assert "hops[star" in rt.transport.describe()
    finally:
        rt.shutdown()
    assert not rt.workers                # shutdown reaped every process


@pytest.mark.parametrize("max_inflight", [1, 2], ids=["depth1", "depth2"])
def test_multiprocess_direct_links_matches_reference(port_model, reference,
                                                     max_inflight):
    """Worker-to-worker forwarding: activations travel on peer links
    (counted per (src, dst) with their bytes), the coordinator sees only
    tokens, and the tokens stay the reference's."""
    prompts, ref = reference
    prompts, ref = prompts[:2], ref[:2]
    rt = spawn(port_model, port_plan(port_model[0], {
        "n0": (0, 2), "n1": (2, 3), "n2": (3, 4)}),
        max_inflight=max_inflight, direct_links=True)
    try:
        reqs = submit_all(rt, prompts)
        rt.run_until_done()
        assert [r.output for r in reqs] == ref
        assert_drained(rt)
        tr = rt.transport
        n_passes = sum(len(r) for r in ref)
        assert tr.transfers[("n0", "n1")] >= n_passes
        assert tr.transfers[("n1", "n2")] >= n_passes
        assert tr.bytes_sent[("n0", "n1")] > \
            tr.transfers[("n0", "n1")] * rt.profile.token_bytes
        assert ("n0", "coordinator") not in tr.transfers
        assert "hops[direct" in tr.describe()
    finally:
        rt.shutdown()


def test_multiprocess_dense_matches_reference(port_model, reference):
    """Dense stage engines in workers (single-shot prefill)."""
    prompts, ref = reference
    prompts, ref = prompts[:2], ref[:2]
    rt = spawn(port_model, port_plan(port_model[0], {"n0": (0, 3),
                                                     "n1": (3, 4)}),
               paged=False, max_inflight=2, direct_links=True)
    try:
        reqs = submit_all(rt, prompts)
        rt.run_until_done()
        assert [r.output for r in reqs] == ref
        assert rt.pool_pages_used() == {}
        assert_drained(rt)
    finally:
        rt.shutdown()


def test_multiprocess_disaggregated_survives_worker_kill(port_model,
                                                         reference):
    """One prefill replica and decode replicas over worker processes with
    direct links: the reference's tokens, also after SIGKILLing a decode
    worker mid-flight and adopting the replanned placement."""
    prompts, ref = reference
    prompts, ref = prompts[:2], ref[:2]
    p = port_disagg_plan(port_model[0], {"n0": (0, 4)},
                         {"n1": (0, 2), "n2": (2, 4), "n3": (0, 4)})
    rt = spawn(port_model, p, max_inflight=2, direct_links=True)
    try:
        assert rt.disaggregated
        reqs = submit_all(rt, prompts)
        step_until(rt, lambda: rt.jobs and any(r.output for r in reqs))
        rt.kill_worker("n1")
        rt.fail_node("n1")
        rt.apply_plan(replan_after_failure(p, "n1", REPLAN_OPT))
        rt.run_until_done()
        assert [r.output for r in reqs] == ref
        assert "n1" not in rt.engines and "n1" not in rt.workers
        handoff = [k for k in rt.transport.transfers if k[0] == "n0"
                   and k[1] != "coordinator"]
        assert handoff, dict(rt.transport.transfers)
        assert_drained(rt)
    finally:
        rt.shutdown()


def test_multiprocess_worker_kill_triggers_failover(port_model, reference):
    """SIGKILL a stage worker with decode passes in flight: the requests
    on it requeue, the replanned placement is adopted, and they re-prefill
    on the surviving workers and finish with the reference's tokens."""
    prompts, ref = reference
    prompts, ref = prompts[:2], ref[:2]
    p = port_plan(port_model[0], {"n0": (0, 2), "n1": (2, 4),
                                  "n2": (0, 4)})
    rt = spawn(port_model, p, max_inflight=2)
    try:
        reqs = submit_all(rt, prompts)
        step_until(rt, lambda: rt.jobs and any(r.output for r in reqs))
        rt.kill_worker("n1")
        rt.fail_node("n1")
        rt.apply_plan(replan_after_failure(p, "n1", REPLAN_OPT))
        rt.run_until_done()
        assert [r.output for r in reqs] == ref
        assert "n1" not in rt.engines and "n1" not in rt.workers
        assert_drained(rt)
    finally:
        rt.shutdown()


def test_node_added_by_a_replan_gets_a_worker(port_model, reference):
    """A plan that adds a node (what a scale-up applies) spawns its worker
    through the factory; requests then serve across old and new workers
    with the reference's tokens."""
    cfg, params = port_model
    prompts, ref = reference
    p = port_plan(cfg, {"n0": (0, 4)})
    rt = spawn(port_model, p)
    try:
        grown = port_plan(cfg, {"n0": (0, 4), "n1": (0, 2), "n2": (2, 4)})
        rt.call_soon(lambda: rt.apply_plan(grown))
        rt.step()
        assert sorted(rt.workers) == ["n0", "n1", "n2"]
        assert isinstance(rt.engines["n2"], RemoteStageEngine)
        reqs = submit_all(rt, prompts)
        rt.run_until_done()
        assert [r.output for r in reqs] == ref
        assert {len(rt.served[i].stages) for i in range(len(prompts))} \
            == {1, 2}
        assert_drained(rt)
    finally:
        rt.shutdown()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_workers_started_by_hand(port_model, reference):
    """``spawn_workers(connect=...)`` accepts workers that dial in
    themselves (``run_worker``, the module's entry point, here on threads
    of this process), serves the reference's tokens, and ``shutdown`` ends
    their frame loops."""
    prompts, ref = reference
    port = _free_port()
    errors = []

    def worker():
        for _ in range(600):
            try:
                run_worker("127.0.0.1", port, timeout_s=60.0, device="cpu")
                return
            except ConnectionRefusedError:
                time.sleep(0.05)    # the coordinator is not listening yet
            except BaseException as e:
                errors.append(e)
                return
        errors.append(RuntimeError("never connected"))

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(2)]
    for t in threads:
        t.start()
    rt = spawn(port_model, port_plan(port_model[0], {"n0": (0, 2),
                                                     "n1": (2, 4)}),
               connect=f"127.0.0.1:{port}", direct_links=True,
               max_inflight=2)
    try:
        assert rt.workers == {}
        reqs = submit_all(rt, prompts)
        rt.run_until_done()
        assert [r.output for r in reqs] == ref
        assert_drained(rt)
    finally:
        rt.shutdown()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and not errors, errors


def test_front_door_over_workers(port_model, reference):
    """The front door streams from worker processes with the reference's
    tokens; ``/healthz`` reads the remote pools."""
    prompts, ref = reference
    rt = spawn(port_model, port_plan(port_model[0], {"n0": (0, 2),
                                                     "n1": (2, 4)}),
               max_inflight=2, direct_links=True)
    fe = Frontend(rt)
    host, port = fe.serve("127.0.0.1", 0)
    try:
        req = urllib.request.Request(
            f"http://{host}:{port}/v1/completions",
            data=json.dumps({"prompt": [int(t) for t in prompts[0]],
                             "max_tokens": 6, "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        toks = []
        with urllib.request.urlopen(req, timeout=60) as resp:
            for raw in resp:
                line = raw.strip()
                if line == b"data: [DONE]":
                    break
                if line.startswith(b"data: "):
                    c = json.loads(line[6:])["choices"][0]
                    if c.get("token_id") is not None:
                        toks.append(c["token_id"])
        assert toks == ref[0]
        deadline = time.monotonic() + 30
        while rt.pending() and time.monotonic() < deadline:
            time.sleep(0.02)
        with urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                    timeout=60) as r:
            h = json.load(r)
        assert h["pool_pages_used"] == {"n0": 0, "n1": 0}
        assert h["completed"] == 1
    finally:
        fe.shutdown(drain=True, timeout_s=60)
        rt.shutdown()
    assert fe.loop_error is None


def test_cuda_worker_without_a_card_raises(port_model, monkeypatch):
    """A worker, or ``spawn_workers`` at its default device, asked for
    CUDA on a host without it raises before it dials or launches
    anything: no fallback to the CPU."""
    cfg, params = port_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_worker("127.0.0.1", 9, timeout_s=1.0, device="cuda")
    p = port_plan(cfg, {"n0": (0, 4)})
    with pytest.raises(RuntimeError, match="cuda"):
        ClusterRuntime.spawn_workers(cfg, params, p, EC)
