"""The port's ingest FIFO, listeners and cancellation against the JAX
package (f32, CPU).

``ClusterRuntime.cancel`` must tear a request down at any point of its
life — still queued, mid-decode at depth 2 over three stages, with verify
windows in flight, during a disaggregated KV handoff — releasing its slots
on every node and at the draft, while the other requests keep the
reference's tokens.  Each case drives the reference's ``ClusterRuntime``
and the port's through the same scenario (same plan, links, requests,
steps and cancels) and holds them equal: tokens and finish reasons, the
counters, the transport's per-link ledger, the virtual-clock decode
latencies, the listeners' call sequence, and drained pools and draft
slots.
"""
import threading

from repro.serving import ClusterRuntime as JClusterRuntime
from repro.serving import InProcessTransport as JTransport
from repro.serving import Request as JRequest
from repro_torch.serving.engine import Request
from repro_torch.serving.runtime import ClusterRuntime, InProcessTransport

from harness import (EC as JEC, make_disagg_plan as jmake_disagg_plan,
                     make_plan as jmake_plan)
from test_torch_disagg import ONE_PREFILL, port_disagg_plan
from test_torch_runtime import EC, port_model, port_plan  # noqa: F401

TWO = {"n0": (0, 2), "n1": (2, 4)}
THREE = {"n0": (0, 2), "n1": (2, 3), "n2": (3, 4)}
COUNTERS = ("cancelled_requests", "cancelled_inflight", "completed",
            "tokens_produced", "spec_proposed", "spec_accepted",
            "spec_rejected", "spec_rounds", "spec_confirmed")


class Side:
    """One side of a parity run: the reference's runtime or the port's,
    and the listener log its scenario writes."""

    def __init__(self, rt, request_cls):
        self.rt = rt
        self.Request = request_cls
        self.log = []
        self.reqs = []

    def submit(self, rid, prompt, max_new_tokens=6):
        r = self.Request(rid, prompt, max_new_tokens=max_new_tokens)
        self.rt.submit(
            r, on_token=lambda t, i=rid: self.log.append((i, "token", t)),
            on_done=lambda rr: self.log.append(
                (rr.request_id, "done", rr.finish_reason)))
        self.reqs.append(r)
        return r

    def step_until(self, pred, max_steps=2000):
        """Step until ``pred(rt)``; the step count goes into the log."""
        for n in range(max_steps):
            if pred(self.rt):
                self.log.append(("steps", n))
                return
            self.rt.step()
        raise AssertionError(f"predicate never held in {max_steps} steps")


def both(gqa_model, port_model, layout, scenario, *, disagg=False,
         delay=0.0, draft=False, **kw):
    """Run ``scenario(side)`` on the port's runtime and on the
    reference's, built alike; returns (port side, reference side)."""
    out = []
    for port in (True, False):
        cfg, params = port_model if port else gqa_model
        if disagg:
            p = (port_disagg_plan if port else jmake_disagg_plan)(
                cfg, *layout)
        else:
            p = (port_plan if port else jmake_plan)(cfg, layout)
        extra = dict(kw, device="cpu") if port else dict(kw)
        if draft:
            extra.update(draft_cfg=cfg, draft_params=params, spec_tokens=3)
        transport = (InProcessTransport if port else JTransport)(
            default_delay_s=delay)
        rt = (ClusterRuntime if port else JClusterRuntime)(
            cfg, params, p, EC if port else JEC, paged=True,
            transport=transport, **extra)
        side = Side(rt, Request if port else JRequest)
        scenario(side)
        out.append(side)
    return out


def drained(rt):
    used = rt.pool_pages_used()
    return (bool(used) and all(u == 0 for u in used.values()) and
            (rt.draft is None or rt.draft.free_slots == EC.max_batch))


def assert_same(side, jside):
    """The port's run equals the reference's, and its listeners saw each
    request's confirmed tokens in order and one ``on_done``."""
    rt, jrt = side.rt, jside.rt
    assert [r.output for r in side.reqs] == [r.output for r in jside.reqs]
    assert [r.finish_reason for r in side.reqs] == \
        [r.finish_reason for r in jside.reqs]
    for name in COUNTERS:
        assert getattr(rt, name) == getattr(jrt, name), name
    assert dict(rt.transport.transfers) == dict(jrt.transport.transfers)
    assert dict(rt.transport.bytes_sent) == dict(jrt.transport.bytes_sent)
    assert rt.decode_latencies == jrt.decode_latencies
    assert side.log == jside.log
    for r in side.reqs:
        rid = r.request_id
        assert [e[2] for e in side.log if e[:2] == (rid, "token")] == \
            r.output
        assert [e for e in side.log if e[:2] == (rid, "done")] == \
            [(rid, "done", r.finish_reason)]
    assert drained(rt) and drained(jrt)
    assert rt.pending() == jrt.pending() == 0


def test_cancel_queued_request_before_prefill(gqa_model, port_model,
                                              reference):
    """A cancel behind its submit in the FIFO: the request ends as
    "cancelled" with no token and no work done."""
    prompts, ref = reference

    def scenario(s):
        for i, p in enumerate(prompts):
            s.submit(i, p)
        s.rt.cancel(1)
        s.rt.run_until_done()

    side, jside = both(gqa_model, port_model, TWO, scenario)
    assert_same(side, jside)
    r = side.reqs[1]
    assert r.done and r.finish_reason == "cancelled" and r.output == []
    assert [x.output for i, x in enumerate(side.reqs) if i != 1] == \
        [o for i, o in enumerate(ref) if i != 1]
    assert side.rt.cancelled_requests == 1


def test_cancel_mid_decode_depth2_three_stages(gqa_model, port_model,
                                               reference):
    """Request 0 cancelled with a pass in flight on a 3-stage pipeline at
    depth 2: its confirmed prefix is the greedy prefix, the others keep
    their tokens, and the same runtime then serves a new request."""
    prompts, ref = reference

    def scenario(s):
        for i, p in enumerate(prompts):
            s.submit(i, p)
        s.step_until(lambda rt: 0 in rt.jobs and len(s.reqs[0].output) >= 1
                     and rt.jobs[0].inflight > 0)
        s.rt.cancel(0)
        s.rt.run_until_done()
        s.submit(99, prompts[0])
        s.rt.run_until_done()

    side, jside = both(gqa_model, port_model, THREE, scenario,
                       max_inflight=2, delay=1e-3)
    assert_same(side, jside)
    r0 = side.reqs[0]
    assert r0.finish_reason == "cancelled" and len(r0.output) < len(ref[0])
    assert r0.output == ref[0][:len(r0.output)]
    assert [r.output for r in side.reqs[1:4]] == ref[1:]
    assert side.reqs[4].output == ref[0]
    assert side.rt.cancelled_inflight > 0


def test_cancel_with_spec_windows_inflight(gqa_model, port_model,
                                           reference):
    """A cancel while a verify round is in flight (a perfect draft, γ = 3):
    the draft's slot is freed with the nodes' pages."""
    prompts, ref = reference

    def scenario(s):
        for i, p in enumerate(prompts):
            s.submit(i, p)
        s.step_until(lambda rt: 0 in rt.jobs and rt.jobs[0].inflight > 0)
        s.rt.cancel(0)
        s.rt.run_until_done()

    side, jside = both(gqa_model, port_model, TWO, scenario, draft=True,
                       max_inflight=2, delay=1e-3)
    assert_same(side, jside)
    assert side.reqs[0].finish_reason == "cancelled"
    assert [r.output for r in side.reqs[1:]] == ref[1:]
    assert side.rt.spec_rounds > 0


def test_cancel_during_disagg_kv_handoff(gqa_model, port_model, reference):
    """A cancel while the prefill node still ships KV to the decode
    replica (``kv_pending`` non-empty): the handoff dies on delivery and
    pages are freed on both replicas."""
    prompts, ref = reference
    victims = []

    def scenario(s):
        for i, p in enumerate(prompts):
            s.submit(i, p)
        s.step_until(lambda rt: any(j.kv_pending for j in rt.jobs.values()))
        victim = next(j for j in s.rt.jobs.values() if j.kv_pending)
        victims.append(victim.req.request_id)
        s.rt.cancel(victim.req.request_id)
        s.rt.run_until_done()

    side, jside = both(gqa_model, port_model, ONE_PREFILL, scenario,
                       disagg=True, max_inflight=2, delay=2e-3)
    assert_same(side, jside)
    vid = victims[0]
    assert victims == [vid, vid]
    assert side.reqs[vid].finish_reason == "cancelled"
    assert [r.output for r in side.reqs if r.request_id != vid] == \
        [o for i, o in enumerate(ref) if i != vid]
    assert side.rt.disaggregated


def test_cancel_unknown_or_finished_is_noop(gqa_model, port_model,
                                            reference):
    """Cancelling a finished id or one never seen changes nothing."""
    prompts, ref = reference

    def scenario(s):
        for i, p in enumerate(prompts[:2]):
            s.submit(i, p)
        s.rt.run_until_done()
        s.rt.cancel(0)
        s.rt.cancel(424242)
        s.rt.step()

    side, jside = both(gqa_model, port_model, TWO, scenario)
    assert_same(side, jside)
    assert [r.output for r in side.reqs] == ref[:2]
    assert side.rt.cancelled_requests == 0
    assert [r.finish_reason for r in side.reqs] == ["length", "length"]


def test_cancel_from_other_thread_while_serving(gqa_model, port_model,
                                                reference):
    """``cancel`` from another thread lands through the FIFO."""
    prompts, ref = reference

    def scenario(s):
        for i, p in enumerate(prompts):
            s.submit(i, p)
        s.step_until(lambda rt: 0 in rt.jobs and len(s.reqs[0].output) >= 1)
        th = threading.Thread(target=s.rt.cancel, args=(0,))
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
        s.rt.run_until_done()

    side, jside = both(gqa_model, port_model, TWO, scenario,
                       max_inflight=2, delay=1e-3)
    assert_same(side, jside)
    assert side.reqs[0].finish_reason == "cancelled"
    assert [r.output for r in side.reqs[1:]] == ref[1:]


def test_pending_matches_reference_after_each_step(gqa_model, port_model,
                                                   reference):
    """``pending()`` — ingest, admission queue and live jobs — right after
    the submits and after every step, with one request cancelled while
    queued and one mid-decode; submits land in the ingest FIFO, not in
    the admission deque."""
    prompts, _ = reference

    def scenario(s):
        for i, p in enumerate(prompts):
            s.submit(i, p)
        s.log.append(("queue", len(s.rt.queue)))
        s.log.append(("pending", s.rt.pending()))
        s.rt.cancel(3)
        cancelled = False
        for _ in range(2000):
            if s.rt._idle():
                break
            s.log.append(("step", s.rt.step()))
            s.log.append(("pending", s.rt.pending()))
            if len(s.reqs[0].output) == 2 and not cancelled:
                s.rt.cancel(0)
                cancelled = True

    side, jside = both(gqa_model, port_model, TWO, scenario,
                       max_inflight=2, delay=1e-3)
    assert_same(side, jside)
    pend = [e[1] for e in side.log if e[0] == "pending"]
    assert ("queue", 0) in side.log and pend[0] == 4
    assert pend[-1] == 0 and len(pend) > 5
    assert side.rt.cancelled_requests == 2
