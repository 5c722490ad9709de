"""The port's runtime telemetry and link model against the JAX package (f32,
CPU).

The port's ``InProcessTransport`` (per-link delay, bandwidth, the
``delay()`` hook, direct links or the coordinator star) and the runtime's
virtual-clock counters (``tokens_produced``, ``completed``,
``cancelled_inflight``, ``mean_decode_latency``) must give the reference's
values: the latencies and hop counts its own tests pin (``tests/
test_runtime.py``), and on the early-eos case every counter, latency and
link ledger of the reference's runtime run beside the port's.  Greedy
tokens stay equal to the reference's throughout.
"""
import dataclasses

import pytest

from repro.serving import EngineConfig as JEngineConfig
from repro.serving import InProcessTransport as JTransport
from repro_torch.core.cluster import COORDINATOR
from repro_torch.serving.engine import Request
from repro_torch.serving.runtime import ClusterRuntime, InProcessTransport

from harness import make_plan as jmake_plan, random_prompts, serve_on_cluster
from test_torch_runtime import EC, port_model, port_plan  # noqa: F401

THREE = {"n0": (0, 2), "n1": (2, 3), "n2": (3, 4)}


def serve(cfg, params, assignment, prompts, *, ec=EC, **kw):
    rt = ClusterRuntime(cfg, params, port_plan(cfg, assignment), ec,
                        device="cpu", **kw)
    reqs = [Request(i, pr, max_new_tokens=6) for i, pr in enumerate(prompts)]
    for r in reqs:
        rt.submit(r)
    rt.run_until_done()
    assert all(r.done for r in reqs)
    assert all(u == 0 for u in rt.pool_pages_used().values())
    assert rt.completed == len(reqs)
    assert rt.tokens_produced == sum(len(r.output) for r in reqs)
    return rt, reqs


def test_inflight_depth2_reduces_decode_latency(port_model, reference):
    """3 stages, link delay d: depth 1 pays final->coordinator->stage 0
    plus two hops (4d a token), depth 2 launches pass t+1 from the final
    stage (3d)."""
    cfg, params = port_model
    prompts, ref = reference
    d = 2e-3
    lat = {}
    for depth in (1, 2):
        rt, reqs = serve(cfg, params, THREE, prompts, max_inflight=depth,
                         transport=InProcessTransport(default_delay_s=d))
        assert [r.output for r in reqs] == ref
        lat[depth] = rt.mean_decode_latency()
        assert len(rt.decode_latencies) == len(prompts)
    assert lat[1] == pytest.approx(4 * d)
    assert lat[2] == pytest.approx(3 * d)


def test_direct_links_reduce_decode_hops(port_model, reference):
    """k = 3 stages, delay d: the star charges 2k = 6 hops a token (every
    stage output through the coordinator) and 6d of latency, direct links
    k + 1 = 4 hops and 4d; the per-link ledger and ``describe()`` follow
    the physical route."""
    cfg, params = port_model
    prompts, ref = reference
    d = 2e-3
    hops, lat = {}, {}
    for direct in (False, True):
        tr = InProcessTransport(default_delay_s=d, direct_links=direct)
        rt, reqs = serve(cfg, params, THREE, prompts, transport=tr)
        assert [r.output for r in reqs] == ref
        hops[direct] = sum(tr.transfers.values()) / sum(map(len, ref))
        lat[direct] = rt.mean_decode_latency()
        peer = {k: v for k, v in tr.transfers.items()
                if COORDINATOR not in k}
        if direct:
            assert peer.get(("n0", "n1")) and peer.get(("n1", "n2")), peer
        else:
            assert not peer, f"star mode used peer links: {peer}"
        assert tr.describe().startswith(
            "hops[direct: " if direct else "hops[star: ")
    assert hops[False] == pytest.approx(6.0)
    assert hops[True] == pytest.approx(4.0)
    assert lat[False] == pytest.approx(6 * d)
    assert lat[True] == pytest.approx(4 * d)


def test_link_delay_and_bandwidth_match_reference(gqa_model, port_model):
    """Per-link latency overrides and bytes over the bandwidth set each
    send's delay.  With no base latency a smaller prompt chunk overtakes
    its predecessor on the n0 -> n1 link, and must wait for it: tokens
    equal the delay-free run's, and the hop and byte ledgers and virtual-
    clock latencies equal the reference's runtime on the same links."""
    jcfg, jparams = gqa_model
    cfg, params = port_model
    prompts = random_prompts(jcfg, (20, 40, 7), seed=3)

    def links(cls):
        return cls(link_delay_s={("n1", COORDINATOR): 2e-3},
                   bandwidth_bytes_per_s=1e6)
    tr = links(InProcessTransport)
    assert tr.delay("n1", COORDINATOR, 2000) == pytest.approx(4e-3)
    assert tr.delay("n0", "n1", 0) == 0.0
    two = {"n0": (0, 2), "n1": (2, 4)}
    _, free = serve(cfg, params, two, prompts)
    rt, reqs = serve(cfg, params, two, prompts, transport=tr)
    assert [r.output for r in reqs] == [r.output for r in free]
    jrt, jreqs = serve_on_cluster(jcfg, jparams, jmake_plan(jcfg, two),
                                  prompts, paged=True,
                                  transport=links(JTransport))
    assert [r.output for r in jreqs] == [r.output for r in reqs]
    assert dict(tr.transfers) == dict(jrt.transport.transfers)
    assert dict(tr.bytes_sent) == dict(jrt.transport.bytes_sent)
    assert rt.decode_latencies == jrt.decode_latencies
    assert rt.mean_decode_latency() > 0


def test_eos_mid_window_cancels_inflight_cleanly(gqa_model, port_model,
                                                 reference):
    """eos confirmed while the pass for token t+1 is mid-pipeline (depth 3,
    delay): the pass is cancelled (``cancelled_inflight > 0``), no page
    leaks, outputs are the reference's cut at eos, and the same runtime
    then serves a fresh request correctly.  The reference's runtime on the
    same case gives equal counters, latencies and link ledger."""
    jcfg, jparams = gqa_model
    cfg, params = port_model
    prompts, ref = reference
    eos = ref[0][2]
    ec = dataclasses.replace(EC, eos_token=eos)

    def cut(out):
        return out[:out.index(eos) + 1] if eos in out else out

    rt, reqs = serve(cfg, params, THREE, prompts, ec=ec, max_inflight=3,
                     transport=InProcessTransport(default_delay_s=1e-3))
    assert [r.output for r in reqs] == [cut(o) for o in ref]
    assert reqs[0].finish_reason == "stop"
    assert rt.cancelled_inflight > 0
    jrt, jreqs = serve_on_cluster(
        jcfg, jparams, jmake_plan(jcfg, THREE), prompts, paged=True,
        max_inflight=3, ec=JEngineConfig(**dataclasses.asdict(ec)),
        transport=JTransport(default_delay_s=1e-3))
    assert [r.output for r in jreqs] == [r.output for r in reqs]
    for name in ("cancelled_inflight", "tokens_produced", "completed"):
        assert getattr(rt, name) == getattr(jrt, name), name
    assert rt.decode_latencies == jrt.decode_latencies
    assert rt.mean_decode_latency() == jrt.mean_decode_latency()
    assert dict(rt.transport.transfers) == dict(jrt.transport.transfers)
    extra = Request(99, prompts[1], max_new_tokens=6)
    rt.submit(extra)
    rt.run_until_done()
    assert extra.output == cut(ref[1])
    assert all(u == 0 for u in rt.pool_pages_used().values())


class _ReorderingTransport(InProcessTransport):
    """The first delivery to the coordinator from each node is slower than
    later ones, so a pipelined pass's token (output index 1) overtakes the
    prefill's token (index 0) on the way back."""

    def __init__(self):
        super().__init__(default_delay_s=1e-3)
        self._slowed = set()

    def delay(self, src, dst, nbytes):
        d = super().delay(src, dst, nbytes)
        if dst == COORDINATOR and src not in self._slowed:
            self._slowed.add(src)
            return d + 5e-3
        return d


def test_out_of_order_token_arrival_confirms_in_order(port_model, reference):
    """Decode tokens that reach the coordinator before the prefill token
    wait in the inbox and confirm in output order once it lands."""
    cfg, params = port_model
    prompts, ref = reference
    tr = _ReorderingTransport()
    rt, reqs = serve(cfg, params, {"n0": (0, 2), "n1": (2, 4)}, prompts,
                     paged=False, max_inflight=2, transport=tr)
    assert [r.output for r in reqs] == ref
    assert tr._slowed == {"n1"}
