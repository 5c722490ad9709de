"""The port's autoscaler against the JAX package's (f32, CPU).

The reference's ``Autoscaler`` over the reference's ``ClusterRuntime`` and
the port's over the port's are built alike and ticked in lockstep (the
cases of ``tests/test_autoscaler.py``): a sustained load step scales up
through the mix planner with the incumbents' ranges kept, sustained
underload drains and retires the priciest redundant node, and measured
straggler telemetry reweights IWRR in place.  Equal on both sides: each
tick's action, the events (``t``, ``kind``, ``detail``), the grown or
shrunk node names and ``cost_per_hour``, the placement's assignment and
flows, and the greedy tokens of the requests served through it all.
"""
import dataclasses

import pytest

import repro.core as jcore
import repro.core.mix_planner as jmp
from repro.core.cluster import DEVICE_PROFILES as J_DEVICE_PROFILES
from repro.serving import Autoscaler as JAutoscaler
from repro.serving import ClusterRuntime as JClusterRuntime
from repro.serving import InProcessTransport as JTransport
from repro.serving import Request as JRequest
import repro_torch.core as core
import repro_torch.core.mix_planner as mp
from repro_torch.core.cluster import COORDINATOR, DEVICE_PROFILES
from repro_torch.serving.autoscaler import Autoscaler
from repro_torch.serving.engine import Request
from repro_torch.serving.runtime import ClusterRuntime, InProcessTransport

from harness import (EC as JEC, make_cluster as j_make_cluster,
                     make_plan as jmake_plan, small_model as j_small_model)
from test_torch_runtime import EC, port_model, port_plan  # noqa: F401


class Side:
    """The runtime, autoscaler and request class of one package."""

    def __init__(self, port, cfg, params, layout, sc_kw, rt_kw):
        self.port = port
        p = (port_plan if port else jmake_plan)(cfg, layout)
        kw = dict(rt_kw, device="cpu") if port else dict(rt_kw)
        if "delay" in kw:
            kw["transport"] = (InProcessTransport if port else JTransport)(
                default_delay_s=kw.pop("delay"))
        self.plan = p
        self.rt = (ClusterRuntime if port else JClusterRuntime)(
            cfg, params, p, EC if port else JEC, paged=True, **kw)
        sc_kw = dict(sc_kw)
        if "rate" in sc_kw:
            sc_kw["catalog"] = {"A100": capped_a100(port, sc_kw.pop("rate"))}
        self.load = {"t": None}
        mod = mp if port else jmp
        self.traffic = lambda rate: mod.TrafficProfile(
            rate_rps=rate, buckets=[mod.Bucket(EC.prompt_len, 6)],
            weights=[1.0])
        self.sc = (Autoscaler if port else JAutoscaler)(
            self.rt, p, traffic_fn=lambda: self.load["t"], **sc_kw)
        self.reqs = []

    def set_rate(self, rate):
        self.load["t"] = self.traffic(rate)

    def submit(self, prompts, base=0):
        reqs = [(Request if self.port else JRequest)(
            base + i, pr, max_new_tokens=6) for i, pr in enumerate(prompts)]
        for r in reqs:
            self.rt.submit(r)
        self.reqs += reqs
        return reqs


def capped_a100(port, rate):
    """An A100 whose profiled token rate is capped at ``rate`` (the
    reference test's ``_capped_a100``)."""
    profiles = DEVICE_PROFILES if port else J_DEVICE_PROFILES
    return dataclasses.replace(profiles["A100"], max_tokens_per_s=rate)


def pair(gqa_model, port_model, layout, sc_kw, **rt_kw):
    """(port side, reference side), built alike."""
    return (Side(True, *port_model, layout, sc_kw, rt_kw),
            Side(False, *gqa_model, layout, sc_kw, rt_kw))


def events(sc):
    return [(e.t, e.kind, e.detail) for e in sc.events]


def placement(plan):
    return {n: (r.start, r.end) for n, r in plan.placement.assignment.items()}


def tick(sides):
    """One tick on each side: the same action, the same events."""
    acts = [s.sc.tick() for s in sides]
    assert acts[0] == acts[1]
    assert events(sides[0].sc) == events(sides[1].sc)
    return acts[0]


def assert_same_fleet(sides):
    """Nodes, $/hr, placement, flows and ``describe()`` equal."""
    a, b = sides
    assert sorted(a.rt.cluster.nodes) == sorted(b.rt.cluster.nodes)
    assert sorted(a.rt.engines) == sorted(b.rt.engines)
    assert a.rt.cluster.cost_per_hour() == b.rt.cluster.cost_per_hour()
    assert placement(a.sc.plan) == placement(b.sc.plan)
    assert {n: (r.start, r.end) for n, r in
            a.rt.placement.assignment.items()} == \
        {n: (r.start, r.end) for n, r in b.rt.placement.assignment.items()}
    assert a.sc.plan.flows == b.sc.plan.flows
    assert a.sc.plan.throughput == b.sc.plan.throughput
    assert a.sc.describe() == b.sc.describe()


def drained(rt):
    return all(u == 0 for u in rt.pool_pages_used().values())


def serve_both(sides, prompts, ref, base=0):
    """Submit ``prompts`` on both sides, run to the end: tokens equal to
    the reference engine's, pools drained."""
    got = []
    for s in sides:
        reqs = s.submit(prompts, base)
        s.rt.run_until_done()
        assert [r.output for r in reqs] == ref
        assert drained(s.rt)
        got.append(reqs)
    return got


@pytest.mark.parametrize("factor", [0.2, 0.5, 1e-3])
def test_reweight_matches_reference(factor):
    """``reweight_for_straggler`` on two full replicas of an 8-layer toy
    model: the same flows and throughput as the reference's, flow shifted
    off the victim, placement unchanged; an unknown node raises
    ``KeyError`` on both sides."""
    jmodel = j_small_model(8)
    model = core.ModelProfile.from_dims(
        "toy", num_layers=8, d_model=4096, d_ff=11008, vocab=32000,
        n_kv_heads=32, head_dim=128)
    both = {n: (0, 8) for n in ("n0", "n1")}
    p = core.plan(core.full_mesh_cluster(2, bandwidth=10e9 / 8,
                                         latency_s=1e-3), model,
                  placement=core.Placement(
                      {n: core.LayerRange(*r) for n, r in both.items()}, 8))
    jp = jcore.plan(j_make_cluster(2), jmodel, placement=jcore.Placement(
        {n: jcore.LayerRange(*r) for n, r in both.items()}, 8))
    q = core.reweight_for_straggler(p, "n1", factor)
    jq = jcore.reweight_for_straggler(jp, "n1", factor)
    assert q.flows == jq.flows and q.throughput == jq.throughput
    assert placement(q) == placement(p)
    assert q.flows.get((COORDINATOR, "n1"), 0.0) < \
        p.flows.get((COORDINATOR, "n1"), 0.0)
    for fn, pl in ((core.reweight_for_straggler, p),
                   (jcore.reweight_for_straggler, jp)):
        with pytest.raises(KeyError):
            fn(pl, "nope", factor)


def test_straggler_reweight_applies_in_place(gqa_model, port_model,
                                             reference):
    """Fabricated telemetry shows n2 ten times slower than the fleet: the
    reweight lands between steps with the same engine objects, tokens are
    the reference's, and telemetry back to fleet speed restores n2."""
    prompts, ref = reference
    sides = pair(gqa_model, port_model,
                 {"n0": (0, 4), "n1": (0, 4), "n2": (0, 4)},
                 dict(patience=1, min_decode_tokens=1))
    before = []
    for s in sides:
        s.rt.node_decode_s.update({"n0": 1.0, "n1": 1.0, "n2": 10.0})
        s.rt.node_decode_tokens.update({"n0": 100, "n1": 100, "n2": 100})
        before.append(dict(s.rt.engines))
    assert tick(sides) is None
    for s, engines in zip(sides, before):
        assert s.sc._reweighted.get("n2") == pytest.approx(0.1)
        assert placement(s.sc.plan) == placement(s.plan)
        s.rt.step()                  # the queued apply_plan lands here
        assert dict(s.rt.engines) == engines
        assert all(s.rt.engines[n] is e for n, e in engines.items())
    assert sides[0].sc._reweighted == sides[1].sc._reweighted
    assert_same_fleet(sides)
    assert [e.kind for e in sides[0].sc.events] == ["straggler"]
    serve_both(sides, prompts, ref)
    for s in sides:
        s.rt.node_decode_s.update({"n0": 2.0, "n1": 2.0, "n2": 11.0})
        s.rt.node_decode_tokens.update({"n0": 200, "n1": 200, "n2": 200})
    assert tick(sides) is None
    assert "n2" not in sides[0].sc._reweighted
    assert "recovered" in sides[0].sc.events[-1].detail
    assert_same_fleet(sides)


def test_scale_up_under_load_step(gqa_model, port_model, reference):
    """Baseline traffic fits the 2-node fleet, a sustained 60 rps step does
    not: after ``patience`` hot ticks the mix is solved and the grown plan
    lands between steps, the incumbents' ranges kept and flow on the new
    nodes; requests in flight and a second batch through the grown fleet
    keep the reference's tokens and routes, and the real decode telemetry
    counts the same tokens per node."""
    prompts, ref = reference
    sides = pair(gqa_model, port_model, {"n0": (0, 2), "n1": (2, 4)},
                 dict(rate=400.0, patience=2, headroom=1.2),
                 max_inflight=2, delay=1e-3)
    for s in sides:
        s.set_rate(25.0)
    assert tick(sides) is None and tick(sides) is None
    assert not sides[0].sc.events
    for s in sides:
        s.submit(prompts)
        for _ in range(6):
            s.rt.step()
        assert s.rt.jobs, "nothing in flight before the load step"
        s.set_rate(60.0)
    assert tick(sides) is None
    assert tick(sides) == "scale_up"
    for s in sides:
        s.rt.step()
    assert_same_fleet(sides)
    rt = sides[0].rt
    new = set(rt.engines) - {"n0", "n1"}
    assert new and all(n.startswith("a100-as") for n in new)
    for n in ("n0", "n1"):
        assert rt.placement.assignment[n] == sides[0].plan.placement \
            .assignment[n]
    assert rt.cluster.cost_per_hour() > sides[0].plan.cluster.cost_per_hour()
    for s in sides:
        s.rt.run_until_done()
        assert [r.output for r in s.reqs] == ref and drained(s.rt)
    served = serve_both(sides, prompts, ref, base=100)
    assert [[st.node for st in sides[0].rt.served[r.request_id].stages]
            for r in served[0]] == \
        [[st.node for st in sides[1].rt.served[r.request_id].stages]
         for r in served[1]]
    assert all(sides[0].sc.plan.flows[(COORDINATOR, n)] > 0 for n in new
               if rt.placement.assignment[n].start == 0)
    assert sorted(rt.node_decode_tokens) == \
        sorted(sides[1].rt.node_decode_tokens)
    assert dict(rt.node_decode_tokens) == \
        dict(sides[1].rt.node_decode_tokens)
    assert all(v > 0 for v in rt.node_decode_s.values())


def test_scale_up_respects_max_nodes(gqa_model, port_model):
    sides = pair(gqa_model, port_model, {"n0": (0, 2), "n1": (2, 4)},
                 dict(rate=400.0, patience=1, max_nodes=2))
    for s in sides:
        s.set_rate(60.0)
    assert tick(sides) is None
    assert [e.kind for e in sides[0].sc.events] == ["error"]
    assert "max_nodes" in sides[0].sc.events[0].detail
    assert set(sides[0].rt.cluster.nodes) - {COORDINATOR} == {"n0", "n1"}
    assert_same_fleet(sides)


def test_drain_then_retire_redundant_node(gqa_model, port_model,
                                          reference):
    """Three full replicas at 2 rps: one is drained (flow shifted away,
    placement kept), then retired once the loop-thread probe finds it
    empty; the survivors serve the reference's tokens at a lower $/hr."""
    prompts, ref = reference
    sides = pair(gqa_model, port_model,
                 {"n0": (0, 4), "n1": (0, 4), "n2": (0, 4)},
                 dict(rate=400.0, patience=1))
    cost = sides[0].rt.cluster.cost_per_hour()
    for s in sides:
        s.set_rate(2.0)
    assert tick(sides) == "drain"
    victim = sides[0].sc.describe()["draining"]
    assert victim is not None
    for s in sides:
        s.rt.step()
    assert tick(sides) == "retire"
    for s in sides:
        s.rt.step()
        assert victim not in s.rt.engines
        assert victim not in s.rt.cluster.nodes
    assert_same_fleet(sides)
    assert sides[0].rt.cluster.cost_per_hour() < cost
    assert [e.kind for e in sides[0].sc.events] == ["drain", "retire"]
    serve_both(sides, prompts, ref)


def test_no_signal_means_no_action(gqa_model, port_model):
    sides = pair(gqa_model, port_model, {"n0": (0, 4)}, dict(patience=1))
    for _ in range(3):
        assert tick(sides) is None
    assert not sides[0].sc.events
    assert set(sides[0].rt.cluster.nodes) - {COORDINATOR} == {"n0"}
    assert_same_fleet(sides)
