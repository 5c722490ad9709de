"""The port's copy of the GPU-mix planner and of the event simulator
against the JAX package's (CPU, pure Python on both sides).

``repro_torch.core.mix_planner`` and ``repro_torch.sim`` are copies of
``repro.core.mix_planner`` and ``repro.sim``: on the inputs of
``tests/test_mix_planner.py`` the throughput tables, bucketed traffic,
feasibility answers and greedy mixes must be equal to the reference's,
the CP-SAT gate must give way without ``ortools``, and the simulator must
give the same ``Metrics``, field by field, on one seeded trace with a
cancel.
"""
import dataclasses
import sys

import pytest

import repro.core.mix_planner as jmp
from repro.core import (LLAMA_70B as J_LLAMA_70B, LayerRange as JLayerRange,
                        Placement as JPlacement, plan as jplan)
from repro.core.cluster import full_mesh_cluster as j_full_mesh
from repro.sim import Simulator as JSimulator
from repro.sim.traces import TraceRequest as JTraceRequest
from repro.sim.traces import make_trace as j_make_trace
import repro_torch.core.mix_planner as mp
from repro_torch.core import LLAMA_70B, MILPOptions, ModelProfile, plan
from repro_torch.core.cluster import full_mesh_cluster
from repro_torch.sim import Simulator
from repro_torch.sim.traces import TraceRequest, make_trace

from harness import small_model as j_small_model

DEVS = ("A100", "V100", "L4", "T4")
# (rate, [(input, output)], weights): the Mélange shape of
# tests/test_mix_planner.py, its one-bucket simulator load, and a
# three-bucket mix
TRAFFICS = {
    "melange": (20.0, [(64, 64), (1800, 128)], [0.9, 0.1]),
    "short": (8.0, [(64, 64)], [1.0]),
    "three": (5.0, [(32, 16), (512, 256), (1024, 64)], [0.5, 0.3, 0.2]),
}
SLOS = {"std": (2.0, 0.05), "harsh": (0.2, 0.05), "none": (None, None)}


def traffic(mod, key, scale=1.0):
    rate, buckets, weights = TRAFFICS[key]
    return mod.TrafficProfile(rate_rps=rate * scale,
                              buckets=[mod.Bucket(*b) for b in buckets],
                              weights=list(weights))


def slo(mod, key):
    return mod.SLO(*SLOS[key])


def same(a, b):
    """Two dataclass values of the two packages hold the same fields."""
    return dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("skey", list(SLOS))
@pytest.mark.parametrize("tkey", list(TRAFFICS))
def test_throughput_table_matches_reference(tkey, skey):
    t, jt = traffic(mp, tkey), traffic(jmp, tkey)
    table = mp.ThroughputTable.profile(LLAMA_70B, t.buckets, DEVS,
                                       slo=slo(mp, skey))
    jtable = jmp.ThroughputTable.profile(J_LLAMA_70B, jt.buckets, DEVS,
                                         slo=slo(jmp, skey))
    assert same(table, jtable)
    assert table.feasible_pairs() == jtable.feasible_pairs()
    assert t.demand_tokens() == jt.demand_tokens()


def test_from_requests_matches_reference():
    """Observed length pairs bucketed as the reference buckets them: the
    pairs of tests/test_mix_planner.py and a spread of lengths."""
    for pairs, rate in (
            ([(60, 60)] * 45 + [(70, 70)] * 45 + [(1800, 128)] * 10, 5.0),
            ([(3 + 37 * i % 2000, 1 + 13 * i % 700) for i in range(300)],
             2.5), ([(10, 6)], 0.1)):
        assert same(mp.TrafficProfile.from_requests(pairs, rate),
                    jmp.TrafficProfile.from_requests(pairs, rate))


@pytest.mark.parametrize("headroom", [1.0, 1.5])
@pytest.mark.parametrize("tkey", list(TRAFFICS))
def test_greedy_mix_matches_reference(tkey, headroom):
    """``solve_mix(solver="greedy")`` and ``best_homogeneous`` give the
    reference's counts, cost, predicted rate and table; feasibility of
    the mix and of the mix less one node of each type agrees."""
    t, jt = traffic(mp, tkey), traffic(jmp, tkey)
    mix = mp.solve_mix(LLAMA_70B, t, DEVS, slo=slo(mp, "std"),
                       headroom=headroom, solver="greedy")
    jmix = jmp.solve_mix(J_LLAMA_70B, jt, DEVS, slo=slo(jmp, "std"),
                         headroom=headroom, solver="greedy")
    assert (mix.counts, mix.cost_per_hour, mix.predicted_rate_rps,
            mix.solver) == (jmix.counts, jmix.cost_per_hour,
                            jmix.predicted_rate_rps, jmix.solver)
    assert same(mix.table, jmix.table) and mix.describe() == jmix.describe()
    for scale in (0.5, 0.999, 1.0, 1.05, 2.0):
        for g in [None, *mix.counts]:
            counts = dict(mix.counts)
            if g is not None:
                counts[g] -= 1
            assert mp.mix_is_feasible(mix.table, traffic(mp, tkey, scale),
                                      counts) == \
                jmp.mix_is_feasible(jmix.table, traffic(jmp, tkey, scale),
                                    counts)
    homo = mp.best_homogeneous(LLAMA_70B, t, DEVS, slo=slo(mp, "std"))
    jhomo = jmp.best_homogeneous(J_LLAMA_70B, jt, DEVS, slo=slo(jmp, "std"))
    assert (homo.counts, homo.cost_per_hour, homo.predicted_rate_rps) == \
        (jhomo.counts, jhomo.cost_per_hour, jhomo.predicted_rate_rps)
    cluster, jcluster = mix.cluster(), jmix.cluster()
    assert sorted(cluster.nodes) == sorted(jcluster.nodes)
    assert cluster.cost_per_hour() == jcluster.cost_per_hour()


def test_unservable_bucket_raises_like_reference():
    for mod, model in ((mp, LLAMA_70B), (jmp, J_LLAMA_70B)):
        with pytest.raises(ValueError, match="no device type"):
            mod.solve_mix(model, traffic(mod, "melange"), DEVS,
                          slo=slo(mod, "harsh"), solver="greedy")
        assert mod.best_homogeneous(model, traffic(mod, "melange"), DEVS,
                                    slo=slo(mod, "harsh")) is None


def test_cpsat_gate_without_ortools(monkeypatch):
    """Without ``ortools`` (installed neither here nor on the card; its
    import is refused here in any case) the CP-SAT solve returns None,
    ``solver="cpsat"`` raises naming ortools, and ``"auto"`` solves
    greedily — as the reference does."""
    monkeypatch.setitem(sys.modules, "ortools", None)
    t = traffic(mp, "melange")
    table = mp.ThroughputTable.profile(LLAMA_70B, t.buckets, DEVS,
                                       slo=slo(mp, "std"))
    assert mp._solve_cpsat(table, t, 64, 1.0) is None
    for mod, model in ((mp, LLAMA_70B), (jmp, J_LLAMA_70B)):
        with pytest.raises(RuntimeError, match="ortools"):
            mod.solve_mix(model, traffic(mod, "melange"), DEVS,
                          slo=slo(mod, "std"), solver="cpsat")
    auto = mp.solve_mix(LLAMA_70B, t, DEVS, slo=slo(mp, "std"),
                        solver="auto")
    greedy = mp.solve_mix(LLAMA_70B, t, DEVS, slo=slo(mp, "std"),
                          solver="greedy")
    assert auto.solver == "greedy" and auto.counts == greedy.counts


def _metrics(m):
    d = dataclasses.asdict(m)
    return {k: dict(v) if isinstance(v, dict) else v for k, v in d.items()}


def test_profiled_rate_holds_in_simulator_like_reference():
    """tests/test_mix_planner.py:147: the best homogeneous A100 cluster at
    70% of its profiled rate completes a 50-request trace with no drop —
    in the port's simulator, with Metrics equal to the reference's."""
    t, jt = traffic(mp, "short"), traffic(jmp, "short")
    homo = mp.best_homogeneous(LLAMA_70B, t, ("A100",), slo=slo(mp, "std"))
    jhomo = jmp.best_homogeneous(J_LLAMA_70B, jt, ("A100",),
                                 slo=slo(jmp, "std"))
    cluster, jcluster = homo.cluster(), jhomo.cluster()
    p = plan(cluster, LLAMA_70B, MILPOptions(time_limit_s=5.0, lns_rounds=0,
                                             fgls_rounds=10))
    jp = jplan(jcluster, J_LLAMA_70B, placement=JPlacement(
        {n: JLayerRange(r.start, r.end)
         for n, r in p.placement.assignment.items()}, LLAMA_70B.num_layers))
    rate = 0.7 * homo.predicted_rate_rps
    runs = []
    for sim_cls, tr_cls, pl, cl, model in (
            (Simulator, TraceRequest, p, cluster, LLAMA_70B),
            (JSimulator, JTraceRequest, jp, jcluster, J_LLAMA_70B)):
        trace = [tr_cls(i, (i + 1) / rate, 64, 64) for i in range(50)]
        sim = sim_cls(cl, model, pl.placement, pl.make_scheduler(),
                      warmup_s=2.0, horizon_s=300.0, decode_chunk=4)
        runs.append(sim.run(trace))
    m, jm = runs
    assert m.dropped_requests == 0 and m.completed_requests == 50
    assert m.cost_per_hour == pytest.approx(cluster.cost_per_hour())
    assert _metrics(m) == _metrics(jm)


def test_simulator_cancel_matches_reference():
    """tests/test_cancellation.py:168 on a seeded Poisson trace: two A100s
    over an 8-layer toy model, request 1 (513 prompt tokens, 209 new
    ones, arriving at 0.67 s) cancelled at 1 s, before it could finish,
    and an unknown id cancelled as a no-op; every Metrics field equal to the
    reference simulator's."""
    jmodel = j_small_model(8)
    model = ModelProfile.from_dims("toy", num_layers=8, d_model=4096,
                                   d_ff=11008, vocab=32000, n_kv_heads=32,
                                   head_dim=128)
    assert same(model, jmodel)
    cluster = full_mesh_cluster(["A100", "A100"], bandwidth=10e9 / 8,
                                latency_s=1e-3)
    jcluster = j_full_mesh(["A100", "A100"], bandwidth=10e9 / 8,
                           latency_s=1e-3)
    p = plan(cluster, model, MILPOptions(time_limit_s=5.0, lns_rounds=0,
                                         fgls_rounds=10))
    jp = jplan(jcluster, jmodel, placement=JPlacement(
        {n: JLayerRange(r.start, r.end)
         for n, r in p.placement.assignment.items()}, 8))
    runs = []
    for sim_cls, pl, cl, mdl, trace in (
            (Simulator, p, cluster, model, make_trace(12, 3.0, seed=5)),
            (JSimulator, jp, jcluster, jmodel,
             j_make_trace(12, 3.0, seed=5))):
        sim = sim_cls(cl, mdl, pl.placement, pl.make_scheduler(),
                      warmup_s=0.0, horizon_s=600.0, decode_chunk=4)
        sim.cancel(1.0, 1)
        sim.cancel(1.0, 999)
        runs.append(sim.run(trace))
    m, jm = runs
    assert m.cancelled_requests == 1
    assert m.completed_requests == 11 and m.dropped_requests == 0
    assert _metrics(m) == _metrics(jm)
