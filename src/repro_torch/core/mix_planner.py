"""Cost/SLO-aware GPU-mix planning (Mélange-style).

Helix's planner answers "place the model on THIS cluster"; this module
answers the question before it: "which cluster should I rent?".  Following
Mélange ("Cost Efficiency of Multi-GPU Serving"), traffic is bucketed by
(input-len, output-len), each device type gets a *bucketed throughput
table* — requests/s one node sustains per bucket, zeroed where the type
cannot meet the TTFT/TPOT SLO — and a solver picks the cheapest node mix
whose aggregate table capacity covers the measured demand.  The result is
an ordinary ``ClusterSpec`` that feeds the existing MILP ``plan()``, so
"choose the cluster" composes with "place the model on it".

Throughput model (the same §3.2 arithmetic the placement graph uses):
a node's model-normalized token rate is

    T(dev) = min(flops / (flops_per_token_layer * num_layers),
                 max_tokens_per_s, nic_bytes_per_s / activation_bytes)

i.e. the tokens/s it contributes to a pipeline when layers are split
proportional to compute (the max-flow upper bound ``compute_upper_bound``
is exactly the sum of these).  A bucket (i, o) costs i + o tokens per
request, so one node serves ``T / (i + o)`` requests/s of that bucket.
SLO gating is per (device, bucket): solo decode TPOT ``1 / T`` must meet
``slo.tpot_s`` and prefilling ``i`` tokens at ``prefill_speedup * T`` must
meet ``slo.ttft_s``.  ``tests/test_mix_planner.py`` checks the table
against the event simulator so the arithmetic cannot silently drift from
what the runtime/simulator actually deliver.

Solvers: a greedy + flow-checked-trim baseline with no dependencies
(feasibility of a candidate mix is an exact bipartite max-flow over the
repo's own ``preflow_push``), and an optional CP-SAT formulation (ortools,
per the Mélange/edge-placement idiom) used when available — never Gurobi.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .cluster import (COORDINATOR, DEVICE_PROFILES, ClusterSpec,
                      DeviceProfile, LinkSpec, ModelProfile, NodeSpec,
                      _full_mesh_links)
from .maxflow import FlowNetwork, preflow_push


# ---------------------------------------------------------------------------
# traffic: (input-len, output-len) buckets
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Bucket:
    """One (input-len, output-len) traffic bucket (bucket centers)."""

    input_len: int
    output_len: int

    @property
    def tokens(self) -> int:
        return self.input_len + self.output_len

    def __str__(self) -> str:
        return f"{self.input_len}in/{self.output_len}out"


@dataclasses.dataclass
class TrafficProfile:
    """Measured (or target) traffic: total request rate + bucket weights."""

    rate_rps: float
    buckets: List[Bucket]
    weights: List[float]

    def __post_init__(self) -> None:
        if self.rate_rps < 0:
            raise ValueError(f"rate_rps must be >= 0, got {self.rate_rps}")
        if len(self.buckets) != len(self.weights) or not self.buckets:
            raise ValueError("buckets and weights must be non-empty and "
                             "the same length")
        tot = float(sum(self.weights))
        if tot <= 0:
            raise ValueError("weights must sum > 0")
        self.weights = [w / tot for w in self.weights]

    def demand_rps(self) -> List[float]:
        """Requests/s per bucket."""
        return [self.rate_rps * w for w in self.weights]

    def demand_tokens(self) -> List[float]:
        """Tokens/s per bucket (requests/s x tokens per request)."""
        return [self.rate_rps * w * b.tokens
                for w, b in zip(self.weights, self.buckets)]

    def tokens_per_s(self) -> float:
        return sum(self.demand_tokens())

    @staticmethod
    def from_requests(pairs: Sequence[Tuple[int, int]], rate_rps: float,
                      edges: Sequence[int] = (128, 512, 2048)
                      ) -> "TrafficProfile":
        """Histogram observed (input_len, output_len) pairs into buckets.

        ``edges`` are upper input-length bounds; output lengths share the
        same edges.  Bucket centers are the mean of the member requests,
        so the profile reflects what was actually seen, not bin midpoints.
        This is what the autoscaler feeds the mix solver from live stats.
        """
        if not pairs:
            raise ValueError("no requests to profile")

        def edge_of(n: int) -> int:
            for k, e in enumerate(edges):
                if n <= e:
                    return k
            return len(edges)

        groups: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        for i, o in pairs:
            groups.setdefault((edge_of(i), edge_of(o)), []).append((i, o))
        buckets, weights = [], []
        for key in sorted(groups):
            mem = groups[key]
            buckets.append(Bucket(
                input_len=max(1, round(sum(i for i, _ in mem) / len(mem))),
                output_len=max(1, round(sum(o for _, o in mem) / len(mem)))))
            weights.append(float(len(mem)))
        return TrafficProfile(rate_rps=rate_rps, buckets=buckets,
                              weights=weights)


@dataclasses.dataclass(frozen=True)
class SLO:
    """Per-request latency targets gating the throughput table."""

    ttft_s: Optional[float] = None   # time to first token (prefill)
    tpot_s: Optional[float] = None   # time per output token (decode)


# ---------------------------------------------------------------------------
# bucketed per-device-type throughput table
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ThroughputTable:
    """Per-device-type bucketed throughput: ``rates[dev][b]`` is the
    requests/s ONE node of that type sustains for bucket ``b`` (0 when the
    type cannot meet the SLO for that bucket, or cannot hold even one layer
    of the model); ``token_rate[dev]`` is its model-normalized tokens/s."""

    model: ModelProfile
    buckets: List[Bucket]
    devices: Dict[str, DeviceProfile]
    token_rate: Dict[str, float]
    rates: Dict[str, List[float]]
    max_layers: Dict[str, int]
    prefill_speedup: float
    slo: SLO

    @staticmethod
    def profile(model: ModelProfile, buckets: Sequence[Bucket],
                device_names: Sequence[str] = ("A100", "V100", "L4", "T4"),
                *, slo: SLO = SLO(), param_frac: float = 0.5,
                prefill_speedup: float = 2.0,
                devices: Optional[Mapping[str, DeviceProfile]] = None
                ) -> "ThroughputTable":
        """One-time bucketed profiling pass (the Mélange tput tables).

        ``prefill_speedup`` models prefill's better FLOP utilization vs the
        (already-derated) decode rate — prefill is one big batched matmul,
        decode is memory-bound single rows.
        """
        devs = {n: (devices or DEVICE_PROFILES)[n] for n in device_names}
        token_rate: Dict[str, float] = {}
        rates: Dict[str, List[float]] = {}
        max_layers: Dict[str, int] = {}
        for name, d in devs.items():
            t = min(d.flops / (model.flops_per_token_layer * model.num_layers),
                    d.max_tokens_per_s,
                    d.nic_bytes_per_s / model.activation_bytes)
            token_rate[name] = t
            max_layers[name] = int((d.vram_bytes * param_frac)
                                   // model.layer_param_bytes)
            row: List[float] = []
            for b in buckets:
                ok = max_layers[name] >= 1 and t > 0
                if ok and slo.tpot_s is not None:
                    ok = (1.0 / t) <= slo.tpot_s
                if ok and slo.ttft_s is not None:
                    ok = b.input_len / (t * prefill_speedup) <= slo.ttft_s
                row.append(t / b.tokens if ok else 0.0)
            rates[name] = row
        return ThroughputTable(model=model, buckets=list(buckets),
                               devices=devs, token_rate=token_rate,
                               rates=rates, max_layers=max_layers,
                               prefill_speedup=prefill_speedup, slo=slo)

    def feasible_pairs(self) -> List[Tuple[str, int]]:
        return [(g, bi) for g, row in self.rates.items()
                for bi, r in enumerate(row) if r > 0]


# ---------------------------------------------------------------------------
# mix feasibility: exact bipartite max-flow (bucket demand -> type capacity)
# ---------------------------------------------------------------------------

def _served_fraction(table: ThroughputTable, traffic: TrafficProfile,
                     counts: Mapping[str, int]) -> float:
    """Fraction of the bucketed token demand a mix can serve, via max flow:
    source -> bucket (demand tokens/s) -> device type (edge iff the type is
    SLO-feasible for the bucket) -> sink (count x token rate).  1.0 means
    the mix covers the traffic exactly (fractional assignment, which IWRR
    scheduling delivers)."""
    demand = traffic.demand_tokens()
    total = sum(demand)
    if total <= 0:
        return 1.0
    net = FlowNetwork()
    src, snk = ("mix", "src"), ("mix", "snk")
    for bi, d in enumerate(demand):
        if d > 0:
            net.add_edge(src, ("b", bi), d)
    for g, bi in table.feasible_pairs():
        if demand[bi] > 0 and counts.get(g, 0) > 0:
            # big-M, not inf: preflow_push scales its epsilon off the max
            # capacity, so an inf edge would wash out every push
            net.add_edge(("b", bi), ("g", g), total)
    for g, n in counts.items():
        if n > 0:
            net.add_edge(("g", g), snk, n * table.token_rate[g])
    value, _ = preflow_push(net, src, snk)
    return value / total


def mix_is_feasible(table: ThroughputTable, traffic: TrafficProfile,
                    counts: Mapping[str, int]) -> bool:
    covered = (sum(table.max_layers[g] * n for g, n in counts.items())
               >= table.model.num_layers)
    return covered and _served_fraction(table, traffic, counts) >= 1 - 1e-9


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MixPlan:
    """A solved GPU mix: counts per device type + what it promises."""

    counts: Dict[str, int]
    cost_per_hour: float
    predicted_rate_rps: float        # max servable rate of THIS mix
    table: ThroughputTable
    traffic: TrafficProfile
    solver: str

    @property
    def num_nodes(self) -> int:
        return sum(self.counts.values())

    def cluster(self, *, bandwidth_bytes_per_s: float = 10e9 / 8,
                latency_s: float = 1e-3) -> ClusterSpec:
        """Materialize the mix as a single-region full-mesh ``ClusterSpec``
        — the object the existing MILP ``plan()`` consumes."""
        nodes: Dict[str, NodeSpec] = {}
        regions: Dict[str, str] = {COORDINATOR: "r0"}
        for g in sorted(self.counts):
            for i in range(self.counts[g]):
                name = f"{g.lower()}-{i}"
                nodes[name] = NodeSpec(name, self.table.devices[g],
                                       region="r0")
                regions[name] = "r0"
        links = _full_mesh_links(list(nodes), regions,
                                 bandwidth_bytes_per_s, latency_s,
                                 bandwidth_bytes_per_s, latency_s)
        return ClusterSpec(nodes=nodes, links=links)

    def describe(self) -> str:
        mix = "+".join(f"{n}x{g}" for g, n in sorted(self.counts.items())
                       if n > 0)
        return (f"mix[{mix} ${self.cost_per_hour:.2f}/hr "
                f"rate<={self.predicted_rate_rps:.2f}rps via {self.solver}]")


def _mix_cost(table: ThroughputTable, counts: Mapping[str, int]) -> float:
    return sum(table.devices[g].cost_per_hour * n
               for g, n in counts.items())


def _predicted_rate(table: ThroughputTable, traffic: TrafficProfile,
                    counts: Mapping[str, int]) -> float:
    """Max request rate (same bucket shape) the mix can serve: binary-search
    the rate multiplier where the served fraction stays 1."""
    if traffic.rate_rps <= 0:
        return 0.0
    lo, hi = 0.0, 1.0
    # grow hi until infeasible (or absurdly large)
    for _ in range(40):
        t = dataclasses.replace(traffic, rate_rps=traffic.rate_rps * hi,
                                weights=list(traffic.weights))
        if _served_fraction(table, t, counts) < 1 - 1e-9:
            break
        lo = hi
        hi *= 2
    else:
        return traffic.rate_rps * lo
    for _ in range(30):
        mid = (lo + hi) / 2
        t = dataclasses.replace(traffic, rate_rps=traffic.rate_rps * mid,
                                weights=list(traffic.weights))
        if _served_fraction(table, t, counts) >= 1 - 1e-9:
            lo = mid
        else:
            hi = mid
    return traffic.rate_rps * lo


def _solve_greedy(table: ThroughputTable, traffic: TrafficProfile,
                  max_per_type: int) -> Dict[str, int]:
    """Cheapest-per-absorbed-token greedy + exact-flow trim.

    Repeatedly add one node of the type with the best $/(tokens/s of
    *residual* demand it can absorb); buckets with fewer feasible types are
    absorbed first so a cheap generalist does not starve a bucket only an
    expensive specialist can serve.  A trim pass then drops any node the
    exact feasibility flow proves redundant (fixes greedy's rounding)."""
    demand = traffic.demand_tokens()
    residual = list(demand)
    counts: Dict[str, int] = {g: 0 for g in table.rates}
    feas: Dict[str, List[int]] = {
        g: [bi for bi, r in enumerate(row) if r > 0]
        for g, row in table.rates.items()}
    # options per bucket, to absorb scarce buckets first
    n_opts = [sum(1 for g in feas if bi in feas[g])
              for bi in range(len(demand))]
    for bi, d in enumerate(demand):
        if d > 0 and n_opts[bi] == 0:
            raise ValueError(
                f"bucket {table.buckets[bi]} has demand but no device type "
                f"meets its SLO — relax the SLO or add device types")

    while any(r > 1e-9 for r in residual):
        best, best_eff, best_gain = None, float("inf"), 0.0
        for g in table.rates:
            if counts[g] >= max_per_type:
                continue
            gain = min(table.token_rate[g],
                       sum(residual[bi] for bi in feas[g]))
            if gain <= 1e-12:
                continue
            cost = table.devices[g].cost_per_hour
            eff = cost / gain if cost > 0 else 0.0
            if eff < best_eff - 1e-15 or (abs(eff - best_eff) <= 1e-15
                                          and gain > best_gain):
                best, best_eff, best_gain = g, eff, gain
        if best is None:
            raise ValueError(
                "greedy mix solve ran out of capacity before covering "
                f"demand (max_per_type={max_per_type})")
        counts[best] += 1
        cap = table.token_rate[best]
        for bi in sorted(feas[best], key=lambda b: n_opts[b]):
            take = min(cap, residual[bi])
            residual[bi] -= take
            cap -= take
            if cap <= 1e-12:
                break
    # model coverage: enough total VRAM to hold every layer somewhere
    def covered() -> bool:
        return (sum(table.max_layers[g] * n for g, n in counts.items())
                >= table.model.num_layers)
    while not covered():
        cands = [g for g in table.rates
                 if table.max_layers[g] > 0 and counts[g] < max_per_type]
        if not cands:
            raise ValueError("cannot cover the model's layers within "
                             f"max_per_type={max_per_type}")
        g = min(cands, key=lambda g: table.devices[g].cost_per_hour
                / table.max_layers[g])
        counts[g] += 1
    # trim: drop nodes the exact flow check proves redundant, priciest first
    for g in sorted(counts, key=lambda g: -table.devices[g].cost_per_hour):
        while counts[g] > 0:
            counts[g] -= 1
            if not mix_is_feasible(table, traffic, counts):
                counts[g] += 1
                break
    return counts


def _solve_cpsat(table: ThroughputTable, traffic: TrafficProfile,
                 max_per_type: int, time_limit_s: float
                 ) -> Optional[Dict[str, int]]:
    """CP-SAT mix formulation (optional; ortools only, never Gurobi):
    integer node counts n_g, integer-scaled bucket-load assignment x_gb,
    sum_g x_gb >= demand_b, sum_b x_gb <= n_g * rate_g, minimize cost.
    Returns None when ortools is unavailable or the solve fails."""
    try:
        from ortools.sat.python import cp_model
    except ImportError:
        return None
    SCALE = 1000                      # token/s -> integer milli-tokens/s
    demand = traffic.demand_tokens()
    model = cp_model.CpModel()
    n = {g: model.NewIntVar(0, max_per_type, f"n_{g}")
         for g in table.rates}
    x: Dict[Tuple[str, int], object] = {}
    horizon = int(sum(demand) * SCALE) + 1
    for g, bi in table.feasible_pairs():
        if demand[bi] > 0:
            x[(g, bi)] = model.NewIntVar(0, horizon, f"x_{g}_{bi}")
    for bi, d in enumerate(demand):
        if d <= 0:
            continue
        terms = [x[(g, bi)] for g in table.rates if (g, bi) in x]
        if not terms:
            raise ValueError(
                f"bucket {table.buckets[bi]} has demand but no device type "
                f"meets its SLO — relax the SLO or add device types")
        model.Add(sum(terms) >= math.ceil(d * SCALE))
    for g in table.rates:
        terms = [x[(g, bi)] for bi in range(len(demand)) if (g, bi) in x]
        if terms:
            model.Add(sum(terms) <= n[g] * int(table.token_rate[g] * SCALE))
    # model coverage: total max layers across the mix >= num_layers
    model.Add(sum(n[g] * table.max_layers[g] for g in table.rates)
              >= table.model.num_layers)
    model.Minimize(sum(
        n[g] * int(round(table.devices[g].cost_per_hour * 100))
        for g in table.rates))
    solver = cp_model.CpSolver()
    solver.parameters.max_time_in_seconds = time_limit_s
    status = solver.Solve(model)
    if status not in (cp_model.OPTIMAL, cp_model.FEASIBLE):
        return None
    return {g: int(solver.Value(n[g])) for g in table.rates}


def solve_mix(model: ModelProfile, traffic: TrafficProfile,
              device_names: Sequence[str] = ("A100", "V100", "L4", "T4"),
              *, slo: SLO = SLO(), solver: str = "auto",
              max_per_type: int = 64, headroom: float = 1.0,
              param_frac: float = 0.5, prefill_speedup: float = 2.0,
              cpsat_time_limit_s: float = 10.0,
              table: Optional[ThroughputTable] = None) -> MixPlan:
    """Solve for the cheapest GPU mix serving ``traffic`` under ``slo``.

    ``headroom`` > 1 over-provisions (the autoscaler plans for 1.2-1.5x the
    measured rate so a drift does not immediately re-trigger).  ``solver``:
    "greedy" (always available), "cpsat" (requires ortools; raises if
    missing), or "auto" (CP-SAT when importable, greedy otherwise — and
    greedy as fallback when CP-SAT proves nothing within its time limit).
    """
    if headroom <= 0:
        raise ValueError(f"headroom must be > 0, got {headroom}")
    if table is None:
        table = ThroughputTable.profile(model, traffic.buckets,
                                        device_names, slo=slo,
                                        param_frac=param_frac,
                                        prefill_speedup=prefill_speedup)
    want = dataclasses.replace(traffic,
                               rate_rps=traffic.rate_rps * headroom,
                               weights=list(traffic.weights))
    if solver not in ("auto", "greedy", "cpsat"):
        raise ValueError(f"unknown solver {solver!r}")
    counts: Optional[Dict[str, int]] = None
    used = solver
    if solver in ("auto", "cpsat"):
        counts = _solve_cpsat(table, want, max_per_type, cpsat_time_limit_s)
        used = "cpsat"
        if counts is None and solver == "cpsat":
            raise RuntimeError("solver='cpsat' requires ortools "
                               "(pip install ortools) — use 'greedy'/'auto'")
        if counts is not None and not mix_is_feasible(table, want, counts):
            counts = None            # scaled-integer rounding fell short
    if counts is None:
        counts = _solve_greedy(table, want, max_per_type)
        used = "greedy"
    counts = {g: n for g, n in counts.items() if n > 0}
    return MixPlan(counts=counts,
                   cost_per_hour=_mix_cost(table, counts),
                   predicted_rate_rps=_predicted_rate(table, traffic,
                                                      counts),
                   table=table, traffic=traffic, solver=used)


def best_homogeneous(model: ModelProfile, traffic: TrafficProfile,
                     device_names: Sequence[str] = ("A100", "V100", "L4",
                                                    "T4"),
                     *, slo: SLO = SLO(), max_per_type: int = 64,
                     headroom: float = 1.0, param_frac: float = 0.5,
                     prefill_speedup: float = 2.0,
                     table: Optional[ThroughputTable] = None
                     ) -> Optional[MixPlan]:
    """Cheapest SINGLE-type cluster meeting the traffic (the baseline the
    mix must beat); None when no one type can serve every bucket."""
    if table is None:
        table = ThroughputTable.profile(model, traffic.buckets,
                                        device_names, slo=slo,
                                        param_frac=param_frac,
                                        prefill_speedup=prefill_speedup)
    want = dataclasses.replace(traffic,
                               rate_rps=traffic.rate_rps * headroom,
                               weights=list(traffic.weights))
    best: Optional[MixPlan] = None
    for g in table.rates:
        if any(d > 0 and table.rates[g][bi] <= 0
               for bi, d in enumerate(want.demand_tokens())):
            continue                  # this type cannot serve some bucket
        if table.max_layers[g] < 1:
            continue
        need = math.ceil(want.tokens_per_s()
                         / max(table.token_rate[g], 1e-12) - 1e-9)
        need = max(need, math.ceil(table.model.num_layers
                                   / table.max_layers[g]))
        need = max(need, 1)
        counts = {g: need}
        while need <= max_per_type and \
                not mix_is_feasible(table, want, counts):
            need += 1
            counts = {g: need}
        if need > max_per_type:
            continue
        cost = _mix_cost(table, counts)
        if best is None or cost < best.cost_per_hour:
            best = MixPlan(counts=counts, cost_per_hour=cost,
                           predicted_rate_rps=_predicted_rate(
                               table, traffic, counts),
                           table=table, traffic=traffic,
                           solver="homogeneous")
    return best
