"""Paper §3.3–3.4: MILP model placement via max-flow maximization.

Variables (Table 2):
  s_i      int     first layer node i holds
  b_i^j    binary  node i holds exactly j layers (j = 1..k_i)
  f_{u,v}  real    flow on candidate connection (u,v)
  d_{u,v}  binary  connection validity
  cond1/2  binary  aux for the partial-inference validity linearization

Constraints (Table 3): placement validity, flow conservation, inference
throughput, connection validity, transmission throughput.  Objective:
maximize sum of flow out of the source.

Solver: scipy.optimize.milp (HiGHS).  The paper uses Gurobi; HiGHS has no
warm-start API, so §3.4's "hint with heuristic solutions" is reproduced as
(a) an incumbent lower bound from the best heuristic and (b) LNS
(fix-and-reoptimize) around the incumbent.  §3.4's other speedups — cluster
pruning and the compute-sum upper bound — are implemented directly.

Note on the paper's no-partial-inference linearization: the text gives
``L*d <= L + s_j - e_i`` and ``L*d >= L - s_j + e_i``; the latter direction
is inconsistent (both reduce to e_i <= s_j).  We use the pair
``L*d <= L + s_j - e_i`` and ``L*d <= L - s_j + e_i``, whose conjunction
correctly forces e_i == s_j when d == 1.
"""
from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
from scipy import sparse
from scipy.optimize import Bounds, LinearConstraint, milp

from .cluster import ClusterSpec, ModelProfile, COORDINATOR
from .graph import build_graph, compute_upper_bound, placement_throughput
from .placement import (LayerRange, Placement, petals_placement,
                        separate_pipelines_placement, swarm_placement)

SRC = "__source__"
SNK = "__sink__"


@dataclasses.dataclass
class MILPOptions:
    partial_inference: bool = True
    prune_degree: Optional[int] = 12
    time_limit_s: float = 60.0
    mip_rel_gap: float = 0.01
    warm_start: bool = True
    lns_rounds: int = 4
    lns_neighborhood: int = 6
    lns_time_limit_s: float = 15.0
    # Beyond-paper: flow-guided local search refinement of the best solution
    # (see local_search.py) — fast anytime improvement with the exact
    # preflow-push evaluator; also strengthens the LNS incumbent.
    fgls_rounds: int = 40
    use_upper_bound: bool = True
    # Beyond-paper MILP strengthening: clamp every capacity at the §3.4
    # compute-sum bound (no single edge can carry more than the total flow,
    # which the bound caps) — big-M coefficients drop from ~3e8 to ~1e4 and
    # the LP relaxation tightens dramatically.
    clamp_capacity_at_bound: bool = True
    # Beyond-paper: identical nodes (same device/region/tp) are
    # interchangeable; order their start layers to break symmetry.
    symmetry_breaking: bool = True
    param_frac: float = 0.5  # VRAM fraction for params (rest = KV cache)
    seed: int = 0
    verbose: bool = False


@dataclasses.dataclass
class PlacementResult:
    placement: Placement
    predicted_throughput: float   # MILP objective value
    actual_throughput: float      # preflow-push on the resulting graph
    status: str
    solve_time_s: float
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# Candidate connection set (§3.4 cluster pruning)
# ---------------------------------------------------------------------------

def candidate_edges(cluster: ClusterSpec, prune_degree: Optional[int]
                    ) -> List[Tuple[str, str]]:
    """Compute-compute candidate links, optionally pruned to a target degree.

    Pruning keeps the highest-bandwidth (then lowest-latency) out-links per
    node; coordinator links are never pruned.
    """
    names = cluster.node_names()
    edges: List[Tuple[str, str]] = []
    for src in names:
        # Tie-break equal-bandwidth links by a deterministic hash so pruning
        # spreads the kept links across the mesh (sorting by name makes every
        # node keep the same 12 peers, destroying connectivity).
        import hashlib

        def _spread(dst: str) -> int:
            return int(hashlib.md5(f"{src}->{dst}".encode()).hexdigest()[:8], 16)

        outs = [(l.bandwidth_bytes_per_s, -l.latency_s, _spread(l.dst), l.dst)
                for l in cluster.out_links(src)
                if l.dst != COORDINATOR and l.dst in cluster.nodes]
        outs.sort(reverse=True)
        if prune_degree is not None:
            outs = outs[:prune_degree]
        edges.extend((src, dst) for _, _, _, dst in outs)
    return edges


# ---------------------------------------------------------------------------
# MILP construction
# ---------------------------------------------------------------------------

class _VarRegistry:
    def __init__(self) -> None:
        self.names: List[str] = []
        self.lb: List[float] = []
        self.ub: List[float] = []
        self.integrality: List[int] = []
        self.index: Dict[str, int] = {}

    def add(self, name: str, lb: float, ub: float, integer: bool) -> int:
        idx = len(self.names)
        self.names.append(name)
        self.lb.append(lb)
        self.ub.append(ub)
        self.integrality.append(1 if integer else 0)
        self.index[name] = idx
        return idx

    def __getitem__(self, name: str) -> int:
        return self.index[name]

    def __len__(self) -> int:
        return len(self.names)


class _ConstraintBuilder:
    def __init__(self, nvars: int) -> None:
        self.rows: List[Dict[int, float]] = []
        self.lo: List[float] = []
        self.hi: List[float] = []
        self.nvars = nvars

    def add(self, coeffs: Mapping[int, float], lo: float, hi: float) -> None:
        self.rows.append(dict(coeffs))
        self.lo.append(lo)
        self.hi.append(hi)

    def build(self) -> LinearConstraint:
        data, ri, ci = [], [], []
        for r, row in enumerate(self.rows):
            for c, v in row.items():
                ri.append(r)
                ci.append(c)
                data.append(v)
        mat = sparse.csr_matrix((data, (ri, ci)),
                                shape=(len(self.rows), self.nvars))
        return LinearConstraint(mat, np.array(self.lo), np.array(self.hi))


@dataclasses.dataclass
class _Problem:
    reg: _VarRegistry
    cons: _ConstraintBuilder
    objective: np.ndarray
    nodes: List[str]
    k_of: Dict[str, int]
    edges: List[Tuple[str, str]]
    L: int


def _build_problem(cluster: ClusterSpec, model: ModelProfile,
                   options: MILPOptions,
                   fixed: Optional[Mapping[str, LayerRange]] = None
                   ) -> _Problem:
    L = model.num_layers
    names = cluster.node_names()
    # Nodes that cannot hold even one layer are excluded from placement.
    k_of = {n: min(L, cluster.max_layers_on(n, model, options.param_frac))
            for n in names}
    nodes = [n for n in names if k_of[n] >= 1]
    edges = [(u, v) for (u, v) in candidate_edges(cluster, options.prune_degree)
             if u in set(nodes) and v in set(nodes)]

    # Clamp capacities at the total-flow bound: no edge can carry more than
    # the sum of all compute, so this is exact — and it shrinks big-Ms.
    flow_cap = compute_upper_bound(cluster, model) \
        if options.clamp_capacity_at_bound else float("inf")

    reg = _VarRegistry()
    fixed = fixed or {}
    for n in nodes:
        if n in fixed:
            rng = fixed[n]
            reg.add(f"s[{n}]", rng.start, rng.start, True)
            for j in range(1, k_of[n] + 1):
                val = 1.0 if j == rng.num_layers else 0.0
                reg.add(f"b[{n},{j}]", val, val, True)
        else:
            reg.add(f"s[{n}]", 0, L - 1, True)
            for j in range(1, k_of[n] + 1):
                reg.add(f"b[{n},{j}]", 0, 1, True)

    for n in nodes:
        cap = cluster.link_token_capacity(COORDINATOR, n, model) \
            if cluster.link(COORDINATOR, n) else 0.0
        cap = min(cap, flow_cap)
        reg.add(f"f[{SRC},{n}]", 0, cap, False)
        reg.add(f"d[{SRC},{n}]", 0, 1 if cap > 0 else 0, True)
        cap = cluster.link_token_capacity(n, COORDINATOR, model) \
            if cluster.link(n, COORDINATOR) else 0.0
        cap = min(cap, flow_cap)
        reg.add(f"f[{n},{SNK}]", 0, cap, False)
        reg.add(f"d[{n},{SNK}]", 0, 1 if cap > 0 else 0, True)

    # For edges whose BOTH endpoints are fixed, connection validity is a
    # constant — pre-resolve it so LNS sub-problems shed most binaries.
    def _fixed_validity(u: str, v: str) -> Optional[bool]:
        if u not in fixed or v not in fixed:
            return None
        a, b = fixed[u], fixed[v]
        if options.partial_inference:
            return b.start <= a.end < b.end
        return a.end == b.start

    for (u, v) in edges:
        cap = min(cluster.link_token_capacity(u, v, model), flow_cap)
        known = _fixed_validity(u, v)
        reg.add(f"f[{u},{v}]", 0, cap if known in (None, True) else 0.0, False)
        if known is None:
            reg.add(f"d[{u},{v}]", 0, 1, True)
        else:
            reg.add(f"d[{u},{v}]", int(known), int(known), True)
        if options.partial_inference and known is None:
            reg.add(f"c1[{u},{v}]", 0, 1, True)
            reg.add(f"c2[{u},{v}]", 0, 1, True)

    cons = _ConstraintBuilder(len(reg))

    def e_terms(n: str, sign: float) -> Dict[int, float]:
        """Coefficients of e_n = s_n + sum_j j*b_n^j, scaled by sign."""
        out = {reg[f"s[{n}]"]: sign}
        for j in range(1, k_of[n] + 1):
            out[reg[f"b[{n},{j}]"]] = sign * j
        return out

    def _merge(*ds: Mapping[int, float]) -> Dict[int, float]:
        out: Dict[int, float] = {}
        for d in ds:
            for k, val in d.items():
                out[k] = out.get(k, 0.0) + val
        return out

    in_edges: Dict[str, List[str]] = {n: [] for n in nodes}
    out_edges: Dict[str, List[str]] = {n: [] for n in nodes}
    for (u, v) in edges:
        out_edges[u].append(f"f[{u},{v}]")
        in_edges[v].append(f"f[{u},{v}]")
    for n in nodes:
        in_edges[n].append(f"f[{SRC},{n}]")
        out_edges[n].append(f"f[{n},{SNK}]")

    for n in nodes:
        # C1: exactly one b; e_i <= L
        cons.add({reg[f"b[{n},{j}]"]: 1.0 for j in range(1, k_of[n] + 1)}, 1, 1)
        cons.add(e_terms(n, +1.0), -np.inf, L)
        # C2: flow conservation
        row = {reg[f]: 1.0 for f in in_edges[n]}
        for f in out_edges[n]:
            row[reg[f]] = row.get(reg[f], 0.0) - 1.0
        cons.add(row, 0, 0)
        # C3: inference throughput, sum_in f <= sum_j T_n^j b_n^j
        row = {reg[f]: 1.0 for f in in_edges[n]}
        for j in range(1, k_of[n] + 1):
            t = cluster.node_token_throughput(n, model, j)
            row[reg[f"b[{n},{j}]"]] = row.get(reg[f"b[{n},{j}]"], 0.0) - t
        cons.add(row, -np.inf, 0)
        # C4 source: s_i + L*d_src <= L
        cons.add({reg[f"s[{n}]"]: 1.0, reg[f"d[{SRC},{n}]"]: float(L)},
                 -np.inf, L)
        # C4 sink: L*d_sink - e_i <= 0
        cons.add(_merge({reg[f"d[{n},{SNK}]"]: float(L)}, e_terms(n, -1.0)),
                 -np.inf, 0)
        # C5 source/sink transmission: f <= cap * d
        cap = reg.ub[reg[f"f[{SRC},{n}]"]]
        cons.add({reg[f"f[{SRC},{n}]"]: 1.0, reg[f"d[{SRC},{n}]"]: -cap},
                 -np.inf, 0)
        cap = reg.ub[reg[f"f[{n},{SNK}]"]]
        cons.add({reg[f"f[{n},{SNK}]"]: 1.0, reg[f"d[{n},{SNK}]"]: -cap},
                 -np.inf, 0)

    for (u, v) in edges:
        if _fixed_validity(u, v) is not None:
            # d already pinned; only the f <= cap*d row below is needed.
            pass
        elif options.partial_inference:
            # cond1 = 1 only if s_v <= e_u:  s_v - e_u + (L+1)c1 <= L+1
            cons.add(_merge({reg[f"s[{v}]"]: 1.0,
                             reg[f"c1[{u},{v}]"]: float(L + 1)},
                            e_terms(u, -1.0)),
                     -np.inf, L + 1)
            # cond2 = 1 only if e_u < e_v:   e_u - e_v + (L+1)c2 <= L
            cons.add(_merge(e_terms(u, +1.0), e_terms(v, -1.0),
                            {reg[f"c2[{u},{v}]"]: float(L + 1)}),
                     -np.inf, L)
            # d <= 0.5c1 + 0.5c2
            cons.add({reg[f"d[{u},{v}]"]: 1.0,
                      reg[f"c1[{u},{v}]"]: -0.5,
                      reg[f"c2[{u},{v}]"]: -0.5}, -np.inf, 0)
        else:
            # d = 1 only if e_u == s_v (see module docstring for the fix):
            # L*d - s_v + e_u <= L   and   L*d + s_v - e_u <= L
            cons.add(_merge({reg[f"d[{u},{v}]"]: float(L),
                             reg[f"s[{v}]"]: -1.0}, e_terms(u, +1.0)),
                     -np.inf, L)
            cons.add(_merge({reg[f"d[{u},{v}]"]: float(L),
                             reg[f"s[{v}]"]: 1.0}, e_terms(u, -1.0)),
                     -np.inf, L)
        # C5: f <= cap * d
        cap = reg.ub[reg[f"f[{u},{v}]"]]
        cons.add({reg[f"f[{u},{v}]"]: 1.0,
                  reg[f"d[{u},{v}]"]: -cap}, -np.inf, 0)

    # §3.4 compute-sum upper bound on total source flow
    if options.use_upper_bound:
        ub = compute_upper_bound(cluster, model)
        cons.add({reg[f"f[{SRC},{n}]"]: 1.0 for n in nodes}, -np.inf, ub)

    # Symmetry breaking: identical free nodes get ordered start layers.
    if options.symmetry_breaking and not fixed:
        groups: Dict[Tuple, List[str]] = {}
        for n in nodes:
            spec = cluster.nodes[n]
            key = (spec.device.name, spec.region, spec.tp_degree)
            groups.setdefault(key, []).append(n)
        for members in groups.values():
            members.sort()
            for a, b in zip(members, members[1:]):
                # s_a <= s_b
                cons.add({reg[f"s[{a}]"]: 1.0, reg[f"s[{b}]"]: -1.0},
                         -np.inf, 0)

    obj = np.zeros(len(reg))
    for n in nodes:
        obj[reg[f"f[{SRC},{n}]"]] = -1.0  # milp minimizes

    return _Problem(reg=reg, cons=cons, objective=obj, nodes=nodes,
                    k_of=k_of, edges=edges, L=L)


def _solve(problem: _Problem, options: MILPOptions,
           time_limit: Optional[float] = None) -> Tuple[Optional[Placement], float, str]:
    reg = problem.reg
    res = milp(
        c=problem.objective,
        constraints=problem.cons.build(),
        integrality=np.array(reg.integrality),
        bounds=Bounds(np.array(reg.lb), np.array(reg.ub)),
        options={
            "time_limit": time_limit or options.time_limit_s,
            "mip_rel_gap": options.mip_rel_gap,
            "disp": options.verbose,
        },
    )
    if res.x is None:
        return None, 0.0, f"status={res.status} ({res.message})"
    assignment: Dict[str, LayerRange] = {}
    for n in problem.nodes:
        s = int(round(res.x[reg[f"s[{n}]"]]))
        num = 0
        best = 0.0
        for j in range(1, problem.k_of[n] + 1):
            val = res.x[reg[f"b[{n},{j}]"]]
            if val > best:
                best, num = val, j
        assignment[n] = LayerRange(s, s + num)
    placement = Placement(assignment, problem.L, meta={"method": "milp"})
    return placement, -float(res.fun), f"status={res.status}"


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def heuristic_incumbents(cluster: ClusterSpec, model: ModelProfile,
                         options: MILPOptions) -> List[Tuple[str, Placement, float]]:
    out = []
    for name, fn in [("swarm", swarm_placement),
                     ("petals", petals_placement),
                     ("separate_pipelines", separate_pipelines_placement)]:
        try:
            p = fn(cluster, model, param_frac=options.param_frac)
        except TypeError:
            p = fn(cluster, model)
        if p.validate():
            continue
        t = placement_throughput(cluster, model, p, options.partial_inference)
        out.append((name, p, t))
    out.sort(key=lambda x: -x[2])
    return out


def solve_placement(cluster: ClusterSpec, model: ModelProfile,
                    options: Optional[MILPOptions] = None) -> PlacementResult:
    """End-to-end Helix placement: heuristics → MILP → LNS refinement."""
    options = options or MILPOptions()
    rng = random.Random(options.seed)
    t0 = time.time()

    incumbents = heuristic_incumbents(cluster, model, options)
    best_placement: Optional[Placement] = incumbents[0][1] if incumbents else None
    best_value = incumbents[0][2] if incumbents else 0.0
    history = [{"phase": "heuristic:" + n, "throughput": t}
               for n, _, t in incumbents]

    problem = _build_problem(cluster, model, options)
    placement, predicted, status = _solve(problem, options)
    milp_actual = 0.0
    if placement is not None and not placement.validate():
        milp_actual = placement_throughput(cluster, model, placement,
                                           options.partial_inference)
        history.append({"phase": "milp", "throughput": milp_actual,
                        "predicted": predicted, "status": status})
        if milp_actual > best_value:
            best_placement, best_value = placement, milp_actual

    # Beyond-paper: flow-guided local search on the incumbent.
    if options.fgls_rounds and best_placement is not None:
        from .local_search import FGLSOptions, refine_placement
        refined, val, _hist = refine_placement(
            cluster, model, best_placement,
            FGLSOptions(rounds=options.fgls_rounds,
                        partial_inference=options.partial_inference,
                        param_frac=options.param_frac, seed=options.seed))
        history.append({"phase": "fgls", "throughput": val})
        if val > best_value + 1e-9:
            best_placement, best_value = refined, val

    # §3.4 warm start, reproduced as LNS fix-and-reoptimize around incumbent.
    if options.warm_start and best_placement is not None and options.lns_rounds:
        nodes = [n for n in problem.nodes]
        for r in range(options.lns_rounds):
            if len(nodes) <= options.lns_neighborhood:
                break
            # alternate: bottleneck-guided neighborhoods and random ones
            if r % 2 == 0 and best_placement is not None:
                per_layer = best_placement.layer_compute(cluster, model)
                worst = min(range(len(per_layer)), key=lambda l: per_layer[l])
                near = [n for n in nodes
                        if n in best_placement.assignment
                        and abs((best_placement.assignment[n].start
                                 + best_placement.assignment[n].end) / 2
                                - worst) <= model.num_layers / 3]
                rng.shuffle(near)
                free = set(near[:options.lns_neighborhood])
                pool = [n for n in nodes if n not in free]
                while len(free) < options.lns_neighborhood and pool:
                    free.add(pool.pop(rng.randrange(len(pool))))
            else:
                free = set(rng.sample(nodes, options.lns_neighborhood))
            fixed = {n: best_placement.assignment[n] for n in nodes
                     if n not in free and n in best_placement.assignment}
            sub = _build_problem(cluster, model, options, fixed=fixed)
            cand, pred, st = _solve(sub, options,
                                    time_limit=options.lns_time_limit_s)
            if cand is None or cand.validate():
                continue
            val = placement_throughput(cluster, model, cand,
                                       options.partial_inference)
            history.append({"phase": f"lns[{r}]", "throughput": val,
                            "predicted": pred, "status": st})
            if val > best_value + 1e-9:
                best_placement, best_value = cand, val

    if best_placement is None:
        raise RuntimeError("no feasible placement found (cluster too small "
                           "to hold the model?)")
    return PlacementResult(
        placement=best_placement,
        predicted_throughput=predicted if placement is not None else 0.0,
        actual_throughput=best_value,
        status=status,
        solve_time_s=time.time() - t0,
        meta={"history": history,
              "num_vars": len(problem.reg),
              "num_constraints": len(problem.cons.rows),
              "upper_bound": compute_upper_bound(cluster, model)},
    )
