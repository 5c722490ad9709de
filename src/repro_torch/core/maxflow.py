"""Highest-label preflow-push max flow (paper §3.2 uses preflow-push [6]).

Pure-Python implementation with the gap heuristic.  Capacities are floats
(tokens/s).  Validated against ``networkx.maximum_flow`` in tests.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Hashable, List, Mapping, Tuple

Node = Hashable
EPS = 1e-9


class FlowNetwork:
    """Directed graph with float capacities; parallel edges are merged."""

    def __init__(self) -> None:
        self.capacity: Dict[Tuple[Node, Node], float] = defaultdict(float)
        self.adj: Dict[Node, List[Node]] = defaultdict(list)
        self.nodes: set = set()

    def add_edge(self, u: Node, v: Node, cap: float) -> None:
        if u == v or cap <= 0:
            return
        if (u, v) not in self.capacity and (v, u) not in self.capacity:
            self.adj[u].append(v)
            self.adj[v].append(u)
        elif (u, v) not in self.capacity:
            # reverse edge exists; arcs already in adjacency
            pass
        self.capacity[(u, v)] += cap
        self.capacity.setdefault((v, u), 0.0)
        self.nodes.add(u)
        self.nodes.add(v)

    def edges(self):
        return [(u, v, c) for (u, v), c in self.capacity.items() if c > 0]


def preflow_push(net: FlowNetwork, source: Node, sink: Node
                 ) -> Tuple[float, Dict[Tuple[Node, Node], float]]:
    """Highest-label preflow-push with gap heuristic.

    Returns (max_flow_value, flow dict keyed by directed edge).

    Robustness: capacities are floats, so we use a *scale-relative* epsilon
    (absolute 1e-9 lets ~1e-8 rounding dust on 1e8-scale capacities ping-pong
    between two nodes forever) and enforce the standard 2n height bound —
    any excess stranded above it is numerical dust with no residual path to
    either terminal and is dropped.
    """
    if source not in net.nodes or sink not in net.nodes:
        return 0.0, {}

    nodes = list(net.nodes)
    n = len(nodes)
    cap = dict(net.capacity)
    scale = max((c for c in cap.values() if c > 0), default=1.0)
    EPS = max(1e-10 * scale, 1e-12)
    MAX_HEIGHT = 2 * n + 1
    flow: Dict[Tuple[Node, Node], float] = defaultdict(float)
    height: Dict[Node, int] = {v: 0 for v in nodes}
    excess: Dict[Node, float] = {v: 0.0 for v in nodes}
    # arc pointers for the current-arc heuristic
    arc_ptr: Dict[Node, int] = {v: 0 for v in nodes}
    # count of nodes at each height (gap heuristic)
    height_count = defaultdict(int)
    height_count[0] = n

    def residual(u: Node, v: Node) -> float:
        return cap.get((u, v), 0.0) - flow[(u, v)]

    def push(u: Node, v: Node) -> None:
        delta = min(excess[u], residual(u, v))
        flow[(u, v)] += delta
        flow[(v, u)] -= delta
        excess[u] -= delta
        excess[v] += delta

    # saturate source arcs
    height[source] = n
    height_count[0] -= 1
    height_count[n] += 1
    for v in net.adj[source]:
        if residual(source, v) > EPS:
            excess[source] += residual(source, v)
            push(source, v)

    # bucket-based highest-label selection
    buckets: Dict[int, List[Node]] = defaultdict(list)
    in_bucket: Dict[Node, bool] = defaultdict(bool)

    def activate(v: Node) -> None:
        if v not in (source, sink) and excess[v] > EPS and not in_bucket[v]:
            buckets[height[v]].append(v)
            in_bucket[v] = True

    for v in nodes:
        activate(v)
    highest = max([h for h, b in buckets.items() if b], default=-1)

    while highest >= 0:
        if not buckets[highest]:
            highest -= 1
            continue
        u = buckets[highest].pop()
        in_bucket[u] = False
        if excess[u] <= EPS:
            continue
        # discharge u
        while excess[u] > EPS:
            neigh = net.adj[u]
            if arc_ptr[u] >= len(neigh):
                # relabel
                old_h = height[u]
                min_h = None
                for v in neigh:
                    if residual(u, v) > EPS:
                        if min_h is None or height[v] < min_h:
                            min_h = height[v]
                if min_h is None:
                    excess[u] = 0.0  # isolated: drop excess (shouldn't happen)
                    break
                if min_h + 1 > MAX_HEIGHT:
                    # No residual path to source or sink within the height
                    # bound: this excess is numerical dust — drop it.
                    excess[u] = 0.0
                    break
                height[u] = min_h + 1
                arc_ptr[u] = 0
                height_count[old_h] -= 1
                height_count[height[u]] += 1
                # gap heuristic: no nodes left at old_h → lift everything
                # above old_h (below n) straight to n+1.
                if height_count[old_h] == 0 and old_h < n:
                    for w in nodes:
                        if w not in (source,) and old_h < height[w] <= n and w != sink:
                            height_count[height[w]] -= 1
                            height[w] = n + 1
                            height_count[n + 1] += 1
            else:
                v = neigh[arc_ptr[u]]
                if residual(u, v) > EPS and height[u] == height[v] + 1:
                    push(u, v)
                    activate(v)
                else:
                    arc_ptr[u] += 1
        if excess[u] > EPS:
            activate(u)
        highest = max([h for h, b in buckets.items() if b], default=-1)

    value = sum(flow[(source, v)] for v in net.adj[source])
    # keep only positive flows on real edges
    out = {e: f for e, f in flow.items()
           if f > EPS and cap.get(e, 0.0) > 0}
    return value, out


def max_flow(edges: Mapping[Tuple[Node, Node], float], source: Node,
             sink: Node) -> Tuple[float, Dict[Tuple[Node, Node], float]]:
    """Convenience wrapper: edges dict -> (value, flow assignment)."""
    net = FlowNetwork()
    for (u, v), c in edges.items():
        net.add_edge(u, v, c)
    return preflow_push(net, source, sink)
