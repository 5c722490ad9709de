"""Paper §3.2: graph abstraction of a cluster with a given model placement.

Each compute node c_i becomes two vertices (c_i^in, c_i^out) joined by an edge
whose capacity is the node's token throughput.  Valid network connections
become edges with capacity bandwidth / per-token bytes:

  (1) coordinator -> c_i          iff c_i holds the FIRST layer
  (2) c_i -> coordinator          iff c_i holds the LAST layer
  (3) c_i -> c_j                  iff c_j holds layers immediately needed
                                  after inference on c_i:
                                      s_j <= e_i < e_j   (partial inference)
                                  or  e_i == s_j         (strict pipelining)

Max flow source->sink == max serving throughput (tokens/s) of the placement.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .cluster import ClusterSpec, ModelProfile, COORDINATOR
from .maxflow import FlowNetwork, preflow_push
from .placement import Placement

SOURCE = ("source",)
SINK = ("sink",)


def node_in(name: str) -> Tuple[str, str]:
    return (name, "in")


def node_out(name: str) -> Tuple[str, str]:
    return (name, "out")


def connection_valid(placement: Placement, src: str, dst: str,
                     partial_inference: bool = True) -> bool:
    """Validity of a compute-node -> compute-node connection (criterion 3)."""
    a = placement.assignment.get(src)
    b = placement.assignment.get(dst)
    if a is None or b is None or src == dst:
        return False
    if partial_inference:
        return b.start <= a.end < b.end
    return a.end == b.start


@dataclasses.dataclass
class ClusterGraph:
    """Flow network + bookkeeping to map flows back onto cluster entities."""

    net: FlowNetwork
    placement: Placement
    # directed edge in cluster terms -> capacity (tokens/s)
    link_capacity: Dict[Tuple[str, str], float]
    node_capacity: Dict[str, float]

    def max_flow(self) -> Tuple[float, Dict[Tuple[str, str], float]]:
        """Run preflow-push; return (tokens/s, flow on cluster links).

        Flow keys use cluster node names with COORDINATOR for both the
        source and sink side so the scheduler can read them directly.
        """
        value, flow = preflow_push(self.net, SOURCE, SINK)
        out: Dict[Tuple[str, str], float] = {}
        for (u, v), f in flow.items():
            if f <= 1e-9:
                continue
            if u == SOURCE and isinstance(v, tuple) and v[1] == "in":
                out[(COORDINATOR, v[0])] = f
            elif v == SINK and isinstance(u, tuple) and u[1] == "out":
                out[(u[0], COORDINATOR)] = f
            elif (isinstance(u, tuple) and u[1] == "out"
                  and isinstance(v, tuple) and v[1] == "in"):
                out[(u[0], v[0])] = f
        return value, out


def build_graph(cluster: ClusterSpec, model: ModelProfile,
                placement: Placement, partial_inference: bool = True
                ) -> ClusterGraph:
    net = FlowNetwork()
    link_capacity: Dict[Tuple[str, str], float] = {}
    node_capacity: Dict[str, float] = {}

    for name, rng in placement.assignment.items():
        cap = cluster.node_token_throughput(name, model, rng.num_layers)
        node_capacity[name] = cap
        net.add_edge(node_in(name), node_out(name), cap)

    for name, rng in placement.assignment.items():
        # criterion 1: coordinator -> node holding layer 0
        if rng.start == 0 and cluster.link(COORDINATOR, name) is not None:
            cap = cluster.link_token_capacity(COORDINATOR, name, model)
            link_capacity[(COORDINATOR, name)] = cap
            net.add_edge(SOURCE, node_in(name), cap)
        # criterion 2: node holding last layer -> coordinator
        if rng.end == model.num_layers and cluster.link(name, COORDINATOR) is not None:
            cap = cluster.link_token_capacity(name, COORDINATOR, model)
            link_capacity[(name, COORDINATOR)] = cap
            net.add_edge(node_out(name), SINK, cap)

    for src in placement.assignment:
        for dst in placement.assignment:
            if src == dst:
                continue
            if cluster.link(src, dst) is None:
                continue
            if connection_valid(placement, src, dst, partial_inference):
                cap = cluster.link_token_capacity(src, dst, model)
                link_capacity[(src, dst)] = cap
                net.add_edge(node_out(src), node_in(dst), cap)

    return ClusterGraph(net=net, placement=placement,
                        link_capacity=link_capacity,
                        node_capacity=node_capacity)


def placement_throughput(cluster: ClusterSpec, model: ModelProfile,
                         placement: Placement,
                         partial_inference: bool = True) -> float:
    """Max serving throughput (tokens/s) of a placement — the paper's
    evaluation function for any placement (heuristic or MILP)."""
    if placement.validate():
        return 0.0
    graph = build_graph(cluster, model, placement, partial_inference)
    value, _ = graph.max_flow()
    return value


def compute_upper_bound(cluster: ClusterSpec, model: ModelProfile) -> float:
    """§3.4 early-stop bound: sum of node compute averaged over all layers."""
    total = sum(cluster.nodes[n].flops for n in cluster.node_names())
    per_layer = total / (model.flops_per_token_layer * model.num_layers)
    return per_layer
