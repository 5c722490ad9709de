"""Model placement representation + the paper's baseline heuristics.

A placement maps each compute node to a contiguous layer interval
``[start, end)`` of the model.  Helix's MILP (milp.py) searches over these;
this module holds the shared datatype and the three heuristics the paper
compares against / warm-starts from:

* **Swarm** [31]: partition the model into equal-length stages; assign nodes
  to stages balancing per-stage compute capacity.
* **Petals** [4]: nodes choose greedily, covering the layers with the least
  accumulated compute, holding as many layers as VRAM allows.
* **Separate pipelines (SP)**: one homogeneous pipeline per device type,
  layers split evenly within each pipeline.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Dict, List, Mapping, Optional, Tuple

from .cluster import ClusterSpec, ModelProfile, COORDINATOR


@dataclasses.dataclass(frozen=True)
class LayerRange:
    start: int
    end: int  # exclusive

    @property
    def num_layers(self) -> int:
        return max(0, self.end - self.start)

    def overlaps(self, other: "LayerRange") -> bool:
        return self.start < other.end and other.start < self.end


@dataclasses.dataclass
class Placement:
    """node name -> layer range.  Nodes holding zero layers are omitted."""

    assignment: Dict[str, LayerRange]
    num_layers: int
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def validate(self) -> List[str]:
        """Return a list of problems (empty == valid)."""
        problems = []
        covered = [0] * self.num_layers
        for node, rng in self.assignment.items():
            if rng.num_layers <= 0:
                problems.append(f"{node}: empty range {rng}")
            if rng.start < 0 or rng.end > self.num_layers:
                problems.append(f"{node}: out of bounds {rng}")
            for l in range(max(rng.start, 0), min(rng.end, self.num_layers)):
                covered[l] += 1
        missing = [l for l, c in enumerate(covered) if c == 0]
        if missing:
            problems.append(f"uncovered layers: {missing[:8]}{'...' if len(missing) > 8 else ''}")
        return problems

    def holders_of(self, layer: int) -> List[str]:
        return sorted(n for n, r in self.assignment.items()
                      if r.start <= layer < r.end)

    def roles(self) -> Dict[str, str]:
        """Replica role per node (``prefill`` / ``decode`` / ``mixed``).
        Placements without explicit roles treat every node as mixed."""
        roles = (self.meta or {}).get("roles") or {}
        return {n: roles.get(n, "mixed") for n in self.assignment}

    def layer_compute(self, cluster: ClusterSpec, model: ModelProfile) -> List[float]:
        """Tokens/s of capacity covering each layer (the min over layers is
        the classic pipeline-bottleneck metric from §3.1)."""
        out = [0.0] * self.num_layers
        for node, rng in self.assignment.items():
            tput = cluster.node_token_throughput(node, model, rng.num_layers)
            for l in range(rng.start, rng.end):
                out[l] += tput
        return out


# ---------------------------------------------------------------------------
# Disaggregated prefill/decode (HexGen-2-style replica roles)
# ---------------------------------------------------------------------------

def disaggregated_placement(prefill: Mapping[str, LayerRange],
                            decode: Mapping[str, LayerRange],
                            num_layers: int) -> Placement:
    """Build a placement split into prefill and decode replica groups.

    Each group must cover ``[0, num_layers)`` on its own: prompt passes run
    only on the prefill group, decode passes only on the decode group, and
    the filled KV is handed from the former to the latter over a peer link.
    A node listed in both groups (same range) becomes ``mixed`` — its KV is
    already home, so no handoff is shipped for its layers.
    """
    assignment: Dict[str, LayerRange] = {}
    roles: Dict[str, str] = {}
    for group, role in ((prefill, "prefill"), (decode, "decode")):
        for node, rng in group.items():
            if node in assignment and assignment[node] != rng:
                raise ValueError(
                    f"{node} appears in both groups with conflicting "
                    f"ranges {assignment[node]} vs {rng}")
            assignment[node] = rng
            roles[node] = "mixed" if node in roles else role
    for name, group in (("prefill", prefill), ("decode", decode)):
        sub = Placement(dict(group), num_layers)
        bad = sub.validate()
        if bad:
            raise ValueError(f"{name} group does not cover the model: {bad}")
    return Placement(assignment, num_layers,
                     meta={"method": "disaggregated", "roles": roles})


# ---------------------------------------------------------------------------
# Heuristic baselines
# ---------------------------------------------------------------------------

def swarm_placement(cluster: ClusterSpec, model: ModelProfile,
                    num_stages: Optional[int] = None,
                    param_frac: float = 0.5) -> Placement:
    """Equal-length stages; nodes assigned to stages to balance compute.

    The paper sets #stages to the minimum that lets the weakest GPU hold one
    stage with half its VRAM.
    """
    names = cluster.node_names()
    if num_stages is None:
        weakest_layers = min(
            max(1, cluster.max_layers_on(n, model, param_frac)) for n in names)
        num_stages = max(1, math.ceil(model.num_layers / weakest_layers))
    num_stages = min(num_stages, model.num_layers, len(names))
    # split layers into (nearly) equal stages
    bounds = [round(i * model.num_layers / num_stages) for i in range(num_stages + 1)]
    stages = [LayerRange(bounds[i], bounds[i + 1]) for i in range(num_stages)]
    # sort nodes by capacity desc, assign each to the stage with least compute
    stage_compute = [0.0] * num_stages
    assignment: Dict[str, LayerRange] = {}
    for node in sorted(names, key=lambda n: -cluster.nodes[n].flops):
        i = min(range(num_stages), key=lambda s: stage_compute[s])
        assignment[node] = stages[i]
        stage_compute[i] += cluster.node_token_throughput(
            node, model, stages[i].num_layers)
    return Placement(assignment, model.num_layers, meta={"method": "swarm",
                                                         "num_stages": num_stages})


def petals_placement(cluster: ClusterSpec, model: ModelProfile,
                     param_frac: float = 0.5) -> Placement:
    """Greedy: each node (in arbitrary join order) picks the contiguous window
    it can hold that currently has the least total compute coverage."""
    names = cluster.node_names()
    coverage = [0.0] * model.num_layers
    assignment: Dict[str, LayerRange] = {}
    for node in names:
        k = cluster.max_layers_on(node, model, param_frac)
        k = max(1, min(k, model.num_layers))
        best_start, best_cov = 0, float("inf")
        window = sum(coverage[:k])
        best_cov, best_start = window, 0
        for s in range(1, model.num_layers - k + 1):
            window += coverage[s + k - 1] - coverage[s - 1]
            if window < best_cov - 1e-12:
                best_cov, best_start = window, s
        rng = LayerRange(best_start, best_start + k)
        assignment[node] = rng
        tput = cluster.node_token_throughput(node, model, k)
        for l in range(rng.start, rng.end):
            coverage[l] += tput
    return Placement(assignment, model.num_layers, meta={"method": "petals"})


def separate_pipelines_placement(cluster: ClusterSpec, model: ModelProfile,
                                 param_frac: float = 0.5,
                                 allow_mixed_tail: bool = False) -> Placement:
    """One pipeline per device type; even layer split inside each pipeline.

    Device types whose members cannot jointly hold the model form no pipeline
    (paper: SP excludes them; SP+ builds one mixed pipeline from leftovers —
    enabled via ``allow_mixed_tail``)."""
    by_type: Dict[str, List[str]] = defaultdict(list)
    for name in cluster.node_names():
        key = f"{cluster.nodes[name].device.name}x{cluster.nodes[name].tp_degree}"
        by_type[key].append(name)

    assignment: Dict[str, LayerRange] = {}
    leftovers: List[str] = []
    for dev, members in sorted(by_type.items()):
        per_node_max = cluster.max_layers_on(members[0], model, param_frac)
        if per_node_max <= 0:
            leftovers.extend(members)
            continue
        need = math.ceil(model.num_layers / per_node_max)
        if len(members) < need:
            leftovers.extend(members)
            continue
        # greedily form ⌊len/need⌋ replicas; spare nodes join leftovers
        num_replicas = len(members) // need
        used = num_replicas * need
        leftovers.extend(members[used:])
        for r in range(num_replicas):
            group = members[r * need:(r + 1) * need]
            bounds = [round(i * model.num_layers / need) for i in range(need + 1)]
            for i, node in enumerate(group):
                assignment[node] = LayerRange(bounds[i], bounds[i + 1])

    if allow_mixed_tail and leftovers:
        mixed = _mixed_pipeline(cluster, model, leftovers, param_frac)
        assignment.update(mixed)
    return Placement(assignment, model.num_layers,
                     meta={"method": "separate_pipelines",
                           "unused_nodes": [] if allow_mixed_tail else leftovers})


def _mixed_pipeline(cluster: ClusterSpec, model: ModelProfile,
                    members: List[str], param_frac: float) -> Dict[str, LayerRange]:
    """Chain leftover nodes into one pipeline, each holding its VRAM max,
    proportionally shrunk to exactly cover the model if oversubscribed."""
    caps = {n: max(1, cluster.max_layers_on(n, model, param_frac)) for n in members}
    total = sum(caps.values())
    if total < model.num_layers:
        return {}
    assignment: Dict[str, LayerRange] = {}
    cursor = 0
    remaining = model.num_layers
    ordered = sorted(members, key=lambda n: -caps[n])
    for i, n in enumerate(ordered):
        left_nodes = len(ordered) - i
        rest_cap = sum(caps[m] for m in ordered[i + 1:])
        # balanced share, but never leave more than the rest can cover
        take = min(caps[n], remaining)
        take = max(take if left_nodes == 1 else min(take, math.ceil(remaining / left_nodes)),
                   remaining - rest_cap)
        if take > 0:
            assignment[n] = LayerRange(cursor, cursor + take)
            cursor += take
            remaining -= take
    if remaining > 0:
        return {}
    return assignment
