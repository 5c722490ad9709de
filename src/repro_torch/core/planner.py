"""End-to-end Helix planner: cluster → placement → max-flow → scheduler.

Also hosts the fault-tolerance entry points:
  * ``replan_after_failure`` — node loss → re-solve placement on the reduced
    cluster, warm-started (LNS) from the surviving assignment.
  * ``reweight_for_straggler`` — capacity degradation → recompute max flow on
    the degraded graph (placement unchanged; cheap) and swap IWRR weights.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

from .cluster import ClusterSpec, ModelProfile, COORDINATOR
from .graph import ClusterGraph, build_graph, placement_throughput
from .milp import MILPOptions, PlacementResult, solve_placement
from .placement import Placement
from .scheduler import HelixScheduler, KVEstimator


@dataclasses.dataclass
class Plan:
    cluster: ClusterSpec
    model: ModelProfile
    placement: Placement
    graph: ClusterGraph
    flows: Dict[Tuple[str, str], float]
    throughput: float
    milp: Optional[PlacementResult] = None

    def make_scheduler(self, partial_inference: bool = True,
                       with_kv_estimation: bool = True) -> HelixScheduler:
        kv = KVEstimator.from_placement(self.cluster, self.model,
                                        self.placement) \
            if with_kv_estimation else None
        return HelixScheduler(self.cluster, self.model, self.placement,
                              self.flows, partial_inference, kv)


def plan(cluster: ClusterSpec, model: ModelProfile,
         options: Optional[MILPOptions] = None,
         placement: Optional[Placement] = None) -> Plan:
    """Solve (or adopt) a placement and derive flows for scheduling."""
    options = options or MILPOptions()
    milp_result = None
    if placement is None:
        milp_result = solve_placement(cluster, model, options)
        placement = milp_result.placement
    graph = build_graph(cluster, model, placement, options.partial_inference)
    value, flows = graph.max_flow()
    return Plan(cluster=cluster, model=model, placement=placement,
                graph=graph, flows=flows, throughput=value, milp=milp_result)


def replan_after_failure(old: Plan, failed_node: str,
                         options: Optional[MILPOptions] = None) -> Plan:
    """Elastic replanning on node failure.

    The surviving placement seeds the LNS (nodes keep their layer ranges
    unless moving them improves flow), so replanning is fast and the swap is
    incremental.
    """
    options = options or MILPOptions()
    cluster = old.cluster.remove_node(failed_node)
    surviving = {n: r for n, r in old.placement.assignment.items()
                 if n != failed_node}
    seed = Placement(surviving, old.model.num_layers,
                     meta={"method": "surviving"})
    # If the surviving placement still covers the model it becomes the LNS
    # incumbent automatically (solve_placement evaluates heuristics + MILP);
    # otherwise the MILP repairs coverage from scratch.
    result = solve_placement(cluster, old.model, options)
    if not seed.validate():
        surviving_tput = placement_throughput(cluster, old.model, seed,
                                              options.partial_inference)
        if surviving_tput > result.actual_throughput:
            return plan(cluster, old.model, options, placement=seed)
    return plan(cluster, old.model, options, placement=result.placement)


def reweight_for_straggler(current: Plan, node: str, factor: float) -> Plan:
    """Straggler mitigation: degrade ``node``'s capacity by ``factor`` and
    re-run max flow only (placement unchanged — no weights move)."""
    cluster = current.cluster.degrade_node(node, factor)
    return plan(cluster, current.model, placement=current.placement)
