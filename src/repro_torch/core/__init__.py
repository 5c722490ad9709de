"""Helix core: max-flow/MILP placement + per-request pipeline scheduling.

A copy of ``repro.core`` (pure Python, numpy and scipy, the GPU-mix planner
included) so the port imports nothing of the JAX package.
"""
from .cluster import (COORDINATOR, DEVICE_PROFILES, LLAMA_30B, LLAMA_70B,
                      ClusterSpec, DeviceProfile, LinkSpec, ModelProfile,
                      NodeSpec, full_mesh_cluster, make_distributed_cluster,
                      make_high_heterogeneity_cluster, make_serving_cluster,
                      make_single_cluster, make_tpu_pod_cluster)
from .graph import (ClusterGraph, build_graph, compute_upper_bound,
                    connection_valid, placement_throughput)
from .maxflow import FlowNetwork, max_flow, preflow_push
from .milp import MILPOptions, PlacementResult, solve_placement
from .mix_planner import (SLO, Bucket, MixPlan, ThroughputTable,
                          TrafficProfile, best_homogeneous, mix_is_feasible,
                          solve_mix)
from .placement import (LayerRange, Placement, disaggregated_placement,
                        petals_placement, separate_pipelines_placement,
                        swarm_placement)
from .planner import Plan, plan, replan_after_failure, reweight_for_straggler
from .scheduler import (IWRR, BaseScheduler, HelixScheduler, KVEstimator,
                        PipelineStage, RandomScheduler, RequestPipeline,
                        SwarmScheduler)
