"""Paper §4: Helix runtime scheduling — per-request pipelines via IWRR.

Every node (including the coordinator) owns an IWRR instance whose candidates
are the nodes reachable through valid connections and whose weights are the
edge flows from the max-flow solution.  Scheduling a request walks IWRR
instances from the coordinator until the pipeline covers all L layers;
*partial inference* (§3.3) means a stage only infers layers not yet inferred.

KV-cache estimation (§4.2): the scheduler tracks per-node KV usage estimates
and masks out nodes above a high-water mark during IWRR selection.

Baselines (§5.7): Swarm scheduling (next stage chosen with probability
proportional to node throughput) and random scheduling.
"""
from __future__ import annotations

import dataclasses
import random
from collections import defaultdict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .cluster import ClusterSpec, ModelProfile, COORDINATOR
from .graph import ClusterGraph, build_graph, connection_valid
from .placement import LayerRange, Placement


@dataclasses.dataclass(frozen=True)
class PipelineStage:
    node: str
    layers: LayerRange  # layers actually inferred at this stage


@dataclasses.dataclass(frozen=True)
class RequestPipeline:
    stages: Tuple[PipelineStage, ...]

    def validate(self, num_layers: int) -> List[str]:
        problems = []
        cursor = 0
        for st in self.stages:
            if st.layers.start != cursor:
                problems.append(f"stage {st} starts at {st.layers.start}, "
                                f"expected {cursor}")
            cursor = st.layers.end
        if cursor != num_layers:
            problems.append(f"pipeline ends at layer {cursor}, "
                            f"expected {num_layers}")
        return problems

    @property
    def nodes(self) -> Tuple[str, ...]:
        return tuple(s.node for s in self.stages)


class IWRR:
    """Interleaved weighted round-robin [37] over (candidate, weight) pairs.

    Implemented as smooth/interleaved WRR: each query adds ``weight`` to every
    candidate's credit and picks the max-credit unmasked candidate, subtracting
    the total weight — giving interleaving proportional to weights without
    bursts (unlike classic WRR which emits runs of the same candidate).
    """

    def __init__(self, candidates: Sequence[str], weights: Sequence[float]):
        assert len(candidates) == len(weights)
        self.candidates = list(candidates)
        self.weights = [max(0.0, w) for w in weights]
        self.credit = [0.0] * len(candidates)

    def pick(self, masked: Optional[set] = None) -> Optional[str]:
        masked = masked or set()
        total = 0.0
        best_i, best_c = -1, -float("inf")
        for i, (cand, w) in enumerate(zip(self.candidates, self.weights)):
            if w <= 0.0:
                continue
            self.credit[i] += w
            total += w
            if cand in masked:
                continue
            if self.credit[i] > best_c:
                best_c, best_i = self.credit[i], i
        if best_i < 0 or total <= 0.0:
            return None
        self.credit[best_i] -= total
        return self.candidates[best_i]


@dataclasses.dataclass
class KVEstimator:
    """§4.2 scheduler-side KV usage estimate per node.

    ``capacity_tokens[n]`` is how many cached tokens node n can hold (VRAM not
    used by params, divided by per-token KV bytes for the layers it holds).
    ``usage[n]`` is the scheduler's running estimate.
    """

    capacity_tokens: Dict[str, float]
    high_water: float = 0.9
    usage: Dict[str, float] = dataclasses.field(default_factory=lambda: defaultdict(float))

    def masked_nodes(self) -> set:
        return {n for n, cap in self.capacity_tokens.items()
                if cap > 0 and self.usage[n] >= self.high_water * cap}

    def reserve(self, node: str, tokens: float) -> None:
        self.usage[node] += tokens

    def release(self, node: str, tokens: float) -> None:
        self.usage[node] = max(0.0, self.usage[node] - tokens)

    def sync(self, node: str, tokens: float) -> None:
        """Install a node's *measured* KV occupancy (e.g. true ``PagePool``
        usage reported by the serving runtime), replacing the running
        reserve/release estimate — the §4.2 mask then reflects reality
        instead of reservations drifting from actual paged usage."""
        self.usage[node] = max(0.0, tokens)

    @staticmethod
    def from_placement(cluster: ClusterSpec, model: ModelProfile,
                       placement: Placement) -> "KVEstimator":
        caps: Dict[str, float] = {}
        for node, rng in placement.assignment.items():
            vram = cluster.nodes[node].vram_bytes
            free = max(0.0, vram - rng.num_layers * model.layer_param_bytes)
            per_token = model.kv_bytes_per_token_layer * rng.num_layers
            caps[node] = free / per_token if per_token > 0 else float("inf")
        return KVEstimator(capacity_tokens=caps)


class BaseScheduler:
    """Common plumbing: placement + valid-connection topology."""

    def __init__(self, cluster: ClusterSpec, model: ModelProfile,
                 placement: Placement, partial_inference: bool = True,
                 kv_estimator: Optional[KVEstimator] = None):
        self.cluster = cluster
        self.model = model
        self.placement = placement
        self.partial_inference = partial_inference
        self.kv = kv_estimator
        self.graph = build_graph(cluster, model, placement, partial_inference)
        # adjacency in cluster terms
        self.succ: Dict[str, List[str]] = defaultdict(list)
        for (u, v) in self.graph.link_capacity:
            self.succ[u].append(v)
        for u in self.succ:
            self.succ[u].sort()

    # -- pipeline walk -----------------------------------------------------
    def _walk(self, choose) -> RequestPipeline:
        """Walk from coordinator to coordinator, using ``choose(current,
        candidates)`` to pick each hop.  Returns a validated pipeline."""
        L = self.model.num_layers
        stages: List[PipelineStage] = []
        current = COORDINATOR
        inferred = 0
        guard = 0
        while inferred < L:
            guard += 1
            if guard > 10 * len(self.placement.assignment) + 10:
                raise RuntimeError("scheduler failed to build a pipeline "
                                   "(graph may be disconnected)")
            candidates = [v for v in self.succ.get(current, [])
                          if v != COORDINATOR
                          and self.placement.assignment[v].end > inferred
                          and self.placement.assignment[v].start <= inferred]
            nxt = choose(current, candidates)
            if nxt is None:
                raise RuntimeError(f"no candidate from {current} at layer "
                                   f"{inferred}")
            rng = self.placement.assignment[nxt]
            stages.append(PipelineStage(nxt, LayerRange(inferred, rng.end)))
            inferred = rng.end
            current = nxt
        return RequestPipeline(tuple(stages))


class HelixScheduler(BaseScheduler):
    """Max-flow-weighted IWRR per-request pipelines (§4.1)."""

    def __init__(self, cluster: ClusterSpec, model: ModelProfile,
                 placement: Placement, flows: Mapping[Tuple[str, str], float],
                 partial_inference: bool = True,
                 kv_estimator: Optional[KVEstimator] = None):
        super().__init__(cluster, model, placement, partial_inference,
                         kv_estimator)
        self._build_iwrr(flows)

    def _build_iwrr(self, flows: Mapping[Tuple[str, str], float]) -> None:
        """(Re)build per-node IWRR instances from edge flows.  The new table
        is assembled fully before being installed, so concurrent ``schedule``
        calls never observe a half-built state."""
        iwrr: Dict[str, IWRR] = {}
        by_src: Dict[str, List[Tuple[str, float]]] = defaultdict(list)
        for (u, v), f in flows.items():
            if v != COORDINATOR and f > 1e-9:
                by_src[u].append((v, f))
        for u, cands in by_src.items():
            cands.sort()
            iwrr[u] = IWRR([c for c, _ in cands], [w for _, w in cands])
        self.flows = dict(flows)
        self._iwrr = iwrr

    def schedule(self, prompt_tokens: int = 0) -> RequestPipeline:
        masked = self.kv.masked_nodes() if self.kv else set()

        def choose(current: str, candidates: List[str]) -> Optional[str]:
            inst = self._iwrr.get(current)
            if inst is None:
                return None
            # IWRR over flow-positive candidates, skipping KV-masked nodes
            # and nodes that can't continue this request.
            bad = masked | (set(inst.candidates) - set(candidates))
            pick = inst.pick(masked=bad)
            if pick is None and candidates:
                # all flow-candidates masked: fall back to least-loaded valid
                pick = min(candidates,
                           key=lambda n: self.kv.usage[n] / max(self.kv.capacity_tokens.get(n, 1), 1)
                           if self.kv else 0.0)
            return pick

        pipe = self._walk(choose)
        if self.kv and prompt_tokens:
            for st in pipe.stages:
                self.kv.reserve(st.node, prompt_tokens)
        return pipe

    def finish(self, pipeline: RequestPipeline, total_tokens: int) -> None:
        """Release KV reservation when a request completes."""
        if self.kv:
            for st in pipeline.stages:
                self.kv.release(st.node, total_tokens)

    def update_weights(self, flows: Mapping[Tuple[str, str], float]) -> None:
        """Atomically swap IWRR weights (used by elastic replanning) without
        rebuilding the topology graph or the KV estimator."""
        self._build_iwrr(flows)


class SwarmScheduler(BaseScheduler):
    """Baseline: next node chosen with probability proportional to its
    inference throughput (SWARM [31] routing, adapted to inference)."""

    def __init__(self, *args, seed: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self._rng = random.Random(seed)

    def schedule(self, prompt_tokens: int = 0) -> RequestPipeline:
        def choose(current: str, candidates: List[str]) -> Optional[str]:
            if not candidates:
                return None
            weights = [self.graph.node_capacity.get(c, 0.0) + 1e-9
                       for c in candidates]
            return self._rng.choices(candidates, weights=weights, k=1)[0]
        return self._walk(choose)

    def finish(self, pipeline: RequestPipeline, total_tokens: int) -> None:
        pass


class RandomScheduler(BaseScheduler):
    """Baseline: uniformly random next node."""

    def __init__(self, *args, seed: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self._rng = random.Random(seed)

    def schedule(self, prompt_tokens: int = 0) -> RequestPipeline:
        def choose(current: str, candidates: List[str]) -> Optional[str]:
            if not candidates:
                return None
            return self._rng.choice(candidates)
        return self._walk(choose)

    def finish(self, pipeline: RequestPipeline, total_tokens: int) -> None:
        pass
