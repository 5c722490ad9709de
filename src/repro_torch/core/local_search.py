"""Flow-guided local search (FGLS) — beyond-paper placement refinement.

The paper's MILP needs a commercial solver (Gurobi) to close large instances;
HiGHS (our offline substitute) often stalls on the connection-validity
big-M structure.  FGLS is a fast anytime refiner that works directly with the
exact evaluation function (preflow-push max flow on the *full* graph):

  repeat:
    1. evaluate placement, locate the bottleneck (min-capacity layer window
       and saturated nodes/links in the max-flow solution)
    2. propose moves for a few nodes: shift the layer window left/right,
       grow/shrink it (within VRAM), or re-anchor it at the bottleneck
    3. keep the best improving move; stop after ``patience`` non-improving
       rounds

Used as (a) a standalone optimizer, and (b) the incumbent provider that
warm-starts the MILP/LNS (§3.4's heuristic-hint reproduced with a stronger
hint).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Tuple

from .cluster import ClusterSpec, ModelProfile
from .graph import placement_throughput
from .placement import LayerRange, Placement


@dataclasses.dataclass
class FGLSOptions:
    rounds: int = 60
    patience: int = 10
    moves_per_round: int = 24
    partial_inference: bool = True
    param_frac: float = 0.5
    seed: int = 0


def _propose_moves(cluster: ClusterSpec, model: ModelProfile,
                   placement: Placement, node: str, k_max: int,
                   bottleneck_layer: int) -> List[LayerRange]:
    rng = placement.assignment[node]
    L = model.num_layers
    out = []
    n = rng.num_layers
    # shift window
    for delta in (-2, -1, 1, 2):
        s = rng.start + delta
        if 0 <= s and s + n <= L:
            out.append(LayerRange(s, s + n))
    # grow / shrink
    if n + 1 <= k_max and rng.end + 1 <= L:
        out.append(LayerRange(rng.start, rng.end + 1))
    if n + 1 <= k_max and rng.start - 1 >= 0:
        out.append(LayerRange(rng.start - 1, rng.end))
    if n > 1:
        out.append(LayerRange(rng.start, rng.end - 1))
        out.append(LayerRange(rng.start + 1, rng.end))
    # re-anchor at the bottleneck
    s = max(0, min(L - n, bottleneck_layer - n // 2))
    out.append(LayerRange(s, s + n))
    return [r for r in out if r != rng]


def refine_placement(cluster: ClusterSpec, model: ModelProfile,
                     placement: Placement,
                     options: Optional[FGLSOptions] = None
                     ) -> Tuple[Placement, float, List[Dict]]:
    """Refine ``placement``; returns (best placement, throughput, history)."""
    options = options or FGLSOptions()
    rng = random.Random(options.seed)
    k_max = {n: max(1, cluster.max_layers_on(n, model, options.param_frac))
             for n in placement.assignment}

    best = Placement(dict(placement.assignment), placement.num_layers,
                     meta=dict(placement.meta))
    best_val = placement_throughput(cluster, model, best,
                                    options.partial_inference)
    history = [{"round": -1, "throughput": best_val}]
    stale = 0
    nodes = sorted(placement.assignment)

    for rnd in range(options.rounds):
        if stale >= options.patience:
            break
        per_layer = best.layer_compute(cluster, model)
        bottleneck = min(range(len(per_layer)), key=lambda l: per_layer[l])
        # candidate (node, new_range) moves, biased toward low-capacity nodes
        weights = []
        for n in nodes:
            r = best.assignment[n]
            mid = (r.start + r.end) / 2
            dist = abs(mid - bottleneck) + 1
            weights.append(1.0 / dist)
        moves: List[Tuple[str, LayerRange]] = []
        for _ in range(options.moves_per_round):
            node = rng.choices(nodes, weights=weights, k=1)[0]
            props = _propose_moves(cluster, model, best, node, k_max[node],
                                   bottleneck)
            if props:
                moves.append((node, rng.choice(props)))
        improved = False
        for node, new_range in moves:
            trial = dict(best.assignment)
            trial[node] = new_range
            cand = Placement(trial, best.num_layers, meta={"method": "fgls"})
            if cand.validate():
                continue
            val = placement_throughput(cluster, model, cand,
                                       options.partial_inference)
            if val > best_val * (1 + 1e-9):
                best, best_val = cand, val
                improved = True
        history.append({"round": rnd, "throughput": best_val})
        stale = 0 if improved else stale + 1
    best.meta["method"] = f"fgls({placement.meta.get('method', '?')})"
    return best, best_val, history
