"""Live autoscaling over the serving runtime (Mélange x Helix, online) —
counterpart of ``repro.serving.autoscaler``.

The mix planner (``core/mix_planner.py``) answers "which cluster should I
rent for THIS traffic"; the :class:`Autoscaler` keeps asking it as traffic
drifts, and applies the answer to a *running* ``ClusterRuntime`` through
the same replan machinery failover uses (``plan()`` + ``apply_plan``):

  scale-up    measured traffic (front-door arrival rate + completed
              (input, output) length pairs) no longer fits the current
              node mix -> solve the cheapest mix that does, grow the
              ``ClusterSpec`` (never shrinking below what is running),
              re-place, ``apply_plan``.  Engines for the new nodes are
              built by the runtime's ``_make_engine``: on the runtime's
              device, or through its engine factory, so a runtime of
              ``spawn_workers`` spawns a worker for each new node.
  scale-down  the mix stays feasible without some node for
              ``patience`` consecutive ticks -> two-phase drain + retire:
              first shift flow away (``reweight_for_straggler`` with a
              ~zero factor: placement unchanged, IWRR weights move), then
              once the node holds no slots, apply a plan without it.
  straggler   a node's measured wall-seconds/token drifts past
              ``straggler_factor`` x the fleet median -> re-run max flow
              with its capacity degraded by the measured ratio and swap
              IWRR weights in place (``reweight_for_straggler``'s first
              real caller) — no engines rebuilt, no requests requeued.

Thread discipline: the autoscaler samples from its own thread (or from
``tick()`` in tests — fully synchronous, no thread needed) but NEVER
mutates the runtime directly; every mutation rides
``ClusterRuntime.call_soon`` onto the loop thread, the same FIFO a
``cancel()`` rides, so plans apply between steps, never during one.

The traffic signal: ``traffic_fn``, or the front door
(``serving.frontend.Frontend``: its ``arrival_rate(window_s)`` and the
completed ``lengths``); passing ``frontend=`` registers the autoscaler as
``frontend.autoscaler``, which ``/healthz`` reports.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.cluster import COORDINATOR, ClusterSpec, DeviceProfile, NodeSpec
from ..core.mix_planner import (SLO, ThroughputTable, TrafficProfile,
                                mix_is_feasible, solve_mix)
from ..core.placement import LayerRange, Placement
from ..core.planner import Plan, plan as plan_cluster, reweight_for_straggler


@dataclasses.dataclass
class AutoscaleEvent:
    t: float                       # runtime clock at decision time
    kind: str                      # scale_up | drain | retire | straggler
    detail: str


class Autoscaler:
    """Samples live serving signals, decides, applies — see module docstring.

    Parameters
    ----------
    runtime, plan : the running ``ClusterRuntime`` and the ``Plan`` it was
        built from (the runtime keeps cluster/placement but not the Plan).
    frontend : optional ``Frontend`` — the arrival-rate / length-pair
        source.  Tests may instead inject
        ``traffic_fn`` returning a ``TrafficProfile`` (or None for "no
        signal yet").
    catalog : device types the autoscaler may rent, name -> profile.
        Defaults to the distinct device types already in the cluster.
    slo, headroom : mix-solver inputs; ``headroom`` over-provisions so a
        marginal drift does not re-trigger every tick.
    patience : consecutive ticks a condition must hold before acting —
        one slow sample must not buy a GPU.
    """

    def __init__(self, runtime, plan: Plan, *, frontend=None,
                 catalog: Optional[Dict[str, DeviceProfile]] = None,
                 slo: SLO = SLO(), headroom: float = 1.2,
                 patience: int = 3, window_s: float = 30.0,
                 hi_occupancy: float = 0.9,
                 straggler_factor: float = 2.0,
                 scale_down_margin: float = 1.5,
                 min_decode_tokens: int = 32,
                 max_nodes: int = 64,
                 prefill_speedup: float = 2.0,
                 traffic_fn: Optional[Callable[[], Optional[TrafficProfile]]]
                 = None,
                 solver: str = "auto"):
        self.rt = runtime
        self.plan = plan
        self.frontend = frontend
        self.slo = slo
        self.headroom = headroom
        self.patience = max(1, patience)
        self.window_s = window_s
        self.hi_occupancy = hi_occupancy
        self.straggler_factor = straggler_factor
        self.scale_down_margin = scale_down_margin
        self.min_decode_tokens = min_decode_tokens
        self.max_nodes = max_nodes
        self.prefill_speedup = prefill_speedup
        self.traffic_fn = traffic_fn
        self.solver = solver
        if catalog is None:
            catalog = {}
            for name, node in runtime.cluster.nodes.items():
                if name != COORDINATOR:
                    catalog.setdefault(node.device.name, node.device)
        self.catalog = catalog
        self.events: List[AutoscaleEvent] = []
        self._over = 0               # consecutive overloaded ticks
        self._under = 0              # consecutive underloaded ticks
        self._slow: Dict[str, int] = {}          # node -> slow-tick streak
        self._reweighted: Dict[str, float] = {}  # node -> applied factor
        self._draining: Optional[str] = None     # node mid drain+retire
        self._node_busy: Dict[str, bool] = {}    # loop-thread probe results
        self._spawned = 0                        # unique-name counter
        self._last_decode: Dict[str, Tuple[float, int]] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if frontend is not None:
            frontend.autoscaler = self

    # -- lifecycle ----------------------------------------------------------
    def start(self, interval_s: float = 5.0) -> None:
        """Sample on a daemon thread every ``interval_s`` until ``stop()``."""
        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception as e:   # a bad tick must not kill sampling
                    self._event("error", repr(e))
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="autoscaler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def describe(self) -> Dict[str, Any]:
        return {
            "nodes": self._counts(),
            "cost_per_hour": round(self.rt.cluster.cost_per_hour(), 4),
            "draining": self._draining,
            "reweighted": dict(self._reweighted),
            "events": [dataclasses.asdict(e) for e in self.events[-8:]],
            "num_events": len(self.events),
        }

    # -- signal gathering ---------------------------------------------------
    def _counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for name, node in self.rt.cluster.nodes.items():
            if name == COORDINATOR:
                continue
            key = node.device.name
            counts[key] = counts.get(key, 0) + 1
        return counts

    def measure_traffic(self) -> Optional[TrafficProfile]:
        """Bucketed live traffic, from the injected ``traffic_fn`` or the
        front door's arrival window + completed length pairs.  None until
        there is enough signal to bucket (no completions yet)."""
        if self.traffic_fn is not None:
            return self.traffic_fn()
        fe = self.frontend
        if fe is None:
            return None
        rate = fe.arrival_rate(self.window_s)
        with fe._lock:
            pairs = list(fe.lengths)
        if rate <= 0 or not pairs:
            return None
        return TrafficProfile.from_requests(pairs, rate)

    def _table(self, traffic: TrafficProfile) -> ThroughputTable:
        return ThroughputTable.profile(
            self.rt.profile, traffic.buckets, sorted(self.catalog),
            slo=self.slo, devices=self.catalog,
            prefill_speedup=self.prefill_speedup)

    # -- the decision loop --------------------------------------------------
    def tick(self) -> Optional[str]:
        """One sampling + decision pass.  Returns the action taken (or
        None) — synchronous and thread-free, so virtual-clock tests drive
        it directly and assert on the result."""
        self._check_stragglers()
        if self._draining is not None:
            return self._continue_retire()
        traffic = self.measure_traffic()
        if traffic is None or traffic.rate_rps <= 0:
            self._over = self._under = 0
            return None
        table = self._table(traffic)
        want = dataclasses.replace(traffic,
                                   rate_rps=traffic.rate_rps * self.headroom,
                                   weights=list(traffic.weights))
        counts = self._counts()
        occ = self.rt.node_occupancy()
        hot = occ and max(occ.values()) >= self.hi_occupancy
        if not mix_is_feasible(table, want, counts) or hot:
            self._under = 0
            self._over += 1
            if self._over >= self.patience:
                self._over = 0
                return self._scale_up(traffic, table, hot=bool(hot))
            return None
        self._over = 0
        victim = self._retirable(table, traffic, counts)
        if victim is not None:
            self._under += 1
            if self._under >= self.patience:
                self._under = 0
                return self._begin_drain(victim)
        else:
            self._under = 0
        return None

    # -- straggler reweighting ----------------------------------------------
    def _decode_rates(self) -> Dict[str, float]:
        """Wall seconds/token per node since the previous tick (nodes that
        decoded fewer than ``min_decode_tokens`` are skipped — a two-token
        sample must not look like a straggler)."""
        out: Dict[str, float] = {}
        for node in list(self.rt.node_decode_tokens):
            s = self.rt.node_decode_s.get(node, 0.0)
            n = self.rt.node_decode_tokens.get(node, 0)
            ps, pn = self._last_decode.get(node, (0.0, 0))
            self._last_decode[node] = (s, n)
            if n - pn >= self.min_decode_tokens:
                out[node] = (s - ps) / (n - pn)
        return out

    def _check_stragglers(self) -> None:
        rates = self._decode_rates()
        if len(rates) < 2:
            return
        med = sorted(rates.values())[len(rates) // 2]
        if med <= 0:
            return
        for node, spt in rates.items():
            if spt > self.straggler_factor * med:
                self._slow[node] = self._slow.get(node, 0) + 1
            else:
                self._slow.pop(node, None)
                if node in self._reweighted:
                    # recovered: restore full capacity in the flow graph
                    self._apply_reweight(node, 1.0, recovered=True)
            if self._slow.get(node, 0) >= self.patience:
                self._slow[node] = 0
                factor = max(med / spt, 0.05)
                if abs(self._reweighted.get(node, 1.0) - factor) > 0.1:
                    self._apply_reweight(node, factor)

    def _apply_reweight(self, node: str, factor: float,
                        recovered: bool = False) -> None:
        base = self.plan
        if factor >= 1.0 - 1e-9:
            # rebuild flows from the undegraded cluster
            p = plan_cluster(base.cluster, base.model,
                             placement=base.placement)
            self._reweighted.pop(node, None)
        else:
            p = reweight_for_straggler(base, node, factor)
            self._reweighted[node] = factor
        self.plan = p
        self.rt.call_soon(lambda: self.rt.apply_plan(p))
        self._event("straggler",
                    f"{node} {'recovered' if recovered else 'degraded'} "
                    f"factor={factor:.3f}")

    # -- scale-up ------------------------------------------------------------
    def _scale_up(self, traffic: TrafficProfile, table: ThroughputTable,
                  hot: bool) -> Optional[str]:
        counts = self._counts()
        mix = solve_mix(self.rt.profile, traffic, sorted(self.catalog),
                        slo=self.slo, headroom=self.headroom,
                        solver=self.solver, table=table)
        target = {g: max(mix.counts.get(g, 0), counts.get(g, 0))
                  for g in set(mix.counts) | set(counts)}
        add = {g: target[g] - counts.get(g, 0)
               for g in target if target[g] > counts.get(g, 0)}
        if not add and hot:
            # the mix says current capacity suffices but pools are pinned
            # hot (e.g. long contexts, not rate): add one of the cheapest
            # type that can hold at least one layer
            g = min((g for g in self.catalog if table.max_layers[g] > 0),
                    key=lambda g: self.catalog[g].cost_per_hour,
                    default=None)
            if g is None:
                return None
            add = {g: 1}
        if not add:
            return None
        total = sum(counts.values()) + sum(add.values())
        if total > self.max_nodes:
            self._event("error", f"scale_up would exceed max_nodes="
                        f"{self.max_nodes} ({total})")
            return None
        cluster = self.rt.cluster
        new_nodes: List[str] = []
        for g in sorted(add):
            for _ in range(add[g]):
                name = f"{g.lower()}-as{self._spawned}"
                self._spawned += 1
                cluster = cluster.add_node(NodeSpec(name, self.catalog[g]))
                new_nodes.append(name)
        p = self._replan_grown(cluster, new_nodes)
        self.plan = p
        self.rt.call_soon(lambda: self.rt.apply_plan(p))
        self._event("scale_up", f"+{add} -> ${cluster.cost_per_hour():.2f}"
                    f"/hr nodes={sorted(new_nodes)}")
        return "scale_up"

    def _replan_grown(self, cluster: ClusterSpec,
                      new_nodes: List[str]) -> Plan:
        """Place the model on the grown cluster.  Preferred: keep every
        incumbent node's layer range untouched (running requests keep
        their pipelines — nothing requeues) and give the new nodes their
        own proportional pipeline over the full model; fall back to a
        fresh MILP solve when the new nodes cannot cover the model alone."""
        model = self.rt.profile
        old = dict(self.plan.placement.assignment)
        caps = {}
        # role-split (disaggregated) placements need the MILP to assign the
        # new nodes roles; the incumbent-preserving shortcut skips them
        ok = not (self.plan.placement.meta or {}).get("roles")
        for n in new_nodes:
            caps[n] = cluster.nodes[n].device.tokens_per_s(
                1, model.flops_per_token_layer)
            if cluster.max_layers_on(n, model) < 1:
                ok = False
        if ok and new_nodes:
            total = sum(caps.values())
            assign = dict(old)
            start = 0
            order = sorted(new_nodes, key=lambda n: -caps[n])
            for i, n in enumerate(order):
                share = (model.num_layers - start) if i == len(order) - 1 \
                    else max(1, round(model.num_layers * caps[n] / total))
                share = min(share, cluster.max_layers_on(n, model),
                            model.num_layers - start)
                if share > 0:
                    assign[n] = LayerRange(start, start + share)
                    start += share
                if start >= model.num_layers:
                    break
            if start >= model.num_layers:
                p = Placement(assign, model.num_layers,
                              meta=dict(self.plan.placement.meta or {}))
                if not p.validate():
                    return plan_cluster(cluster, model, placement=p)
        return plan_cluster(cluster, model)

    # -- scale-down: drain + retire ------------------------------------------
    def _retirable(self, table: ThroughputTable, traffic: TrafficProfile,
                   counts: Dict[str, int]) -> Optional[str]:
        """Most expensive node whose removal keeps the mix feasible at
        ``scale_down_margin`` x the measured traffic (margin ON TOP of the
        solver headroom, so scale-down hysteresis > scale-up threshold and
        the pair cannot oscillate)."""
        want = dataclasses.replace(
            traffic,
            rate_rps=traffic.rate_rps * self.headroom
            * self.scale_down_margin,
            weights=list(traffic.weights))
        names = [n for n in self.rt.cluster.nodes if n != COORDINATOR]
        if len(names) <= 1:
            return None
        for name in sorted(names, key=lambda n:
                           -self.rt.cluster.nodes[n].cost_per_hour):
            dev = self.rt.cluster.nodes[name].device.name
            if dev not in table.rates:
                continue
            fewer = dict(counts)
            fewer[dev] -= 1
            if mix_is_feasible(table, want, fewer):
                return name
        return None

    def _begin_drain(self, node: str) -> Optional[str]:
        """Phase 1: shift flow off the node (placement unchanged, IWRR
        weights re-derived from a near-zero-capacity flow solve) so new
        requests route elsewhere while residents finish."""
        p = reweight_for_straggler(self.plan, node, 1e-3)
        self.plan = p
        self._draining = node
        self._node_busy[node] = True
        self.rt.call_soon(lambda: self.rt.apply_plan(p))
        self._probe_busy(node)
        self._event("drain", f"{node} draining "
                    f"(${self.rt.cluster.nodes[node].cost_per_hour:.2f}/hr)")
        return "drain"

    def _probe_busy(self, node: str) -> None:
        """Ask the loop thread whether any live job still holds a slot on
        ``node`` — jobs are loop-affine, so the probe rides call_soon."""
        def probe():
            self._node_busy[node] = any(
                node in j.slots for j in self.rt.jobs.values())
        self.rt.call_soon(probe)

    def _continue_retire(self) -> Optional[str]:
        node = self._draining
        if self._node_busy.get(node, True):
            self._probe_busy(node)   # still busy: re-probe, wait
            return None
        # Phase 2: node is empty — remove it and re-place.  Seed with the
        # incumbent assignment minus the node so survivors keep their
        # slices when they still cover the model.
        cluster = self.rt.cluster.remove_node(node)
        surviving = {n: r for n, r
                     in self.plan.placement.assignment.items() if n != node}
        model = self.rt.profile
        p = None
        if surviving:
            seed = Placement(surviving, model.num_layers,
                             meta=dict(self.plan.placement.meta or {}))
            if not seed.validate():
                p = plan_cluster(cluster, model, placement=seed)
        if p is None:
            p = plan_cluster(cluster, model)
        self.plan = p
        self._draining = None
        self._node_busy.pop(node, None)
        self._reweighted.pop(node, None)
        self.rt.call_soon(lambda: self.rt.apply_plan(p))
        self._event("retire", f"{node} retired -> "
                    f"${cluster.cost_per_hour():.2f}/hr")
        return "retire"

    # -- misc ----------------------------------------------------------------
    def _event(self, kind: str, detail: str) -> None:
        self.events.append(AutoscaleEvent(t=self.rt.clock(), kind=kind,
                                          detail=detail))
