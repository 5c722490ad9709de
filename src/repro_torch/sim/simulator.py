"""Event-driven simulator for distributed LLM serving on heterogeneous
clusters (paper §5.1 "Simulator").

Entities:
  * NodeSim  — a compute node: FIFO batch server at the profiled token rate,
    with a KV-cache occupancy model (prompt reserves, decode grows, overshoot
    triggers an offload penalty) mirroring vLLM-style paging behaviour.
  * LinkSim  — a directed network link: serialization at bandwidth + fixed
    propagation latency; FIFO queueing captures congestion (the paper's §5.7
    case study).
  * Simulator — drives request lifecycles: arrival → per-request pipeline
    from a scheduler → prompt pass through stages → autoregressive decode
    passes (chunked by ``decode_chunk`` for speed) → completion.

Pipelined decode mirrors the ClusterRuntime's in-flight window: each pass
is its own ``_Pass`` walking the stages, and with ``max_inflight`` >= 2 the
final stage launches the next chunk straight back to stage 0 while the
produced tokens travel to the coordinator — so the simulator and the real
runtime model the same overlap and stay comparable.  ``max_inflight=1``
(default) reproduces the classic one-outstanding-pass walk exactly.

Speculative decoding mirrors the runtime's draft-model path: with
``spec_tokens`` > 0 each decode pass verifies a window of draft tokens and
confirms the expected accepted prefix (``spec_acceptance`` per-token), so
tokens-per-round-trip scales with draft quality while every stage still
computes — and every link still carries — the full window.

Fault-tolerance hooks: ``fail_node(t, name)`` kills a node mid-run (in-flight
requests restart on a replanned placement), ``slow_node(t, name, factor)``
injects a straggler; both exercise the planner's elastic replanning.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional, Tuple

from ..core.cluster import COORDINATOR, ClusterSpec, ModelProfile
from ..core.placement import Placement
from ..core.scheduler import BaseScheduler, RequestPipeline
from .traces import TraceRequest


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Metrics:
    warmup_s: float
    horizon_s: float
    decoded_tokens: int = 0
    prompt_tokens: int = 0
    completed_requests: int = 0
    prompt_latencies: List[float] = dataclasses.field(default_factory=list)
    decode_latencies: List[float] = dataclasses.field(default_factory=list)
    node_busy_s: Dict[str, float] = dataclasses.field(default_factory=lambda: defaultdict(float))
    link_queue_s: Dict[Tuple[str, str], float] = dataclasses.field(default_factory=lambda: defaultdict(float))
    link_transfers: Dict[Tuple[str, str], int] = dataclasses.field(default_factory=lambda: defaultdict(int))
    link_bytes: Dict[Tuple[str, str], float] = dataclasses.field(default_factory=lambda: defaultdict(float))
    restarts: int = 0
    dropped_requests: int = 0
    # client-cancelled requests (the ``cancel`` hook — parity with
    # ``ClusterRuntime.cancelled_requests``)
    cancelled_requests: int = 0
    # cluster rental price and scale/fault decisions taken during the run
    # (parity with the live Autoscaler's event log)
    cost_per_hour: float = 0.0
    autoscale_events: List[Tuple[float, str, str]] = dataclasses.field(
        default_factory=list)
    # speculative decoding (mirrors ClusterRuntime's counters): drafts
    # proposed / accepted / rejected and verify round-trips completed
    spec_proposed: int = 0
    spec_accepted: int = 0
    spec_rejected: int = 0
    spec_rounds: int = 0
    spec_confirmed: int = 0

    @property
    def spec_acceptance_rate(self) -> float:
        return self.spec_accepted / max(1, self.spec_proposed)

    @property
    def spec_tokens_per_round_trip(self) -> float:
        return self.spec_confirmed / max(1, self.spec_rounds)

    @property
    def measure_window_s(self) -> float:
        return max(1e-9, self.horizon_s - self.warmup_s)

    @property
    def decode_throughput(self) -> float:
        return self.decoded_tokens / self.measure_window_s

    @property
    def processed_throughput(self) -> float:
        """Prompt + decode tokens per second — comparable to the max-flow
        bound, which counts every token passing through the cluster."""
        return (self.decoded_tokens + self.prompt_tokens) / self.measure_window_s

    @property
    def dollars_per_million_tokens(self) -> float:
        """Serving cost at the measured throughput — the mix planner's
        objective expressed per token instead of per hour."""
        tput = self.processed_throughput
        if tput <= 0:
            return float("inf")
        return (self.cost_per_hour / 3600.0) / tput * 1e6

    def _stats(self, xs: List[float]) -> Dict[str, float]:
        if not xs:
            return {"mean": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0}
        s = sorted(xs)
        pick = lambda q: s[min(len(s) - 1, int(q * len(s)))]
        return {"mean": sum(s) / len(s), "p50": pick(0.5), "p90": pick(0.9),
                "p99": pick(0.99)}

    @property
    def prompt_latency(self) -> Dict[str, float]:
        return self._stats(self.prompt_latencies)

    @property
    def decode_latency(self) -> Dict[str, float]:
        return self._stats(self.decode_latencies)

    def node_utilization(self, horizon: Optional[float] = None) -> Dict[str, float]:
        h = horizon or self.horizon_s
        return {n: b / max(h, 1e-9) for n, b in sorted(self.node_busy_s.items())}


# ---------------------------------------------------------------------------
# Servers
# ---------------------------------------------------------------------------

class NodeSim:
    def __init__(self, name: str, rate_tokens_per_s: float,
                 kv_capacity_tokens: float, batch_token_cap: float = 4096,
                 batch_overhead_s: float = 0.015,
                 offload_penalty: float = 0.25):
        self.name = name
        self.rate = rate_tokens_per_s
        self.kv_capacity = kv_capacity_tokens
        self.kv_used = 0.0
        self.batch_token_cap = batch_token_cap
        self.batch_overhead_s = batch_overhead_s
        self.offload_penalty = offload_penalty
        self.pending: deque = deque()   # (work_units, done_cb, pass)
        self.kv_wait: deque = deque()   # (work_units, kv_need, kv_grow,
                                        #  done_cb, pass)
        self.busy_until = 0.0
        self.alive = True
        self.speed_factor = 1.0

    def effective_rate(self) -> float:
        rate = self.rate * self.speed_factor
        if self.kv_capacity > 0 and self.kv_used > self.kv_capacity:
            rate *= self.offload_penalty  # paging to host memory
        return max(rate, 1e-6)


class LinkSim:
    def __init__(self, src: str, dst: str, bandwidth: float, latency: float):
        self.src = src
        self.dst = dst
        self.bandwidth = bandwidth
        self.latency = latency
        self.busy_until = 0.0


# ---------------------------------------------------------------------------
# Request state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _ReqState:
    trace: TraceRequest
    pipeline: RequestPipeline
    arrival_s: float
    decoded: int = 0                 # output tokens confirmed at coordinator
    launched: int = 0                # output tokens covered by passes so far
    inflight: int = 0                # passes launched, not yet confirmed
    in_pipeline: bool = False        # a pass is inside the stages right now
    epoch: int = 0                   # bumped on restart: stale passes die
    first_token_s: Optional[float] = None
    restarted: int = 0
    # disaggregated prefill/decode: the prompt pass walks this pipeline
    # (decode walks ``pipeline``) and the first decode launch waits for
    # ``kv_handoffs`` prefill->decode KV transfers to land
    prefill_pipeline: Optional[RequestPipeline] = None
    prefill_scheduler: Optional[BaseScheduler] = None
    kv_handoffs: int = 0
    kv_need: float = 0.0             # prompt-time KV reservation per node
    # the scheduler that reserved this request's pipeline — reservations
    # must be released on the same estimator even after a replan swap
    scheduler: Optional[BaseScheduler] = None
    # exact KV charged per node so far — released verbatim on completion or
    # restart, so accounting can never drift from the charges
    kv_charged: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Pass:
    """One pipeline pass (the prompt, or one decode chunk) in flight.  With
    ``max_inflight`` >= 2 several passes of one request walk the stages
    concurrently, each carrying its own stage cursor."""
    state: _ReqState
    chunk: int                       # output tokens this pass produces
    start: int                       # output-token offset the chunk covers
    stage_idx: int = 0
    is_prompt: bool = False
    epoch: int = 0
    drafts: int = 0                  # speculative: draft tokens verified
                                     # alongside the confirmed input token


class Simulator:
    def __init__(self, cluster: ClusterSpec, model: ModelProfile,
                 placement: Placement, scheduler: BaseScheduler,
                 *, decode_chunk: int = 4, warmup_s: float = 30.0,
                 horizon_s: float = 600.0, batch_overhead_s: float = 0.015,
                 kv_output_estimate: int = 256,
                 replan_fn: Optional[Callable] = None,
                 max_decode_tokens: Optional[int] = None,
                 max_inflight: int = 1,
                 direct_links: bool = True,
                 prefill_scheduler: Optional[BaseScheduler] = None,
                 spec_tokens: int = 0,
                 spec_acceptance: float = 1.0):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if spec_tokens < 0:
            raise ValueError(f"spec_tokens must be >= 0, got {spec_tokens}")
        if not 0.0 <= spec_acceptance <= 1.0:
            raise ValueError(f"spec_acceptance must be in [0, 1], "
                             f"got {spec_acceptance}")
        self.max_inflight = max_inflight
        # speculative decoding: each decode pass verifies ``spec_tokens``
        # draft tokens alongside the confirmed input token, confirming the
        # expected accepted prefix 1 + sum(acceptance^i) per round-trip.
        # The pass still computes (and ships activations for) the FULL
        # 1 + spec_tokens window — rejected work is the cost of drafting
        self.spec_tokens = spec_tokens
        self.spec_acceptance = spec_acceptance
        # direct_links mirrors the runtime transports: True charges
        # stage->stage traffic on the (src, dst) link; False models the
        # coordinator-star dataflow (src->coordinator then coordinator->dst)
        self.direct_links = direct_links
        # a distinct prefill_scheduler turns on disaggregated mode: prompt
        # passes walk its pipelines, decode walks ``scheduler``'s, and the
        # KV handoff transfer gates the first decode launch
        self.prefill_scheduler = prefill_scheduler
        self.cluster = cluster
        self.model = model
        self.placement = placement
        self.scheduler = scheduler
        self.decode_chunk = decode_chunk
        self.warmup_s = warmup_s
        self.horizon_s = horizon_s
        self.kv_output_estimate = kv_output_estimate
        self.replan_fn = replan_fn
        self.max_decode_tokens = max_decode_tokens
        self.max_schedule_attempts = 20   # 10 s of 0.5 s retries, then drop

        self.nodes: Dict[str, NodeSim] = {}
        for name, rng in placement.assignment.items():
            rate = cluster.node_token_throughput(name, model, rng.num_layers)
            vram = cluster.nodes[name].vram_bytes
            free = max(0.0, vram - rng.num_layers * model.layer_param_bytes)
            # kv_bytes_per_token_layer carries the KV storage dtype: a
            # profile built with kv_dtype="int8" (1-byte pages + amortized
            # absmax scales) roughly doubles every node's token capacity
            # here, matching what serving.kv_pool.pages_for_vram gives the
            # real engines
            per_tok = model.kv_bytes_per_token_layer * rng.num_layers
            kv_cap = free / per_tok if per_tok > 0 else float("inf")
            self.nodes[name] = NodeSim(name, rate, kv_cap,
                                       batch_overhead_s=batch_overhead_s)
        self.links: Dict[Tuple[str, str], LinkSim] = {}
        for (src, dst), spec in cluster.links.items():
            self.links[(src, dst)] = LinkSim(src, dst,
                                             spec.bandwidth_bytes_per_s,
                                             spec.latency_s)

        self.metrics = Metrics(warmup_s=warmup_s, horizon_s=horizon_s,
                               cost_per_hour=cluster.cost_per_hour())
        self._events: List = []
        self._seq = 0
        self._now = 0.0
        self._live: Dict[int, "_ReqState"] = {}  # request_id -> state

    # -- event machinery ----------------------------------------------------
    def _push(self, t: float, fn: Callable, *args) -> None:
        self._seq += 1
        heapq.heappush(self._events, (t, self._seq, fn, args))

    # -- network ------------------------------------------------------------
    def _transfer(self, src: str, dst: str, nbytes: float,
                  deliver: Callable) -> None:
        link = self.links.get((src, dst))
        if link is None:  # same node / missing link: instant
            self._push(self._now, deliver)
            return
        start = max(self._now, link.busy_until)
        queue_delay = start - self._now
        ser = nbytes / link.bandwidth
        link.busy_until = start + ser
        if self._now >= self.warmup_s:
            self.metrics.link_queue_s[(src, dst)] += queue_delay
            self.metrics.link_transfers[(src, dst)] += 1
            self.metrics.link_bytes[(src, dst)] += nbytes
        self._push(link.busy_until + link.latency, deliver)

    def _route_transfer(self, src: str, dst: str, nbytes: float,
                        deliver: Callable) -> None:
        """Node-to-node traffic takes the direct link when direct links
        are on; otherwise it bounces through the coordinator (two
        transfers, both charged), matching ``SocketTransport``'s star
        dataflow."""
        if self.direct_links or COORDINATOR in (src, dst) or src == dst:
            self._transfer(src, dst, nbytes, deliver)
            return
        self._transfer(src, COORDINATOR, nbytes,
                       lambda: self._transfer(COORDINATOR, dst, nbytes,
                                              deliver))

    # -- node batch server ----------------------------------------------------
    def _charge_kv(self, ns: NodeSim, state: "_ReqState",
                   amount: float) -> None:
        if amount > 0:
            ns.kv_used += amount
            state.kv_charged[ns.name] = \
                state.kv_charged.get(ns.name, 0.0) + amount

    def _release_kv(self, state: "_ReqState") -> None:
        """Return every byte-token this request charged, exactly — then wake
        kv-waiters on those nodes.  Without the wakeup, a request whose
        completion freed the capacity a waiter needs would strand it forever
        when no other batch ever lands on that node."""
        touched = list(state.kv_charged)
        for node, amt in state.kv_charged.items():
            ns = self.nodes.get(node)
            if ns is not None:
                ns.kv_used = max(0.0, ns.kv_used - amt)
        state.kv_charged.clear()
        for node in touched:
            self._admit_waiters(node)

    def _admit_waiters(self, node: str) -> None:
        """Admit kv-waiters (front-of-queue order) whose reservation now
        fits, dropping waiters whose request restarted while queued —
        charging those would leak KV the restart's release already cleared."""
        ns = self.nodes.get(node)
        if ns is None or not ns.alive:
            return
        while ns.kv_wait:
            w, need, grow, cb, p = ns.kv_wait[0]
            if p.epoch != p.state.epoch:
                ns.kv_wait.popleft()
                continue
            if ns.kv_used + need > ns.kv_capacity:
                break
            ns.kv_wait.popleft()
            self._charge_kv(ns, p.state, need + grow)
            ns.pending.append((w, cb, p))
        self._kick(node)

    def _enqueue_work(self, node: str, work_units: float, kv_need: float,
                      kv_grow: float, done: Callable, p: "_Pass") -> None:
        ns = self.nodes[node]
        if not ns.alive:
            self._restart_pass(p)
            return
        if kv_need > 0 and ns.kv_used + kv_need > ns.kv_capacity:
            ns.kv_wait.append((work_units, kv_need, kv_grow, done, p))
            return
        self._charge_kv(ns, p.state, kv_need + kv_grow)
        ns.pending.append((work_units, done, p))
        self._kick(node)

    def _kick(self, node: str) -> None:
        ns = self.nodes[node]
        if not ns.alive or not ns.pending or ns.busy_until > self._now:
            return
        batch, tokens = [], 0.0
        while ns.pending and tokens < ns.batch_token_cap:
            w, cb, st = ns.pending.popleft()
            batch.append((cb, st))
            tokens += w
        dur = tokens / ns.effective_rate() + ns.batch_overhead_s
        ns.busy_until = self._now + dur
        if self._now >= self.warmup_s:
            self.metrics.node_busy_s[node] += dur
        self._push(ns.busy_until, self._batch_done, node, batch)

    def _batch_done(self, node: str, batch: List[Tuple]) -> None:
        ns = self.nodes[node]
        if not ns.alive:
            # node died while this batch was in flight: the work is lost,
            # restart the requests instead of stranding their reservations
            for _, p in batch:
                self._restart_pass(p)
            return
        for cb, _ in batch:
            cb()
        self._admit_waiters(node)

    # -- request lifecycle ----------------------------------------------------
    def _arrive(self, req: TraceRequest, restarted: int = 0,
                attempts: int = 0) -> None:
        amount = req.input_tokens + self.kv_output_estimate
        try:
            pipeline = self.scheduler.schedule(prompt_tokens=amount)
        except RuntimeError:
            # no route available (e.g. mid-replan): retry shortly, but cap
            # like _restart does instead of retrying every 0.5 s forever
            if attempts >= self.max_schedule_attempts:
                self.metrics.dropped_requests += 1
                return
            self._push(self._now + 0.5, self._arrive, req, restarted,
                       attempts + 1)
            return
        prefill_pipe = None
        if self.prefill_scheduler is not None:
            try:
                prefill_pipe = self.prefill_scheduler.schedule(
                    prompt_tokens=amount)
            except RuntimeError:
                self.scheduler.finish(pipeline, amount)
                if attempts >= self.max_schedule_attempts:
                    self.metrics.dropped_requests += 1
                    return
                self._push(self._now + 0.5, self._arrive, req, restarted,
                           attempts + 1)
                return
        state = _ReqState(trace=req, pipeline=pipeline, arrival_s=self._now,
                          restarted=restarted, scheduler=self.scheduler,
                          prefill_pipeline=prefill_pipe,
                          prefill_scheduler=(self.prefill_scheduler
                                             if prefill_pipe else None))
        self._live[req.request_id] = state
        # the prompt pass produces (and therefore "launches") the first
        # output token
        state.launched = 1
        state.inflight = 1
        state.in_pipeline = True
        p = _Pass(state, chunk=1, start=0, is_prompt=True, epoch=state.epoch)
        # coordinator -> first stage: token ids
        nbytes = req.input_tokens * self.model.token_bytes
        first = (prefill_pipe or pipeline).stages[0].node
        self._transfer(COORDINATOR, first, nbytes,
                       lambda: self._stage_work(p))

    def _limit(self, state: _ReqState) -> int:
        limit = state.trace.output_tokens
        if self.max_decode_tokens is not None:
            limit = min(limit, self.max_decode_tokens)
        return limit

    def _spec_chunk(self, remaining: int) -> Tuple[int, int]:
        """(expected confirmed tokens, draft count) for one verify pass with
        ``remaining`` output tokens still uncovered.  The accepted-prefix
        length under i.i.d. per-token acceptance ``a`` has expectation
        sum(a^i, i=1..gamma); plus one token the verify pass always
        confirms (the corrected/bonus token)."""
        gamma = max(0, min(self.spec_tokens, remaining - 1))
        expected, run = 1.0, 1.0
        for _ in range(gamma):
            run *= self.spec_acceptance
            expected += run
        return max(1, min(remaining, int(round(expected)))), gamma

    def _pass_tokens(self, p: _Pass) -> int:
        """Tokens this pass actually computes at each stage: a verify pass
        runs the full 1 + drafts window regardless of how many confirm."""
        if p.is_prompt:
            return p.state.trace.input_tokens
        return 1 + p.drafts if p.drafts else p.chunk

    def _pipe(self, p: _Pass) -> RequestPipeline:
        """The pipeline this pass walks: prompt passes walk the prefill
        replica's when disaggregated, everything else walks the decode
        pipeline."""
        if p.is_prompt and p.state.prefill_pipeline is not None:
            return p.state.prefill_pipeline
        return p.state.pipeline

    def _stage_work(self, p: _Pass) -> None:
        """Run this pass's current stage."""
        state = p.state
        if p.epoch != state.epoch:
            return                   # request restarted while we queued
        st = self._pipe(p).stages[p.stage_idx]
        ns = self.nodes.get(st.node)
        if ns is None or not ns.alive:
            self._restart_pass(p)
            return
        held = self.placement.assignment[st.node].num_layers
        frac = st.layers.num_layers / max(held, 1)
        if p.is_prompt:
            tokens = state.trace.input_tokens
            kv_need = tokens + min(self.kv_output_estimate,
                                   state.trace.output_tokens)
            state.kv_need = kv_need
            kv_grow = 0.0
        else:
            tokens = self._pass_tokens(p)
            kv_need = 0.0
            # decode grows KV only by the tokens that exceed the prompt-time
            # reservation (charging the full chunk when the estimate is first
            # crossed overcharged by up to decode_chunk-1 per node)
            reserved = min(self.kv_output_estimate,
                           state.trace.output_tokens)
            kv_grow = float(max(0, p.start + p.chunk
                                - max(reserved, p.start)))
        work = tokens * frac
        self._enqueue_work(st.node, work, kv_need, kv_grow,
                           lambda: self._stage_done(p), p)

    def _stage_done(self, p: _Pass) -> None:
        state = p.state
        if p.epoch != state.epoch:
            return
        pipe = self._pipe(p)
        st = pipe.stages[p.stage_idx]
        last = p.stage_idx == len(pipe.stages) - 1
        if p.is_prompt and state.prefill_pipeline is not None:
            self._fire_handoffs(state, st)
        if not last:
            nxt = pipe.stages[p.stage_idx + 1].node
            nbytes = self._pass_tokens(p) * self.model.activation_bytes
            p.stage_idx += 1
            self._route_transfer(st.node, nxt, nbytes,
                                 lambda: self._stage_work(p))
            return
        # pass complete -> token(s) to coordinator; with window room the
        # next chunk leaves for stage 0 from HERE, overlapping the return
        # hop — the ClusterRuntime's optimistic launch, modelled.  A verify
        # pass returns one greedy token per window position
        state.in_pipeline = False
        nbytes = self.model.token_bytes * (1 if p.is_prompt
                                           else self._pass_tokens(p))
        self._transfer(st.node, COORDINATOR, nbytes,
                       lambda: self._pass_done(p))
        self._launch_from(st.node, state)

    def _launch_from(self, src: str, state: _ReqState) -> None:
        """Launch the next decode pass if the in-flight window has room,
        output tokens remain uncovered, and no pass is inside the stages.
        Decode is autoregressive: a chunk's input token is produced only
        when the previous chunk exits the final stage, so at most ONE pass
        per request walks the pipeline at any time (exactly like the
        ClusterRuntime) — the window only absorbs the coordinator return
        path."""
        limit = self._limit(state)
        if state.kv_handoffs > 0:
            return                   # decode replica's KV still in flight
        if state.in_pipeline or state.inflight >= self.max_inflight \
                or state.launched >= limit:
            return
        if self.spec_tokens > 0:
            chunk, drafts = self._spec_chunk(limit - state.launched)
        else:
            chunk, drafts = min(self.decode_chunk,
                                limit - state.launched), 0
        p = _Pass(state, chunk=chunk, start=state.launched,
                  epoch=state.epoch, drafts=drafts)
        state.launched += chunk
        state.inflight += 1
        state.in_pipeline = True
        # a verify pass ships the confirmed token + every draft downstream
        self._route_transfer(src, state.pipeline.stages[0].node,
                             self.model.token_bytes * self._pass_tokens(p),
                             lambda pp=p: self._stage_work(pp))

    def _fire_handoffs(self, state: _ReqState, st) -> None:
        """Ship this prefill stage's filled KV to every decode stage whose
        layer range overlaps it (skipping mixed nodes, whose KV is already
        home), exactly like the runtime's per-stage handoff — earlier
        stages' transfers overlap later stages' compute."""
        for sd in state.pipeline.stages:
            if sd.node == st.node:
                continue
            lo = max(st.layers.start, sd.layers.start)
            hi = min(st.layers.end, sd.layers.end)
            if hi <= lo:
                continue
            nbytes = (self.model.kv_bytes_per_token_layer
                      * state.trace.input_tokens * (hi - lo))
            state.kv_handoffs += 1
            self._route_transfer(
                st.node, sd.node, nbytes,
                lambda s=state, e=state.epoch: self._handoff_done(s, e))

    def _handoff_done(self, state: _ReqState, epoch: int) -> None:
        if epoch != state.epoch:
            return
        state.kv_handoffs -= 1
        if state.kv_handoffs > 0:
            return
        # all KV landed: occupancy moves to the decode replica — release
        # the prefill-only nodes' charge, charge the decode nodes, and let
        # decode launch (the prompt token may have confirmed while KV was
        # in flight)
        decode_nodes = {sd.node for sd in state.pipeline.stages}
        for node in [n for n in list(state.kv_charged)
                     if n not in decode_nodes]:
            amt = state.kv_charged.pop(node)
            ns = self.nodes.get(node)
            if ns is not None:
                ns.kv_used = max(0.0, ns.kv_used - amt)
                self._admit_waiters(node)
        for node in decode_nodes:
            if node not in state.kv_charged and node in self.nodes:
                self._charge_kv(self.nodes[node], state, state.kv_need)
        self._launch_from(COORDINATOR, state)

    def _pass_done(self, p: _Pass) -> None:
        state = p.state
        if p.epoch != state.epoch:
            return
        state.inflight -= 1
        if p.is_prompt:
            state.first_token_s = self._now
            state.decoded = 1  # prompt pass emits the first output token
            if self._now >= self.warmup_s:
                self.metrics.prompt_latencies.append(
                    self._now - state.arrival_s)
                self.metrics.decoded_tokens += 1
                self.metrics.prompt_tokens += state.trace.input_tokens
        else:
            state.decoded += p.chunk
            if self._now >= self.warmup_s:
                self.metrics.decoded_tokens += p.chunk
                if p.drafts:
                    accepted = p.chunk - 1
                    self.metrics.spec_rounds += 1
                    self.metrics.spec_proposed += p.drafts
                    self.metrics.spec_accepted += accepted
                    self.metrics.spec_rejected += p.drafts - accepted
                    self.metrics.spec_confirmed += p.chunk
        if state.decoded >= self._limit(state):
            self._complete(state)
            return
        # window slack after confirmation (always the case at depth 1):
        # the next pass launches from the coordinator, the classic walk
        self._launch_from(COORDINATOR, state)

    def _complete(self, state: _ReqState) -> None:
        self._live.pop(state.trace.request_id, None)
        if self._now >= self.warmup_s:
            self.metrics.completed_requests += 1
            if state.first_token_s is not None and state.decoded > 1:
                per_tok = (self._now - state.first_token_s) / max(
                    1, state.decoded - 1)
                self.metrics.decode_latencies.append(per_tok)
        self._release_kv(state)
        self._finish_reservation(state)

    def _finish_reservation(self, state: _ReqState) -> None:
        """Release the scheduler's KV reservation with exactly the amount
        ``_arrive`` reserved (input + estimate) — releasing input + decoded
        instead leaks phantom usage whenever decoded < estimate, eventually
        pushing healthy nodes over the estimator's high-water mask.  The
        release goes to the scheduler that *made* the reservation: after a
        replan swap, releasing on the new estimator would erase other
        requests' reservations (per-node clamp at 0)."""
        amount = state.trace.input_tokens + self.kv_output_estimate
        sched = state.scheduler or self.scheduler
        sched.finish(state.pipeline, amount)
        if state.prefill_scheduler is not None \
                and state.prefill_pipeline is not None:
            state.prefill_scheduler.finish(state.prefill_pipeline, amount)

    def _restart_pass(self, p: _Pass) -> None:
        """Restart entry point for per-pass events (dead node, lost batch).
        With several passes of one request in flight, only the FIRST one to
        hit the failure restarts the request — the epoch bump turns the
        rest into no-ops instead of double-restarting."""
        if p.epoch != p.state.epoch:
            return
        self._restart(p.state)

    def _restart(self, state: _ReqState) -> None:
        """Request lost a node mid-flight: restart from the prompt phase on a
        freshly scheduled pipeline (KV on dead node is gone).  The abandoned
        pipeline's node + scheduler KV reservations are released here — the
        surviving nodes would otherwise leak them on every failure."""
        state.epoch += 1             # cancel every in-flight pass
        state.inflight = 0
        state.in_pipeline = False
        state.kv_handoffs = 0        # in-flight handoffs die with the epoch
        # deregister while reservations are released: a cancel landing in
        # the 0.1 s retry gap must not double-release (re-arrival re-registers)
        self._live.pop(state.trace.request_id, None)
        self.metrics.restarts += 1
        state.restarted += 1
        self._release_kv(state)
        self._finish_reservation(state)
        if state.restarted > 5:
            # drop pathological requests (reservations just released) —
            # counted, like the schedule-retry cap, so submitted always
            # reconciles with completed + dropped
            self._live.pop(state.trace.request_id, None)
            self.metrics.dropped_requests += 1
            return
        retry = TraceRequest(state.trace.request_id, self._now,
                             state.trace.input_tokens,
                             max(1, state.trace.output_tokens - state.decoded))
        self._push(self._now + 0.1, self._arrive, retry, state.restarted)

    # -- fault injection -------------------------------------------------------
    def fail_node(self, t: float, name: str) -> None:
        self._push(t, self._do_fail, name)

    def _do_fail(self, name: str) -> None:
        ns = self.nodes.get(name)
        if ns is None:
            return
        ns.alive = False
        # passes queued (or waiting on KV) at the dead node must restart
        # their requests, not silently vanish with reservations held on
        # other nodes
        stranded = [p for (_, _, p) in ns.pending]
        stranded += [p for (*_, p) in ns.kv_wait]
        ns.pending.clear()
        ns.kv_wait.clear()
        self.metrics.autoscale_events.append((self._now, "fail", name))
        if self.replan_fn is not None:
            new_sched, new_placement = self.replan_fn(name)
            self.scheduler = new_sched
            self.placement = new_placement
            for n, rng in new_placement.assignment.items():
                if n in self.nodes and self.nodes[n].alive:
                    self.nodes[n].rate = self.cluster.node_token_throughput(
                        n, self.model, rng.num_layers)
        for p in stranded:
            self._restart_pass(p)

    def slow_node(self, t: float, name: str, factor: float) -> None:
        self._push(t, self._do_slow, name, factor)

    def _do_slow(self, name: str, factor: float) -> None:
        ns = self.nodes.get(name)
        if ns is not None:
            ns.speed_factor = factor
            self.metrics.autoscale_events.append(
                (self._now, "slow", f"{name} x{factor}"))

    def record_autoscale(self, kind: str, detail: str) -> None:
        """Log a scale decision into the metrics (parity with the live
        ``Autoscaler.events`` — a replan_fn that grows or shrinks the
        cluster calls this so sim runs report the same event stream)."""
        self.metrics.autoscale_events.append((self._now, kind, detail))

    def cancel(self, t: float, request_id: int) -> None:
        """Client-disconnect parity hook: tear the request down at ``t``
        exactly as ``ClusterRuntime.cancel`` does — epoch bump (in-flight
        passes and handoffs die), node KV and scheduler reservations
        released — and count it."""
        self._push(t, self._do_cancel, request_id)

    def _do_cancel(self, request_id: int) -> None:
        state = self._live.pop(request_id, None)
        if state is None:
            return                   # finished, dropped, or never arrived
        state.epoch += 1
        state.inflight = 0
        state.in_pipeline = False
        state.kv_handoffs = 0
        self._release_kv(state)
        self._finish_reservation(state)
        self.metrics.cancelled_requests += 1

    # -- main loop ---------------------------------------------------------------
    def run(self, trace: List[TraceRequest]) -> Metrics:
        for req in trace:
            self._push(req.arrival_s, self._arrive, req)
        while self._events:
            t, _, fn, args = heapq.heappop(self._events)
            if t > self.horizon_s:
                break
            self._now = t
            fn(*args)
        self.metrics.horizon_s = min(self.horizon_s, max(self._now,
                                                         self.warmup_s))
        return self.metrics
