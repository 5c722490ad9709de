"""ClusterRuntime: execute IWRR pipelines across per-node stage engines —
counterpart of ``repro.serving.runtime`` (the in-process, virtual-clock
path).

The MILP places layer slices on nodes, max-flow IWRR walks per-request
pipelines, and this module runs them: each node owns a stage engine over
its assigned ``LayerRange`` — a ``PagedStageEngine`` (paged mode, the
default) or a dense ``StageEngine`` (``paged=False``, or a slice with no
paged layer) — activations hop between nodes through the
``InProcessTransport``, and every node continuously batches whatever
stage-work (from any request, entering at any layer) is resident each
iteration.  Every node's engine lives on the same device (one card, or the
CPU when asked), as the reference runs every node in one process.

Event loop: a virtual-clock heap of deliveries.  Prefill hops execute inline
as they arrive: in paged mode chunked across stages (chunk n+1 enters
stage 0 as soon as chunk n left it), in dense mode single-shot, one hop per
stage, with a guard that drops a duplicate delivery; decode inputs
accumulate in per-node inboxes and run as batched ``decode_stage`` calls
per node per iteration.

Pipelined decode: each request carries an in-flight window of up to
``max_inflight`` decode passes launched but not yet confirmed.  After
sampling token t the final stage launches the pass for t+1 straight to
stage 0 while token t travels back; the coordinator confirms tokens
strictly in order, applies the stop rules (eos / max_new_tokens / max_len)
and cancels in-flight passes on completion or preemption by bumping the job
epoch, which every delivery checks.  Launching reserves KV for the new
position on every stage node up front.  ``max_inflight=1`` is the classic
one-outstanding-token walk.

Speculative decoding (``draft_cfg`` / ``draft_params`` / ``spec_tokens``):
a draft model sharing the target's vocab lives at the coordinator (a dense
full-model ``StageEngine``).  Each round the draft proposes γ tokens; the
target verifies all γ+1 positions in one pass through the decode pipeline
(the stage engines run it as position-ordered sub-batches), the final stage
returns the greedy argmax vector, and the coordinator accepts the longest
matching draft prefix, confirms it in order (plus the bonus token), and on
the first mismatch bumps the job epoch and rolls every stage node back to
the accepted prefix.  Greedy speculative output equals non-speculative
greedy output for any draft.  Speculation needs ``temperature <= 0``; a
request that finds the draft's slots full serves non-speculatively.  A spec
job keeps one verify pass in flight and launches only from the coordinator.

Telemetry: ``tokens_produced``, ``completed``, ``cancelled_inflight``
(in-flight passes an early stop or a rejected verify cancelled), the spec
counters, and ``mean_decode_latency`` — the mean per-token decode latency
on the virtual clock, which advances only by the transport's modelled link
delays (``InProcessTransport``: per-link latency plus bytes over
bandwidth, and two hops per stage-to-stage send in the star topology), not
by compute.

Disaggregated prefill/decode: a placement whose ``meta["roles"]`` splits
the nodes into prefill and decode replica groups (``core.placement.
disaggregated_placement``) gets one IWRR scheduler per role.  Each job
compiles a ``Route`` at every (re)admission: prompt passes walk the prefill
pipeline, decode passes the decode pipeline, and each prefill stage ships
the KV of the layers a decode node reads (``export_kv`` / ``import_kv``)
once its final chunk lands — a ``mixed`` node's KV stays home.  Decode
launches wait until every handoff of the job has been imported
(``kv_pending``), and prefill-only nodes free the job's slot once their
handoffs have landed.  The handoff's link bytes are the profile's KV bytes
per token and layer x tokens x layers.

Memory: admission takes a slot and the prompt's pages on every node of the
route up front (prefill nodes first; a dense engine's rectangle is
reserved at construction); completion and preemption release KV on every
node still held.  When a pool runs dry mid-decode the newest resident
request is preempted pipeline-wide (recompute-on-readmit keeps its
generated tokens).

Failover: ``fail_node`` drops a node's engine and requeues every request
whose route crossed it (its KV on survivors released); ``apply_plan``
adopts a replanned placement (``core.planner.replan_after_failure``),
rebuilding the engines whose slice changed and the role schedulers, and
readmitted requests re-prefill their prompt and generated tokens.

Scheduler feedback: after every iteration each node's true pool occupancy
is written into its role scheduler's ``KVEstimator`` (``_sync_kv``), and
real pool capacities are installed at startup and after ``apply_plan``.

Not ported yet (the arguments raise; ROADMAP queue 1): int8 KV pools
(item 1), cancellation and the autoscaler (item 5), the wall-clock
(realtime) loop, socket transports, workers and worker-to-worker pushes
(item 6), and models that are not all-paged (item 7).  Nor are the
reference's guards against a transport that delivers a payload twice, but
for the dense prefill's and the KV handoff's (item 6): the in-process
transport delivers each payload once (it may reorder them: prefill chunks
then wait for their predecessors, decode tokens in the coordinator's
inbox).
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict, deque
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..configs.base import ModelConfig
from ..core.cluster import COORDINATOR
from ..core.placement import LayerRange, Placement
from ..core.planner import plan as make_plan
from ..models.common import resolve_device
from ..models.paged import all_blocks_paged
from ..models.stage import stage_num_paged_layers
from .engine import EngineConfig, Request
from .kv_pool import full_rectangle_pages, pages_for_vram
from .stage_engine import DecodeItem, PagedStageEngine, StageEngine


class InProcessTransport:
    """Same-process transport: payloads are handed over by reference after
    a modelled link delay (``delay``: the link's latency plus nbytes over
    the bandwidth), on the runtime's virtual clock (the runtime binds
    ``schedule(delay_s, fn)`` at construction).

    ``direct_links`` (the default) models routed worker-to-worker links: a
    stage->stage send costs one (src, dst) hop.  With
    ``direct_links=False`` it models the coordinator-mediated star: every
    stage->stage send is charged as two hops, (src, COORDINATOR) then
    (COORDINATOR, dst), with both link delays paid back to back.  The
    per-(src, dst) hop and byte counters follow the physical route either
    way."""

    def __init__(self, default_delay_s: float = 0.0,
                 link_delay_s: Optional[Mapping[Tuple[str, str],
                                                float]] = None,
                 bandwidth_bytes_per_s: float = 0.0, *,
                 direct_links: bool = True):
        self.default_delay_s = default_delay_s
        self.link_delay_s = dict(link_delay_s or {})
        self.bandwidth = bandwidth_bytes_per_s
        self.direct_links = direct_links
        self.transfers: Dict[Tuple[str, str], int] = defaultdict(int)
        self.bytes_sent: Dict[Tuple[str, str], float] = defaultdict(float)
        # runtime-maintained one-liners appended to describe() (the
        # speculation counters)
        self.annotations: Dict[str, str] = {}

    def bind(self, schedule: Callable[[float, Callable[[], None]], None]
             ) -> None:
        self._schedule = schedule

    def delay(self, src: str, dst: str, nbytes: float) -> float:
        d = self.link_delay_s.get((src, dst), self.default_delay_s)
        if self.bandwidth > 0:
            d += nbytes / self.bandwidth
        return d

    def _count(self, src: str, dst: str, nbytes: float) -> None:
        self.transfers[(src, dst)] += 1
        self.bytes_sent[(src, dst)] += nbytes

    def send(self, src: str, dst: str, payload: Any, nbytes: float,
             deliver: Callable[[Any], None]) -> None:
        if self.direct_links or COORDINATOR in (src, dst):
            self._count(src, dst, nbytes)
            self._schedule(self.delay(src, dst, nbytes),
                           lambda: deliver(payload))
            return
        # star route: src -> coordinator -> dst
        self._count(src, COORDINATOR, nbytes)
        self._count(COORDINATOR, dst, nbytes)
        d = (self.delay(src, COORDINATOR, nbytes)
             + self.delay(COORDINATOR, dst, nbytes))
        self._schedule(d, lambda: deliver(payload))

    def describe(self) -> str:
        frags = [f"{s}->{d}={n}/{self.bytes_sent[(s, d)]:.0f}B"
                 for (s, d), n in sorted(self.transfers.items())]
        mode = "direct" if self.direct_links else "star"
        extra = "".join(f" {v}" for _, v in sorted(self.annotations.items()))
        return f"hops[{mode}: " + ", ".join(frags) + "]" + extra


@dataclasses.dataclass
class Route:
    """A job's compiled dataflow: the pipeline that runs its prompt passes,
    the one that runs its decode passes, and the KV handoffs bridging the
    two replica groups.  For a placement without roles prefill and decode
    are the same pipeline and there is no handoff.  Routes are compiled at
    every (re)admission, so failover replans rebuild them for free.

    ``handoffs`` maps a prefill stage index to the ``(decode node, global
    layers)`` exports due once that stage's final prompt chunk lands —
    layers are matched by global index, so any pair of prefill and decode
    layer splits composes."""

    prefill: Any                      # RequestPipeline for prompt passes
    decode: Any                       # RequestPipeline for decode passes
    handoffs: Dict[int, List[Tuple[str, List[int]]]] = \
        dataclasses.field(default_factory=dict)

    @property
    def disaggregated(self) -> bool:
        return self.prefill is not self.decode

    @property
    def nodes(self) -> set:
        return ({st.node for st in self.prefill.stages}
                | {st.node for st in self.decode.stages})


@dataclasses.dataclass
class _Job:
    req: Request
    pipe: Any = None                 # decode RequestPipeline (== route.decode)
    route: Optional[Route] = None    # compiled dataflow (kept across preempt)
    kv_pending: set = dataclasses.field(default_factory=set)
                                     # (prefill stage idx, decode node) KV
                                     # handoffs not yet imported: decode
                                     # cannot launch until this empties
    slots: Dict[str, int] = dataclasses.field(default_factory=dict)
    pos: int = 0                     # tokens confirmed resident in caches
    epoch: int = 0                   # bumped on preempt/requeue/complete:
                                     # stale in-flight messages die
    seq: int = -1                    # admission order (preemption victims)
    # -- in-flight decode window (reset on every (re)admission) ----------
    next_j: int = 0                  # output index the next launched pass
                                     # will produce
    next_pos: int = 0                # cache position of the next pass
    inbox: Dict[int, int] = dataclasses.field(default_factory=dict)
                                     # out-of-order sampled tokens by index
    seen: set = dataclasses.field(default_factory=set)
                                     # dedup keys of deliveries already run
    hop_next: Dict[int, int] = dataclasses.field(default_factory=dict)
                                     # per-stage next expected chunk offset
    hop_stash: Dict[int, Dict[int, Any]] = dataclasses.field(
        default_factory=dict)        # chunks that overtook a predecessor
    # -- speculative decoding (draft model) -------------------------------
    draft_slot: Optional[int] = None  # coordinator draft-engine slot
    draft_pos: int = 0               # next draft row to feed (rows below
                                     # hold tokens the draft has consumed)
    spec_drafts: List[int] = dataclasses.field(default_factory=list)
                                     # γ proposals of the in-flight verify
    spec_base: int = 0               # cache position of the verify pass

    @property
    def resumed(self) -> bool:
        return bool(self.req.output)

    @property
    def inflight(self) -> int:
        """Decode passes launched whose token the coordinator has not yet
        confirmed."""
        return self.next_j - len(self.req.output)


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"(ROADMAP queue 1 item {item})")


class ClusterRuntime:
    """Orchestrates one stage engine per placed node (see the module
    docstring).

    ``plan`` is a ``repro_torch.core.planner.Plan``; engines are built from
    its placement on ``device``.  Paged engines get pools sized from each
    node's own VRAM (capped at the full rectangle, floored at one max_len
    request) unless ``pool_pages`` names a node's page count.
    """

    def __init__(self, cfg: ModelConfig, params, plan,
                 engine_cfg: EngineConfig, *, paged: bool = True,
                 page_size: int = 16, kv_dtype: Optional[str] = None,
                 pool_pages: Optional[Mapping[str, int]] = None,
                 transport: Optional[InProcessTransport] = None,
                 rng_seed: int = 0, max_inflight: int = 1, device="cuda",
                 engine_factory=None,
                 draft_cfg: Optional[ModelConfig] = None, draft_params=None,
                 spec_tokens: int = 4, realtime: Optional[bool] = None):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if kv_dtype == "int8":
            raise _not_ported("int8 KV serving", 1)
        if realtime:
            raise _not_ported("the wall-clock loop", 6)
        if engine_factory is not None:
            raise _not_ported("engine factories (remote workers)", 6)
        if not all_blocks_paged(cfg):
            raise _not_ported(f"serving {cfg.name} (not all-paged)", 7)
        self.cfg = cfg
        self.params = params
        self.ec = engine_cfg
        self.device = resolve_device(device)
        self.max_inflight = max_inflight
        self.paged = paged
        self.page_size = page_size
        self.pool_pages = dict(pool_pages or {})
        self.rng_seed = rng_seed
        self.cluster = plan.cluster
        self.placement = plan.placement
        self.profile = plan.model
        if plan.model.num_layers != cfg.num_layers:
            raise ValueError(f"plan covers {plan.model.num_layers} layers; "
                             f"{cfg.name} has {cfg.num_layers}")
        self._build_role_schedulers(plan)
        self.transport = transport or InProcessTransport()
        self.transport.bind(lambda d, fn: self._push(self._now + d, fn))

        # -- speculative decoding: coordinator-side draft model ----------
        self.spec_tokens = spec_tokens
        self.draft_cfg = draft_cfg
        self.draft = None
        if draft_cfg is not None:
            if draft_params is None:
                raise ValueError("draft_cfg given without draft_params")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft {draft_cfg.name} vocab {draft_cfg.vocab_size} "
                    f"!= target {cfg.name} vocab {cfg.vocab_size}")
            if spec_tokens < 1:
                raise ValueError(
                    f"spec_tokens must be >= 1, got {spec_tokens}")
            # a full model at the coordinator; dense positional caches make
            # rejected speculative rows free to overwrite, and sharing
            # engine_cfg keeps its slot and row budgets the target's
            self.draft = StageEngine(draft_cfg, draft_params,
                                     LayerRange(0, draft_cfg.num_layers),
                                     engine_cfg, rng_seed=rng_seed,
                                     device=self.device)
        self.spec_proposed = 0       # draft tokens sent to verification
        self.spec_accepted = 0       # draft tokens matching target greedy
        self.spec_rejected = 0       # draft tokens rolled back
        self.spec_rounds = 0         # verify round trips
        self.spec_confirmed = 0      # tokens confirmed by verify rounds
                                     # (accepted prefix + 1 per round)

        self.engines: Dict[str, Any] = {}
        for node, rng in sorted(self.placement.assignment.items()):
            self.engines[node] = self._make_engine(node, rng)
        self._sync_kv(capacities=True)

        self.queue: deque = deque()      # _Job awaiting admission
        self.jobs: Dict[int, _Job] = {}  # request_id -> active job
        self._ready: Dict[str, List[dict]] = defaultdict(list)
        self._events: List = []
        self._eseq = 0
        self._jseq = 0
        self._now = 0.0
        self.tokens_produced = 0
        self.completed = 0
        # in-flight passes cancelled by an early stop (eos/length) or a
        # rejected verify round
        self.cancelled_inflight = 0
        # request_id -> the pipeline it was (last) served on
        self.served: Dict[int, Any] = {}
        # virtual-clock latency: first-token confirm time, and mean
        # per-token decode latency recorded at completion
        self._vfirst: Dict[int, float] = {}
        self.decode_latencies: Dict[int, float] = {}

    # -- engine construction ------------------------------------------------
    def _pool_pages(self, node: str, rng: LayerRange) -> int:
        """Pool size for a node's slice."""
        if node in self.pool_pages:
            return self.pool_pages[node]
        n_paged = stage_num_paged_layers(self.cfg, rng)
        rect = full_rectangle_pages(self.cfg, max_batch=self.ec.max_batch,
                                    max_len=self.ec.max_len,
                                    page_size=self.page_size,
                                    paged_layers=n_paged)
        pages = pages_for_vram(self.cfg, self.cluster.nodes[node].vram_bytes,
                               page_size=self.page_size,
                               layers_on_node=rng.num_layers, max_pages=rect)
        # floor: one full-budget request must always fit
        blocks = -(-self.ec.max_len // self.page_size)
        return max(pages, 1 + blocks * n_paged)

    def _make_engine(self, node: str, rng: LayerRange):
        """A dense ``StageEngine`` when the runtime is dense or the slice has
        no paged layer, else a ``PagedStageEngine`` with its pool."""
        if not self.paged or stage_num_paged_layers(self.cfg, rng) == 0:
            return StageEngine(self.cfg, self.params, rng, self.ec,
                               rng_seed=self.rng_seed, device=self.device)
        return PagedStageEngine(self.cfg, self.params, rng, self.ec,
                                num_pages=self._pool_pages(node, rng),
                                page_size=self.page_size,
                                rng_seed=self.rng_seed, device=self.device)

    # -- role schedulers (disaggregated prefill/decode) -----------------------
    def _build_role_schedulers(self, plan) -> None:
        """Install the IWRR scheduler(s).  A placement whose roles
        (``meta["roles"]``: node -> prefill | decode | mixed) form distinct
        prefill and decode groups gets a scheduler per role over the role's
        sub-placement (max-flow on the role's subgraph, KV estimation over
        its nodes); otherwise one scheduler serves both."""
        roles = (plan.placement.meta or {}).get("roles") or {}
        pre = {n for n, r in roles.items() if r in ("prefill", "mixed")}
        dec = {n for n, r in roles.items() if r in ("decode", "mixed")}
        if not (pre and dec) or pre == dec:
            self.scheduler = plan.make_scheduler()
            self.sched_prefill = self.scheduler
            return

        def sub(nodes: set):
            p = Placement({n: plan.placement.assignment[n] for n in nodes},
                          plan.placement.num_layers,
                          meta=dict(plan.placement.meta))
            bad = p.validate()
            if bad:
                raise ValueError(
                    f"role group {sorted(nodes)} does not cover the model "
                    f"on its own: {bad}")
            return make_plan(plan.cluster, plan.model, placement=p)

        self.scheduler = sub(dec).make_scheduler()
        self.sched_prefill = sub(pre).make_scheduler()

    @property
    def disaggregated(self) -> bool:
        return self.sched_prefill is not self.scheduler

    # -- event machinery ----------------------------------------------------
    def _push(self, t: float, fn: Callable[[], None]) -> None:
        self._eseq += 1
        heapq.heappush(self._events, (t, self._eseq, fn))

    def _send(self, src: str, dst: str, payload, nbytes: float,
              deliver: Callable[[Any], None]) -> None:
        self.transport.send(src, dst, payload, nbytes, deliver)

    def _act_bytes(self, n_tokens: int) -> float:
        elt = {"bfloat16": 2, "float32": 4}[self.cfg.param_dtype]
        return float(n_tokens * self.cfg.d_model * elt)

    def _kv_bytes(self, tokens: int, n_layers: int) -> float:
        return float(self.profile.kv_bytes_per_token_layer
                     * tokens * n_layers)

    # -- public API ---------------------------------------------------------
    def clock(self) -> float:
        """Seconds on the runtime's virtual event clock; every per-request
        timestamp is stamped from here."""
        return self._now

    def submit(self, req: Request) -> None:
        """Queue a request.  Raises ``ValueError`` for requests that could
        never serve."""
        if len(req.prompt) == 0:
            raise ValueError("empty prompt")
        if len(req.prompt) > self.ec.max_len:
            raise ValueError(f"prompt of {len(req.prompt)} tokens exceeds "
                             f"max_len {self.ec.max_len}; refusing to "
                             "truncate")
        if req.temperature > 0 and self.draft is not None:
            raise ValueError(
                f"temperature {req.temperature} > 0 is incompatible with "
                f"speculative decoding (spec_tokens={self.spec_tokens}): "
                "verification accepts draft tokens by greedy argmax, so "
                "sampled acceptance would change the output distribution; "
                "serve sampled requests on a runtime without a draft model")
        req.submitted_s = self.clock()
        self.queue.append(_Job(req))

    def _idle(self) -> bool:
        return not (self.queue or self.jobs or self._events or self._ready)

    def run_until_done(self, max_iters: int = 100000) -> None:
        for _ in range(max_iters):
            if self._idle():
                return
            if self.step():
                continue
            raise RuntimeError(
                "runtime stalled: queued requests cannot be admitted "
                "(cluster slots/pools too small?); " + self._state())
        if self._idle():
            return                   # finished exactly on the last step
        raise RuntimeError(
            f"not done after {max_iters} iterations; " + self._state())

    def _state(self) -> str:
        """Queue / in-flight diagnostics for stall and iteration-budget
        errors."""
        windows = {j.req.request_id: f"{len(j.req.output)}+{j.inflight}"
                   for j in self.jobs.values()}
        ready = {n: len(v) for n, v in self._ready.items() if v}
        return (f"queued={len(self.queue)} "
                f"in_flight(confirmed+window)={windows} "
                f"pending_events={len(self._events)} ready={ready} "
                f"now={self._now:.6f} transport={self.transport.describe()}")

    def step(self) -> bool:
        """One runtime iteration: admit, drain deliveries due now, then one
        batched decode per node with resident stage-work.  Returns whether
        anything progressed."""
        progressed = self._admit()
        if self._events:
            self._now = max(self._now, self._events[0][0])
            while self._events and self._events[0][0] <= self._now + 1e-12:
                _, _, fn = heapq.heappop(self._events)
                fn()
                progressed = True
        for node in [n for n, v in self._ready.items() if v]:
            work = self._ready.pop(node)
            work = [w for w in work if w["job"].epoch == w["epoch"]]
            if work:
                self._decode_node(node, work)
                progressed = True
        self._sync_kv()
        return progressed

    # -- KV feedback --------------------------------------------------------
    def _sync_kv(self, capacities: bool = False) -> None:
        scheds = [self.scheduler]
        if self.sched_prefill is not self.scheduler:
            scheds.append(self.sched_prefill)
        for sched in scheds:
            kv = sched.kv
            if kv is None:
                continue
            for node, eng in self.engines.items():
                if node not in kv.capacity_tokens:
                    continue             # the other role group's node
                if capacities:
                    kv.capacity_tokens[node] = float(
                        eng.kv_tokens_capacity())
                kv.sync(node, float(eng.kv_tokens_used()))

    # -- admission ----------------------------------------------------------
    def _prefill_tokens(self, job: _Job) -> np.ndarray:
        """Tokens to prefill: the prompt, plus — after preemption — all
        generated output but the last token (recompute; the last token
        restarts decode)."""
        prompt = np.asarray(job.req.prompt, np.int32)
        if len(job.req.output) > 1:
            prompt = np.concatenate(
                [prompt, np.asarray(job.req.output[:-1], np.int32)])
        return prompt

    def _compile_route(self, job: _Job) -> None:
        """Compile the job's dataflow.  Disaggregated placements schedule a
        pipeline per role and derive the KV handoffs bridging them (decode
        layer l ships from the prefill stage that computed l, unless the
        same node plays both parts and the KV is already home)."""
        if not self.disaggregated:
            pipe = self.scheduler.schedule()
            job.route = Route(prefill=pipe, decode=pipe)
            job.pipe = pipe
            return
        d = self.scheduler.schedule()
        p = self.sched_prefill.schedule()
        handoffs: Dict[int, List[Tuple[str, List[int]]]] = {}
        for sd in d.stages:
            for si, sp in enumerate(p.stages):
                if sp.node == sd.node:
                    continue            # mixed node: KV stays in its slot
                common = [l for l in range(sd.layers.start, sd.layers.end)
                          if sp.layers.start <= l < sp.layers.end]
                if common:
                    handoffs.setdefault(si, []).append((sd.node, common))
        job.route = Route(prefill=p, decode=d, handoffs=handoffs)
        job.pipe = d

    def _admit(self) -> bool:
        progressed = False
        while self.queue:
            job = self.queue[0]
            if job.route is None:
                try:
                    self._compile_route(job)
                except RuntimeError:
                    break               # no route (mid-replan): wait
            S = len(self._prefill_tokens(job))
            need = min(S + 1, self.ec.max_len)
            # a slot on every node of the route, prefill nodes first (the
            # order fixes the slot ids)
            nodes = dict.fromkeys(st.node for st in (
                *job.route.prefill.stages, *job.route.decode.stages))
            taken: List[Tuple[str, int]] = []
            ok = True
            for node in nodes:
                eng = self.engines.get(node)
                slot = eng.alloc_slot(job.req.request_id) if eng else None
                if slot is None or not eng.ensure(slot, need):
                    if slot is not None:
                        eng.free_slot(slot)
                    ok = False
                    break
                taken.append((node, slot))
            if not ok:
                for node, slot in taken:
                    self.engines[node].release(slot)
                break                   # FIFO: wait for running work to free
            self.queue.popleft()
            job.slots = dict(taken)
            job.pos = S
            job.kv_pending = {(si, dst)
                              for si, hs in job.route.handoffs.items()
                              for dst, _ in hs}
            # open the in-flight window: the first decode pass consumes the
            # last known token at position S and produces output index
            # ``next_j`` (a fresh request's prefill token is index 0)
            job.next_j = len(job.req.output) if job.resumed else 1
            job.next_pos = S
            job.inbox = {}
            job.seen = set()
            job.hop_next = {}
            job.hop_stash = {}
            # speculation: take a draft slot and prefill the draft with the
            # tokens the target sees; greedy only — sampled requests (and
            # requests that find the draft full) serve non-speculatively
            job.draft_slot = None
            job.draft_pos = 0
            if self.draft is not None and job.req.temperature <= 0:
                dslot = self.draft.alloc_slot(job.req.request_id)
                if dslot is not None:
                    self.draft.prefill_stage(dslot,
                                             self._prefill_tokens(job), 0)
                    job.draft_slot = dslot
                    job.draft_pos = job.pos
            job.seq = self._jseq
            self._jseq += 1
            self.jobs[job.req.request_id] = job
            self.served[job.req.request_id] = job.pipe
            if self.paged:      # chunked prefill (all-paged stacks)
                self._send_chunk(job, 0)
            else:
                tokens = self._prefill_tokens(job)
                self._send(COORDINATOR, job.route.prefill.stages[0].node,
                           tokens, len(tokens) * self.profile.token_bytes,
                           self._hop(job, 0, None))
            progressed = True
        return progressed

    def _send_chunk(self, job: _Job, off: int) -> None:
        """Send the prompt chunk starting at ``off`` to prefill stage 0."""
        tokens = self._prefill_tokens(job)
        chunk = tokens[off:off + max(1, self.ec.prompt_len)]
        self._send(COORDINATOR, job.route.prefill.stages[0].node, chunk,
                   len(chunk) * self.profile.token_bytes,
                   self._hop(job, 0, off))

    # -- prefill hops -------------------------------------------------------
    def _hop(self, job: _Job, si: int, off: Optional[int]
             ) -> Callable[[Any], None]:
        """Delivery of a prefill payload to stage ``si``: the whole prompt
        (``off=None``, dense), which runs once per stage — a duplicate
        delivery is dropped — or the chunk at ``off`` (paged).  Chunks run
        strictly in offset order per stage: with a bandwidth term a smaller
        chunk's link delay is shorter, so it can overtake its predecessor,
        and then waits for it."""
        epoch = job.epoch

        def deliver(x):
            if job.epoch != epoch:
                return               # preempted/requeued mid-flight
            if off is None:
                if ("pf", si) in job.seen:
                    return
                job.seen.add(("pf", si))
                self._prefill_exec(job, epoch, si, x, None)
                return
            stash = job.hop_stash.setdefault(si, {})
            stash[off] = x
            while job.epoch == epoch and job.hop_next.get(si, 0) in stash:
                nxt = job.hop_next.get(si, 0)
                self._prefill_exec(job, epoch, si, stash.pop(nxt), nxt)
        return deliver

    def _prefill_exec(self, job: _Job, epoch: int, si: int, x,
                      off: Optional[int]) -> None:
        stages = job.route.prefill.stages
        st = stages[si]
        eng = self.engines[st.node]
        slot = job.slots[st.node]
        last = si == len(stages) - 1
        if off is None:
            n_tok = job.pos
            out = eng.prefill_stage(slot, x, st.layers.start)
        else:
            n_tok = min(max(1, self.ec.prompt_len), job.pos - off)
            out = eng.prefill_chunk(slot, x, st.layers.start, off)
            job.hop_next[si] = off + n_tok
        if not last:
            self._send(st.node, stages[si + 1].node, out,
                       self._act_bytes(n_tok), self._hop(job, si + 1, off))
        if off is not None and si == 0 and off + n_tok < job.pos:
            # stage 0 freed: stream the next chunk in behind this one
            self._send_chunk(job, off + n_tok)
        stage_done = off is None or off + n_tok >= job.pos
        if stage_done:
            # this stage's KV is complete: ship it to the decode node(s)
            # that read these layers (disaggregated placements only)
            for dst, lays in job.route.handoffs.get(si, []):
                self._start_handoff(job, epoch, si, dst, lays)
        if last and stage_done:
            # final chunk left the final stage: out is last-token logits
            if job.resumed:
                tok = job.req.output[-1]      # sampled before eviction
            else:
                tok = eng.sample(out, job.req.temperature)
            self._send(st.node, COORDINATOR, tok, self.profile.token_bytes,
                       lambda t: self._on_first_token(job, epoch, t))
            # at depth >= 2 decode starts here — the first pass leaves for
            # stage 0 while the prefill token travels to the coordinator;
            # depth 1 always waits for the coordinator
            if self.max_inflight > 1:
                self._maybe_launch(job, st.node, int(tok), job.next_j)

    # -- KV handoff (disaggregated prefill -> decode) ------------------------
    def _start_handoff(self, job: _Job, epoch: int, si: int, dst: str,
                       layers: List[int]) -> None:
        """Ship one prefill stage's filled KV (prompt tokens x ``layers``)
        to a decode node; the decode launch stays gated on
        ``kv_pending`` until it lands."""
        st = job.route.prefill.stages[si]
        payload = self.engines[st.node].export_kv(job.slots[st.node],
                                                  job.pos, layers)
        self._send(st.node, dst, payload, self._kv_bytes(job.pos,
                                                         len(layers)),
                   lambda p, jb=job, e=epoch, s=si, d=dst:
                   self._finish_handoff(jb, e, s, d, p))

    def _finish_handoff(self, job: _Job, epoch: int, si: int, dst: str,
                        payload) -> None:
        if job.epoch != epoch:
            return
        key = ("kv", si, dst)
        if key in job.seen:
            return                      # duplicated delivery
        job.seen.add(key)
        self.engines[dst].import_kv(job.slots[dst], job.pos, payload)
        job.kv_pending.discard((si, dst))
        self._maybe_release_prefill(job)
        if not job.kv_pending and job.req.output:
            # the first token may have confirmed while KV was in flight —
            # its launch attempt was gated; relaunch now that decode can run
            self._maybe_launch(job, COORDINATOR, int(job.req.output[-1]),
                               len(job.req.output))
            self._drain_inbox(job)

    def _maybe_release_prefill(self, job: _Job) -> None:
        """Free prefill-only nodes' slots (and KV) once every handoff out
        of them has landed — long prompts stop holding prefill pools, which
        is the point of disaggregating."""
        if not job.route.disaggregated:
            return
        decode_nodes = {st.node for st in job.route.decode.stages}
        pending_src = {job.route.prefill.stages[s].node
                       for s, _ in job.kv_pending}
        for st in job.route.prefill.stages:
            if st.node in decode_nodes or st.node in pending_src:
                continue
            slot = job.slots.pop(st.node, None)
            if slot is not None:
                self.engines[st.node].release(slot)

    # -- token arrivals (coordinator) ----------------------------------------
    def _confirm(self, job: _Job, tok: int) -> None:
        """Confirm ONE token at the coordinator: append it to the visible
        output and stamp the first-token time."""
        req = job.req
        req.output.append(int(tok))
        self.tokens_produced += 1
        if req.first_token_s is None:
            req.first_token_s = self.clock()
        self._vfirst.setdefault(req.request_id, self._now)

    def _stop_reason(self, job: _Job) -> Optional[str]:
        req = job.req
        if int(req.output[-1]) == self.ec.eos_token:
            return "stop"
        if len(req.output) >= req.max_new_tokens:
            return "length"
        if job.pos >= self.ec.max_len:
            return "length"
        return None

    def _on_first_token(self, job: _Job, epoch: int, tok: int) -> None:
        """Prefill's token reached the coordinator (resumed requests re-send
        their last confirmed token instead of sampling a new one)."""
        if job.epoch != epoch:
            return
        req = job.req
        if not job.resumed:
            self._confirm(job, int(tok))
            reason = self._stop_reason(job)
            if reason is not None:
                self._complete(job, reason)
                return
        # depth 1 (or a closed window at prefill time): the first decode
        # pass launches from here; a no-op if the final stage launched it
        self._maybe_launch(job, COORDINATOR, int(req.output[-1]),
                           len(req.output))
        self._drain_inbox(job)

    def _on_decode_token(self, job: _Job, epoch: int, j: int, tok: int
                         ) -> None:
        """A sampled token arrived.  Confirm strictly in output order —
        arrivals ahead of the expected index wait in the job's inbox."""
        if job.epoch != epoch:
            return
        job.inbox[j] = int(tok)
        self._drain_inbox(job)

    def _drain_inbox(self, job: _Job) -> None:
        req = job.req
        while len(req.output) in job.inbox:
            t = job.inbox.pop(len(req.output))
            self._confirm(job, t)
            job.pos += 1
            reason = self._stop_reason(job)
            if reason is not None:
                self._complete(job, reason)
                return
            self._maybe_launch(job, COORDINATOR, t, len(req.output))

    # -- speculative verify results (coordinator) -----------------------------
    def _on_spec_result(self, job: _Job, epoch: int, j: int, greedy) -> None:
        """A verify pass's greedy vector reached the coordinator: accept
        the longest draft prefix, confirm those tokens (plus the bonus
        token) strictly in order, and on the first mismatch bump the epoch
        and roll every stage node back to the accepted prefix."""
        if job.epoch != epoch:
            return
        req = job.req
        drafts = job.spec_drafts
        greedy = [int(t) for t in np.asarray(greedy).reshape(-1)]
        gamma = len(greedy) - 1
        a = 0
        while a < gamma and drafts[a] == greedy[a]:
            a += 1
        self.spec_accepted += a
        self.spec_rejected += gamma - a
        base = job.spec_base
        # draft rows base+1..base+min(a, γ-1) hold proposals the target
        # just confirmed — the draft need not consume them again
        job.draft_pos = max(job.draft_pos, base + 1 + min(a, gamma - 1))
        for t in greedy[:a + 1]:
            self._confirm(job, t)
            self.spec_confirmed += 1
            job.pos += 1
            reason = self._stop_reason(job)
            if reason is not None:
                # early stop inside the accepted prefix: completion
                # releases every slot — no rollback needed
                self._complete(job, reason)
                self._spec_annotate()
                return
        if a < gamma:
            # rejection: cancel the optimistic window and bump the epoch so
            # no delivery of the dead pass runs after the rollback
            keep = base + a + 1
            self.cancelled_inflight += max(0, job.inflight)
            job.epoch += 1
            job.next_j = len(req.output)
            job.next_pos = keep
            self._rollback_job(job, keep)
        self._spec_annotate()
        self._maybe_launch(job, COORDINATOR, int(req.output[-1]),
                           len(req.output))

    def _rollback_job(self, job: _Job, keep: int) -> None:
        """Truncate the job's KV to ``keep`` rows on every stage node before
        the next pass launches.  The draft needs no rollback: its dense
        caches are positional and ``draft_pos`` already points at the last
        confirmed row."""
        for node in dict.fromkeys(st.node for st in job.pipe.stages):
            self.engines[node].rollback(job.slots[node], keep)

    def _spec_note(self) -> str:
        if self.draft is None:
            return ""
        return (f"spec[proposed={self.spec_proposed} "
                f"accepted={self.spec_accepted} "
                f"rejected={self.spec_rejected} "
                f"rate={self.spec_acceptance_rate:.2f} "
                f"tokens/rt={self.spec_tokens_per_round_trip:.2f}]")

    def _spec_annotate(self) -> None:
        self.transport.annotations["spec"] = self._spec_note()

    @property
    def spec_acceptance_rate(self) -> float:
        """Fraction of draft proposals the target's greedy pass accepted."""
        return self.spec_accepted / max(1, self.spec_proposed)

    @property
    def spec_tokens_per_round_trip(self) -> float:
        """Tokens confirmed per verify round trip (1 + accepted prefix)."""
        return self.spec_confirmed / max(1, self.spec_rounds)

    # -- decode pass launch (window) -----------------------------------------
    def _spec_gamma(self, job: _Job) -> int:
        """Draft length of the next verify round, clamped so every position
        could still be confirmed: the round produces output indices
        ``next_j .. next_j+γ`` and writes cache rows ``next_pos ..
        next_pos+γ`` (under ``max_len``)."""
        return max(0, min(self.spec_tokens,
                          job.req.max_new_tokens - job.next_j - 1,
                          self.ec.max_len - 1 - job.next_pos))

    def _draft_propose(self, job: _Job, gamma: int) -> List[int]:
        """Run the coordinator-side draft: catch up on confirmed tokens it
        has not consumed (one multi-token decode over rows
        ``draft_pos..next_pos``), then propose ``gamma`` greedy tokens.
        Rejected rows of earlier rounds are overwritten in place."""
        eng, slot = self.draft, job.draft_slot
        req = job.req
        P = len(req.prompt)
        p = job.next_pos

        def tok_at(r: int) -> int:
            # row r >= P holds output[r - P] (prefill fed prompt + output
            # contiguously, so this covers resumed requests too)
            return int(req.prompt[r]) if r < P else int(req.output[r - P])

        catch = [tok_at(r) for r in range(job.draft_pos, p + 1)]
        out = eng.decode_stage([DecodeItem(slot=slot, pos=job.draft_pos,
                                           entry=0, tokens=catch)])[0]
        logits = out.logits
        cur = int(np.argmax(logits[-1] if logits.ndim == 2 else logits))
        drafts = [cur]
        for s in range(1, gamma):
            out = eng.decode_stage([DecodeItem(slot=slot, pos=p + s,
                                               entry=0, token=cur)])[0]
            cur = int(np.argmax(out.logits))
            drafts.append(cur)
        job.draft_pos = p + 1        # rows 0..p are now consumed
        return drafts

    def _maybe_launch(self, job: _Job, src: str, tok: int, expect_j: int
                      ) -> None:
        """Launch the decode pass producing output index ``expect_j`` if no
        one else has (the final stage races the coordinator for it), the
        hard budgets allow it to ever be confirmed, and the in-flight window
        has room.

        Jobs holding a draft slot launch verify passes instead: γ draft
        proposals ride with the confirmed token as one multi-token pass.
        Only the coordinator launches them (the draft lives there), and one
        verify pass is in flight per request — the optimistic window
        ``next_j = j+γ+1`` stays closed until the round confirms or rolls
        back."""
        req = job.req
        spec = job.draft_slot is not None
        if spec and src != COORDINATOR:
            return                   # the final stage cannot draft
        if req.done or job.next_j != expect_j:
            return
        if job.kv_pending:
            return                   # decode KV still in flight from prefill
        if job.next_j >= req.max_new_tokens or job.next_pos >= self.ec.max_len:
            return                   # pass could never be confirmed
        if spec and job.inflight != 0:
            return                   # one verify round in flight at a time
        if job.inflight >= self.max_inflight and not spec:
            return                   # window full: coordinator relaunches
        gamma = self._spec_gamma(job) if spec else 0
        pos, j, epoch = job.next_pos, job.next_j, job.epoch
        if not self._reserve_inflight(job, pos + gamma + 1):
            return                   # job itself was preempted reserving
        first = job.pipe.stages[0].node
        if gamma >= 1:
            drafts = self._draft_propose(job, gamma)
            job.spec_drafts = drafts
            job.spec_base = pos
            job.next_j = j + gamma + 1      # optimistic: rolled back on
            job.next_pos = pos + gamma + 1  # rejection (epoch bump)
            self.spec_rounds += 1
            self.spec_proposed += gamma
            toks = np.asarray([int(tok)] + drafts, np.int32)
            self._send(src, first, toks,
                       (gamma + 1) * self.profile.token_bytes,
                       lambda t, e=epoch, p=pos, jj=j, n=gamma + 1:
                       self._enqueue_decode(job, e, 0, 0, None, p, jj,
                                            toks=t, spec=True, nt=n))
            return
        job.next_j = j + 1
        job.next_pos = pos + 1
        self._send(src, first, int(tok), self.profile.token_bytes,
                   lambda t, e=epoch, p=pos, jj=j:
                   self._enqueue_decode(job, e, 0, int(t), None, p, jj))

    def _enqueue_decode(self, job: _Job, epoch: int, si: int, tok: int,
                        h, pos: int, j: int, toks=None, spec: bool = False,
                        nt: int = 1) -> None:
        if job.epoch != epoch:
            return
        node = job.pipe.stages[si].node
        self._ready[node].append(dict(job=job, epoch=epoch, si=si, tok=tok,
                                      h=h, pos=pos, j=j, toks=toks,
                                      spec=spec, nt=nt))

    def _grow_or_preempt(self, eng, node: str, job: _Job, tokens: int
                         ) -> bool:
        """Grow ``job``'s KV on ``node`` to hold ``tokens``, preempting the
        newest resident request (pipeline-wide) while the pool is dry.
        Returns False when the victim chain reached ``job`` itself."""
        epoch = job.epoch
        while not eng.ensure(job.slots[node], tokens):
            live = [j for j in self.jobs.values() if node in j.slots]
            victim = max(live, key=lambda j: j.seq)
            self._preempt(victim)
            if job.epoch != epoch:
                return False
        return True

    def _reserve_inflight(self, job: _Job, tokens: int) -> bool:
        """Reserve KV for an in-flight token on every stage node at launch;
        returns False when the job itself got preempted making room."""
        for st in job.pipe.stages:
            if st.node not in job.slots:
                return False
            if not self._grow_or_preempt(self.engines[st.node], st.node, job,
                                         tokens):
                return False
        return True

    # -- decode (per-node continuous batching) -------------------------------
    def _decode_node(self, node: str, work: List[dict]) -> None:
        """All stage-work resident at ``node`` this iteration, run as
        batched decode passes of at most ``max_batch`` items."""
        eng = self.engines[node]
        # grow pools oldest-first, as a backstop: launch-time reservation
        # makes this a no-op unless another request raced the pool dry
        for w in sorted(work, key=lambda w: w["job"].seq):
            job = w["job"]
            if job.epoch != w["epoch"]:
                continue
            self._grow_or_preempt(eng, node, job, w["pos"] + w["nt"])
        while work:
            batch = [w for w in work[:self.ec.max_batch]
                     if w["job"].epoch == w["epoch"]]
            work = work[self.ec.max_batch:]
            if not batch:
                continue
            items = [DecodeItem(slot=w["job"].slots[node], pos=w["pos"],
                                entry=w["job"].pipe.stages[w["si"]]
                                .layers.start,
                                token=w["tok"], h=w["h"], tokens=w["toks"])
                     for w in batch]
            outs = eng.decode_stage(items)
            for w, out in zip(batch, outs):
                job, si, epoch, j = w["job"], w["si"], w["epoch"], w["j"]
                if si == len(job.pipe.stages) - 1:
                    if w["spec"]:
                        # verify pass: no sampling, no node-side launch —
                        # the greedy argmax of each verified position goes
                        # to the coordinator, which owns acceptance and
                        # rollback
                        greedy = np.argmax(out.logits, axis=-1).astype(
                            np.int32).reshape(-1)
                        self._send(node, COORDINATOR, (j, greedy),
                                   len(greedy) * self.profile.token_bytes,
                                   lambda p, jb=job, e=epoch:
                                   self._on_spec_result(jb, e, p[0], p[1]))
                        continue
                    tok = eng.sample(out.logits, job.req.temperature)
                    self._send(node, COORDINATOR, (j, tok),
                               self.profile.token_bytes,
                               lambda p, jb=job, e=epoch:
                               self._on_decode_token(jb, e, p[0], p[1]))
                    # pipelined: token j leaves for the coordinator while
                    # the pass for j+1 leaves for stage 0
                    self._maybe_launch(job, node, tok, j + 1)
                else:
                    nxt = job.pipe.stages[si + 1].node
                    n = w["nt"]
                    self._send(node, nxt, out.h, self._act_bytes(n),
                               lambda h, jb=job, e=epoch, s=si + 1,
                               p=w["pos"], jj=j, sp=w["spec"], nn=n:
                               self._enqueue_decode(jb, e, s, 0, h, p, jj,
                                                    spec=sp, nt=nn))

    # -- completion / preemption ---------------------------------------------
    def _release_all(self, job: _Job) -> None:
        for node, slot in job.slots.items():
            eng = self.engines.get(node)
            if eng is not None:          # None: the node failed
                eng.release(slot)
        job.slots = {}
        if job.draft_slot is not None:
            self.draft.release(job.draft_slot)
        job.draft_slot = None
        job.draft_pos = 0

    def _complete(self, job: _Job, reason: str) -> None:
        req = job.req
        req.done = True
        req.finish_reason = reason
        req.finished_s = self.clock()
        # cancel in-flight passes (a stop confirmed while token t+1 is
        # mid-pipeline): the epoch bump kills their deliveries
        self.cancelled_inflight += max(0, job.inflight)
        job.epoch += 1
        job.inbox = {}
        t0 = self._vfirst.pop(req.request_id, None)
        if t0 is not None and len(req.output) > 1:
            self.decode_latencies[req.request_id] = \
                (self._now - t0) / (len(req.output) - 1)
        self._release_all(job)
        self.jobs.pop(req.request_id, None)
        self.completed += 1

    def _preempt(self, job: _Job) -> None:
        """Pool exhausted: evict pipeline-wide, keep generated tokens,
        requeue at the front (recompute-on-readmit, same route)."""
        self._requeue(job, clear_pipe=False)

    # -- failover ------------------------------------------------------------
    def fail_node(self, name: str) -> None:
        """Drop a node's engine; every request whose route crossed it is
        requeued (its KV on survivors released) pending a replanned
        route."""
        self.engines.pop(name, None)
        for job in list(self.jobs.values()):
            if name in job.route.nodes:
                self._requeue(job, clear_pipe=True)
        for job in self.queue:
            if job.route is not None and name in job.route.nodes:
                job.pipe = None
                job.route = None

    def _requeue(self, job: _Job, clear_pipe: bool) -> None:
        job.epoch += 1               # cancels every in-flight pass
        job.inbox = {}
        job.kv_pending = set()       # readmission restarts any KV handoff
        self._release_all(job)
        if clear_pipe:
            job.pipe = None
            job.route = None
        self.jobs.pop(job.req.request_id, None)
        job.req.preemptions += 1
        self.queue.appendleft(job)

    def apply_plan(self, plan) -> None:
        """Adopt a replanned placement: rebuild the engines whose slice
        changed (requeueing their resident requests), swap IWRR weights in
        place when the placement and its roles survived, else install
        fresh role schedulers, and re-sync true pool occupancy into the KV
        estimators."""
        new_assign = plan.placement.assignment
        for node in [n for n in self.engines if n not in new_assign]:
            self.fail_node(node)
        old_assign = self.placement.assignment
        old_roles = (self.placement.meta or {}).get("roles")
        # the new topology first: pool sizing reads node VRAM from
        # self.cluster
        self.cluster = plan.cluster
        self.profile = plan.model
        changed = set()
        for node, rng in sorted(new_assign.items()):
            if node in self.engines and old_assign.get(node) == rng:
                continue
            changed.add(node)
            for job in list(self.jobs.values()):
                if node in job.slots:
                    self._requeue(job, clear_pipe=True)
            self.engines[node] = self._make_engine(node, rng)
        # queued jobs (preempted ones hold their old route) whose route
        # crosses a rebuilt node would run stale layer ranges: reschedule
        for job in self.queue:
            if job.route is not None and \
                    changed.intersection(job.route.nodes):
                job.pipe = None
                job.route = None
        same = (old_assign == new_assign
                and old_roles == (plan.placement.meta or {}).get("roles"))
        self.placement = plan.placement
        if same and not self.disaggregated and \
                self.scheduler.placement.assignment == new_assign:
            self.scheduler.update_weights(plan.flows)
        else:
            kv_old = self.scheduler.kv
            kv_pre = self.sched_prefill.kv
            self._build_role_schedulers(plan)
            if self.scheduler.kv is not None and kv_old is not None:
                self.scheduler.kv.high_water = kv_old.high_water
            if self.sched_prefill is not self.scheduler and \
                    self.sched_prefill.kv is not None and kv_pre is not None:
                self.sched_prefill.kv.high_water = kv_pre.high_water
        self._sync_kv(capacities=True)

    # -- introspection --------------------------------------------------------
    def node_occupancy(self) -> Dict[str, float]:
        """Per-node KV occupancy fraction (used tokens / capacity
        tokens)."""
        out = {}
        for n, e in self.engines.items():
            cap = e.kv_tokens_capacity()
            out[n] = e.kv_tokens_used() / cap if cap else 0.0
        return out

    def pool_pages_used(self) -> Dict[str, int]:
        """Allocated pages per paged node (dense nodes have no pool)."""
        return {n: u for n, e in self.engines.items()
                if (u := e.pool_used()) is not None}

    def mean_decode_latency(self) -> float:
        """Mean per-token decode latency on the virtual clock, over
        completed requests that decoded at least one token past prefill."""
        lats = list(self.decode_latencies.values())
        return sum(lats) / len(lats) if lats else 0.0
