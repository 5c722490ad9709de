"""Serving driver of the port — counterpart of the ``--cluster`` and
``--paged`` paths of ``repro.launch.serve``.

Cluster serving: MILP placement over a (VRAM-derated) logical cluster ->
IWRR pipelines -> one stage engine per node under the ``ClusterRuntime``,
paged stage engines by default or dense ones with ``--dense``.  Every
node's engine lives on the one device (``--device``, CUDA by default), as
the reference plays every node in one process.  ``--arch`` names any arch
of the port's registry: ``smollm_360m``, ``olmo_1b``, ``starcoder2_7b``,
``chameleon_34b`` or ``gemma3_12b``.  gemma3's stack mixes windowed and
global layers: on the paged paths (``--paged``, and ``--cluster`` without
``--dense``) its global layers page their K/V while the windowed ones keep
dense ring caches, and every prompt prefills single-shot (one pass of the
whole prompt per stage, then the global layers' K/V moves into the pool);
all-paged stacks prefill in chunks of 16 tokens instead:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_12b \
      --cluster A100,L4 --stages 2 --prompt 600,1100,1500,2100 \
      --new-tokens 16 --max-len 2128            # add --dense: dense caches

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m \
      --cluster A100,L4 --stages 2 --batch 4 --prompt 40 --new-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m \
      --cluster A100,L4 --stages 2 --dense --prompt 37,128,300,511 \
      --new-tokens 16 --max-len 576

Single-node paged-KV serving (``PagedEngine``, a full-rectangle pool):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m \
      --paged --batch 4 --prompt 40 --new-tokens 8

Disaggregated prefill/decode and failover have no flag, as in the
reference's ``launch/serve.py``: pass ``run_cluster`` a plan of a
``core.disaggregated_placement`` (``chip_smoke.py`` does), or drive
``ClusterRuntime`` with one and call ``fail_node`` / ``apply_plan``.

Greedy speculative decoding over the cluster: ``--draft ARCH`` puts a
draft model at the coordinator (the registry's config of that arch, at the
target's width: SMOKE with ``--smoke``; weights from ``--seed``, so
``--draft`` naming the target's own arch is a perfect draft) proposing
``--spec-tokens`` tokens per verify round:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m \
      --cluster A100,L4 --stages 2 --prompt 40 --new-tokens 16 \
      --draft smollm_360m --spec-tokens 4

Multi-process cluster serving: one stage worker process per node behind
the ``SocketTransport`` (``--transport socket``; ``--direct-links`` lets
workers forward activations to the next stage's worker over peer links;
``--connect HOST:PORT`` waits for workers started by hand with
``python -m repro_torch.launch.worker --connect HOST:PORT --device cuda``):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m \
      --cluster A100,L4 --stages 2 --transport socket --new-tokens 8

Online front door (OpenAI-compatible HTTP API with SSE streaming over the
wall-clock runtime; SIGINT drains and prints the TTFT/TPOT summary;
``--autoscale`` runs the live autoscaler on its arrival rate):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m \
      --cluster A100,L4 --stages 2 --serve 127.0.0.1:8902 \
      [--transport socket]

CPU smoke runs (small config, plain versions of the kernels): add
``--smoke --device cpu`` (workers then run on the CPU too).  ``--prompt``
takes one length or a comma-separated list that the requests cycle
through.

Not ported yet: the sharded mesh path (ROADMAP queue 1 item 8; without
``--cluster`` or ``--paged`` this module raises) and int8 KV (item 1).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import (MILPOptions, ModelProfile, make_serving_cluster,
                              plan)
from repro_torch.core.cluster import COORDINATOR
from repro_torch.models import init, resolve_device
from repro_torch.serving.autoscaler import Autoscaler
from repro_torch.serving.engine import EngineConfig, PagedEngine, Request
from repro_torch.serving.frontend import Frontend
from repro_torch.serving.runtime import ClusterRuntime


def build_config(args, arch: Optional[str] = None):
    """The registry's config of ``arch`` (default ``--arch``): SMOKE with
    ``--smoke``, else the full one."""
    arch = arch or args.arch
    return get_smoke_config(arch) if args.smoke else get_config(arch)


def make_plan(cfg, args):
    """MILP placement of ``cfg`` over the ``--cluster`` devices, VRAM
    derated so the model splits into at least ``--stages`` stages."""
    profile = ModelProfile.from_dims(
        cfg.name, cfg.num_layers, cfg.d_model, max(cfg.d_ff, 1),
        cfg.vocab_size, cfg.num_kv_heads, cfg.resolved_head_dim,
        kv_page_size=args.page_size)
    cluster = make_serving_cluster(profile, devs=args.cluster.split(","),
                                   force_stages=args.stages)
    return plan(cluster, profile, MILPOptions(time_limit_s=10.0, lns_rounds=0,
                                              fgls_rounds=20))


def make_requests(cfg, args) -> List[Request]:
    """``--batch`` requests of random tokens (seed ``--seed``), prompt
    lengths cycling through ``--prompt``."""
    lens = [int(n) for n in str(args.prompt).split(",")]
    rng = np.random.RandomState(args.seed)
    return [Request(i, rng.randint(0, cfg.vocab_size,
                                   size=(lens[i % len(lens)],)),
                    max_new_tokens=args.new_tokens)
            for i in range(args.batch)]


def timed(dev, run) -> float:
    """Seconds of ``run()`` on the host clock, the device synchronised at
    both ends."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def _report(reqs, dt, dev, what):
    toks = sum(len(r.output) for r in reqs)
    print(f"{what}: {len(reqs)} reqs, {toks} tokens in {dt:.3f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s) on {dev}")
    print("sampled ids:", [r.output for r in reqs[:2]])


def engine_config(args) -> EngineConfig:
    """The cluster's stage-engine budgets: ``--batch`` slots of
    ``--max-len`` tokens, prompts in chunks of at most 16."""
    return EngineConfig(max_batch=args.batch, max_len=args.max_len,
                        prompt_len=min(16, args.max_len))


def build_runtime(cfg, args, params=None, *, draft=None, transport=None,
                  plan=None, verbose: bool = True):
    """The cluster runtime of ``--cluster`` (or ``plan``): paged stage
    engines, or dense ones with ``--dense``, in this process or, with
    ``--transport socket``, in one worker process per node; speculative
    when ``draft`` names a ``(draft_cfg, draft_params)`` pair or
    ``--draft`` an arch.  ``transport`` (an ``InProcessTransport``) models
    the links of an in-process run.  With ``--serve`` an in-process
    runtime runs on the wall clock.  Returns (runtime, plan)."""
    dev = resolve_device(args.device)
    p = plan if plan is not None else make_plan(cfg, args)
    if verbose:
        for node, rng_ in sorted(p.placement.assignment.items()):
            print(f"  {node}: layers [{rng_.start}, {rng_.end})")
    if params is None:
        params = init(cfg, args.seed, device=dev)
    if draft is None and args.draft:
        dcfg = build_config(args, args.draft)
        draft = (dcfg, init(dcfg, args.seed, device=dev))
    kw = dict(paged=not args.dense, page_size=args.page_size,
              max_inflight=args.max_inflight, device=dev)
    if draft is not None:
        if verbose:
            print(f"draft: {draft[0].name} ({draft[0].num_layers}L "
                  f"d={draft[0].d_model} {draft[0].param_dtype}), "
                  f"spec_tokens={args.spec_tokens}")
        kw.update(draft_cfg=draft[0], draft_params=draft[1],
                  spec_tokens=args.spec_tokens)
    if args.transport == "socket":
        rt = ClusterRuntime.spawn_workers(
            cfg, params, p, engine_config(args),
            connect=args.connect or None, stall_timeout_s=120.0,
            direct_links=args.direct_links, **kw)
    else:
        rt = ClusterRuntime(cfg, params, p, engine_config(args),
                            transport=transport,
                            realtime=True if args.serve else None, **kw)
    return rt, p


def run_cluster(cfg, args, params=None, *, draft=None, transport=None,
                plan=None, verbose: bool = True):
    """Serve ``--batch`` random prompts through the runtime of
    ``build_runtime`` (same arguments).  ``plan`` replaces the MILP's plan
    of ``--cluster`` — a ``core.disaggregated_placement`` plan serves
    disaggregated prefill/decode.  Returns (runtime, requests, plan,
    seconds); the caller shuts down a runtime with workers."""
    dev = resolve_device(args.device)
    rt, p = build_runtime(cfg, args, params, draft=draft,
                          transport=transport, plan=plan, verbose=verbose)
    reqs = make_requests(cfg, args)

    def run():
        for r in reqs:
            rt.submit(r)
        rt.run_until_done()
    dt = timed(dev, run)
    assert all(r.done for r in reqs)
    if verbose:
        for r in reqs:
            print(f"req{r.request_id} -> "
                  + " -> ".join(s.node for s in rt.served[r.request_id].stages))
        _report(reqs, dt, dev, "cluster" + (" (dense)" if args.dense else ""))
        if rt.draft is not None:
            print(f"  {rt._spec_note()}")
        clock = ("wall clock" if rt.realtime else
                 "virtual clock: modelled link delays, not compute")
        print(f"  mean decode latency ({clock}): "
              f"{1e3 * rt.mean_decode_latency():.3f} ms/token; "
              f"cancelled in-flight passes: {rt.cancelled_inflight}")
    return rt, reqs, p, dt


def run_frontdoor(cfg, rt, args, plan_obj=None) -> None:
    """Serve the runtime behind the OpenAI-compatible HTTP front door until
    SIGINT/SIGTERM, then drain and print the TTFT/TPOT/SLO summary.  With
    ``--autoscale`` the live autoscaler samples the front door's arrival
    rate."""
    host, _, port = args.serve.rpartition(":")
    fe = Frontend(rt, max_pending=args.max_pending,
                  slo_ttft_s=args.slo_ttft_ms / 1e3
                  if args.slo_ttft_ms > 0 else None,
                  slo_tpot_s=args.slo_tpot_ms / 1e3
                  if args.slo_tpot_ms > 0 else None)
    scaler = None
    if args.autoscale and plan_obj is not None:
        catalog = None
        if args.autoscale_node_rate > 0:
            # cap every device's modelled token rate, so the mix planner
            # sees a small, known per-node capacity
            catalog = {n.device.name:
                       dataclasses.replace(
                           n.device,
                           max_tokens_per_s=args.autoscale_node_rate)
                       for name, n in rt.cluster.nodes.items()
                       if name != COORDINATOR}
        scaler = Autoscaler(rt, plan_obj, frontend=fe, catalog=catalog,
                            patience=args.autoscale_patience,
                            window_s=args.autoscale_window_s)
        scaler.start(args.autoscale_interval_s)
        print(f"autoscaler: interval={args.autoscale_interval_s}s "
              f"patience={args.autoscale_patience} "
              f"window={args.autoscale_window_s}s "
              f"catalog={sorted(scaler.catalog)}", flush=True)
    bhost, bport = fe.serve(host or "127.0.0.1", int(port))
    print(f"serving {cfg.name} on http://{bhost}:{bport} "
          f"(POST /v1/completions, GET /healthz; SIGINT drains)",
          flush=True)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    while not stop.is_set():
        stop.wait(0.2)
    print("draining ...", flush=True)
    if scaler is not None:
        scaler.stop()
    fe.shutdown(drain=True)
    if scaler is not None:
        print("autoscale events: " + json.dumps(
            [dataclasses.asdict(e) for e in scaler.events], default=float),
            flush=True)
    print("served summary: " + json.dumps(fe.summary(), default=float),
          flush=True)
    rt.shutdown()
    if fe.loop_error is not None:
        raise SystemExit(f"runtime loop died: {fe.loop_error!r}")


def run_paged(cfg, args, params=None, *, verbose: bool = True):
    """Single-node paged-KV serving: a full-rectangle pool, paged attention
    decode; an all-paged stack prefills in 16-token chunks, a hybrid one
    (gemma3) single-shot, its global layers' K/V then scattered into the
    pool.  Returns (engine, requests, seconds)."""
    dev = resolve_device(args.device)
    ec = EngineConfig(max_batch=args.batch, max_len=args.max_len,
                      prompt_len=min(16, args.max_len))
    if params is None:
        params = init(cfg, args.seed, device=dev)
    eng = PagedEngine(cfg, params, ec, page_size=args.page_size, device=dev)
    if verbose:
        print(f"pool: {eng.pool.num_pages} pages x {args.page_size} tokens")
    reqs = make_requests(cfg, args)

    def run():
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
    dt = timed(dev, run)
    assert all(r.done for r in reqs)
    if verbose:
        _report(reqs, dt, dev, "paged")
    return eng, reqs, dt


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced SMOKE config")
    ap.add_argument("--cluster", default="",
                    help="comma-separated device types of the logical "
                         "cluster the planner places the model on")
    ap.add_argument("--stages", type=int, default=0,
                    help="with --cluster: derate VRAM to force >= N "
                         "pipeline stages")
    ap.add_argument("--dense", action="store_true",
                    help="with --cluster: dense stage engines, not paged")
    ap.add_argument("--paged", action="store_true",
                    help="without --cluster: serve through the single-node "
                         "paged-KV engine")
    ap.add_argument("--device", default="cuda",
                    help="device every engine runs on (cuda | cpu)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", default="16",
                    help="prompt length, or comma-separated lengths the "
                         "requests cycle through")
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-inflight", type=int, default=1,
                    help="with --cluster: per-request in-flight decode "
                         "window")
    ap.add_argument("--draft", default="",
                    help="with --cluster: arch of a coordinator-side draft "
                         "model for greedy speculative decoding (must "
                         "share the target's vocab)")
    ap.add_argument("--spec-tokens", type=int, default=4,
                    help="with --draft: draft tokens proposed per verify "
                         "round trip (gamma)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    ap.add_argument("--transport", choices=["inproc", "socket"],
                    default="inproc",
                    help="with --cluster: socket runs one stage worker "
                         "process per node (on --device) behind the "
                         "SocketTransport")
    ap.add_argument("--connect", default="",
                    help="with --transport socket: listen on HOST:PORT and "
                         "wait for workers started by hand (python -m "
                         "repro_torch.launch.worker --connect HOST:PORT) "
                         "instead of spawning local subprocesses")
    ap.add_argument("--direct-links", action="store_true",
                    help="with --transport socket: stage workers forward "
                         "activations to the next stage's worker over peer "
                         "TCP links; only tokens return to the coordinator")
    ap.add_argument("--serve", default="",
                    help="with --cluster: HOST:PORT of the OpenAI-"
                         "compatible HTTP front door (SSE streaming; port "
                         "0 picks a free port, printed on startup) instead "
                         "of a one-shot batch")
    ap.add_argument("--max-pending", type=int, default=64,
                    help="with --serve: 429 past this many accepted but "
                         "unfinished requests")
    ap.add_argument("--slo-ttft-ms", type=float, default=0.0,
                    help="with --serve: TTFT SLO of the served summary "
                         "(0 = none)")
    ap.add_argument("--slo-tpot-ms", type=float, default=0.0,
                    help="with --serve: mean-TPOT SLO of the served "
                         "summary (0 = none)")
    ap.add_argument("--autoscale", action="store_true",
                    help="with --serve: run the live autoscaler (mix-solve "
                         "the measured traffic, grow, shrink or reweight "
                         "through apply_plan)")
    ap.add_argument("--autoscale-interval-s", type=float, default=2.0,
                    help="with --autoscale: sampling interval")
    ap.add_argument("--autoscale-patience", type=int, default=2,
                    help="with --autoscale: consecutive overloaded samples "
                         "before scaling")
    ap.add_argument("--autoscale-window-s", type=float, default=15.0,
                    help="with --autoscale: arrival-rate trailing window")
    ap.add_argument("--autoscale-node-rate", type=float, default=0.0,
                    help="with --autoscale: cap each device type's "
                         "modelled tokens/s at this value (0 = the device "
                         "profiles' own)")
    return ap.parse_args(argv)


def _not_drained(rt) -> dict:
    """Nodes still holding pages (paged) or slots (dense); a worker's
    engine is asked over RPC (pages and KV tokens)."""
    out = {n: u for n, u in rt.pool_pages_used().items() if u}
    engines = dict(rt.engines)
    if rt.draft is not None:
        engines["draft"] = rt.draft
    for n, e in engines.items():
        busy = len(e.slots) - e.free_slots if hasattr(e, "slots") else 0
        if busy or e.kv_tokens_used():
            out[n] = f"{busy} slots, {e.kv_tokens_used()} KV tokens"
    return out


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    cfg = build_config(args)
    if args.cluster:
        print(f"serving {cfg.name} ({cfg.num_layers}L d={cfg.d_model} "
              f"{cfg.param_dtype}) over cluster {args.cluster} on "
              f"{args.device}" + (" (one worker process per node)"
                                  if args.transport == "socket" else ""))
        if args.serve:
            rt, p = build_runtime(cfg, args)
            run_frontdoor(cfg, rt, args, plan_obj=p)
            return
        rt, _, _, _ = run_cluster(cfg, args)
        try:
            leaked = _not_drained(rt)
        finally:
            rt.shutdown()            # reap worker processes (socket runs)
        if leaked:
            raise SystemExit(f"KV not released: {leaked}")
        print("dense caches released on every node" if args.dense
              else "pools drained on every node")
        return
    if args.paged:
        print(f"serving {cfg.name} ({cfg.num_layers}L d={cfg.d_model} "
              f"{cfg.param_dtype}) on one paged engine on {args.device}")
        eng, _, _ = run_paged(cfg, args)
        if eng.pool.used:
            raise SystemExit(f"pages leaked: {eng.pool.used}")
        print("pool drained")
        return
    raise NotImplementedError(
        "sharded serving over a device mesh is not ported to repro_torch "
        "yet (ROADMAP queue 1 item 8); pass --cluster or --paged")


if __name__ == "__main__":
    main()
