"""Serving driver of the port — counterpart of the ``--cluster`` and
``--paged`` paths of ``repro.launch.serve``.

Cluster serving: MILP placement over a (VRAM-derated) logical cluster ->
IWRR pipelines -> one stage engine per node under the ``ClusterRuntime``,
paged stage engines by default or dense ones with ``--dense``.  Every
node's engine lives on the one device (``--device``, CUDA by default), as
the reference plays every node in one process.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m \
      --cluster A100,L4 --stages 2 --batch 4 --prompt 40 --new-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m \
      --cluster A100,L4 --stages 2 --dense --prompt 37,128,300,511 \
      --new-tokens 16 --max-len 576

Single-node paged-KV serving (``PagedEngine``, a full-rectangle pool):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m \
      --paged --batch 4 --prompt 40 --new-tokens 8

Greedy speculative decoding over the cluster: ``--draft ARCH`` puts a
draft model at the coordinator (the registry's config of that arch, at the
target's width: SMOKE with ``--smoke``; weights from ``--seed``, so
``--draft`` naming the target's own arch is a perfect draft) proposing
``--spec-tokens`` tokens per verify round:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m \
      --cluster A100,L4 --stages 2 --prompt 40 --new-tokens 16 \
      --draft smollm_360m --spec-tokens 4

CPU smoke runs (small config, plain versions of the kernels): add
``--smoke --device cpu``.  ``--prompt`` takes one length or a
comma-separated list that the requests cycle through.

Not ported yet: the sharded mesh path (ROADMAP queue 1 item 8; without
``--cluster`` or ``--paged`` this module raises), int8 KV, socket workers
and the HTTP front door.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import (MILPOptions, ModelProfile, make_serving_cluster,
                              plan)
from repro_torch.models import init, resolve_device
from repro_torch.serving.engine import EngineConfig, PagedEngine, Request
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


def run_cluster(cfg, args, params=None, *, draft=None, transport=None,
                verbose: bool = True):
    """Serve ``--batch`` random prompts through the cluster runtime (paged
    stage engines, or dense ones with ``--dense``), speculatively when
    ``draft`` names a ``(draft_cfg, draft_params)`` pair or ``--draft`` an
    arch; ``transport`` (an ``InProcessTransport``) models the links on the
    runtime's virtual clock (default: no delay).  Returns (runtime,
    requests, plan, seconds)."""
    dev = resolve_device(args.device)
    p = make_plan(cfg, args)
    if verbose:
        for node, rng_ in sorted(p.placement.assignment.items()):
            print(f"  {node}: layers [{rng_.start}, {rng_.end})")
    if params is None:
        params = init(cfg, args.seed, device=dev)
    if draft is None and args.draft:
        dcfg = build_config(args, args.draft)
        draft = (dcfg, init(dcfg, args.seed, device=dev))
    spec_kw = {}
    if draft is not None:
        if verbose:
            print(f"draft: {draft[0].name} ({draft[0].num_layers}L "
                  f"d={draft[0].d_model} {draft[0].param_dtype}), "
                  f"spec_tokens={args.spec_tokens}")
        spec_kw = dict(draft_cfg=draft[0], draft_params=draft[1],
                       spec_tokens=args.spec_tokens)
    ec = EngineConfig(max_batch=args.batch, max_len=args.max_len,
                      prompt_len=min(16, args.max_len))
    rt = ClusterRuntime(cfg, params, p, ec, paged=not args.dense,
                        page_size=args.page_size,
                        max_inflight=args.max_inflight, device=dev,
                        transport=transport, **spec_kw)
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
        print(f"  mean decode latency (virtual clock: modelled link delays, "
              f"not compute): {1e3 * rt.mean_decode_latency():.3f} ms/token; "
              f"cancelled in-flight passes: {rt.cancelled_inflight}")
    return rt, reqs, p, dt


def run_paged(cfg, args, params=None, *, verbose: bool = True):
    """Single-node paged-KV serving: a full-rectangle pool, chunked prefill
    for prompts past the 16-token chunk, paged attention decode.  Returns
    (engine, requests, seconds)."""
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
    return ap.parse_args(argv)


def _not_drained(rt) -> dict:
    """Nodes still holding pages (paged) or slots (dense)."""
    out = {n: u for n, u in rt.pool_pages_used().items() if u}
    engines = dict(rt.engines)
    if rt.draft is not None:
        engines["draft"] = rt.draft
    for n, e in engines.items():
        if e.free_slots != len(e.slots) or e.kv_tokens_used():
            out[n] = f"{len(e.slots) - e.free_slots} slots"
    return out


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    cfg = build_config(args)
    if args.cluster:
        print(f"serving {cfg.name} ({cfg.num_layers}L d={cfg.d_model} "
              f"{cfg.param_dtype}) over cluster {args.cluster} on "
              f"{args.device}")
        rt, _, _, _ = run_cluster(cfg, args)
        leaked = _not_drained(rt)
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
