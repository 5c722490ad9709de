"""Cluster serving driver of the port — counterpart of the in-process
``--cluster`` path of ``repro.launch.serve`` (``run_cluster``).

MILP placement over a (VRAM-derated) logical cluster -> IWRR pipelines ->
one paged stage engine per node under the ``ClusterRuntime``.  Every node's
engine lives on the one device (``--device``, CUDA by default), as the
reference plays every node in one process.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m \
      --cluster A100,L4 --stages 2 --batch 4 --prompt 40 --new-tokens 16

CPU smoke run (small config, plain versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m \
      --smoke --cluster A100,L4 --stages 2 --device cpu

Not ported yet: the single-node ``--paged`` engine, the sharded ``--mesh``
path, ``--dense``, int8 KV, socket workers, speculative decoding and the
HTTP front door.
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
from repro_torch.serving.engine import EngineConfig, Request
from repro_torch.serving.runtime import ClusterRuntime


def build_config(args):
    return get_smoke_config(args.arch) if args.smoke else get_config(args.arch)


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


def run_cluster(cfg, args, params=None, *, verbose: bool = True):
    """Serve ``--batch`` random prompts through the cluster runtime.
    Returns (runtime, requests, plan, seconds)."""
    dev = resolve_device(args.device)
    p = make_plan(cfg, args)
    if verbose:
        for node, rng_ in sorted(p.placement.assignment.items()):
            print(f"  {node}: layers [{rng_.start}, {rng_.end})")
    if params is None:
        params = init(cfg, args.seed, device=dev)
    ec = EngineConfig(max_batch=args.batch, max_len=args.max_len,
                      prompt_len=min(16, args.max_len))
    rt = ClusterRuntime(cfg, params, p, ec, page_size=args.page_size,
                        max_inflight=args.max_inflight, device=dev)
    rng = np.random.RandomState(args.seed)
    reqs = [Request(i, rng.randint(0, cfg.vocab_size, size=(args.prompt,)),
                    max_new_tokens=args.new_tokens)
            for i in range(args.batch)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for r in reqs:
        rt.submit(r)
    rt.run_until_done()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    assert all(r.done for r in reqs)
    if verbose:
        toks = sum(len(r.output) for r in reqs)
        for r in reqs:
            print(f"req{r.request_id} -> "
                  + " -> ".join(s.node for s in rt.served[r.request_id].stages))
        print(f"cluster: {len(reqs)} reqs, {toks} tokens in {dt:.3f}s "
              f"({toks / max(dt, 1e-9):.1f} tok/s) on {dev}")
        print("sampled ids:", [r.output for r in reqs[:2]])
    return rt, reqs, p, dt


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced SMOKE config")
    ap.add_argument("--cluster", required=True,
                    help="comma-separated device types of the logical "
                         "cluster the planner places the model on")
    ap.add_argument("--stages", type=int, default=0,
                    help="derate VRAM to force >= N pipeline stages")
    ap.add_argument("--device", default="cuda",
                    help="device every node's engine runs on (cuda | cpu)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-inflight", type=int, default=1,
                    help="per-request in-flight decode window")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    cfg = build_config(args)
    print(f"serving {cfg.name} ({cfg.num_layers}L d={cfg.d_model} "
          f"{cfg.param_dtype}) over cluster {args.cluster} on {args.device}")
    rt, _, _, _ = run_cluster(cfg, args)
    leaked = {n: u for n, u in rt.pool_pages_used().items() if u}
    if leaked:
        raise SystemExit(f"pages leaked: {leaked}")
    print("pools drained on every node")


if __name__ == "__main__":
    main()
