"""Training driver of the port: one device, checkpoint and restart —
counterpart of ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \\
      --steps 20 --batch 8 --seq 512 --ckpt-dir ckpt/ [--resume]
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \\
      --smoke --device cpu --steps 2

It runs on CUDA unless ``--device cpu`` is given (and raises without a
card).  Each step prints its loss and training tokens/s (host clock, the
card synchronised).  With ``--ckpt-dir`` it saves every CKPT_EVERY steps,
as the reference does, and after the last one; ``--resume`` continues from the newest
checkpoint there, on the exact batch it left off.  A ``--mesh`` of more
than one device needs the distribution layer (ROADMAP queue 1 item 8) and
raises.
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from ..configs import get_config, get_smoke_config
from ..models import init
from ..models.common import resolve_device
from ..training import (AsyncCheckpointer, DataConfig, TrainConfig,
                        init_train_state, latest_step, make_batch,
                        make_train_step, restore)
from .steps import optimizer_for

CKPT_EVERY = 20


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--mesh", default="",
                    help="comma dims, e.g. 2,4 -> (data, model); more than "
                         "one device is not ported yet")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the driver; returns the final (params, opt_state)."""
    args = parse_args(argv)
    if args.mesh and math.prod(int(x) for x in args.mesh.split(",")) > 1:
        raise NotImplementedError(
            f"--mesh {args.mesh}: training over more than one device needs "
            "the distribution layer, not ported yet (ROADMAP queue 1 item "
            "8: dist)")
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"device {dev}; model {cfg.name} "
          f"({cfg.param_count() / 1e6:.1f}M params)", flush=True)

    tc = TrainConfig(optimizer=optimizer_for(cfg), remat="full")
    step_fn = make_train_step(cfg, tc)
    params = init(cfg, 0, device=dev)
    opt_state = init_train_state(cfg, tc, params)

    dc = DataConfig(vocab_size=cfg.vocab_size, batch_size=args.batch,
                    seq_len=args.seq)
    start = 0
    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir):
        state, step, meta = restore(args.ckpt_dir, None,
                                    {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        start = meta["data_step"]
        print(f"resumed at data step {start}", flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    for s in range(start, args.steps):
        batch = make_batch(dc, s, device=dev)
        sync()
        t = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch)
        loss = float(m["loss"])        # synchronises
        sync()
        dt = time.perf_counter() - t
        print(f"step {s}: loss {loss:.4f} ({dt * 1e3:.1f} ms, "
              f"{args.batch * args.seq / dt:.0f} tokens/s; "
              f"{time.perf_counter() - t0:.1f}s)", flush=True)
        if ckpt and ((s + 1) % CKPT_EVERY == 0 or s + 1 == args.steps):
            ckpt.save_async(s + 1, {"params": params, "opt": opt_state},
                            metadata={"data_step": s + 1})
    if ckpt:
        ckpt.wait()
    return params, opt_state


if __name__ == "__main__":
    main()
