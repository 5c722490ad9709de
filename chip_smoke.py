#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device   — prints the card's name and power limit (nvidia-smi); TF32
                off for matmuls and convolutions.
  2. build    — compiles the paged attention kernel with nvcc for sm_90a
                from ``src/repro_torch/csrc`` (first use builds it).
  3. kernel   — holds the kernel against its plain PyTorch version on the
                card: smoke and full smollm shapes, ragged lengths (1, page,
                page+1, NP*page, and 0), lengths that cross the kernel's
                64-token tiles (63, 64, 65, 128, 129, 1999, 2048), a
                shuffled block table whose dead entries point far outside
                the pool, f32 / bf16 / int8 + scales.  Tolerances: f32 and
                int8-with-f32-q atol=rtol=1e-5 (same fp32 math, other
                summation order); bf16 and int8-with-bf16-q atol=rtol=2e-2
                and, scaled to the output's size, max error <= 2**-7 x
                max|plain| (one bf16 rounding of the output).  Times
                the kernel, its plain version and, as a yardstick the port
                never calls, ``scaled_dot_product_attention`` on already
                gathered dense K/V (CUDA events, median of 100 launches
                after warm-up) at the main path's decode shape and at
                B=32, L=2048.
  4. serving  — the port's ``launch/serve.py --cluster A100,L4 --stages 2``
                path on cuda: full-width smollm-360m in bf16, 4 requests x
                40-token prompts (chunked prefill past the 16-token chunk)
                x 16 new tokens.  Asserts every request done, every pool
                drained, >= 2 nodes per request, and kernel launches ==
                decode passes x paged layers per node.
  5. cross-check — the same full-width model in f32 through the runtime on
                cuda (kernel) and on the CPU (plain versions), same weights:
                first-prefill and first-decode last-stage logits allclose at
                atol=rtol=1e-3, greedy tokens equal.
The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.  Without CUDA it exits non-zero at once.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels.paged_attention import kernel as k1  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention, paged_attention_ref)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import init  # noqa: E402
from repro_torch.models.common import map_tree  # noqa: E402
from repro_torch.serving.stage_engine import PagedStageEngine  # noqa: E402

TOL = {"f32": dict(atol=1e-5, rtol=1e-5), "bf16": dict(atol=2e-2, rtol=2e-2)}
# bf16 output: kernel and plain version both compute in fp32 and round once,
# so they differ by at most one bf16 ulp, <= 2**-7 of the largest output
BF16_REL_TO_MAX = 2.0 ** -7
XCHECK_TOL = dict(atol=1e-3, rtol=1e-3)
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12          # H100 SXM, fp32 outside the tensor cores
PAGE = 16
DEVICE = "cuda"

# the serving phase's shape: batch 4 (+1 pad row), prompt 40, 16 new tokens
SERVE_ARGV = ["--arch", "smollm_360m", "--cluster", "A100,L4", "--stages",
              "2", "--batch", "4", "--prompt", "40", "--new-tokens", "16",
              "--max-len", "64"]
XCHECK_ARGV = ["--arch", "smollm_360m", "--cluster", "A100,L4", "--stages",
               "2", "--batch", "2", "--prompt", "40", "--new-tokens", "4",
               "--max-len", "64"]


def phase(name):
    print(f"\n== {name} ==", flush=True)


def require(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def sync():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def make_inputs(B, H, KH, D, NP, lengths, *, q_dtype, kv, gen, P=None,
                dead_ids=False):
    """Random q / pool / shuffled block tables on the card.  ``kv`` is
    "same" (pages in q's dtype) or "int8" (int8 pages + f32 scales)."""
    dev = DEVICE
    P = P or B * NP + 1
    q = torch.randn(B, H, D, generator=gen, device=dev).to(q_dtype)
    shape = (P, PAGE, KH, D)
    if kv == "int8":
        k = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        ks = torch.rand(P, KH, generator=gen, device=dev) * 0.02 + 1e-3
        vs = torch.rand(P, KH, generator=gen, device=dev) * 0.02 + 1e-3
    else:
        k = torch.randn(shape, generator=gen, device=dev).to(q_dtype)
        v = torch.randn(shape, generator=gen, device=dev).to(q_dtype)
        ks = vs = None
    perm = torch.randperm(P - 1, generator=gen, device=dev)[:B * NP] + 1
    tables = perm.reshape(B, NP).to(torch.int32)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    if dead_ids:
        # entries past a row's live pages hold an id far outside the pool:
        # the kernel must never read them (the plain version clamps)
        live = (lengths.long() + PAGE - 1) // PAGE
        dead = torch.arange(NP, device=dev)[None, :] >= live[:, None]
        tables = tables.masked_fill(dead, 2 ** 31 - 1)
    return ((q, k, v, tables.contiguous(), lengths),
            dict(k_scales=ks, v_scales=vs))


def check_case(name, args, kw, tol):
    out = paged_attention(*args, **kw)
    sync()
    ref = paged_attention_ref(*args, kw["k_scales"], kw["v_scales"])
    err = (out.float() - ref.float()).abs().max().item()
    ok = torch.allclose(out.float(), ref.float(), **TOL[tol])
    tol_txt = f"atol=rtol={TOL[tol]['atol']:g}"
    if tol == "bf16":
        limit = BF16_REL_TO_MAX * ref.float().abs().max().item()
        ok = ok and err <= limit
        tol_txt += f", <= {limit:.3g}"
    print(f"  {name:<44} max|kernel-plain| = {err:.3e}  "
          f"({tol_txt}) {'ok' if ok else 'FAIL'}")
    require(ok and torch.isfinite(out.float()).all(),
            f"paged_attention disagrees with its plain version on {name}: "
            f"max abs err {err}")
    return err


def kernel_checks():
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    errs = []
    shapes = {"smoke H4/KH2/D16": (4, 2, 16, 4),
              "smollm H15/KH5/D64": (15, 5, 64, 4)}
    for sname, (H, KH, D, NP) in shapes.items():
        lens = [1, PAGE, PAGE + 1, NP * PAGE, 37, 0]
        for dt, kv, tol in ((torch.float32, "same", "f32"),
                            (torch.bfloat16, "same", "bf16"),
                            (torch.float32, "int8", "f32"),
                            (torch.bfloat16, "int8", "bf16")):
            args, kw = make_inputs(len(lens), H, KH, D, NP, lens, q_dtype=dt,
                                   kv=kv, gen=gen, dead_ids=True)
            tag = f"{sname} {str(dt)[6:]} {kv} lens={lens}"
            errs.append(check_case(tag, args, kw, tol))
    # lengths crossing the kernel's 64-token tiles (kTileTokens in
    # paged_attention.cu): the running max and denominator are rescaled
    # between tiles, held here at the f32 tolerance too
    long_lens = [63, 64, 65, 128, 129, 1999, 2048, 1, 0]
    for sname, (H, KH, D, _) in shapes.items():
        for dt, kv, tol in ((torch.float32, "same", "f32"),
                            (torch.float32, "int8", "f32"),
                            (torch.bfloat16, "same", "bf16"),
                            (torch.bfloat16, "int8", "bf16")):
            args, kw = make_inputs(len(long_lens), H, KH, D, 128, long_lens,
                                   q_dtype=dt, kv=kv, gen=gen, dead_ids=True)
            tag = f"{sname} {str(dt)[6:]} {kv} multi-tile lens={long_lens}"
            errs.append(check_case(tag, args, kw, tol))
    # long context, the second timing shape
    args, kw = make_inputs(32, 15, 5, 64, 128, [2048] * 31 + [1999],
                           q_dtype=torch.bfloat16, kv="same", gen=gen)
    errs.append(check_case("smollm bf16 B=32 L=2048", args, kw, "bf16"))
    return max(errs)


def time_ms(fn, reps=100, warmup=10):
    """Median over ``reps`` launches of one call, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(args):
    """Least time for the same work: the bytes the function must move (q
    and out once, each live K/V page once, the live block-table entries
    and the lengths) over HBM bandwidth vs its fp32 operations (QK and PV
    over the live tokens) over the fp32 peak; the larger bounds it."""
    q, k, v, tables, lengths = args
    B, H, D = q.shape
    KH = k.shape[2]
    lens = lengths.long().cpu()
    live_pages = int(((lens + PAGE - 1) // PAGE).sum())
    elt = k.element_size()
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * live_pages * PAGE * KH * D * elt
              + live_pages * 4 + B * 4)
    flops = 4 * H * D * int(lens.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sdpa_yardstick(args):
    """Dense-attention yardstick on already gathered K/V (not the same
    function: it leaves out the page gather; the port never calls it)."""
    q, k, v, tables, lengths = args
    B, H, D = q.shape
    KH = k.shape[2]
    NP = tables.shape[1]
    kd = k[tables.long()].reshape(B, NP * PAGE, KH, D).transpose(1, 2)
    vd = v[tables.long()].reshape(B, NP * PAGE, KH, D).transpose(1, 2)
    kd = kd.repeat_interleave(H // KH, dim=1).contiguous()
    vd = vd.repeat_interleave(H // KH, dim=1).contiguous()
    mask = (torch.arange(NP * PAGE, device=DEVICE)[None]
            < lengths[:, None].long())[:, None, None, :]
    qd = q[:, :, None, :]
    f = torch.nn.functional.scaled_dot_product_attention
    return lambda: f(qd, kd, vd, attn_mask=mask)


def kernel_timings(pool_pages):
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    out = {}
    # main path decode shape: 4 requests mid-decode (length 48 of the
    # 40 + 16 budget) + the pad row (scratch page, length 1), one node's
    # pool, bf16
    shapes = {"decode": (5, [48, 48, 48, 48, 1], 4, pool_pages),
              "B32_L2048": (32, [2048] * 32, 128, None)}
    for key, (B, lens, NP, P) in shapes.items():
        args, kw = make_inputs(B, 15, 5, 64, NP, lens, q_dtype=torch.bfloat16,
                               kv="same", gen=gen, P=P)
        ms = time_ms(lambda: paged_attention(*args, **kw))
        plain_ms = time_ms(lambda: paged_attention_ref(*args), reps=20)
        yard_ms = time_ms(sdpa_yardstick(args))
        bound_ms, bound_by = bound(args)
        out[key] = dict(shape=f"B={B} H=15 KH=5 D=64 page={PAGE} NP={NP} "
                              f"lengths={lens if B <= 5 else '32x2048'} bf16",
                        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, yardstick_ms=yard_ms)
        print(f"  {key}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa(dense, gathered) {yard_ms:.4f} ms, bound {bound_ms:.5f} "
              f"ms ({bound_by})", flush=True)
    return out


# ---------------------------------------------------------------------------
# serving + cross-check
# ---------------------------------------------------------------------------

class LastStageLogits:
    """Records last-stage logits per request while active: the final
    prefill chunk's and every decode pass's (by position)."""

    def __init__(self):
        self.prefill, self.decode = {}, {}

    def __enter__(self):
        self._orig = (PagedStageEngine.prefill_chunk,
                      PagedStageEngine.decode_stage)
        rec = self
        orig_pf, orig_dec = self._orig

        def prefill_chunk(eng, slot, x, entry, start):
            out = orig_pf(eng, slot, x, entry, start)
            if eng.is_last:
                rec.prefill[eng.slots[slot]] = np.array(out)   # last chunk wins
            return out

        def decode_stage(eng, items):
            outs = orig_dec(eng, items)
            if eng.is_last:
                for it, o in zip(items, outs):
                    rec.decode.setdefault(eng.slots[it.slot], {})[it.pos] = \
                        np.array(o.logits)
            return outs

        PagedStageEngine.prefill_chunk = prefill_chunk
        PagedStageEngine.decode_stage = decode_stage
        return self

    def __exit__(self, *exc):
        PagedStageEngine.prefill_chunk, PagedStageEngine.decode_stage = \
            self._orig


def serving_phase():
    args = serve.parse_args(SERVE_ARGV + ["--device", DEVICE])
    cfg = serve.build_config(args)
    print(f"  {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"H={cfg.num_heads}/KH={cfg.num_kv_heads} D={cfg.resolved_head_dim} "
          f"vocab={cfg.vocab_size} {cfg.param_dtype}")
    params = init(cfg, args.seed, device=DEVICE)
    warm = serve.parse_args(SERVE_ARGV + ["--device", DEVICE,
                                          "--new-tokens", "2"])
    serve.run_cluster(cfg, warm, params, verbose=False)     # CUDA warm-up
    k1.launches = 0
    with LastStageLogits() as rec:
        rt, reqs, p, dt = serve.run_cluster(cfg, args, params)
    launches = k1.launches
    toks = sum(len(r.output) for r in reqs)
    require(all(r.done and len(r.output) == args.new_tokens for r in reqs),
            "not every request finished with all its tokens")
    require(all(0 <= t < cfg.vocab_size for r in reqs for t in r.output),
            "token ids outside the vocabulary")
    for rid in range(len(reqs)):
        require(len(rt.served[rid].stages) >= 2,
                f"req{rid} served on {rt.served[rid]}")
        require(np.isfinite(rec.prefill[rid]).all() and
                all(np.isfinite(l).all() for l in rec.decode[rid].values()),
                f"req{rid}: non-finite last-stage logits")
    used = rt.pool_pages_used()
    require(all(u == 0 for u in used.values()), f"pages leaked: {used}")
    expected = sum(e.decode_steps * e.n_paged for e in rt.engines.values())
    passes = {n: e.decode_steps for n, e in rt.engines.items()}
    require(expected > 0 and launches == expected,
            f"{launches} kernel launches, expected {expected}")
    print(f"  placement: " + ", ".join(
        f"{n}=[{r.start},{r.end})"
        for n, r in sorted(p.placement.assignment.items())))
    print(f"  {len(reqs)} requests, {toks} tokens in {dt:.4f} s = "
          f"{toks / dt:.2f} tokens/s (host clock, after a warm-up run)")
    print(f"  paged_attention launches: {launches} = decode passes {passes} "
          f"x paged layers {({n: e.n_paged for n, e in rt.engines.items()})}; "
          f"pools drained {used}")
    pool_pages = max(e.pool.num_pages for e in rt.engines.values())
    return launches, toks / dt, pool_pages


def cross_check():
    args_gpu = serve.parse_args(XCHECK_ARGV + ["--device", DEVICE])
    args_cpu = serve.parse_args(XCHECK_ARGV + ["--device", "cpu"])
    cfg = dataclasses.replace(serve.build_config(args_gpu),
                              param_dtype="float32", compute_dtype="float32")
    params_cpu = init(cfg, args_gpu.seed, device="cpu")
    params_gpu = map_tree(lambda t: t.to(DEVICE), params_cpu)
    runs = {}
    for name, args, params in (("cuda", args_gpu, params_gpu),
                               ("cpu", args_cpu, params_cpu)):
        with LastStageLogits() as rec:
            _, reqs, _, dt = serve.run_cluster(cfg, args, params,
                                               verbose=False)
        runs[name] = (rec, [r.output for r in reqs])
        print(f"  {name}: tokens {runs[name][1]} ({dt:.2f} s)")
    (g, g_tok), (c, c_tok) = runs["cuda"], runs["cpu"]
    worst = 0.0
    for rid in sorted(c.prefill):
        first_pos = min(c.decode[rid])
        for what, a, b in (("prefill", g.prefill[rid], c.prefill[rid]),
                           ("decode", g.decode[rid][first_pos],
                            c.decode[rid][first_pos])):
            err = float(np.abs(a - b).max())
            worst = max(worst, err)
            print(f"  req{rid} first {what} logits: max|cuda-cpu| = "
                  f"{err:.3e} (max |logit| {np.abs(b).max():.3f})")
            require(np.allclose(a, b, **XCHECK_TOL),
                    f"req{rid} {what} logits differ beyond {XCHECK_TOL}: "
                    f"{err}")
    require(g_tok == c_tok, f"greedy tokens differ: cuda {g_tok} cpu {c_tok}")
    print(f"  greedy tokens equal; worst logit gap {worst:.3e}")


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on the card only", file=sys.stderr)
        return 2
    phase("device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("build")
    t0 = time.perf_counter()
    lib = k1.build()
    print(f"  built {os.path.relpath(lib, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in k1.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    phase("kernel")
    max_err = kernel_checks()

    phase("serving")
    launches, tok_s, pool_pages = serving_phase()

    phase("kernel timings")
    t = kernel_timings(pool_pages)

    phase("cross-check f32 cuda vs cpu")
    cross_check()

    print(f"serving: {tok_s:.2f} tokens/s on {card}")
    main_t = t["decode"]
    # no single PyTorch call computes paged attention (the gather through
    # the block table included), so library_ms is null; yardstick_ms is
    # scaled_dot_product_attention on K/V gathered beforehand
    record = {"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:96",
        "launches": launches, "max_abs_err": max_err,
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": None, "yardstick_ms": main_t["yardstick_ms"],
        "shape": main_t["shape"], "B32_L2048": t["B32_L2048"]}]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
