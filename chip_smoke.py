#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device   — prints the card's name and power limit (nvidia-smi); TF32
                off for matmuls and convolutions.
  2. build    — compiles both kernels (paged_attention.cu, K1, and
                flash_attention.cu, K2) with nvcc for sm_90a from
                ``src/repro_torch/csrc``, the two builds started together;
                prints each instance's registers, shared memory and spills
                (-Xptxas -v); an instance that spills fails the run.
  3. K1       — paged decode attention (split-K) against its plain PyTorch
                version on the card, f32 / bf16 / int8 + scales with f32 or
                bf16 q: smoke and full smollm shapes with ragged lengths (1,
                page, page+1, NP*page, 37 and 0); lengths across the ring's
                stages and the splits (63, 64, 65, 128, 129, 1999, 2048, 1,
                0 at NP=128), at the splits ``num_splits`` chooses and
                forced to 1, 2, 3, 7 and NP; D=128 with G=8 and D=256 with
                G=2; B=1 at L = 2047, 2048, 2049, 32767 and 32768; B=32 at
                L=2048, and a B=32 batch mixing lengths 0, 1 and 2048 on
                int8 pages; shuffled block tables whose dead entries point
                far outside the pool.  Bounds: f32 and int8-with-f32-q
                atol=rtol=1e-5 (same fp32 math, other summation order);
                bf16 and int8-with-bf16-q each element within 2**-7 x
                |plain| + 1e-5 (one bf16 rounding of that element).  Every
                call counts one launch, and one split launch when it runs
                more than one split (the forced ones > 1 and B=1, L=32768
                among them); an empty batch launches nothing; a call
                replayed from a CUDA graph equals the eager call.
  4. K2       — flash prefill attention against its plain version: every
                mask (causal, bidirectional, causal + window 100) at every
                D 16, 64, 128, G 1, 3, 4 and Sq = Sk in {1, 37, 64, 65,
                127, 128, 129, 511, 2048, 4096}, B 1 or 3 in turn; Sq != Sk
                both ways; strided (B,S,H,D) views; an empty q launches
                nothing.  f32 (CUDA-core kernel): max error <= 1e-5; bf16
                (tensor-core kernel, every bf16 case counted through it):
                each element within 2**-7 x |plain| + 1e-5 (one output
                rounding of that element).  Prints the worst error over
                its limit of each dtype.
  5. serving  — full-width smollm-360m in bf16 through ``launch/serve.py
                --cluster A100,L4 --stages 2``: paged (4 x 40-token prompts,
                16 new tokens; K1 launches == decode passes x paged layers,
                none of them split, K2 none) and ``--dense`` (prompts of 37,
                128, 300 and 511 tokens, 16 new tokens, max_len 576; K2
                launches == 32 x request prefills, all through the
                tensor-core kernel, K1 none).  Every request done, every
                pool or slot released, >= 2 nodes per request; tokens/s
                printed.
  6. speculative serving — the paged cluster of phase 5 (same plan,
                prompts, 16 new tokens, max_len 64) with a draft model at
                the coordinator, γ = 4: (a) ``--draft smollm_360m``, the
                target's own weights (a perfect draft: spec_accepted > 0,
                tokens per round trip > 1); (b) a bad draft, the same
                config cut to 4 layers with weights from another seed
                (spec_rejected > 0: the rollback runs on the card).  Both:
                greedy tokens equal to phase 5's, pools and draft slots
                drained, K1 launches == decode passes (verify sub-steps
                included) x paged layers with none split, K2 launches ==
                the draft's prefills x its layers, all through the
                tensor-core kernel.  Prints the spec counters, tokens/s on
                the host clock and the mean decode latency on the virtual
                clock (links modelled at 1 ms and 10 Gb/s, the serving
                cluster's, beside a non-speculative run on the same links).
  7. engines  — ``Engine`` (K2 launches == 32 x prefills, all through the
                tensor-core kernel) and ``PagedEngine`` (``--paged``; K1
                launches == 32 x decode steps; its split launches printed)
                at full width.
  8. profile  — both cluster runs again under ``torch.profiler``: device
                busy time against the unprofiled wall time, top kernels.
  9. timings  — CUDA events around each call (the host's launch
                included): K1 at the serving decode shape, at B=32, L=2048
                on bf16 and on int8 pages and at B=1, L=32768, in turns
                with its plain version and ``scaled_dot_product_attention``
                on already gathered K/V (a yardstick, not the same
                function), then both again as 20 calls in a CUDA graph,
                with TB/s and the share of its bound;
                K2 at B=1, causal, bf16: H=15, KH=5, D=64 at S=511 and
                S=4096, and H=32, KH=8, D=128 at S=4096, in turns with its
                plain version and ``scaled_dot_product_attention`` (the
                same function), then both again as 20 calls in a CUDA
                graph (no host launch in the time), with TFLOP/s and the
                share of its bound.  The port never calls SDPA.
  10. cross-checks, f32 — the paged cluster at full depth on cuda and on
                the CPU (plain versions), same weights: first-prefill and
                first-decode logits allclose at atol=rtol=1e-3, tokens
                equal; then at full width and 4 layers, the dense cluster,
                paged cluster, ``Engine`` and ``PagedEngine`` on cuda, the
                dense cluster on the CPU, the paged and dense clusters
                speculating with a bad draft (another seed's weights) on
                cuda (and the paged one with a perfect draft, whose
                acceptance in f32 is printed), and phase 11's runs (a),
                (c) and (e) with their plans cut to [0,4), [0,2) and
                [2,4): equal greedy tokens, dense first-prefill logits
                cuda vs cpu within 1e-3.
  11. disaggregated serving — runs after phase 5's dense run, whose tokens
                it reuses.  Plans of ``disaggregated_placement`` on a full
                mesh of A100s at 1 ms and 10 Gb/s (the links phase 6
                models), driven through ``run_cluster(plan=...)`` with
                phase 5's weights, 32 layers split at 16: (a) prefill
                {n0: all}, decode {n1: [0,16), n2: [16,32)}, paged, phase
                5's requests, at depth 1 and 2; (b) prefill {n0: [0,16),
                n1: [16,32)}, decode {n2: [0,16), n1: [16,32)}: n1 is
                ``mixed``, depth 2; (c) plan (a) dense, the dense phase's
                requests; (d) plan (a) paged with the perfect draft of
                phase 6, γ = 4; (e) plan (a) plus a full-model decode node
                n3, depth 2: stepped until a request decoding through n1
                has two tokens, then ``fail_node("n1")``,
                ``replan_after_failure`` and ``apply_plan``, run to the
                end.  Checks: every request done, every pool and slot
                released; (a)-(d) greedy tokens equal to phase 5's (dense:
                the dense phase's); (a) decode served on n1 and n2 only,
                n0 decodes nothing, each handoff link carries >= one
                transfer per request and exactly the profile's KV bytes
                per token and layer x prompt tokens x 16; (b) n1 -> n2
                carries tokens only; (c) K2 launches == 32 x n0's
                prefills, all tensor-core, none on the decode nodes; (e)
                n1 gone, preemptions > 0, and the bf16 tokens that agree
                with phase 5's are printed.  K1 launches == decode passes
                x paged layers over every engine that ran (n1's too), none
                split; K2 none but (c)'s and the draft's prefills x its
                layers in (d).  Then one handoff byte for byte: a slot
                exported from n0, imported on n1 and re-exported from n1
                is ``torch.equal``.  Prints each run's tokens/s (host
                clock), virtual-clock mean TPOT and link ledger.
The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.  Without CUDA it exits non-zero at once.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels.flash_attention import kernel as k2  # noqa: E402
from repro_torch.kernels.flash_attention import ops as k2_ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_ref)
from repro_torch.kernels.paged_attention import kernel as k1  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention, paged_attention_ref)
from repro_torch.core import (LayerRange, MILPOptions,  # noqa: E402
                              ModelProfile, disaggregated_placement,
                              full_mesh_cluster, plan, replan_after_failure)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import init  # noqa: E402
from repro_torch.models.common import map_tree  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.runtime import (  # noqa: E402
    ClusterRuntime, InProcessTransport)
from repro_torch.serving.stage_engine import (  # noqa: E402
    PagedStageEngine, StageEngine, _StageEngineBase)

K1_F32_TOL = dict(atol=1e-5, rtol=1e-5)   # the same fp32 math, other order
# bf16 output: kernel and plain version both compute in fp32 and round once,
# so each element differs by at most one bf16 ulp, <= 2**-7 of its value
# (+ BF16_ATOL for values near 0)
BF16_REL = 2.0 ** -7
BF16_ATOL = 1e-5
K2_F32_ATOL = 1e-5     # K2 f32: the same fp32 math in another order
XCHECK_TOL = dict(atol=1e-3, rtol=1e-3)
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12          # H100 SXM, fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12         # H100 SXM, bf16 tensor cores, dense
PAGE = 16
DEVICE = "cuda"

# the serving phase's shape: batch 4 (+1 pad row), prompt 40, 16 new tokens
SERVE_ARGV = ["--arch", "smollm_360m", "--cluster", "A100,L4", "--stages",
              "2", "--batch", "4", "--prompt", "40", "--new-tokens", "16",
              "--max-len", "64"]
XCHECK_ARGV = ["--arch", "smollm_360m", "--cluster", "A100,L4", "--stages",
               "2", "--batch", "2", "--prompt", "40", "--new-tokens", "4",
               "--max-len", "64"]
# the dense serving phase: prompts of 37, 128, 300 and 511 tokens (single-
# shot prefill through K2 on both stages), 16 new tokens each
DENSE_ARGV = ["--arch", "smollm_360m", "--cluster", "A100,L4", "--stages",
              "2", "--dense", "--batch", "4", "--prompt", "37,128,300,511",
              "--new-tokens", "16", "--max-len", "576"]
# the speculative phase: the paged serving phase's argv, γ = 4; the bad
# draft is the target's config cut to BAD_DRAFT_LAYERS layers, with weights
# from the seed + BAD_DRAFT_SEED
SPEC_ARGV = SERVE_ARGV + ["--spec-tokens", "4"]
BAD_DRAFT_LAYERS = 4
BAD_DRAFT_SEED = 7
# links of the speculative phase's virtual clock: make_serving_cluster's
# 1 ms and 10 Gb/s
LINK_DELAY_S = 1e-3
LINK_BYTES_PER_S = 10e9 / 8
# the engines phase: Engine (dense) and PagedEngine (--paged), one node
ENGINES_ARGV = ["--arch", "smollm_360m", "--batch", "4", "--prompt",
                "37,128,300,511", "--new-tokens", "8", "--max-len", "576"]
# the four-path cross-check, at full width and DENSE_XCHECK_LAYERS layers
DENSE_XCHECK_LAYERS = 4
DENSE_XCHECK_ARGV = ["--arch", "smollm_360m", "--cluster", "A100,L4",
                     "--stages", "2", "--batch", "4", "--prompt",
                     "37,128,300,511", "--new-tokens", "8", "--max-len",
                     "576"]


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


def check_case(name, args, kw, tol, splits=None):
    """One K1 call against its plain version on the same inputs.  f32 and
    int8-with-f32-q: atol = rtol = 1e-5 (the same fp32 math, other
    summation order).  bf16 and int8-with-bf16-q: each element within
    2**-7 x |plain| + 1e-5 (both compute in fp32 and round the output
    once, so they differ by at most one bf16 ulp of that element).  Checks
    that the call counted one launch, and one split launch when it ran
    more than one split (``splits`` forced, or as ``num_splits`` chooses).
    Returns (max abs error, worst error over its limit, ``tol``)."""
    q, k, _, tables, _ = args
    before = (k1.launches, k1.split_launches)
    out = paged_attention(*args, **kw, num_splits=splits)
    sync()
    ref = paged_attention_ref(*args, kw["k_scales"], kw["v_scales"])
    ran = splits or k1.num_splits(q.shape[0], k.shape[2], tables.shape[1],
                                  PAGE, k1.sm_count(q.device))
    diff = (out.float() - ref.float()).abs()
    ref_abs = ref.float().abs()
    if tol == "f32":
        limit = K1_F32_TOL["atol"] + K1_F32_TOL["rtol"] * ref_abs
        tol_txt = f"atol=rtol={K1_F32_TOL['atol']:g}"
    else:
        limit = BF16_REL * ref_abs + BF16_ATOL
        tol_txt = f"2**-7 x |plain| + {BF16_ATOL:g}"
    err = diff.max().item()
    worst = (diff / limit).max().item()
    ok = worst <= 1.0 and bool(torch.isfinite(out.float()).all())
    print(f"  {name:<52} splits {ran:>3}: max|kernel-plain| = {err:.3e}, "
          f"worst err/limit {worst:.3f} ({tol_txt}) {'ok' if ok else 'FAIL'}")
    require(ok, f"paged_attention disagrees with its plain version on {name}"
                f" ({ran} splits): max abs err {err}, worst err/limit {worst}")
    require((k1.launches, k1.split_launches) ==
            (before[0] + 1, before[1] + (ran > 1)),
            f"{name}: launches {before} -> "
            f"{(k1.launches, k1.split_launches)} for one call of {ran} "
            "splits")
    return err, worst, tol


DTYPE_PAIRS = ((torch.float32, "same", "f32"),
               (torch.bfloat16, "same", "bf16"),
               (torch.float32, "int8", "f32"),
               (torch.bfloat16, "int8", "bf16"))


def kernel_checks():
    """K1 against its plain version at every dtype pair; see the module
    note (phase 3) for the cases.  Returns the largest abs error and the
    worst error over its limit of the f32 and the bf16 bounds."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    res = []
    shapes = {"smoke H4/KH2/D16": (4, 2, 16, 4),
              "smollm H15/KH5/D64": (15, 5, 64, 4)}
    for sname, (H, KH, D, NP) in shapes.items():
        lens = [1, PAGE, PAGE + 1, NP * PAGE, 37, 0]
        for dt, kv, tol in DTYPE_PAIRS:
            args, kw = make_inputs(len(lens), H, KH, D, NP, lens, q_dtype=dt,
                                   kv=kv, gen=gen, dead_ids=True)
            tag = f"{sname} {str(dt)[6:]} {kv} lens={lens}"
            res.append(check_case(tag, args, kw, tol))
    # lengths crossing the ring's stages (4 KB of K a stage: 32 tokens at
    # D=64 in bf16) and the splits, at the splits num_splits chooses and
    # at forced ones: the running max and denominator are rescaled between
    # tokens and merged across lane groups, warps and splits
    long_lens = [63, 64, 65, 128, 129, 1999, 2048, 1, 0]
    for sname, (H, KH, D, _) in shapes.items():
        for dt, kv, tol in DTYPE_PAIRS:
            args, kw = make_inputs(len(long_lens), H, KH, D, 128, long_lens,
                                   q_dtype=dt, kv=kv, gen=gen, dead_ids=True)
            tag = f"{sname} {str(dt)[6:]} {kv} multi-tile"
            for splits in (None, 1, 2, 3, 7, 128):
                res.append(check_case(tag, args, kw, tol, splits))
    # heads of the wider GQA models (ROADMAP queue 2 item 1): D=128 with
    # G=8, D=256 with G=2
    for H, KH, D in ((16, 2, 128), (8, 4, 256)):
        for dt, kv, tol in DTYPE_PAIRS:
            args, kw = make_inputs(len(long_lens), H, KH, D, 128, long_lens,
                                   q_dtype=dt, kv=kv, gen=gen, dead_ids=True)
            tag = f"H{H}/KH{KH}/D{D} {str(dt)[6:]} {kv} multi-tile"
            for splits in (None, 3):
                res.append(check_case(tag, args, kw, tol, splits))
    # one long sequence: split across the card by num_splits
    for L in (2047, 2048, 2049, 32767, 32768):
        args, kw = make_inputs(1, 15, 5, 64, -(-L // PAGE), [L],
                               q_dtype=torch.bfloat16, kv="same", gen=gen)
        before = k1.split_launches
        res.append(check_case(f"smollm bf16 B=1 L={L}", args, kw, "bf16"))
        require(L != 32768 or k1.split_launches == before + 1,
                "the B=1, L=32768 call was not a split launch")
    # long context, the timing shape, and a batch mixing 0, 1 and 2048
    # tokens on int8 pages
    args, kw = make_inputs(32, 15, 5, 64, 128, [2048] * 31 + [1999],
                           q_dtype=torch.bfloat16, kv="same", gen=gen)
    res.append(check_case("smollm bf16 B=32 L=2048", args, kw, "bf16"))
    mixed = ([0, 1, 2048] * 11)[:32]
    for dt, tol in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        args, kw = make_inputs(32, 15, 5, 64, 128, mixed, q_dtype=dt,
                               kv="int8", gen=gen, dead_ids=True)
        res.append(check_case(f"smollm {str(dt)[6:]} int8 B=32 lens 0/1/2048",
                              args, kw, tol))
    # an empty batch launches nothing
    args, kw = make_inputs(0, 15, 5, 64, 4, [], q_dtype=torch.bfloat16,
                           kv="same", gen=gen)
    before = (k1.launches, k1.split_launches)
    empty = paged_attention(*args, **kw)
    require(empty.shape == (0, 15, 64) and
            (k1.launches, k1.split_launches) == before,
            "paged_attention launched (or counted) a kernel for B=0")
    # a call captured in a CUDA graph and replayed gives the eager output,
    # with one split (the decode shape) and with many (B=1, L=32768)
    for B, L, NP in ((5, 48, 4), (1, 32768, 2048)):
        args, kw = make_inputs(B, 15, 5, 64, NP, [L] * B,
                               q_dtype=torch.bfloat16, kv="same", gen=gen)
        eager = paged_attention(*args, **kw)
        graph, out = capture(lambda: paged_attention(*args, **kw))
        graph.replay()
        sync()
        require(torch.equal(out, eager), f"K1 replayed from a CUDA graph "
                                         f"differs from the eager call (L={L})")
    worst = {t: max((w for _, w, tt in res if tt == t), default=0.0)
             for t in ("f32", "bf16")}
    print(f"  {len(res)} cases, all within their bounds; worst err/limit f32 "
          f"{worst['f32']:.3f} (atol=rtol=1e-5), bf16 {worst['bf16']:.3f} "
          f"(2**-7 x |plain| + 1e-5); empty batch: no launch; a CUDA graph "
          "replay equals the eager call (1 split and 105+)")
    return max(e for e, _, _ in res), worst


def capture(fn):
    """``fn`` captured once in a CUDA graph (after one call off the default
    stream, as capture needs): returns the graph and the captured call's
    output."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


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


def bound(args, kw):
    """Least time for the same work: the bytes the function must move (q
    and out once, each live K/V page once with its scales for int8, the
    live block-table entries and the lengths) over HBM bandwidth vs its
    fp32 operations (QK and PV over the live tokens, and the int8 pages'
    scale multiplies) over the fp32 peak; the larger bounds it."""
    q, k, v, tables, lengths = args
    B, H, D = q.shape
    KH = k.shape[2]
    lens = lengths.long().cpu()
    live_pages = int(((lens + PAGE - 1) // PAGE).sum())
    elt = k.element_size()
    quant = kw["k_scales"] is not None
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * live_pages * PAGE * KH * D * elt
              + (2 * live_pages * KH * 4 if quant else 0)
              + live_pages * 4 + B * 4)
    flops = (4 * H * D + (2 * KH * D if quant else 0)) * int(lens.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def sdpa_yardstick(args, kw):
    """Dense-attention yardstick on already gathered K/V (not the same
    function: it leaves out the page gather, and int8 pages are
    dequantised to q's dtype beforehand; the port never calls it)."""
    q, k, v, tables, lengths = args
    B, H, D = q.shape
    KH = k.shape[2]
    NP = tables.shape[1]
    ids = tables.long()

    def gather(pages, scales):
        x = pages[ids]
        if scales is not None:
            x = x.float() * scales[ids][:, :, None, :, None]
        x = x.to(q.dtype).reshape(B, NP * PAGE, KH, D).transpose(1, 2)
        return x.repeat_interleave(H // KH, dim=1).contiguous()
    kd, vd = gather(k, kw["k_scales"]), gather(v, kw["v_scales"])
    mask = (torch.arange(NP * PAGE, device=DEVICE)[None]
            < lengths[:, None].long())[:, None, None, :]
    qd = q[:, :, None, :]
    f = torch.nn.functional.scaled_dot_product_attention
    return lambda: f(qd, kd, vd, attn_mask=mask)


def kernel_timings(pool_pages):
    """K1 (smollm heads: H=15, KH=5, D=64, bf16 q) at the serving decode
    shape, at B=32, L=2048 on bf16 and on int8 pages, and at B=1,
    L=32768: CUDA events around each call (the host's launch included),
    in turns with its plain version and the SDPA yardstick, then the
    kernel and the yardstick again as 20 calls replayed from one CUDA
    graph (no host launch); achieved bytes/s and the share of the bound
    of each."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    out = {}
    # main path decode shape: 4 requests mid-decode (length 48 of the
    # 40 + 16 budget) + the pad row (scratch page, length 1), one node's
    # pool, bf16
    shapes = {"decode": (5, [48, 48, 48, 48, 1], 4, pool_pages, "same"),
              "B32_L2048": (32, [2048] * 32, 128, None, "same"),
              "B32_L2048_int8": (32, [2048] * 32, 128, None, "int8"),
              "B1_L32768": (1, [32768], 2048, None, "same")}
    for key, (B, lens, NP, P, kv) in shapes.items():
        args, kw = make_inputs(B, 15, 5, 64, NP, lens, q_dtype=torch.bfloat16,
                               kv=kv, gen=gen, P=P)
        splits = k1.num_splits(B, 5, NP, PAGE, k1.sm_count(args[0].device))
        t = time_turns({
            "kernel": (lambda: paged_attention(*args, **kw), 50),
            "yardstick": (sdpa_yardstick(args, kw), 50),
            "plain": (lambda: paged_attention_ref(
                *args, kw["k_scales"], kw["v_scales"]), 10)})
        dev = graph_ms(lambda: paged_attention(*args, **kw))
        yard_dev = graph_ms(sdpa_yardstick(args, kw))
        bound_ms, bound_by, nbytes = bound(args, kw)
        lens_txt = lens if B <= 5 else f"{B}x{lens[0]}"
        out[key] = dict(shape=f"B={B} H=15 KH=5 D=64 page={PAGE} NP={NP} "
                              f"lengths={lens_txt} q bf16, pages "
                              f"{'int8' if kv == 'int8' else 'bf16'}",
                        splits=splits, ms=t["kernel"], plain_ms=t["plain"],
                        bound_ms=bound_ms, bound_by=bound_by,
                        yardstick_ms=t["yardstick"], graph_ms=dev,
                        yardstick_graph_ms=yard_dev,
                        tb_per_s=nbytes / t["kernel"] / 1e9,
                        bound_share=bound_ms / t["kernel"],
                        graph_tb_per_s=nbytes / dev / 1e9,
                        graph_bound_share=bound_ms / dev)
        r = out[key]
        print(f"  {key} ({r['shape']}, {splits} splits): kernel "
              f"{r['ms']:.4f} ms = {r['tb_per_s']:.3f} TB/s, "
              f"{100 * r['bound_share']:.1f}% of the bound {bound_ms:.5f} ms "
              f"({bound_by}); in a CUDA graph {dev:.4f} ms = "
              f"{r['graph_tb_per_s']:.3f} TB/s, "
              f"{100 * r['graph_bound_share']:.1f}% of the bound; sdpa "
              f"(dense, gathered) {r['yardstick_ms']:.4f} ms, in a CUDA graph "
              f"{yard_dev:.4f} ms; plain {r['plain_ms']:.4f} ms", flush=True)
    return out


# ---------------------------------------------------------------------------
# K2: flash prefill attention
# ---------------------------------------------------------------------------

K2_MASKS = {"causal": dict(causal=True, window=0),
            "bidirectional": dict(causal=False, window=0),
            "causal+window100": dict(causal=True, window=100)}


def k2_check(name, q, k, v, mask, *, bshd=False):
    """One K2 case against its plain version on the same inputs.  f32:
    max error <= 1e-5 (the same fp32 math in another order).  bf16: each
    element within 2**-7 x |plain| + 1e-5 of its plain value: both compute
    in fp32 (the kernel's P.V from P split into bf16 hi and lo parts, within
    2**-17 of fp32 P) and round the output once, so they differ by at most
    one bf16 ulp of that element (an ulp is <= 2**-7 of the value).
    Returns (max abs error, worst error over its limit); a case out of
    bounds is printed and fails the run."""
    kw = K2_MASKS[mask]
    if bshd:       # model layout, passed as strided views
        out = k2_ops.flash_attention_bshd(q, k, v, **kw)
        ref = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), **kw).transpose(1, 2)
    else:
        out = flash_attention(q, k, v, **kw)
        ref = flash_attention_ref(q, k, v, **kw)
    sync()
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    if q.dtype == torch.float32:
        limit = torch.full_like(diff, K2_F32_ATOL)
    else:
        limit = BF16_REL * ref.float().abs() + BF16_ATOL
    worst = (diff / limit).max().item()       # <= 1 passes
    ok = worst <= 1.0 and bool(torch.isfinite(out.float()).all())
    if not ok:
        print(f"  {name} {mask}: max|kernel-plain| = {err:.3e}, worst "
              f"err/limit {worst:.3f} FAIL")
    require(ok, f"flash_attention disagrees with its plain version on "
                f"{name} {mask}: max abs err {err}, worst err/limit {worst}")
    return err, worst


def k2_inputs(B, H, KH, Sq, Sk, D, dtype, gen):
    q = torch.randn(B, H, Sq, D, generator=gen, device=DEVICE).to(dtype)
    k = torch.randn(B, KH, Sk, D, generator=gen, device=DEVICE).to(dtype)
    v = torch.randn(B, KH, Sk, D, generator=gen, device=DEVICE).to(dtype)
    return q, k, v


K2_SEQS = (1, 37, 64, 65, 127, 128, 129, 511, 2048, 4096)


def k2_checks():
    """Every mask at every G: D 16/64/128 x G 1/3/4 x Sq = Sk in K2_SEQS
    (across the f32 kernel's 64-row and the bf16 kernel's 128-row tiles, up
    to a long prompt) x three masks, B 1 or 3 in turn, f32 and bf16;
    Sq != Sk both ways; strided (B,S,H,D) inputs, among them slices of one
    fused qkv tensor; an empty q launches nothing.  Every bf16 launch goes
    through the tensor-core kernel.  Prints one line per (dtype, D) group
    and returns the worst error over its limit of each dtype and the
    largest abs error."""
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    groups = {}           # (dtype, D or case kind) -> [(err, worst, name)]

    def run(dt, key, name, *args, **kw):
        err, worst = k2_check(name, *args, **kw)
        groups.setdefault((dt, key), []).append((err, worst, name))

    tc_before, all_before = k2.tc_launches, k2.launches
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        n = 0
        for D, G, S in itertools.product((16, 64, 128), (1, 3, 4), K2_SEQS):
            for mask in K2_MASKS:
                B = (1, 3)[n % 2]
                n += 1
                KH = 2 if D == 16 else 5 if D == 64 else 2
                q, k, v = k2_inputs(B, KH * G, KH, S, S, D, dtype, gen)
                run(dt, f"D={D}", f"{dt} B={B} H={KH * G} KH={KH} S={S} "
                    f"D={D}", q, k, v, mask)
        for Sq, Sk in ((37, 511), (511, 37), (65, 2048), (2048, 65),
                       (1, 100), (100, 1), (300, 129)):
            for mask in K2_MASKS:
                q, k, v = k2_inputs(2, 15, 5, Sq, Sk, 64, dtype, gen)
                run(dt, "Sq!=Sk", f"{dt} B=2 H=15 KH=5 Sq={Sq} Sk={Sk} D=64",
                    q, k, v, mask)
        for S, D, H, KH in ((511, 64, 15, 5), (300, 128, 8, 2),
                            (65, 16, 4, 2)):
            for mask in K2_MASKS:
                qkv = torch.randn(2, S, H + 2 * KH, D, generator=gen,
                                  device=DEVICE).to(dtype)
                q, k, v = (qkv[:, :, :H], qkv[:, :, H:H + KH],
                           qkv[:, :, H + KH:])
                run(dt, "(B,S,H,D)", f"{dt} fused-qkv (B,S,H,D) views S={S} "
                    f"H={H} KH={KH} D={D}", q, k, v, mask, bshd=True)
                q, k, v = (x.transpose(1, 2).contiguous()
                           for x in k2_inputs(2, H, KH, S, S, D, dtype, gen))
                run(dt, "(B,S,H,D)", f"{dt} (B,S,H,D) S={S} H={H} KH={KH} "
                    f"D={D}", q, k, v, mask, bshd=True)
    for (dt, key), rows in groups.items():
        err, worst, name = max(rows, key=lambda r: r[1])
        print(f"  {dt:<9} {key:<10} {len(rows):>3} cases: max|kernel-plain| "
              f"= {max(r[0] for r in rows):.3e}, worst err/limit "
              f"{worst:.3f} ({name})")
    n_bf16 = sum(len(r) for (dt, _), r in groups.items() if dt == "bfloat16")
    require(k2.tc_launches - tc_before == n_bf16 and
            k2.launches - all_before == sum(map(len, groups.values())),
            f"{k2.tc_launches - tc_before} tensor-core launches for "
            f"{n_bf16} bf16 cases")
    before = k2.launches
    q, k, v = k2_inputs(2, 15, 5, 0, 37, 64, torch.bfloat16, gen)
    empty = flash_attention(q, k, v)
    require(empty.shape == q.shape and k2.launches == before,
            "flash_attention launched (or counted) a kernel for an empty q")
    worst = {dt: max(w for (d, _), rows in groups.items() if d == dt
                     for _, w, _ in rows) for dt in ("float32", "bfloat16")}
    print(f"  {sum(map(len, groups.values()))} cases, all within their "
          f"bounds; worst err/limit f32 {worst['float32']:.3f} (limit "
          f"{K2_F32_ATOL:g}), bf16 {worst['bfloat16']:.3f} (limit 2**-7 x "
          f"|plain| + {BF16_ATOL:g}); every bf16 case through the "
          f"tensor-core kernel ({n_bf16} launches); empty q (Sq=0): no "
          f"launch, none counted")
    err = max(e for rows in groups.values() for e, _, _ in rows)
    return err, worst


def k2_work(q, k, causal):
    """The bytes the function must move (q, k, v read once, out written
    once) and its FLOPs, 4*D per visible (query, key) pair per query
    head."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    pairs = (sum(min(i + 1, Sk) for i in range(Sq)) if causal
             else Sq * Sk)
    return nbytes, 4 * B * H * D * pairs


def k2_bound(q, k, causal):
    """Least time for the same work: its bytes over HBM bandwidth vs its
    FLOPs over the bf16 (or fp32) peak; the larger bounds it."""
    nbytes, flops = k2_work(q, k, causal)
    peak = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_turns(fns):
    """Median ms of each of ``fns`` (name -> (fn, launches per turn)),
    timed in turns: the order, then the order reversed."""
    times = {name: [] for name in fns}
    order = list(fns)
    for names in (order, order[::-1]):
        for name in names:
            fn, n = fns[name]
            times[name].append(time_ms(fn, reps=n))
    return {name: float(np.median(t)) for name, t in times.items()}


def graph_ms(fn, calls=20):
    """Time of one call of ``fn`` without the host's launch: ``calls``
    calls captured in one CUDA graph, its replay timed with CUDA events
    (median of 10 after a warm-up), divided by ``calls``."""
    graph, _ = capture(lambda: [fn() for _ in range(calls)])
    return time_ms(graph.replay, reps=10, warmup=1) / calls


K2_TIMING_SHAPES = {       # key -> (H, KH, S, D), B=1, causal, bf16
    "S511": (15, 5, 511, 64),          # the dense serving prefill
    "S4096": (15, 5, 4096, 64),
    "D128_S4096": (32, 8, 4096, 128),
}


def k2_timings():
    """K2 (the tensor-core kernel) at the dense serving shape (one
    511-token prompt), at S=4096 and at S=4096 with H=32, KH=8, D=128,
    causal, bf16; timed with CUDA events around each call (the host's
    launch included), in turns with its plain version and with
    ``scaled_dot_product_attention`` (the same function for causal Sq =
    Sk; timed only, the port never calls it), then without the host's
    launch (``graph_ms``); beside its bound, with TFLOP/s counting 4*H*D
    per visible pair."""
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for key, (H, KH, S, D) in K2_TIMING_SHAPES.items():
        q, k, v = k2_inputs(1, H, KH, S, S, D, torch.bfloat16, gen)
        t = time_turns({
            "kernel": (lambda: flash_attention(q, k, v, causal=True), 50),
            "library": (lambda: sdpa(q, k, v, is_causal=True,
                                     enable_gqa=True), 50),
            "plain": (lambda: flash_attention_ref(q, k, v, causal=True),
                      10)})
        dev = graph_ms(lambda: flash_attention(q, k, v, causal=True))
        lib_dev = graph_ms(lambda: sdpa(q, k, v, is_causal=True,
                                        enable_gqa=True))
        bound_ms, bound_by = k2_bound(q, k, True)
        flops = k2_work(q, k, True)[1]
        out[key] = dict(shape=f"B=1 H={H} KH={KH} S={S} D={D} causal bf16",
                        ms=t["kernel"], plain_ms=t["plain"],
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=t["library"],
                        tflops=flops / t["kernel"] / 1e9,
                        bound_share=bound_ms / t["kernel"],
                        graph_ms=dev, library_graph_ms=lib_dev,
                        graph_tflops=flops / dev / 1e9,
                        graph_bound_share=bound_ms / dev)
        r = out[key]
        print(f"  {key} ({r['shape']}): kernel {r['ms']:.4f} ms = "
              f"{r['tflops']:.1f} TFLOP/s, {100 * r['bound_share']:.1f}% of "
              f"the bound {bound_ms:.5f} ms ({bound_by}); in a CUDA graph "
              f"{dev:.4f} ms = {r['graph_tflops']:.1f} TFLOP/s, "
              f"{100 * r['graph_bound_share']:.1f}% of the bound; sdpa "
              f"{r['library_ms']:.4f} ms, in a CUDA graph {lib_dev:.4f} ms = "
              f"{flops / lib_dev / 1e9:.1f} TFLOP/s; plain "
              f"{r['plain_ms']:.4f} ms", flush=True)
    return out


# ---------------------------------------------------------------------------
# serving + cross-check
# ---------------------------------------------------------------------------

class LastStageLogits:
    """Records last-stage logits per request while active, on paged and
    dense stage engines: the final prefill pass's (the last chunk wins) and
    every decode pass's (by position)."""

    def __init__(self):
        self.prefill, self.decode = {}, {}

    def __enter__(self):
        self._orig = (PagedStageEngine.prefill_chunk,
                      StageEngine.prefill_stage, _StageEngineBase.decode_stage)
        rec = self
        orig_chunk, orig_stage, orig_dec = self._orig

        def record(eng, slot, out):
            if eng.is_last:
                rec.prefill[eng.slots[slot]] = np.array(out)
            return out

        def prefill_chunk(eng, slot, x, entry, start):
            return record(eng, slot, orig_chunk(eng, slot, x, entry, start))

        def prefill_stage(eng, slot, x, entry):
            return record(eng, slot, orig_stage(eng, slot, x, entry))

        def decode_stage(eng, items):
            outs = orig_dec(eng, items)
            if eng.is_last:
                for it, o in zip(items, outs):
                    rec.decode.setdefault(eng.slots[it.slot], {})[it.pos] = \
                        np.array(o.logits)
            return outs

        PagedStageEngine.prefill_chunk = prefill_chunk
        StageEngine.prefill_stage = prefill_stage
        _StageEngineBase.decode_stage = decode_stage
        return self

    def __exit__(self, *exc):
        (PagedStageEngine.prefill_chunk, StageEngine.prefill_stage,
         _StageEngineBase.decode_stage) = self._orig


def zero_counts():
    k1.launches = 0
    k1.split_launches = 0
    k2.launches = 0
    k2.tc_launches = 0


def check_requests(cfg, reqs, new_tokens, served=None, rec=None):
    """Every request done with all its tokens, ids in the vocabulary, and
    (cluster runs) served on >= 2 nodes with finite last-stage logits."""
    require(all(r.done and len(r.output) == new_tokens for r in reqs),
            "not every request finished with all its tokens")
    require(all(0 <= t < cfg.vocab_size for r in reqs for t in r.output),
            "token ids outside the vocabulary")
    for r in reqs if served is not None else ():
        rid = r.request_id
        require(len(served[rid].stages) >= 2, f"req{rid} on {served[rid]}")
        require(np.isfinite(rec.prefill[rid]).all() and
                all(np.isfinite(l).all() for l in rec.decode[rid].values()),
                f"req{rid}: non-finite last-stage logits")


def serving_phase(cfg, params):
    """Paged cluster serving: K1 in every decode pass of every layer, K2
    never."""
    args = serve.parse_args(SERVE_ARGV + ["--device", DEVICE])
    warm = serve.parse_args(SERVE_ARGV + ["--device", DEVICE,
                                          "--new-tokens", "2"])
    serve.run_cluster(cfg, warm, params, verbose=False)     # CUDA warm-up
    zero_counts()
    with LastStageLogits() as rec:
        rt, reqs, p, dt = serve.run_cluster(cfg, args, params)
    launches, k2_launches = k1.launches, k2.launches
    split_launches = k1.split_launches
    toks = sum(len(r.output) for r in reqs)
    check_requests(cfg, reqs, args.new_tokens, rt.served, rec)
    used = rt.pool_pages_used()
    require(all(u == 0 for u in used.values()), f"pages leaked: {used}")
    expected = sum(e.decode_steps * e.n_paged for e in rt.engines.values())
    passes = {n: e.decode_steps for n, e in rt.engines.items()}
    require(expected > 0 and launches == expected,
            f"{launches} paged_attention launches, expected {expected}")
    require(split_launches == 0,
            f"{split_launches} paged_attention launches ran more than one "
            "split at the serving decode's NP = 4")
    require(k2_launches == 0, f"{k2_launches} flash_attention launches on "
                              "the paged path, expected 0")
    print(f"  placement: " + ", ".join(
        f"{n}=[{r.start},{r.end})"
        for n, r in sorted(p.placement.assignment.items())))
    print(f"  {len(reqs)} requests, {toks} tokens in {dt:.4f} s = "
          f"{toks / dt:.2f} tokens/s (host clock, after a warm-up run)")
    print(f"  paged_attention launches: {launches} = decode passes {passes} "
          f"x paged layers {({n: e.n_paged for n, e in rt.engines.items()})}, "
          f"none split (split_launches 0); flash_attention launches: 0; "
          f"pools drained {used}")
    pool_pages = max(e.pool.num_pages for e in rt.engines.values())
    return ((launches, split_launches), toks / dt, pool_pages, dt,
            [r.output for r in reqs])


def bad_draft(cfg, seed):
    """A low-acceptance draft: ``cfg`` cut to ``BAD_DRAFT_LAYERS`` layers at
    full width, with weights from another seed."""
    dcfg = dataclasses.replace(cfg, repeats=BAD_DRAFT_LAYERS)
    return dcfg, init(dcfg, seed + BAD_DRAFT_SEED, device=DEVICE)


def link_model():
    return InProcessTransport(default_delay_s=LINK_DELAY_S,
                              bandwidth_bytes_per_s=LINK_BYTES_PER_S)


def check_spec_run(rt, reqs, ref_tokens, name):
    """One speculative cluster run: tokens equal to the non-speculative
    paged phase's, pools and draft slots drained, K1 launches == decode
    passes x paged layers (none split) and K2 launches == the draft's
    prefills x its layers (all tensor-core).  Returns the launch counts."""
    got = [r.output for r in reqs]
    require(got == ref_tokens, f"{name}: speculative tokens {got} differ "
                               f"from the non-speculative run's {ref_tokens}")
    used = rt.pool_pages_used()
    require(all(u == 0 for u in used.values()), f"{name}: pages leaked {used}")
    require(rt.draft.free_slots == len(rt.draft.slots) and
            rt.draft.kv_tokens_used() == 0,
            f"{name}: draft slots not released")
    expected = sum(e.decode_steps * e.n_paged for e in rt.engines.values())
    require(k1.launches == expected > 0 and k1.split_launches == 0,
            f"{name}: {k1.launches} paged_attention launches "
            f"({k1.split_launches} split), expected {expected} (none split)")
    dl = rt.draft.layers.num_layers
    require(k2.launches == rt.draft.prefills * dl > 0 and
            k2.tc_launches == k2.launches and
            rt.draft.prefills >= len(reqs),
            f"{name}: {k2.launches} flash_attention launches "
            f"({k2.tc_launches} tensor-core) for {rt.draft.prefills} draft "
            f"prefills x {dl} layers")
    return dict(k1=k1.launches, k1_split=k1.split_launches, k2=k2.launches,
                k2_tc=k2.tc_launches)


def spec_serving_phase(cfg, params, ref_tokens, card):
    """The paged cluster speculating with (a) a perfect draft (``--draft
    smollm_360m``: the target's own weights) and (b) a bad one, γ = 4, on
    modelled links; beside a non-speculative run on the same links for the
    virtual-clock decode latency."""
    args = serve.parse_args(SPEC_ARGV + ["--device", DEVICE])
    bad = bad_draft(cfg, args.seed)
    serve.run_cluster(cfg, serve.parse_args(
        SPEC_ARGV + ["--device", DEVICE, "--new-tokens", "3"]), params,
        draft=bad, verbose=False)                            # warm-up
    rt0, reqs0, _, _ = serve.run_cluster(cfg, args, params,
                                         transport=link_model(),
                                         verbose=False)
    require([r.output for r in reqs0] == ref_tokens,
            "non-speculative tokens on modelled links differ from phase 5's")
    base_lat = rt0.mean_decode_latency()
    print(f"  non-speculative on the same links: mean decode latency "
          f"{1e3 * base_lat:.4f} ms/token (virtual clock)")
    out = {}
    for name, argv, draft in (
            ("perfect", ["--draft", "smollm_360m"], None),
            ("bad", [], bad)):
        run_args = serve.parse_args(SPEC_ARGV + argv + ["--device", DEVICE])
        zero_counts()
        rt, reqs, _, dt = serve.run_cluster(cfg, run_args, params,
                                            draft=draft,
                                            transport=link_model(),
                                            verbose=False)
        counts = check_spec_run(rt, reqs, ref_tokens, name)
        if name == "perfect":
            require(rt.spec_accepted > 0 and
                    rt.spec_tokens_per_round_trip > 1,
                    f"perfect draft: {rt._spec_note()}")
        else:
            require(rt.spec_rejected > 0, f"bad draft: {rt._spec_note()}")
        toks = sum(len(r.output) for r in reqs)
        lat = rt.mean_decode_latency()
        print(f"  ({name}) draft {rt.draft_cfg.name} "
              f"{rt.draft_cfg.num_layers}L, gamma {rt.spec_tokens}: "
              f"{rt._spec_note()} rounds={rt.spec_rounds} "
              f"cancelled_inflight={rt.cancelled_inflight}")
        print(f"  ({name}) {len(reqs)} requests, {toks} tokens in {dt:.4f} s "
              f"= {toks / dt:.2f} tokens/s on {card} (host clock); mean "
              f"decode latency {1e3 * lat:.4f} ms/token (virtual clock: "
              f"modelled links, not compute) against {1e3 * base_lat:.4f} "
              "non-speculative")
        print(f"  ({name}) paged_attention launches {counts['k1']} = decode "
              f"passes {({n: e.decode_steps for n, e in rt.engines.items()})}"
              f" x paged layers, none split; flash_attention launches "
              f"{counts['k2']} = {rt.draft.prefills} draft prefills x "
              f"{rt.draft.layers.num_layers} layers, all tensor-core; tokens "
              "equal to phase 5's; pools and draft slots drained")
        out[name] = dict(counts, tokens_per_s=toks / dt, latency_s=lat,
                         spec=rt._spec_note())
    return out, base_lat


def dense_serving_phase(cfg, params, card):
    """Dense cluster serving (``--dense``): K2 in every prefill of every
    layer, K1 never (dense decode is plain torch)."""
    args = serve.parse_args(DENSE_ARGV + ["--device", DEVICE])
    warm = serve.parse_args(DENSE_ARGV + ["--device", DEVICE,
                                          "--new-tokens", "2"])
    serve.run_cluster(cfg, warm, params, verbose=False)     # CUDA warm-up
    zero_counts()
    with LastStageLogits() as rec:
        rt, reqs, p, dt = serve.run_cluster(cfg, args, params)
    launches, tc_launches, k1_launches = (k2.launches, k2.tc_launches,
                                          k1.launches)
    toks = sum(len(r.output) for r in reqs)
    check_requests(cfg, reqs, args.new_tokens, rt.served, rec)
    require(all(isinstance(e, StageEngine) for e in rt.engines.values()),
            "--dense built a paged engine")
    held = {n: e.kv_tokens_used() for n, e in rt.engines.items()
            if e.kv_tokens_used() or e.free_slots != len(e.slots)}
    require(not held, f"dense slots not released: {held}")
    prefills = len(reqs) + sum(r.preemptions for r in reqs)
    passes = sum(e.prefills * e.layers.num_layers
                 for e in rt.engines.values())
    require(launches == cfg.num_layers * prefills == passes,
            f"{launches} flash_attention launches, expected "
            f"{cfg.num_layers} x {prefills} request prefills = {passes}")
    require(tc_launches == launches,
            f"{tc_launches} of {launches} bf16 flash_attention launches "
            "went through the tensor-core kernel")
    require(k1_launches == 0, f"{k1_launches} paged_attention launches on "
                              "the dense path, expected 0")
    print(f"  placement: " + ", ".join(
        f"{n}=[{r.start},{r.end})"
        for n, r in sorted(p.placement.assignment.items())))
    print(f"  flash_attention launches: {launches} = {cfg.num_layers} layers "
          f"x {prefills} request prefills (prompts "
          f"{[len(r.prompt) for r in reqs]}), all {tc_launches} through "
          "the tensor-core kernel; paged_attention launches: 0")
    print(f"  dense serving: {len(reqs)} requests, {toks} tokens in "
          f"{dt:.4f} s = {toks / dt:.2f} tokens/s on {card} (host clock, "
          f"after a warm-up run)")
    return (launches, tc_launches), toks / dt, dt, [r.output for r in reqs]


# ---------------------------------------------------------------------------
# disaggregated prefill/decode and failover
# ---------------------------------------------------------------------------

def disagg_plan(cfg, prefill, decode):
    """A plan of ``disaggregated_placement(prefill, decode)`` ({node: (start,
    end)} groups) on a full mesh of A100s with 1 ms, 10 Gb/s links — the
    tests' ``harness.make_cluster``."""
    placement = disaggregated_placement(
        {n: LayerRange(*r) for n, r in prefill.items()},
        {n: LayerRange(*r) for n, r in decode.items()}, cfg.num_layers)
    profile = ModelProfile.from_dims(
        cfg.name, cfg.num_layers, cfg.d_model, max(cfg.d_ff, 1),
        cfg.vocab_size, cfg.num_kv_heads, cfg.resolved_head_dim,
        kv_page_size=PAGE)
    cluster = full_mesh_cluster(len(placement.assignment),
                                bandwidth=LINK_BYTES_PER_S,
                                latency_s=LINK_DELAY_S)
    return plan(cluster, profile, placement=placement)


def disagg_layouts(L):
    """The phase's placements over L layers: (a) one full-model prefill
    node, a 2-stage decode replica; (b) a mixed node; (e) (a) plus a
    full-model decode node n3, for failover."""
    h = L // 2
    one = ({"n0": (0, L)}, {"n1": (0, h), "n2": (h, L)})
    mixed = ({"n0": (0, h), "n1": (h, L)}, {"n2": (0, h), "n1": (h, L)})
    fail = ({"n0": (0, L)}, {"n1": (0, h), "n2": (h, L), "n3": (0, L)})
    return one, mixed, fail


def k1_expected(engines):
    """K1 launches of a run: decode steps x paged layers over the paged
    engines that ran."""
    return sum(e.decode_steps * e.n_paged for e in engines
               if isinstance(e, PagedStageEngine))


def failover_run(cfg, args, params, layout):
    """Serve ``args``' requests on ``layout`` at ``--max-inflight``, step
    until a request whose decode pipeline crosses n1 has confirmed
    two tokens, then ``fail_node``, ``replan_after_failure`` and
    ``apply_plan``, and run to the end.  Returns (runtime, requests, every
    engine that ran, n1's decode steps, the new plan, the tokens confirmed
    before the failure, seconds)."""
    failed = "n1"
    p = disagg_plan(cfg, *layout)
    rt = ClusterRuntime(cfg, params, p, serve.engine_config(args),
                        paged=not args.dense, page_size=args.page_size,
                        max_inflight=args.max_inflight,
                        transport=link_model(), device=DEVICE)
    reqs = serve.make_requests(cfg, args)
    state = {}

    def run():
        for r in reqs:
            rt.submit(r)
        for _ in range(10000):
            if any(failed in {st.node for st in j.pipe.stages}
                   and len(j.req.output) >= 2 for j in rt.jobs.values()):
                break
            require(rt.step(), "runtime stalled before the failure")
        require(rt.jobs, f"no request in flight through {failed}")
        state["before"] = [list(r.output) for r in reqs]
        seen = dict.fromkeys(rt.engines.values())
        state["steps"] = rt.engines[failed].decode_steps
        rt.fail_node(failed)
        new = replan_after_failure(p, failed, MILPOptions(
            time_limit_s=5.0, lns_rounds=0, fgls_rounds=10))
        rt.apply_plan(new)
        rt.run_until_done()
        seen.update(dict.fromkeys(rt.engines.values()))
        state["engines"], state["plan"] = list(seen), new
    dt = serve.timed(torch.device(DEVICE), run)
    return (rt, reqs, state["engines"], state["steps"], state["plan"],
            state["before"], dt)


def check_drained(rt, name):
    used = rt.pool_pages_used()
    held = {n: e.kv_tokens_used() for n, e in rt.engines.items()
            if e.kv_tokens_used() or e.free_slots != len(e.slots)}
    require(all(u == 0 for u in used.values()) and not held,
            f"{name}: pages {used} or slots {held} not released")


def handoff_bytes_check(rt, reqs, src, dsts, layers_each, name):
    """Each (src, dst) link carried the profile's KV bytes of every
    prompt's tokens x the layers it hands over, and >= one handoff per
    request."""
    kv = rt.profile.kv_bytes_per_token_layer
    want = sum(kv * len(r.prompt) * layers_each for r in reqs)
    for dst in dsts:
        n, b = rt.transport.transfers[(src, dst)], \
            rt.transport.bytes_sent[(src, dst)]
        require(n >= len(reqs) and b == want,
                f"{name}: {src}->{dst} {n} transfers / {b} bytes, expected "
                f">= {len(reqs)} / {want}")


def one_handoff_check(rt, cfg, args):
    """Export a prefilled slot's layers [0, L/2) from n0, import them into
    n1 and export again from n1: byte for byte the same tensors."""
    src, dst = rt.engines["n0"], rt.engines["n1"]
    prompt = serve.make_requests(cfg, args)[0].prompt
    S, h = len(prompt), cfg.num_layers // 2
    a, b = src.alloc_slot(100), dst.alloc_slot(100)
    require(src.ensure(a, S) and dst.ensure(b, S + 1), "no room for a slot")
    for off in range(0, S, PAGE):
        src.prefill_chunk(a, prompt[off:off + PAGE], 0, off)
    sent = src.export_kv(a, S, list(range(h)))
    dst.import_kv(b, S, sent)
    back = dst.export_kv(b, S, list(range(h)))
    same = sent.keys() == back.keys() and all(
        torch.equal(sent[l][k], back[l][k]) for l in sent for k in sent[l])
    src.release(a)
    dst.release(b)
    nbytes = sum(t.numel() * t.element_size() for p in sent.values()
                 for t in p.values())
    require(same, "a KV handoff n0 -> n1 -> export is not byte-exact")
    print(f"  one handoff: {S} tokens x {h} layers ({nbytes} B of pages) "
          "n0 -> n1, re-exported from n1: torch.equal")


def disagg_serving_phase(cfg, params, ref_tokens, dense_tokens, base_lat,
                         card):
    """Disaggregated prefill/decode over the Helix cluster, runs (a)-(e):
    see the module note (phase 11).  Returns each run's rates, latency and
    launch counts."""
    L = cfg.num_layers
    one, mixed, fail = disagg_layouts(L)
    out = {}

    def report(name, rt, reqs, dt, extra=""):
        toks = sum(len(r.output) for r in reqs)
        out[name] = dict(tokens_per_s=toks / dt,
                         latency_s=rt.mean_decode_latency(),
                         k1=k1.launches, k2=k2.launches)
        print(f"  ({name}) {len(reqs)} requests, {toks} tokens in {dt:.4f} s "
              f"= {toks / dt:.2f} tokens/s on {card} (host clock); mean "
              f"decode latency {1e3 * rt.mean_decode_latency():.4f} ms/token "
              f"(virtual clock) against {1e3 * base_lat:.4f} on phase 6's "
              f"links without roles; K1 {k1.launches}, K2 {k2.launches}"
              f"{extra}")
        print(f"  ({name}) {rt.transport.describe()}")

    # (a) paged, one prefill node, at depth 1 and 2
    serve.run_cluster(cfg, serve.parse_args(
        SERVE_ARGV + ["--device", DEVICE, "--new-tokens", "2"]), params,
        plan=disagg_plan(cfg, *one), verbose=False)            # warm-up
    for depth in (1, 2):
        name = f"a depth{depth}"
        args = serve.parse_args(SERVE_ARGV + ["--device", DEVICE,
                                              "--max-inflight", str(depth)])
        zero_counts()
        rt, reqs, _, dt = serve.run_cluster(cfg, args, params,
                                            plan=disagg_plan(cfg, *one),
                                            transport=link_model(),
                                            verbose=False)
        require(rt.disaggregated and [r.output for r in reqs] == ref_tokens,
                f"({name}) tokens {[r.output for r in reqs]} differ from "
                f"phase 5's {ref_tokens}")
        check_requests(cfg, reqs, args.new_tokens)
        check_drained(rt, name)
        require(all({st.node for st in rt.served[r.request_id].stages}
                    == {"n1", "n2"} for r in reqs),
                f"({name}) decode served off the decode replica")
        require(rt.engines["n0"].decode_steps == 0 and
                sum(r.preemptions for r in reqs) == 0,
                f"({name}) n0 decoded or a request was preempted")
        handoff_bytes_check(rt, reqs, "n0", ("n1", "n2"), L // 2, name)
        want = k1_expected(rt.engines.values())
        require(k1.launches == want > 0 and k1.split_launches == 0 and
                k2.launches == 0,
                f"({name}) K1 {k1.launches} ({k1.split_launches} split), "
                f"expected {want}; K2 {k2.launches}, expected 0")
        report(name, rt, reqs, dt, f" = decode passes "
               f"{({n: e.decode_steps for n, e in rt.engines.items()})} x "
               "paged layers, none split; tokens equal to phase 5's")
    one_handoff_check(rt, cfg, args)

    # (b) a mixed node keeps its KV home
    name = "b mixed"
    args = serve.parse_args(SERVE_ARGV + ["--device", DEVICE,
                                          "--max-inflight", "2"])
    zero_counts()
    rt, reqs, p, dt = serve.run_cluster(cfg, args, params,
                                        plan=disagg_plan(cfg, *mixed),
                                        transport=link_model(), verbose=False)
    tr = rt.transport
    require(p.placement.meta["roles"] == {"n0": "prefill", "n1": "mixed",
                                          "n2": "decode"},
            f"({name}) roles {p.placement.meta['roles']}")
    require([r.output for r in reqs] == ref_tokens,
            f"({name}) tokens differ from phase 5's")
    check_drained(rt, name)
    handoff_bytes_check(rt, reqs, "n0", ("n2",), L // 2, name)
    require(tr.bytes_sent[("n1", "n2")] ==
            tr.transfers[("n1", "n2")] * rt.profile.token_bytes,
            f"({name}) n1 -> n2 carried {tr.bytes_sent[('n1', 'n2')]} bytes "
            f"in {tr.transfers[('n1', 'n2')]} transfers: not tokens only")
    want = k1_expected(rt.engines.values())
    require(k1.launches == want > 0 and k1.split_launches == 0 and
            k2.launches == 0, f"({name}) K1 {k1.launches}, expected {want}")
    report(name, rt, reqs, dt, "; n1's KV stayed home (n1 -> n2: tokens "
           "only); tokens equal to phase 5's")

    # (c) dense: K2 in every prefill on n0, none on the decode nodes
    name = "c dense"
    dargs = serve.parse_args(DENSE_ARGV + ["--device", DEVICE])
    serve.run_cluster(cfg, serve.parse_args(
        DENSE_ARGV + ["--device", DEVICE, "--new-tokens", "2"]), params,
        plan=disagg_plan(cfg, *one), verbose=False)            # warm-up
    zero_counts()
    rt, reqs, _, dt = serve.run_cluster(cfg, dargs, params,
                                        plan=disagg_plan(cfg, *one),
                                        transport=link_model(), verbose=False)
    require([r.output for r in reqs] == dense_tokens,
            f"({name}) tokens differ from the dense phase's")
    check_drained(rt, name)
    pre = {n: e.prefills for n, e in rt.engines.items()}
    require(k2.launches == L * pre["n0"] > 0 and
            k2.tc_launches == k2.launches and pre["n1"] == pre["n2"] == 0
            and k1.launches == 0,
            f"({name}) K2 {k2.launches} ({k2.tc_launches} tensor-core) for "
            f"prefills {pre}; K1 {k1.launches}")
    handoff_bytes_check(rt, reqs, "n0", ("n1", "n2"), L // 2, name)
    report(name, rt, reqs, dt, f" = {L} x {pre['n0']} prefills on n0, all "
           "tensor-core; decode nodes ran no prefill; decode passes "
           f"{({n: e.decode_steps for n, e in rt.engines.items()})}; tokens "
           "equal to the dense phase's")

    # (d) speculative, the perfect draft
    name = "d speculative"
    sargs = serve.parse_args(SPEC_ARGV + ["--draft", "smollm_360m",
                                          "--device", DEVICE])
    zero_counts()
    rt, reqs, _, dt = serve.run_cluster(cfg, sargs, params,
                                        plan=disagg_plan(cfg, *one),
                                        transport=link_model(), verbose=False)
    require([r.output for r in reqs] == ref_tokens,
            f"({name}) tokens differ from phase 5's")
    check_drained(rt, name)
    want = k1_expected(rt.engines.values())
    dl = rt.draft.layers.num_layers
    require(k1.launches == want > 0 and k1.split_launches == 0 and
            k2.launches == rt.draft.prefills * dl > 0 and
            k2.tc_launches == k2.launches and
            rt.draft.free_slots == len(rt.draft.slots),
            f"({name}) K1 {k1.launches} (expected {want}), K2 {k2.launches} "
            f"for {rt.draft.prefills} draft prefills x {dl} layers")
    report(name, rt, reqs, dt, f"; {rt._spec_note()} rounds="
           f"{rt.spec_rounds}; K2 = {rt.draft.prefills} draft prefills x "
           f"{dl} layers; tokens equal to phase 5's")
    out[name]["spec"] = rt._spec_note()

    # (e) failover of decode node n1 mid-decode, depth 2
    name = "e failover"
    fargs = serve.parse_args(SERVE_ARGV + ["--device", DEVICE,
                                           "--max-inflight", "2"])
    zero_counts()
    rt, reqs, engines, n1_steps, new, before, dt = failover_run(
        cfg, fargs, params, fail)
    check_requests(cfg, reqs, fargs.new_tokens)
    check_drained(rt, name)
    want = k1_expected(engines)
    pre = sum(r.preemptions for r in reqs)
    require("n1" not in rt.engines and pre > 0 and
            k1.launches == want > 0 and k1.split_launches == 0 and
            k2.launches == 0,
            f"({name}) engines {sorted(rt.engines)}, preemptions {pre}, K1 "
            f"{k1.launches} (expected {want}), K2 {k2.launches}")
    agree = sum(a == b for r, ref in zip(reqs, ref_tokens)
                for a, b in zip(r.output, ref))
    early = sum(a == b for out_, ref in zip(before, ref_tokens)
                for a, b in zip(out_, ref))
    report(name, rt, reqs, dt, f" = decode passes over every engine that "
           f"ran (n1: {n1_steps} before it failed) x paged layers; "
           f"{pre} preemptions; replanned to " + ", ".join(
               f"{n}=[{r.start},{r.end})" for n, r in
               sorted(new.placement.assignment.items()))
           + f" (disaggregated: {rt.disaggregated}); bf16 tokens equal to "
           f"phase 5's: {agree} of {sum(map(len, ref_tokens))} ({early} of "
           f"the {sum(map(len, before))} confirmed before the failure)")
    return out


# kernel names as the profiler shows them
K_NAMES = {"K1": ("paged_attention_split_kernel",
                  "paged_attention_combine_kernel"),
           "K2": ("flash_attention_tc_kernel", "flash_attention_f32_kernel")}


def profile_phase(cfg, params, walls):
    """Where the serving time goes: the paged and the dense cluster runs
    once more under ``torch.profiler`` (CPU + CUDA activities).  Sums the
    device time of every kernel and copy in the trace (device events
    only, so an op's time is not counted twice) and prints it beside the
    same run's wall time without the profiler (``walls``, from the serving
    phases) — their ratio is the device's busy share — and beside the
    profiled wall time (inflated by the profiler's own host cost); then
    the kernels with the most device time, and K1's and K2's share.
    Device time missing from the trace is reported as not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for name, argv in (("paged cluster", SERVE_ARGV),
                       ("dense cluster", DENSE_ARGV)):
        args = serve.parse_args(argv + ["--device", DEVICE])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, _, dt = serve.run_cluster(cfg, args, params, verbose=False)
        rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0),
                      key=lambda r: -r[1])
        if not rows:
            print(f"  {name}: device time not measured (the trace holds "
                  "no device events)")
            continue
        busy = sum(ms for _, ms, _ in rows)
        wall = 1e3 * walls[name]
        ours = {k: sum(ms for key, ms, _ in rows
                       if any(n in key for n in names))
                for k, names in K_NAMES.items()}
        print(f"  {name}: device busy {busy:.1f} ms in "
              f"{sum(n for _, _, n in rows)} kernels and copies = "
              f"{100 * busy / wall:.1f}% of the unprofiled wall time "
              f"{wall:.1f} ms (profiled wall {1e3 * dt:.1f} ms); K1 "
              f"{ours['K1']:.2f} ms, K2 {ours['K2']:.2f} ms")
        for key, ms, n in rows[:8]:
            print(f"    {ms:9.3f} ms {100 * ms / busy:5.1f}% x{n:<6} "
                  f"{key[:90]}")


def _engine_config(args):
    """The engines phase's config: the dense Engine's prompt bucket holds
    the longest prompt."""
    return EngineConfig(max_batch=args.batch, max_len=args.max_len,
                        prompt_len=args.max_len)


def _run_engine(cfg, params, args):
    """The dense single-node ``Engine`` on ``args``' requests."""
    eng = Engine(cfg, params, _engine_config(args), device=DEVICE)
    reqs = serve.make_requests(cfg, args)

    def run():
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
    return eng, reqs, serve.timed(torch.device(DEVICE), run)


def engines_phase(cfg, params):
    """The single-node engines at full width: ``Engine`` (dense: K2 in
    every prefill) and ``PagedEngine`` (``--paged``: K1 in every decode
    step), each with its launch counts."""
    args = serve.parse_args(ENGINES_ARGV + ["--device", DEVICE])
    _run_engine(cfg, params, serve.parse_args(
        ENGINES_ARGV + ["--device", DEVICE, "--new-tokens", "2"]))
    zero_counts()
    eng, reqs, dt = _run_engine(cfg, params, args)
    check_requests(cfg, reqs, args.new_tokens)
    require(k2.launches == cfg.num_layers * eng.prefills > 0 and
            k2.tc_launches == k2.launches and k1.launches == 0,
            f"Engine: {k2.launches} flash_attention launches "
            f"({k2.tc_launches} tensor-core) for {eng.prefills} prefills, "
            f"{k1.launches} paged_attention")
    require(not eng.active.any(), "Engine: slots still active")
    toks = sum(len(r.output) for r in reqs)
    print(f"  Engine: {len(reqs)} requests, {toks} tokens in {dt:.4f} s; "
          f"flash_attention launches {k2.launches} = {cfg.num_layers} x "
          f"{eng.prefills} prefills, all {k2.tc_launches} tensor-core; "
          "paged_attention 0")
    engine_k2 = (k2.launches, k2.tc_launches)

    paged = serve.parse_args(ENGINES_ARGV + ["--paged", "--device", DEVICE])
    serve.run_paged(cfg, serve.parse_args(
        ENGINES_ARGV + ["--paged", "--device", DEVICE, "--new-tokens", "2"]),
        params, verbose=False)
    zero_counts()
    peng, preqs, pdt = serve.run_paged(cfg, paged, params, verbose=False)
    check_requests(cfg, preqs, paged.new_tokens)
    require(k1.launches == cfg.num_layers * peng.decode_steps > 0 and
            k2.launches == 0,
            f"PagedEngine: {k1.launches} paged_attention launches for "
            f"{peng.decode_steps} decode steps, {k2.launches} "
            "flash_attention")
    require(peng.pool.used == 0, f"PagedEngine leaked {peng.pool.used} pages")
    ptoks = sum(len(r.output) for r in preqs)
    print(f"  PagedEngine: {len(preqs)} requests, {ptoks} tokens in "
          f"{pdt:.4f} s; paged_attention launches {k1.launches} = "
          f"{cfg.num_layers} x {peng.decode_steps} decode steps, "
          f"{k1.split_launches} of them split (table of "
          f"{peng.pool.blocks_per_seq} entries); flash_attention 0; pool "
          "drained")
    return engine_k2, (k1.launches, k1.split_launches)


def _xcheck_runs(cfg, params, argv):
    """The paged cluster on cuda and the CPU, last-stage logits recorded:
    returns ((gpu recorder, gpu tokens), (cpu recorder, cpu tokens))."""
    runs = {}
    for name, dev, p in (("cuda", DEVICE, params),
                         ("cpu", "cpu", map_tree(lambda t: t.cpu(), params))):
        args = serve.parse_args(argv + ["--device", dev])
        with LastStageLogits() as rec:
            _, reqs, _, dt = serve.run_cluster(cfg, args, p, verbose=False)
        runs[name] = (rec, [r.output for r in reqs])
        print(f"  {name}: tokens {runs[name][1]} ({dt:.2f} s)")
    return runs["cuda"], runs["cpu"]


def _compare_logits(g, c, what):
    worst = 0.0
    for rid in sorted(c.prefill):
        pairs = [("prefill", g.prefill[rid], c.prefill[rid])]
        if what == "decode":
            first_pos = min(c.decode[rid])
            pairs.append(("decode", g.decode[rid][first_pos],
                          c.decode[rid][first_pos]))
        for name, a, b in pairs:
            err = float(np.abs(a - b).max())
            worst = max(worst, err)
            print(f"  req{rid} first {name} logits: max|cuda-cpu| = "
                  f"{err:.3e} (max |logit| {np.abs(b).max():.3f})")
            require(np.allclose(a, b, **XCHECK_TOL),
                    f"req{rid} {name} logits differ beyond {XCHECK_TOL}: "
                    f"{err}")
    return worst


def cross_check(cfg32, params32):
    """Paged cluster, full depth, f32: cuda vs cpu."""
    (g, g_tok), (c, c_tok) = _xcheck_runs(cfg32, params32, XCHECK_ARGV)
    worst = _compare_logits(g, c, "decode")
    require(g_tok == c_tok, f"greedy tokens differ: cuda {g_tok} cpu {c_tok}")
    print(f"  greedy tokens equal; worst logit gap {worst:.3e}")


def dense_cross_check(cfg32, params32):
    """Full width at 4 layers, f32: on the card the dense cluster, the
    paged cluster, ``Engine``, ``PagedEngine``, the paged and dense
    clusters speculating with a bad draft and the paged one with a perfect
    draft (its own weights) give the same greedy tokens; the
    dense cluster's first-prefill logits on the card are within 1e-3 of
    the port's CPU run."""
    cfg4 = dataclasses.replace(cfg32, repeats=DENSE_XCHECK_LAYERS)
    params4 = dict(params32, super=map_tree(
        lambda t: t[:DENSE_XCHECK_LAYERS], params32["super"]))
    (g, g_tok), (c, c_tok) = _xcheck_runs(cfg4, params4,
                                          DENSE_XCHECK_ARGV + ["--dense"])
    worst = _compare_logits(g, c, "prefill")
    tokens = {"dense cluster cuda": g_tok, "dense cluster cpu": c_tok}
    args = serve.parse_args(DENSE_XCHECK_ARGV + ["--device", DEVICE])
    _, reqs, _, _ = serve.run_cluster(cfg4, args, params4, verbose=False)
    tokens["paged cluster cuda"] = [r.output for r in reqs]
    _, reqs, _ = _run_engine(cfg4, params4, args)
    tokens["Engine cuda"] = [r.output for r in reqs]
    args = serve.parse_args(DENSE_XCHECK_ARGV + ["--paged", "--device",
                                                 DEVICE])
    _, reqs, _ = serve.run_paged(cfg4, args, params4, verbose=False)
    tokens["PagedEngine cuda"] = [r.output for r in reqs]
    bad = bad_draft(cfg4, args.seed)
    for mode, name, draft in (("paged", "bad", bad), ("dense", "bad", bad),
                              ("paged", "perfect", (cfg4, params4))):
        sargs = serve.parse_args(DENSE_XCHECK_ARGV + ["--device", DEVICE]
                                 + (["--dense"] if mode == "dense" else []))
        rt, reqs, _, _ = serve.run_cluster(cfg4, sargs, params4, draft=draft,
                                           verbose=False)
        require((rt.spec_rejected if name == "bad" else rt.spec_accepted) > 0
                and all(u == 0 for u in rt.pool_pages_used().values()) and
                rt.draft.free_slots == len(rt.draft.slots),
                f"{mode} speculative run: {rt._spec_note()}, pools "
                f"{rt.pool_pages_used()}, draft slots free "
                f"{rt.draft.free_slots}")
        tokens[f"{mode} cluster cuda, {name} draft"] = [r.output for r in reqs]
        print(f"  {mode} cluster, {name} draft: {rt._spec_note()}")
    one, _, fail = disagg_layouts(DENSE_XCHECK_LAYERS)
    for mode in ("paged", "dense"):
        dargs = serve.parse_args(DENSE_XCHECK_ARGV + ["--device", DEVICE]
                                 + (["--dense"] if mode == "dense" else []))
        rt, reqs, _, _ = serve.run_cluster(cfg4, dargs, params4,
                                           plan=disagg_plan(cfg4, *one),
                                           transport=link_model(),
                                           verbose=False)
        check_drained(rt, f"{mode} disaggregated f32")
        tokens[f"{mode} disaggregated cuda"] = [r.output for r in reqs]
    fargs = serve.parse_args(DENSE_XCHECK_ARGV + ["--device", DEVICE,
                                                  "--max-inflight", "2"])
    rt, reqs, _, _, new, _, _ = failover_run(cfg4, fargs, params4, fail)
    check_drained(rt, "failover f32")
    require("n1" not in rt.engines and
            sum(r.preemptions for r in reqs) > 0,
            f"failover f32: engines {sorted(rt.engines)}, preemptions "
            f"{[r.preemptions for r in reqs]}")
    tokens["paged disaggregated cuda, n1 failed"] = [r.output for r in reqs]
    print(f"  failover f32: {sum(r.preemptions for r in reqs)} preemptions, "
          "replanned to " + ", ".join(
              f"{n}=[{r.start},{r.end})"
              for n, r in sorted(new.placement.assignment.items())))
    for name, toks in tokens.items():
        print(f"  {name}: {toks}")
    require(all(t == g_tok for t in tokens.values()),
            "greedy tokens differ between the serving paths")
    print(f"  greedy tokens equal on all {len(tokens)} runs; worst "
          f"first-prefill logit gap {worst:.3e}")


# ---------------------------------------------------------------------------

def _kernel_name(mangled):
    """``..._25flash_attention_tc_kernelILi64EEEv...`` ->
    ``flash_attention_tc_kernel<64>``: the length-prefixed identifier that
    ends in ``_kernel``, with its integer template arguments (or, where it
    has none, its mangled ones)."""
    for pos in range(len(mangled)):     # a prefix may end a run of digits
        m = re.compile(r"\d+").match(mangled, pos)
        if not m:
            continue
        ident = mangled[m.end():m.end() + int(m.group())]
        rest = mangled[m.end() + len(ident):]
        if ident.endswith("_kernel") and rest.startswith("I"):
            args = re.match(r"I(\w*?)EE", rest)
            raw = args.group(1) if args else ""
            ints = re.findall(r"Li(\d+)E", raw + "E")
            return f"{ident}<{','.join(ints) if ints else raw}>"
    return mangled


def ptxas_report(log):
    """Each entry function's registers, static shared memory, stack and
    spills, from nvcc's -Xptxas -v output."""
    entries, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            name = _kernel_name(m.group(1))
            cur = dict(name=name, regs=None, smem=0, stack=None,
                       spill_stores=None, spill_loads=None)
            entries.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(
                    int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["regs"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                cur["smem"] = int(m.group(1)) if m else 0
    return entries


def build_all():
    """Both kernels' nvcc builds, started together.  Prints each instance's
    registers, shared memory and spills (-Xptxas -v) and any ptxas warning;
    an instance that spills fails the run."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(lambda m: m.build(), (k1, k2)))
    print(f"  built {', '.join(os.path.relpath(l, ROOT) for l in libs)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for m in (k1, k2):
        if not m.build_log:
            print(f"  {m.__name__}: library built before this run, no ptxas "
                  "report")
            continue
        for line in m.build_log.splitlines():
            if "warning" in line.lower():
                print("  " + line.strip())
        for e in ptxas_report(m.build_log):
            dyn = ""
            if m is k2:
                kind, D = re.match(r"flash_attention_(\w+)_kernel<(\d+)>",
                                   e["name"]).groups()
                dyn = f", {k2.smem_bytes(kind == 'tc', int(D))} B dynamic smem"
            split = re.match(r"paged_attention_split_kernel<(\d)", e["name"])
            if split:
                kv = (torch.float32, torch.bfloat16, torch.int8)[
                    int(split.group(1))]
                sizes = [k1.smem_bytes(kv, D) for D in k1.HEAD_DIMS]
                lo, hi = min(sizes), max(sizes)
                dyn = (f", {lo} B dynamic smem" if lo == hi else
                       f", {lo}-{hi} B dynamic smem (by D)")
            print(f"  {e['name']}: {e['regs']} registers, {e['smem']} B "
                  f"static smem{dyn}, {e['stack']} B stack, spill stores "
                  f"{e['spill_stores']} B, spill loads {e['spill_loads']} B")
            require(e["spill_stores"] == 0 and e["spill_loads"] == 0,
                    f"{e['name']} spills registers")


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
    build_all()

    phase("kernel K1: paged_attention vs plain")
    k1_err, k1_worst = kernel_checks()

    phase("kernel K2: flash_attention vs plain")
    k2_err, k2_worst = k2_checks()

    args = serve.parse_args(SERVE_ARGV + ["--device", DEVICE])
    cfg = serve.build_config(args)
    print(f"\n  {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"H={cfg.num_heads}/KH={cfg.num_kv_heads} D={cfg.resolved_head_dim} "
          f"vocab={cfg.vocab_size} {cfg.param_dtype}")
    params = init(cfg, args.seed, device=DEVICE)

    phase("serving: paged cluster")
    k1_launches, tok_s, pool_pages, paged_s, paged_tokens = serving_phase(
        cfg, params)

    phase("serving: speculative paged cluster")
    spec, links_lat = spec_serving_phase(cfg, params, paged_tokens, card)

    phase("serving: dense cluster")
    k2_launches, dense_tok_s, dense_s, dense_tokens = dense_serving_phase(
        cfg, params, card)

    phase("serving: disaggregated prefill/decode and failover")
    disagg = disagg_serving_phase(cfg, params, paged_tokens, dense_tokens,
                                  links_lat, card)

    phase("engines: Engine and PagedEngine")
    engine_k2, engine_k1 = engines_phase(cfg, params)

    phase("profile: where the serving time goes")
    profile_phase(cfg, params, {"paged cluster": paged_s,
                                "dense cluster": dense_s})
    del params

    phase("kernel timings")
    t1 = kernel_timings(pool_pages)
    t2 = k2_timings()

    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    params32 = init(cfg32, args.seed, device=DEVICE)
    phase("cross-check f32: paged cluster cuda vs cpu")
    cross_check(cfg32, params32)

    phase(f"cross-check f32, {DENSE_XCHECK_LAYERS} layers: four serving "
          "paths")
    dense_cross_check(cfg32, params32)

    print(f"\nserving: paged {tok_s:.2f} tokens/s, dense "
          f"{dense_tok_s:.2f} tokens/s on {card}")
    main1, main2 = t1["decode"], t2["S511"]
    k1_shapes = {key: t1[key] for key in t1 if key != "decode"}
    # K1: no single PyTorch call computes paged attention (the gather
    # through the block table included), so library_ms is null and
    # yardstick_ms is scaled_dot_product_attention on K/V gathered
    # beforehand.  K2: scaled_dot_product_attention computes the same
    # function for causal Sq = Sk; its launches are the dense cluster's
    # (all through the tensor-core kernel, as the Engine phase's were).
    record = {"kernels": [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:96",
         "launches": k1_launches[0], "split_launches": k1_launches[1],
         "engine_launches": engine_k1[0],
         "engine_split_launches": engine_k1[1],
         "spec_launches": {k: v["k1"] for k, v in spec.items()},
         "spec_split_launches": {k: v["k1_split"] for k, v in spec.items()},
         "disagg_launches": {k: v["k1"] for k, v in disagg.items()},
         "max_abs_err": k1_err, "worst_err_over_limit": k1_worst,
         "ms": main1["ms"], "plain_ms": main1["plain_ms"],
         "bound_ms": main1["bound_ms"], "bound_by": main1["bound_by"],
         "library_ms": None, "yardstick_ms": main1["yardstick_ms"],
         "graph_ms": main1["graph_ms"],
         "yardstick_graph_ms": main1["yardstick_graph_ms"],
         "bound_share": main1["bound_share"],
         "graph_bound_share": main1["graph_bound_share"],
         "shape": main1["shape"], **k1_shapes},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:74",
         "launches": k2_launches[0], "tc_launches": k2_launches[1],
         "engine_launches": engine_k2[0], "engine_tc_launches": engine_k2[1],
         "spec_launches": {k: v["k2"] for k, v in spec.items()},
         "spec_tc_launches": {k: v["k2_tc"] for k, v in spec.items()},
         "disagg_launches": {k: v["k2"] for k, v in disagg.items()},
         "max_abs_err": k2_err, "worst_err_over_limit": k2_worst,
         "ms": main2["ms"], "plain_ms": main2["plain_ms"],
         "bound_ms": main2["bound_ms"], "bound_by": main2["bound_by"],
         "library_ms": main2["library_ms"], "tflops": main2["tflops"],
         "bound_share": main2["bound_share"], "shape": main2["shape"],
         "S4096": t2["S4096"], "D128_S4096": t2["D128_S4096"]}]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
