#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device   — prints the card's name and power limit (nvidia-smi); TF32
                off for matmuls and convolutions; the CPU's runs flush
                denormals to 0.
  2. build    — compiles the three kernel sources (paged_attention.cu,
                K1; flash_attention.cu, K2, D 16/64/128/256, the D=256
                tensor-core instance two warpgroups without a producer;
                flash_attention_bwd.cu, K2's backward: delta, and dK/dV
                and dQ on the tensor cores for bf16 or the CUDA cores for
                f32, D 16/64/128/256, the D=256 dK/dV instance's two
                warpgroups holding dV and dK apart) with nvcc for sm_90a
                from ``src/repro_torch/csrc``,
                the three builds started together; prints each instance's
                registers, shared memory and spills (-Xptxas -v); an
                instance that spills, or a missing D=256 forward instance,
                fails the run.
  3. K1       — paged decode attention (split-K) against its plain PyTorch
                version on the card, f32 / bf16 / int8 + scales with f32 or
                bf16 q: smoke and full smollm shapes with ragged lengths (1,
                page, page+1, NP*page, 37 and 0); lengths across the ring's
                stages and the splits (63, 64, 65, 128, 129, 1999, 2048, 1,
                0 at NP=128), at the splits ``num_splits`` chooses and
                forced to 1, 2, 3, 7 and NP; D=128 with G=8 and D=256 with
                G=2; the decode heads of phase 15's families at D=128
                (starcoder2 H=36/KH=4: G=9 in uneven head groups of 3;
                olmo H=KH=16; chameleon H=64/KH=8), f32 and bf16 pages,
                across the ring's stages, at the decode shape B=4 and at
                B=32, L=2048, each at the splits ``num_splits`` chooses
                and at 3; gemma3's decode heads (phase 18: H=16/KH=8,
                D=256, G=2), f32 and bf16, at phase 18's decode shape
                (B=4, lengths 600, 1116, 1515 and 2116, NP=133) and at
                B=32, L=2048, each at the splits ``num_splits`` chooses
                and at 3; B=1 at L = 2047, 2048, 2049, 32767 and 32768;
                B=32 at L=2048, and a B=32 batch mixing lengths 0, 1 and
                2048 on int8 pages; shuffled block tables whose dead entries
                point far outside the pool.  Bounds: f32 and int8-with-f32-q
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
                127, 128, 129, 511, 2048, 4096}, B 1 or 3 in turn; the
                prefill heads of phase 15's families at D=128, causal:
                H=KH=16 (G=1), H=36/KH=4 (G=9) and H=64/KH=8 at Sq = Sk
                in {37, 511, 2048}; gemma3's H=16/KH=8 at D=256 (phase
                16): S in {37, 511, 1500, 2048} x causal, causal + window
                1024 and bidirectional, window 100 (cutting the 64-key
                tiles) at S = 511 and 2048, Sq != Sk both ways, and
                phase 16's prefill shapes (S = 600, 1100, 1500, 2100,
                causal and window 1024) as (B,S,H,D) views; Sq != Sk both
                ways; strided (B,S,H,D) views; an empty q launches
                nothing.  f32 (CUDA-core kernel): max error <= 1e-5; bf16
                (tensor-core kernel, every bf16 case counted through it):
                each element within 2**-7 x |plain| + 1e-5 (one output
                rounding of that element).  Prints the worst error over
                its limit of each dtype.  Then with ``lse`` requested (f32
                and bf16, every D and mask, Sq != Sk both ways): ``out``
                bit-equal to the call without it, one launch, ``lse``
                within 1e-4 of ``attention_lse_ref`` (log2 domain), +inf
                exactly on the rows that see no key (D 16/64/128/256).
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
                on bf16 and on int8 pages and at B=1, L=32768, and at
                starcoder2's heads (H=36, KH=4, D=128) and gemma3's (H=16,
                KH=8, D=256) at B=32, L=2048,
                in turns with its plain version and
                ``scaled_dot_product_attention`` on already gathered K/V
                (a yardstick, not the same function), then both again as 20
                calls in a CUDA graph, with TB/s and the share of its bound;
                K2 at B=1, causal, bf16: H=15, KH=5, D=64 at S=511 and
                S=4096, and H=32, KH=8 and H=36, KH=4 (starcoder2) with
                D=128 at S=4096, and gemma3's H=16, KH=8, D=256 at S=4096,
                causal and with window 1024, in turns with its
                plain version and ``scaled_dot_product_attention`` (the
                same function; with a window through a dense boolean mask
                on repeated K/V, its only route), then both again as 20
                calls in a CUDA graph (no host launch in the time), with
                TFLOP/s and the share of its bound (4*D FLOPs per visible
                pair and query head).  The port never calls SDPA.
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
                cuda vs cpu within 1e-3.  Then phase 12's runs (f), (h)
                and (i)'s scale-up at 4 layers on cuda and on the CPU:
                equal tokens, finish reasons, counters, link ledgers,
                steps and autoscaler events.
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
  12. cancellation and live autoscaling — runs after phase 11, with
                phase 5's weights and requests.  (f) phase 5's plan at
                depth 2: request 1 cancelled right after its submit
                (still queued), request 2 from another thread once it
                has two confirmed tokens; (g) phase 6's perfect draft, γ
                = 4, on the modelled links: request 0 cancelled with a
                verify round in flight; (h) phase 11's plan (a) at depth
                2: the first request with a KV handoff in flight
                cancelled; (i) ``Autoscaler.tick()`` with ``traffic_fn``
                and a catalog of A100s capped at 1000 tokens/s, loads
                from ``ThroughputTable.profile`` (printed): scale-up of
                phase 5's placement on two capped A100s under a load
                step with requests in flight, then a second batch; drain
                and retire of one of three full replicas at a low load
                with requests on it, then a second batch; a straggler
                reweight from fabricated telemetry.  Checks: cancelled
                requests end "cancelled" with a prefix of phase 5's
                tokens, the others with phase 5's; ``cancelled_requests``;
                ``on_token`` saw exactly the confirmed tokens in order and
                ``on_done`` fired once per request; pools drained, draft
                slots free, ``pending()`` 0; the incumbents' ranges kept,
                new engines on the card and decoding, $/hr up after the
                scale-up and down after the retire, the straggler's
                engines the same objects; K1 launches == decode passes x
                paged layers over every engine that ran (the retired one
                too), none split; K2 launches == the draft's prefills x
                its layers, all tensor-core, or none.  Prints the
                measured per-node decode telemetry as information.
  13. stage workers, the wall clock and the front door — runs after phase
                12, with phase 5's weights, plan and requests.  (j) the
                paged cluster over two worker processes (``spawn_workers``,
                direct links off, then on; each at depth 1, then 2):
                requests one at a time — greedy tokens equal to the
                in-process virtual-clock cluster's one-at-a-time run,
                exactly, in bf16 — then together (all complete; the count
                equal to phase 5's printed); every remote pool drains to 0,
                checked over RPC.  (k) the dense cluster over workers (the
                dense phase's plan and requests, K2 in the workers'
                prefills), the same checks.  (l) a 2-stage pipeline beside
                a full-model node over three workers: n1's worker SIGKILLed
                once a request through it has its first token, then
                ``fail_node``, ``replan_after_failure`` and ``apply_plan``;
                the survivors' tokens equal (j)'s one-at-a-time tokens,
                pools drain.  (m) ``Frontend`` over (j)'s workers and over
                the realtime in-process runtime: request 0 streamed alone
                equals (j)'s tokens, four concurrent streams complete, a
                client reset mid-stream leaves ``cancelled_requests`` >= 1
                and every pool 0 on ``/healthz``; prints wall-clock
                TTFT/TPOT/E2E percentiles.  Launch counts: (j) and (k)
                once more over workers on threads of this process
                (``spawn_workers(connect=...)`` + ``run_worker``): K1 ==
                decode RPCs x the node's layers (none split), K2 ==
                dense prefill RPCs x layers (all tensor-core).  Prints the
                params' bytes and each worker's init time.  Phase 10 then
                repeats (j) and (l) in f32 at 4 layers over cuda workers:
                tokens equal to the port's CPU in-process run.
  14. training — runs after the kernel timings.  (n) K2's backward (three
                kernels a call: delta, dK/dV, dQ; bf16 on the tensor
                cores, f32 on the CUDA cores; from the forward's lse)
                against its plain version (which recomputes lse) on the
                card: every mask at every D 16/64/128 x G 1/3/4 x
                Sq = Sk in {1, 37, 64, 65, 511}, B 1 or 3 in turn; Sq != Sk
                both ways, rows that see no key (exactly 0); fused-qkv
                (B,S,H,D) views through the autograd function, and (o)'s
                own shape (B=8, S=512, H=15, KH=5, D=64, causal) in the
                model layout through it; at D=256 (gemma3's heads,
                G = 2, and G = 1) every mask, window 1024 among them, x S
                in {1, 37, 64, 65, 511, 1100, 2048}, Sq != Sk both ways
                with rows that see no key, fused-qkv views and phase 17's
                training shape (B=2, S=2048, causal and window 1024)
                through the autograd function.  f32: atol
                = rtol = 1e-4; bf16: each element within 2**-7 x |plain| +
                2**-10 x max|plain| of its tensor + 1e-5; a call without
                lse raises ValueError.  Timed (kernel, CUDA graph, plain,
                SDPA's backward as the yardstick, eager and in a CUDA
                graph) at the training shape B=8, H=15, KH=5, S=512, D=64,
                at K2's timing shapes, and at gemma3's heads (H=16, KH=8,
                D=256) at B=1, S=4096 and at phase 17's B=2, S=2048,
                causal and with window 1024 (SDPA's backward then through
                a dense boolean mask on K/V repeated to 16 heads).
                (o) full-width smollm-360m in bf16
                through ``make_train_step``: AdamW (lr 3e-3, warmup 5, no
                weight decay) 30 steps on one 8 x 512 batch from ``make_batch``
                (finite; mean of the last 5 losses below the first 5's),
                one Adafactor step (finite), remat "none" and "full" over 4
                steps (losses and final params bit-equal), one step at
                microbatches 2; per step exactly: K2 forward launches ==
                layers x microbatches (x 2 under "full"), K2 backward ==
                layers x microbatches x 3, K1 none; step time, training
                tokens/s and peak memory printed.  Then ``python -m
                repro_torch.launch.train`` as subprocesses (batch 4, seq
                256): 4 steps, beside 2 steps + ``--resume`` + 2: the two
                final checkpoints are the same bytes.  Phase 10 then runs
                (p): three AdamW steps (lr 1e-4) of the f32 model at 4
                layers on cuda and on the CPU: losses and params within
                1e-3, each leaf's update within 5e-2 in norm.
  15. model families — runs after phase 10.  olmo-1b (non-parametric
                LayerNorm, MHA 16/16, SwiGLU, tied) and starcoder2-7b
                (LayerNorm, plain GELU FFN, GQA 36/4, untied) whole,
                chameleon-34b (RMSNorm, SwiGLU, GQA 64/8, untied) at full
                width and 8 of its 48 layers (48 would be ~68.6 GB of
                bf16 weights), bf16 weights drawn on the card from a
                seeded generator: phase
                5's paged cluster (K1 launches == decode passes x paged
                layers, none split, K2 none) and dense cluster (K2 ==
                layers x request prefills, all tensor-core, K1 none), each
                with every request done, pools or slots released, >= 2
                nodes per request and a last stage holding ``lm_head`` and
                no ``embed`` when untied; tokens/s (host clock), peak
                device memory and the plan printed.  Then each at full
                width and 2 layers in f32, the paged cluster on cuda and
                on the CPU: on init's weights greedy tokens equal and the
                first-prefill and first-decode logit gap within the larger
                of 1e-3 and 4x the gap between two cuda runs whose
                embeddings are one rounding apart (init's 1/sqrt(depth)
                std makes this random model amplify fp32 rounding); on
                fan-in-scaled weights those logits within atol=rtol=1e-3
                and greedy tokens equal.
  16. gemma3-12b — runs after phase 15.  The whole model (48 layers:
                five local of window 1024 to each global one; d=3840, H=16/KH=8, D=256,
                d_ff 15360, vocab 262,144; ~23.5 GB of bf16 weights drawn
                on the card) through ``launch/serve.py --cluster A100,L4
                --stages 2 --dense`` (phase 5's dense checks) and through
                ``Engine``, 4 prompts of 600, 1100, 1500 and 2100 tokens,
                16 new tokens each: K2 launches == 48 x 4 = 192, all on
                the tensor cores, 160 of them windowed, K1 none, in each;
                tokens/s, peak device memory and wall time printed.
                Then one super-block (6 layers) in f32 at full width, the
                dense cluster on cuda and on the CPU on an 1100-token
                prompt, under phase 15's two gates.
  17. gemma3-12b training — runs after phase 16.  Full width in bf16 at one
                super-block (6 of 48 layers, 2.35 B params: PERF.md
                section 4 reckons the device memory that chose it) through
                ``make_train_step`` on one 2 x 2048 batch from
                ``make_batch`` (past the window of 1024) on the fan-in-
                scaled copy of init's weights: AdamW at TRAIN_OPT for 30
                steps (the loss below its first value; whether it reached
                half of it printed); per step exactly K2 6 launches (5
                windowed), K2's backward 18 (15 windowed), K1 none; step
                time, training tokens/s, peak memory, one profiled step
                with K2-bwd's share of device time; the first step's
                gradients through K2's backward against its plain version
                on the card, the largest relative gap in norm within 4x
                the one that a bf16 rounding of the plain dq, dk and dv
                makes; remat none and full over 3 steps, losses and
                params bit-equal.  Then one super-block in f32 at full
                width, the loss and every gradient on a 1 x 1100 batch on
                cuda and on the CPU, fan-in-scaled weights, within 1e-3
                (the largest gap over a leaf's largest value).
  18. gemma3-12b on the paged paths — runs last.  The whole model in bf16
                (weights drawn once) through ``launch/serve.py --cluster
                A100,L4 --stages 2`` (paged: every node a
                ``PagedStageEngine``, the 8 global layers' K/V in each
                node's pool, ring caches for the 40 local ones) and
                ``serve.py --paged`` (``PagedEngine``), phase 16's prompts,
                16 new tokens, max_len 2128.  Prefill is single-shot, then
                the global layers' K/V is scattered into the pool: K2 ==
                48 x 4 = 192 launches, all tensor-core, 160 windowed; K1
                == decode passes x paged layers on the cluster, decode
                steps x 8 in ``PagedEngine``; pools drained; tokens/s,
                peak memory, wall time and the tokens agreeing with phase
                16's dense cluster's (bf16: printed) printed.  Then one
                super-block in f32 at full width on a forced plan {n0:
                [0,3), a dense ``StageEngine`` (no global layer), n1:
                [3,6), a ``PagedStageEngine``}, the paged cluster on cuda
                and on the CPU on an 1100-token prompt, under phase 15's
                two gates.
The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.  Without CUDA it exits non-zero at once.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import shutil
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels.flash_attention import kernel as k2  # noqa: E402
from repro_torch.kernels.flash_attention import ops as k2_ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_lse_ref, flash_attention, flash_attention_bwd_ref,
    flash_attention_ref)
from repro_torch.kernels.paged_attention import kernel as k1  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention, paged_attention_ref)
from repro_torch.core import (LayerRange, MILPOptions,  # noqa: E402
                              ModelProfile, Placement,
                              disaggregated_placement, full_mesh_cluster,
                              plan, replan_after_failure)
from repro_torch.core.cluster import DEVICE_PROFILES  # noqa: E402
from repro_torch.core.mix_planner import (  # noqa: E402
    Bucket, ThroughputTable, TrafficProfile, mix_is_feasible)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.worker import run_worker  # noqa: E402
from repro_torch.models import init  # noqa: E402
from repro_torch.models.common import map_tree, tree_leaves  # noqa: E402
from repro_torch.models.model import loss_fn  # noqa: E402
from repro_torch.models.paged import num_paged_layers  # noqa: E402
from repro_torch.serving.autoscaler import Autoscaler  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.frontend import Frontend  # noqa: E402
from repro_torch.serving.runtime import (  # noqa: E402
    ClusterRuntime, InProcessTransport)
from repro_torch.serving.stage_engine import (  # noqa: E402
    PagedStageEngine, StageEngine, _StageEngineBase)
from repro_torch.serving.transport import (  # noqa: E402
    RemoteStageEngine, WorkerChannel)
from repro_torch.training import (DataConfig, OptimizerConfig,  # noqa: E402
                                  TrainConfig, init_train_state, make_batch,
                                  make_train_step)

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


# arch -> layers phase 15 serves (None: the whole model).  chameleon-34b
# keeps its full width (d=8192, 64/8 heads, d_ff 22016, vocab 65536) at 8
# of its 48 layers: 48 would be ~68.6 GB of bf16 weights on an 80 GB card
FAMILIES = {"olmo_1b": None, "starcoder2_7b": None, "chameleon_34b": 8}
FAMILY_XCHECK_LAYERS = 2


def family_heads(arch):
    """(H, KH, D) of ``arch`` from the registry: olmo's G = 1 is MHA,
    starcoder2's G = 9 runs K1's head groups unevenly (3, 3, 3 and one
    idle), chameleon's G = 8."""
    cfg = get_config(arch)
    return cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim


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
    # the decode heads of the model families (phase 15), f32 and bf16 at
    # the splits num_splits chooses and at 3: lengths across the ring's
    # stages, the paged decode shape at B=4 (4-page tables: 40-token
    # prompts + 16 new tokens) and B=32 at L=2048
    for H, KH, D in map(family_heads, FAMILIES):
        for dt, kv, tol in DTYPE_PAIRS[:2]:
            for what, B, NP, lens in (
                    ("multi-tile", len(long_lens), 128, long_lens),
                    ("decode B=4", 4, 4, [41, 48, 55, 56]),
                    ("B=32 L=2048", 32, 128, [2048] * 31 + [1999])):
                args, kw = make_inputs(B, H, KH, D, NP, lens, q_dtype=dt,
                                       kv=kv, gen=gen, dead_ids=True)
                tag = f"H{H}/KH{KH}/D{D} {str(dt)[6:]} {what}"
                for splits in (None, 3):
                    res.append(check_case(tag, args, kw, tol, splits))
    # gemma3's decode heads (phase 18: H=16, KH=8, D=256, G=2), f32 and
    # bf16 at the splits num_splits chooses and at 3: phase 18's decode
    # shape (B=4, lengths across its prompts of 600-2100 tokens and their
    # 16 new tokens, 133-page tables: max_len 2128) and B=32 at L=2048
    H, KH, D = family_heads(GEMMA3)
    for dt, kv, tol in DTYPE_PAIRS[:2]:
        for what, B, NP, lens in (
                ("phase 18 decode B=4", 4, 133, [600, 1116, 1515, 2116]),
                ("B=32 L=2048", 32, 128, [2048] * 31 + [1999])):
            args, kw = make_inputs(B, H, KH, D, NP, lens, q_dtype=dt,
                                   kv=kv, gen=gen, dead_ids=True)
            tag = f"gemma3 H{H}/KH{KH}/D{D} {str(dt)[6:]} {what}"
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
    L=32768, and at starcoder2's heads (H=36, KH=4, D=128) and gemma3's
    (H=16, KH=8, D=256) at B=32, L=2048: CUDA events around each call
    (the host's launch included), in turns with its plain version and
    the SDPA yardstick, then the kernel and the yardstick again as 20
    calls replayed from one CUDA graph (no host launch); achieved bytes/s
    and the share of the bound of each."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    out = {}
    # main path decode shape: 4 requests mid-decode (length 48 of the
    # 40 + 16 budget) + the pad row (scratch page, length 1), one node's
    # pool, bf16
    smollm = (15, 5, 64)
    shapes = {"decode": (5, [48, 48, 48, 48, 1], 4, pool_pages, "same",
                         smollm),
              "B32_L2048": (32, [2048] * 32, 128, None, "same", smollm),
              "B32_L2048_int8": (32, [2048] * 32, 128, None, "int8", smollm),
              "B1_L32768": (1, [32768], 2048, None, "same", smollm),
              "starcoder2_B32_L2048": (32, [2048] * 32, 128, None, "same",
                                       family_heads("starcoder2_7b")),
              "gemma3_B32_L2048": (32, [2048] * 32, 128, None, "same",
                                   family_heads(GEMMA3))}
    for key, (B, lens, NP, P, kv, (H, KH, D)) in shapes.items():
        args, kw = make_inputs(B, H, KH, D, NP, lens, q_dtype=torch.bfloat16,
                               kv=kv, gen=gen, P=P)
        splits = k1.num_splits(B, KH, NP, PAGE, k1.sm_count(args[0].device))
        t = time_turns({
            "kernel": (lambda: paged_attention(*args, **kw), 50),
            "yardstick": (sdpa_yardstick(args, kw), 50),
            "plain": (lambda: paged_attention_ref(
                *args, kw["k_scales"], kw["v_scales"]), 10)})
        dev = graph_ms(lambda: paged_attention(*args, **kw))
        yard_dev = graph_ms(sdpa_yardstick(args, kw))
        bound_ms, bound_by, nbytes = bound(args, kw)
        lens_txt = lens if B <= 5 else f"{B}x{lens[0]}"
        out[key] = dict(shape=f"B={B} H={H} KH={KH} D={D} page={PAGE} "
                              f"NP={NP} lengths={lens_txt} q bf16, pages "
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
# gemma3's local layers (phase 16): causal with window 1024
K2_LOCAL_MASK = {"causal+window1024": dict(causal=True, window=1024)}


def k2_check(name, q, k, v, mask, *, bshd=False):
    """One K2 case against its plain version on the same inputs.  f32:
    max error <= 1e-5 (the same fp32 math in another order).  bf16: each
    element within 2**-7 x |plain| + 1e-5 of its plain value: both compute
    in fp32 (the kernel's P.V from P split into bf16 hi and lo parts, within
    2**-17 of fp32 P) and round the output once, so they differ by at most
    one bf16 ulp of that element (an ulp is <= 2**-7 of the value).
    Returns (max abs error, worst error over its limit); a case out of
    bounds is printed and fails the run."""
    kw = {**K2_MASKS, **K2_LOCAL_MASK}[mask]
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
# gemma3 (phase 16): H=16, KH=8, D=256 from the registry, S across its
# window of 1024 and its prompts; the masks of its local and global layers
# and the encoder's
GEMMA3 = "gemma3_12b"
GEMMA3_SEQS = (37, 511, 1500, 2048)
GEMMA3_PROMPTS = (600, 1100, 1500, 2100)
GEMMA3_MASKS = ("causal", "causal+window1024", "bidirectional")


def k2_checks():
    """Every mask at every G: D 16/64/128 x G 1/3/4 x Sq = Sk in K2_SEQS
    (across the f32 kernel's 64-row and the bf16 kernel's 128-row tiles, up
    to a long prompt) x three masks, B 1 or 3 in turn, f32 and bf16;
    Sq != Sk both ways; strided (B,S,H,D) inputs, among them slices of one
    fused qkv tensor; gemma3's heads at D=256 (GEMMA3_SEQS x causal,
    window 1024 and bidirectional; window 100; Sq != Sk; phase 16's
    prefill shapes); an empty q launches nothing.  Every bf16 launch goes
    through the tensor-core kernel.  Prints one line per (dtype, D) group
    and returns the largest abs error, the worst error over its limit of
    each dtype and the number of D=256 cases."""
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
        # the prefill heads of phase 15's families at D=128, causal: G = 1
        # (olmo), G = 9 (starcoder2) and G = 8 (chameleon)
        for (H, KH, D), S in itertools.product(
                map(family_heads, FAMILIES), (37, 511, 2048)):
            q, k, v = k2_inputs(1, H, KH, S, S, D, dtype, gen)
            run(dt, "families", f"{dt} B=1 H={H} KH={KH} S={S} D={D}",
                q, k, v, "causal")
        for Sq, Sk in ((37, 511), (511, 37), (65, 2048), (2048, 65),
                       (1, 100), (100, 1), (300, 129)):
            for mask in K2_MASKS:
                q, k, v = k2_inputs(2, 15, 5, Sq, Sk, 64, dtype, gen)
                run(dt, "Sq!=Sk", f"{dt} B=2 H=15 KH=5 Sq={Sq} Sk={Sk} D=64",
                    q, k, v, mask)
        # gemma3's heads at D=256 (the two-warpgroup tensor-core instance
        # and the f32 one): S across the window, windows of 100 that cut
        # the 64-key tiles mid-way, Sq != Sk both ways, and phase 16's
        # prefill shapes (its prompts, B=1, local and global layers) in
        # the model layout
        H, KH, D = family_heads(GEMMA3)
        for S, mask in itertools.product(GEMMA3_SEQS, GEMMA3_MASKS):
            q, k, v = k2_inputs(1, H, KH, S, S, D, dtype, gen)
            run(dt, "D=256", f"{dt} B=1 H={H} KH={KH} S={S} D={D}",
                q, k, v, mask)
        for S in (511, 2048):
            q, k, v = k2_inputs(2, H, KH, S, S, D, dtype, gen)
            run(dt, "D=256", f"{dt} B=2 H={H} KH={KH} S={S} D={D}",
                q, k, v, "causal+window100")
        for (Sq, Sk), mask in itertools.product(
                ((37, 511), (511, 37), (300, 1100), (1100, 300)),
                GEMMA3_MASKS):
            q, k, v = k2_inputs(2, H, KH, Sq, Sk, D, dtype, gen)
            run(dt, "D=256", f"{dt} B=2 H={H} KH={KH} Sq={Sq} Sk={Sk} "
                f"D={D}", q, k, v, mask)
        for S, mask in itertools.product(GEMMA3_PROMPTS, GEMMA3_MASKS[:2]):
            q, k, v = (x.transpose(1, 2).contiguous()
                       for x in k2_inputs(1, H, KH, S, S, D, dtype, gen))
            run(dt, "D=256", f"{dt} (B,S,H,D) phase 16 prefill S={S} "
                f"H={H} KH={KH} D={D}", q, k, v, mask, bshd=True)
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
    return err, worst, sum(len(r) for (_, key), r in groups.items()
                           if key == "D=256")


K2_LSE_TOL = 1e-4       # log2 domain: the same fp32 sums in another order


def k2_lse_checks():
    """K2's forward with ``lse`` requested (what training asks for), f32
    and bf16, every D, every mask, S across the tiles and Sq != Sk both ways
    (rows that see no key among them: Sq = 300, Sk = 65, window 100):
    ``out`` bit-equal to the call without ``lse``, one launch either way,
    and ``lse`` within K2_LSE_TOL absolute of ``attention_lse_ref``'s, +inf
    exactly where the plain version has it.  Returns the largest error."""
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    worst, n = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for D, (Sq, Sk), mask in itertools.product(
                (16, 64, 128, 256), ((1, 1), (129, 129), (511, 511),
                                     (300, 65), (65, 300)), K2_MASKS):
            kw = K2_MASKS[mask]
            q, k, v = k2_inputs(2, 6, 2, Sq, Sk, D, dtype, gen)
            before = k2.launches
            plain_out = flash_attention(q, k, v, **kw)
            lse = torch.empty(q.shape[:3], dtype=torch.float32, device=DEVICE)
            out = flash_attention(q, k, v, lse=lse, **kw)
            want = attention_lse_ref(q, k, **kw)
            sync()
            name = f"{str(dtype)[6:]} Sq={Sq} Sk={Sk} D={D} {mask}"
            require(k2.launches == before + 2, f"K2 with lse ({name}) "
                    f"launched {k2.launches - before - 1} kernels, not 1")
            require(torch.equal(out, plain_out), f"K2's out with lse differs "
                    f"from its out without ({name})")
            seen = torch.isfinite(want)
            require(bool((lse[~seen] == float("inf")).all()) and
                    bool(torch.isfinite(lse[seen]).all()),
                    f"K2's lse is not +inf exactly on the rows that see no "
                    f"key ({name})")
            err = (lse[seen] - want[seen]).abs().max().item() \
                if seen.any() else 0.0
            require(err <= K2_LSE_TOL, f"K2's lse off by {err} ({name})")
            worst, n = max(worst, err), n + 1
    print(f"  lse requested: {n} cases (f32 and bf16, D 16/64/128/256, "
          f"three masks, S across the tiles, Sq != Sk both ways): out "
          f"bit-equal to the call without lse, one launch each; "
          f"max|lse - plain| = "
          f"{worst:.3e} (limit {K2_LSE_TOL:g}, log2 domain), +inf exactly "
          f"on the rows that see no key")
    return worst


def k2_pairs(Sq, Sk, causal, window=0):
    """Visible (query, key) pairs of one head: top-left aligned, causal
    keeps j <= i, a window keeps i - j < window."""
    i = np.arange(Sq)[:, None]
    j = np.arange(Sk)[None, :]
    vis = np.ones((Sq, Sk), bool)
    if causal:
        vis &= j <= i
    if window:
        vis &= i - j < window
    return int(vis.sum())


def k2_work(q, k, causal, window=0):
    """The bytes the function must move (q, k, v read once, out written
    once) and its FLOPs, 4*D per visible (query, key) pair per query
    head."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    return nbytes, 4 * B * H * D * k2_pairs(Sq, Sk, causal, window)


def k2_bound(q, k, causal, window=0):
    """Least time for the same work: its bytes over HBM bandwidth vs its
    FLOPs over the bf16 (or fp32) peak; the larger bounds it."""
    nbytes, flops = k2_work(q, k, causal, window)
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


K2_TIMING_SHAPES = {  # key -> (H, KH, S, D, window), B=1, causal, bf16
    "S511": (15, 5, 511, 64, 0),       # the dense serving prefill
    "S4096": (15, 5, 4096, 64, 0),
    "D128_S4096": (32, 8, 4096, 128, 0),
    "starcoder2_S4096": (36, 4, 4096, 128, 0),
    # gemma3's global and local layers (H=16, KH=8, D=256)
    "gemma3_S4096": (16, 8, 4096, 256, 0),
    "gemma3_S4096_w1024": (16, 8, 4096, 256, 1024),
}


def sdpa_call(q, k, v, window):
    """``scaled_dot_product_attention`` computing K2's function (timed
    only, the port never calls it): causal through ``is_causal`` with
    GQA; with a window it has no route but a dense boolean mask (every
    pair computed), taken on K/V repeated to the query heads."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if not window:
        return lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)
    S, G = q.shape[2], q.shape[1] // k.shape[1]
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = (j <= i) & (i - j < window)
    kr, vr = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    return lambda: sdpa(q, kr, vr, attn_mask=mask)


def k2_timings():
    """K2 (the tensor-core kernel) at the dense serving shape (one
    511-token prompt), at S=4096, and at S=4096 with H=32, KH=8, D=128,
    with starcoder2's H=36, KH=4, D=128 and with gemma3's H=16, KH=8,
    D=256 (causal, and causal with its local window 1024), bf16; timed
    with CUDA events around each call (the host's launch included), in
    turns with its plain version and with ``scaled_dot_product_attention``
    (``sdpa_call``: the same function; timed only, the port never calls
    it), then without the host's launch (``graph_ms``); beside its bound,
    with TFLOP/s counting 4*H*D per visible pair."""
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    out = {}
    for key, (H, KH, S, D, w) in K2_TIMING_SHAPES.items():
        q, k, v = k2_inputs(1, H, KH, S, S, D, torch.bfloat16, gen)
        lib = sdpa_call(q, k, v, w)
        t = time_turns({
            "kernel": (lambda: flash_attention(q, k, v, causal=True,
                                               window=w), 50),
            "library": (lib, 50),
            "plain": (lambda: flash_attention_ref(q, k, v, causal=True,
                                                  window=w), 10)})
        dev = graph_ms(lambda: flash_attention(q, k, v, causal=True,
                                               window=w))
        lib_dev = graph_ms(lib)
        bound_ms, bound_by = k2_bound(q, k, True, w)
        flops = k2_work(q, k, True, w)[1]
        mask = f"causal, window {w}" if w else "causal"
        out[key] = dict(shape=f"B=1 H={H} KH={KH} S={S} D={D} {mask} bf16",
                        library=("sdpa, dense boolean mask on K/V repeated "
                                 "to the query heads (no windowed route)"
                                 if w else "sdpa, is_causal, enable_gqa"),
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
              f"{100 * r['graph_bound_share']:.1f}% of the bound; "
              f"{r['library']} {r['library_ms']:.4f} ms, in a CUDA graph "
              f"{lib_dev:.4f} ms = {flops / lib_dev / 1e9:.1f} TFLOP/s; "
              f"plain {r['plain_ms']:.4f} ms", flush=True)
    return out


# ---------------------------------------------------------------------------
# K2's backward and training (phase 14)
# ---------------------------------------------------------------------------

KB_F32_TOL = 1e-4       # atol = rtol: the same fp32 math in another order
# bf16 gradients, per element: one bf16 rounding of that element (<= 2**-7
# x |plain|), plus KB_BF16_MAX_REL x max|plain| of the gradient tensor for
# the fp32 sums taken in another order (their terms cancel: each row of dS
# sums to 0), plus KB_BF16_ATOL for tensors that are 0 up to rounding (one
# key: dS = P (dP - delta) = 0)
KB_BF16_MAX_REL = 2.0 ** -10
KB_BF16_ATOL = 1e-5
KB_SEQS = (1, 37, 64, 65, 511)


def kb_check(name, q, k, v, mask, *, bshd=False):
    """K2's backward against its plain version on the same inputs (o and
    lse from K2's forward kernel, do random; the plain version recomputes
    lse).  ``bshd``: through the autograd function in the model layout
    (strided views), as training calls it.  Returns (max abs error, worst
    error over its limit); a case out of bounds is printed and fails the
    run."""
    kw = {**K2_MASKS, **K2_LOCAL_MASK}[mask]
    gen = torch.Generator(device=DEVICE).manual_seed(q.shape[2] * 7 + 1)
    do = torch.randn(q.shape, generator=gen, device=DEVICE).to(q.dtype)
    hm = [x.transpose(1, 2) for x in (q, k, v, do)] if bshd else \
        [q, k, v, do]
    lse = torch.empty(hm[0].shape[:3], dtype=torch.float32, device=DEVICE)
    o = flash_attention(*hm[:3], lse=lse, **kw)
    if bshd:
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = k2_ops.flash_attention_bshd(*leaves, **kw)
        got = [g.transpose(1, 2) for g in
               torch.autograd.grad(out, leaves, do)]
    else:
        got = k2.flash_attention_bwd(*hm[:3], o, hm[3], lse=lse, **kw)
    want = flash_attention_bwd_ref(*hm[:3], o, hm[3], **kw)
    sync()
    err = worst = 0.0
    ok = True
    for g, w in zip(got, want):
        diff = (g.float() - w.float()).abs()
        ref = w.float().abs()
        if q.dtype == torch.float32:
            limit = KB_F32_TOL + KB_F32_TOL * ref
        else:
            limit = (BF16_REL * ref + KB_BF16_MAX_REL * ref.max()
                     + KB_BF16_ATOL)
        err = max(err, diff.max().item())
        worst = max(worst, (diff / limit).max().item())
        ok = ok and bool(torch.isfinite(g.float()).all())
    ok = ok and worst <= 1.0
    if not ok:
        print(f"  {name} {mask}: max|kernel-plain| = {err:.3e}, worst "
              f"err/limit {worst:.3f} FAIL")
    require(ok, f"flash_attention_bwd disagrees with its plain version on "
                f"{name} {mask}: max abs err {err}, worst err/limit {worst}")
    return err, worst, got


def kb_checks():
    """K2's backward over the forward's grid without S = 2048 (every mask
    at every D 16/64/128 x G 1/3/4 x S in KB_SEQS, B 1 or 3 in turn), Sq !=
    Sk both ways (rows that see no key among them: window 100 with Sq >
    Sk + 99), and the model layout through the autograd function; f32 and
    bf16, and the training step's own shape (phase 14 (o)'s batch, causal)
    in the model layout.  bf16 runs on the tensor-core kernels, f32 on the
    CUDA-core ones, both from the forward's lse.  Rows that see no key get
    exactly 0.  Every call counts BWD_KERNELS launches; a call without lse
    raises ValueError and launches nothing.  Then the D=256 cases
    (``kb_d256_cases``).  Returns (max abs error, worst error over its limit
    of each dtype, the number of D=256 cases)."""
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    groups = {}
    before = k2.bwd_launches

    def run(dt, key, name, *args, **kw):
        err, worst, got = kb_check(name, *args, **kw)
        groups.setdefault((dt, key), []).append((err, worst, name))
        return got

    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        n = 0
        for D, G, S in itertools.product((16, 64, 128), (1, 3, 4), KB_SEQS):
            for mask in K2_MASKS:
                B = (1, 3)[n % 2]
                n += 1
                KH = 2 if D == 16 else 5 if D == 64 else 2
                q, k, v = k2_inputs(B, KH * G, KH, S, S, D, dtype, gen)
                run(dt, f"D={D}", f"{dt} B={B} H={KH * G} KH={KH} S={S} "
                    f"D={D}", q, k, v, mask)
        for Sq, Sk in ((37, 511), (511, 37), (65, 300), (300, 65),
                       (1, 100), (100, 1)):
            for mask in K2_MASKS:
                q, k, v = k2_inputs(2, 15, 5, Sq, Sk, 64, dtype, gen)
                dq, _, _ = run(dt, "Sq!=Sk", f"{dt} B=2 H=15 KH=5 Sq={Sq} "
                               f"Sk={Sk} D=64", q, k, v, mask)
                w = K2_MASKS[mask]["window"]
                if w and Sq > Sk + w - 1:       # rows that see no key
                    require(not dq[:, :, Sk + w - 1:].any(),
                            "flash_attention_bwd: a row that sees no key "
                            "got a gradient")
        for S, D, H, KH in ((511, 64, 15, 5), (300, 128, 8, 2)):
            for mask in K2_MASKS:
                qkv = torch.randn(2, S, H + 2 * KH, D, generator=gen,
                                  device=DEVICE).to(dtype)
                q, k, v = (qkv[:, :, :H], qkv[:, :, H:H + KH],
                           qkv[:, :, H + KH:])
                run(dt, "(B,S,H,D)", f"{dt} autograd, fused-qkv views S={S} "
                    f"H={H} KH={KH} D={D}", q, k, v, mask, bshd=True)
        B, H, KH, S, D, _ = KB_TIMING_SHAPES["train"]  # as training calls it
        q = torch.randn(B, S, H, D, generator=gen, device=DEVICE).to(dtype)
        k, v = (torch.randn(B, S, KH, D, generator=gen,
                            device=DEVICE).to(dtype) for _ in range(2))
        run(dt, "train", f"{dt} autograd, training shape B={B} S={S} H={H} "
            f"KH={KH} D={D}", q, k, v, "causal", bshd=True)
        kb_d256_cases(run, dt, dtype, gen)
    for (dt, key), rows in groups.items():
        err, worst, name = max(rows, key=lambda r: r[1])
        print(f"  {dt:<9} {key:<10} {len(rows):>3} cases: max|kernel-plain| "
              f"= {max(r[0] for r in rows):.3e}, worst err/limit "
              f"{worst:.3f} ({name})")
    n_cases = sum(map(len, groups.values()))
    require(k2.bwd_launches - before == k2.BWD_KERNELS * n_cases,
            f"{k2.bwd_launches - before} backward launches for {n_cases} "
            f"cases, not {k2.BWD_KERNELS} each")
    q, k, v = k2_inputs(1, 6, 2, 65, 65, 64, torch.bfloat16, gen)
    o = flash_attention(q, k, v)
    try:
        k2.flash_attention_bwd(q, k, v, o, o)
        refused = False
    except ValueError:
        refused = True
    require(refused and k2.bwd_launches - before == k2.BWD_KERNELS * n_cases,
            "flash_attention_bwd without lse did not raise ValueError, or "
            "launched")
    worst = {dt: max(w for (d, _), rows in groups.items() if d == dt
                     for _, w, _ in rows) for dt in ("float32", "bfloat16")}
    print(f"  {n_cases} cases, all within their bounds; worst err/limit f32 "
          f"{worst['float32']:.3f} (atol = rtol = {KB_F32_TOL:g}), bf16 "
          f"{worst['bfloat16']:.3f} (2**-7 x |plain| + 2**-10 x max|plain| "
          f"+ {KB_BF16_ATOL:g}); {k2.BWD_KERNELS} launches a call; without "
          f"lse: ValueError, no launch")
    err = max(e for rows in groups.values() for e, _, _ in rows)
    return err, worst, sum(len(r) for (_, key), r in groups.items()
                           if key == "D=256")


# gemma3's training (phase 17): its masks, and S across the 64-key and
# 64 / 128-row tiles, the window of 1024 and phase 17's sequence
KB_D256_MASKS = ("causal", "causal+window1024", "bidirectional",
                 "causal+window100")
KB_D256_SEQS = KB_SEQS + (1100, 2048)


def kb_d256_cases(run, dt, dtype, gen):
    """K2's backward at D=256 (the dK/dV kernel's split warpgroups and the
    dQ kernel's 32-key ring in bf16, 32-row tiles in f32): every mask of
    KB_D256_MASKS at gemma3's heads (H=16, KH=8: G = 2) and at G = 1 (H =
    KH = 8) x S in KB_D256_SEQS, B 1 or 2 in turn; Sq != Sk both ways with
    rows that see no key (window 100, Sq > Sk + 99; exactly 0); fused-qkv
    (B,S,H,D) views through the autograd function; phase 17's training
    shape (B=2, S=2048) through it, causal and with window 1024."""
    H, KH, D = family_heads(GEMMA3)
    n = 0
    for (h, kh), S, mask in itertools.product(((H, KH), (KH, KH)),
                                              KB_D256_SEQS, KB_D256_MASKS):
        B = (1, 2)[n % 2]
        n += 1
        q, k, v = k2_inputs(B, h, kh, S, S, D, dtype, gen)
        run(dt, "D=256", f"{dt} B={B} H={h} KH={kh} S={S} D={D}", q, k, v,
            mask)
    for (Sq, Sk), mask in itertools.product(
            ((37, 511), (511, 37), (300, 1100), (1100, 300)), KB_D256_MASKS):
        q, k, v = k2_inputs(2, H, KH, Sq, Sk, D, dtype, gen)
        dq, _, _ = run(dt, "D=256", f"{dt} B=2 H={H} KH={KH} Sq={Sq} "
                       f"Sk={Sk} D={D}", q, k, v, mask)
        w = {**K2_MASKS, **K2_LOCAL_MASK}[mask]["window"]
        if w and Sq > Sk + w - 1:               # rows that see no key
            require(not dq[:, :, Sk + w - 1:].any(),
                    "flash_attention_bwd at D=256: a row that sees no key "
                    "got a gradient")
    for mask in KB_D256_MASKS:
        qkv = torch.randn(2, 300, H + 2 * KH, D, generator=gen,
                          device=DEVICE).to(dtype)
        q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KH], qkv[:, :, H + KH:]
        run(dt, "D=256", f"{dt} autograd, fused-qkv views S=300 H={H} "
            f"KH={KH} D={D}", q, k, v, mask, bshd=True)
    B, S = GEMMA3_TRAIN_BATCH, GEMMA3_TRAIN_SEQ
    for mask in KB_D256_MASKS[:2]:
        q = torch.randn(B, S, H, D, generator=gen, device=DEVICE).to(dtype)
        k, v = (torch.randn(B, S, KH, D, generator=gen,
                            device=DEVICE).to(dtype) for _ in range(2))
        run(dt, "D=256", f"{dt} autograd, phase 17's training shape B={B} "
            f"S={S} H={H} KH={KH} D={D}", q, k, v, mask, bshd=True)


def kb_bound(q, k, causal, window=0):
    """Least time of the backward: its bytes (q, o, do read once and dq
    written once: 4 q-sized; k, v read once and dk, dv written once: 4
    k-sized) over HBM bandwidth vs its five products, 2.5x the forward's
    FLOPs (10*D per visible pair per query head), at the dtype's peak; the
    larger bounds it."""
    nbytes = q.element_size() * (4 * q.numel() + 4 * k.numel())
    flops = 2.5 * k2_work(q, k, causal, window)[1]
    peak = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), flops


KB_TIMING_SHAPES = {  # key -> (B, H, KH, S, D, window), causal, bf16
    "train": (8, 15, 5, 512, 64, 0),       # phase 14's training batch
    "S511": (1, 15, 5, 511, 64, 0),
    "S4096": (1, 15, 5, 4096, 64, 0),
    "D128_S4096": (1, 32, 8, 4096, 128, 0),
    # gemma3's heads (H=16, KH=8, D=256): its global and local layers at
    # S=4096, and phase 17's training batch (B=2, S=2048)
    "gemma3_S4096": (1, 16, 8, 4096, 256, 0),
    "gemma3_S4096_w1024": (1, 16, 8, 4096, 256, 1024),
    "gemma3_train": (2, 16, 8, 2048, 256, 0),
    "gemma3_train_w1024": (2, 16, 8, 2048, 256, 1024),
}


def sdpa_forward(q, k, window):
    """``scaled_dot_product_attention`` as a function of (q, k, v)
    computing K2's function, whose backward is K2-bwd's yardstick (timed
    only, the port never calls it): causal through ``is_causal`` with GQA;
    with a window through a dense boolean mask on K/V repeated to the
    query heads (its only route; the repeat is differentiated too)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if not window:
        return lambda *x: sdpa(*x, is_causal=True, enable_gqa=True)
    S, G = q.shape[2], q.shape[1] // k.shape[1]
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = (j <= i) & (i - j < window)
    return lambda q, k, v: sdpa(q, k.repeat_interleave(G, 1),
                                v.repeat_interleave(G, 1), attn_mask=mask)


def sdpa_bwd_graph_ms(leaves, do, fwd, calls=5):
    """SDPA's backward alone without the host's launch: the forward
    (``sdpa_forward``'s ``fwd``) runs once on a stream of its own, outside
    the graph, and ``calls`` backward calls are captured on that stream
    (autograd runs each backward op on its forward op's stream), replayed
    and timed as in ``graph_ms``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        # leaves of its own, whose gradient accumulators live on this
        # stream too
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        out = fwd(*leaves)
        torch.autograd.grad(out, leaves, do, retain_graph=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            torch.autograd.grad(out, leaves, do, retain_graph=True)
    torch.cuda.current_stream().wait_stream(side)
    return time_ms(graph.replay, reps=10, warmup=1) / calls


def kb_timings():
    """K2's backward (causal, bf16; gemma3's rows also with its window of
    1024) at the training shapes and at K2's timing shapes: CUDA events
    around each call (the host's launch included), in turns with its plain
    version and with the backward of ``scaled_dot_product_attention``
    (autograd of the same function, ``sdpa_forward``: the yardstick; the
    port never calls it), then both without the host's launch
    (``graph_ms``, ``sdpa_bwd_graph_ms``), beside its bound; the kernel's
    time over SDPA's, eager and in a graph."""
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    out = {}
    for key, (B, H, KH, S, D, w) in KB_TIMING_SHAPES.items():
        q, k, v = k2_inputs(B, H, KH, S, S, D, torch.bfloat16, gen)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=DEVICE)
        o = flash_attention(q, k, v, causal=True, window=w, lse=lse)
        do = torch.randn(q.shape, generator=gen, device=DEVICE).to(q.dtype)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        lib_fwd = sdpa_forward(q, k, w)
        lib_out = lib_fwd(*leaves)

        def kernel():
            return k2.flash_attention_bwd(q, k, v, o, do, causal=True,
                                          window=w, lse=lse)

        def library():
            return torch.autograd.grad(lib_out, leaves, do,
                                       retain_graph=True)

        t = time_turns({
            "kernel": (kernel, 20), "library": (library, 20),
            "plain": (lambda: flash_attention_bwd_ref(q, k, v, o, do,
                                                      causal=True,
                                                      window=w), 3)})
        dev = graph_ms(kernel, calls=5)
        lib_dev = sdpa_bwd_graph_ms(leaves, do, lib_fwd)
        bound_ms, bound_by, flops = kb_bound(q, k, True, w)
        mask = f"causal, window {w}" if w else "causal"
        out[key] = dict(shape=f"B={B} H={H} KH={KH} S={S} D={D} {mask} bf16",
                        library=("sdpa backward, dense boolean mask on K/V "
                                 "repeated to the query heads" if w else
                                 "sdpa backward, is_causal, enable_gqa"),
                        ms=t["kernel"], plain_ms=t["plain"],
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=t["library"], graph_ms=dev,
                        library_graph_ms=lib_dev,
                        tflops=flops / dev / 1e9,
                        graph_bound_share=bound_ms / dev,
                        over_library=t["kernel"] / t["library"],
                        graph_over_library=dev / lib_dev)
        r = out[key]
        print(f"  {key} ({r['shape']}): kernel {r['ms']:.4f} ms, in a CUDA "
              f"graph {dev:.4f} ms = {r['tflops']:.2f} TFLOP/s (five "
              f"products), {100 * r['graph_bound_share']:.2f}% of the bound "
              f"{bound_ms:.5f} ms ({bound_by}); {r['library']} "
              f"{r['library_ms']:.4f} ms, in a CUDA graph {lib_dev:.4f} ms; "
              f"kernel / sdpa {r['over_library']:.2f}x eager, "
              f"{r['graph_over_library']:.2f}x in a graph; plain "
              f"{r['plain_ms']:.4f} ms", flush=True)
        del lib_out, leaves
    return out


# the training phase: the reference's overfit config (tests/
# test_serving_training.py) on one fixed 8 x 512 batch at full width
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 30
TRAIN_OPT = dict(lr=3e-3, warmup_steps=5, total_steps=1000, weight_decay=0.0)
REMAT_STEPS = 4
# remat "full" recomputes each block's forward in backward with the same
# deterministic kernels (K2 and its backward use no atomics; cuBLAS on one
# stream) on the same inputs, so its activations, gradients, losses and
# params equal remat "none"'s bit for bit: anything else is a wrong
# recomputation
DRIVER_ARGV = ["--arch", "smollm_360m", "--batch", "4", "--seq", "256"]


def counts():
    return dict(k2=k2.launches, k2_window=k2.window_launches,
                k2_bwd=k2.bwd_launches,
                k2_bwd_window=k2.bwd_window_launches, k1=k1.launches)


def reset_peak():
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_gib():
    return torch.cuda.max_memory_allocated() / 2 ** 30 \
        if DEVICE == "cuda" else 0.0


def train_run(cfg, params, train, batch, steps, name):
    """``steps`` steps of ``make_train_step`` from ``params`` on one batch;
    every launch count per step checked: K2 forward = layers x
    microbatches (x 2 under remat "full"), K2 backward = layers x
    microbatches x BWD_KERNELS, the windowed layers' share of each with a
    window, K1 none.  Returns (params, losses, ms per step)."""
    step_fn = make_train_step(cfg, train)
    opt = init_train_state(cfg, train, params)
    L, W, mb = cfg.num_layers, windowed_layers(cfg), train.microbatches
    fwd = mb * (2 if train.remat == "full" else 1)
    want = dict(k2=L * fwd, k2_window=W * fwd,
                k2_bwd=L * mb * k2.BWD_KERNELS,
                k2_bwd_window=W * mb * k2.BWD_KERNELS, k1=0)
    losses, times = [], []
    for _ in range(steps):
        before = counts()
        sync()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        losses.append(m["loss"].item())
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
        got = {key: c - before[key] for key, c in counts().items()}
        require(got == want, f"({name}) launches per step {got}, not {want}")
    require(all(np.isfinite(losses)), f"({name}) losses {losses}")
    return params, losses, times


def training_phase(cfg, seed, card):
    """Phase 14 (o): full-width smollm-360m in bf16 through
    ``make_train_step``; see the module note.  Returns the launch counts
    of the AdamW run and its rates."""
    params = init(cfg, seed, device=DEVICE)
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size,
                                  batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ),
                       0, device=DEVICE)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    adamw = OptimizerConfig(name="adamw", **TRAIN_OPT)
    reset_peak()
    zero_counts()
    _, losses, times = train_run(cfg, params,
                                 TrainConfig(optimizer=adamw, remat="none"),
                                 batch, TRAIN_STEPS, "AdamW")
    launches = counts()
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    ms = float(np.median(times[1:]))
    print(f"  AdamW, remat none, {TRAIN_STEPS} steps on one {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} batch: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(mean of the first 5 {first:.4f}, of the last 5 {last:.4f}); "
          f"step {ms:.1f} ms median = {tokens / ms * 1e3:.0f} training "
          f"tokens/s on {card}; peak memory {peak_gib():.2f} GiB; launches "
          f"{launches}", flush=True)
    print(f"  losses {[round(x, 4) for x in losses]}")
    train_profile(cfg, params, TrainConfig(optimizer=adamw, remat="none"),
                  batch, ms)
    require(last < first, f"AdamW: mean of the last 5 losses {last} not "
            f"below the first 5 {first}")

    ada = OptimizerConfig(name="adafactor", **TRAIN_OPT)
    p1, ada_loss, _ = train_run(cfg, params,
                                TrainConfig(optimizer=ada, remat="none"),
                                batch, 1, "Adafactor")
    require(all(bool(torch.isfinite(x.float()).all())
                for x in tree_leaves(p1)), "Adafactor: params not finite")
    print(f"  Adafactor, one step: loss {ada_loss[0]:.4f}, params finite")
    del p1

    series, step_ms, ends = {}, {}, {}
    for remat in ("none", "full"):
        reset_peak()
        ends[remat], series[remat], t = train_run(
            cfg, params, TrainConfig(optimizer=adamw, remat=remat), batch,
            REMAT_STEPS, f"remat {remat}")
        step_ms[remat] = (float(np.median(t[1:])), peak_gib())
    same_params = all(map(torch.equal, tree_leaves(ends["none"]),
                          tree_leaves(ends["full"])))
    gap = max(abs(a - b) for a, b in zip(series["full"], series["none"]))
    print(f"  remat none / full, {REMAT_STEPS} steps: losses "
          f"{series['none']} / {series['full']}, largest gap {gap:.3e}, "
          f"final params bit-equal: {same_params} (both must be bit-equal); "
          f"step {step_ms['none'][0]:.1f} / {step_ms['full'][0]:.1f} ms, peak "
          f"memory {step_ms['none'][1]:.2f} / {step_ms['full'][1]:.2f} GiB")
    require(series["full"] == series["none"] and same_params,
            f"remat full's losses {series['full']} or params differ from "
            f"none's {series['none']}")
    del ends
    _, mb_loss, _ = train_run(
        cfg, params, TrainConfig(optimizer=adamw, remat="none",
                                 microbatches=2), batch, 1, "microbatches 2")
    print(f"  microbatches 2, one step: loss {mb_loss[0]:.4f} (one batch: "
          f"{series['none'][0]:.4f}); launch counts as stated")
    del params
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    driver_check()
    return dict(launches=launches, step_ms=ms, tokens_s=tokens / ms * 1e3,
                loss_first5=first, loss_last5=last,
                remat_step_ms={k: v[0] for k, v in step_ms.items()},
                remat_peak_gib={k: v[1] for k, v in step_ms.items()})


def train_profile(cfg, params, train, batch, step_ms):
    """Where a training step's time goes: one AdamW step (after one
    unprofiled warm-up step) under ``torch.profiler``; device time of
    every kernel and copy against the unprofiled median step time, K2's
    and its backward's share, and the kernels with the most device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step_fn = make_train_step(cfg, train)
    opt = init_train_state(cfg, train, params)
    p1, opt, _ = step_fn(params, opt, batch)
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(p1, opt, batch)
        sync()
    del p1, opt
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    if not rows:
        print("  training step: device time not measured (the trace holds "
              "no device events)")
        return None
    busy = sum(ms for _, ms, _ in rows)
    ours = {k: sum(ms for key, ms, _ in rows
                   if any(n in key for n in names))
            for k, names in K_NAMES.items()}
    print(f"  training step profiled: device busy {busy:.1f} ms in "
          f"{sum(n for _, _, n in rows)} kernels and copies = "
          f"{100 * busy / step_ms:.1f}% of the unprofiled step {step_ms:.1f} "
          f"ms; K2 {ours['K2']:.2f} ms ({100 * ours['K2'] / busy:.1f}%), "
          f"K2-bwd {ours['K2-bwd']:.2f} ms "
          f"({100 * ours['K2-bwd'] / busy:.1f}%)")
    print("  K2-bwd by kernel: " + ", ".join(
        f"{name} {ms:.2f} ms x{n}" for name in K_NAMES["K2-bwd"]
        for ms, n in [(sum(m for key, m, _ in rows if name in key),
                       sum(c for key, _, c in rows if name in key))] if n))
    for key, ms, n in rows[:8]:
        print(f"    {ms:9.3f} ms {100 * ms / busy:5.1f}% x{n:<6} {key[:90]}")
    return dict(busy_ms=busy, busy_share=busy / step_ms, k2_ms=ours["K2"],
                k2_bwd_ms=ours["K2-bwd"], k2_bwd_share=ours["K2-bwd"] / busy)


def driver_check():
    """``python -m repro_torch.launch.train`` as a subprocess: 4 steps in
    one directory, and (started beside it) 2 steps then ``--resume`` to 4
    in another; the two final checkpoints (params and optimizer state)
    must be the same bytes."""
    tmp = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(tmp, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *DRIVER_ARGV]

    def start(args):
        return subprocess.Popen(cmd + args, cwd=ROOT, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)

    def finish(proc, name):
        out, _ = proc.communicate(timeout=300)
        lines = [x for x in out.splitlines() if x.startswith(("step",
                                                              "resumed"))]
        print(f"  driver ({name}): " + "; ".join(lines))
        require(proc.returncode == 0, f"driver ({name}) exited "
                f"{proc.returncode}:\n{out[-3000:]}")

    t0 = time.perf_counter()
    whole, half = os.path.join(tmp, "a"), os.path.join(tmp, "b")
    procs = [start(["--steps", "4", "--ckpt-dir", whole]),
             start(["--steps", "2", "--ckpt-dir", half])]
    finish(procs[0], "4 steps")
    finish(procs[1], "2 steps")
    finish(start(["--steps", "4", "--ckpt-dir", half, "--resume"]),
           "--resume to 4")
    a, b = (os.path.join(d, "step_00000004") for d in (whole, half))
    names = sorted(n for n in os.listdir(a) if n.endswith(".npy"))
    require(names == sorted(n for n in os.listdir(b) if n.endswith(".npy")),
            "the two checkpoints hold different leaves")
    differ = [n for n in names if open(os.path.join(a, n), "rb").read()
              != open(os.path.join(b, n), "rb").read()]
    require(not differ, f"4 steps and 2 + --resume + 2 end at different "
            f"states: {differ}")
    print(f"  4 steps == 2 steps + --resume + 2 steps: all {len(names)} "
          f"leaf files (params and AdamW state) equal byte for byte "
          f"({time.perf_counter() - t0:.1f} s for the three runs)")
    shutil.rmtree(tmp, ignore_errors=True)


def training_cross_check(cfg4, params4):
    """Phase 14 (p): three AdamW steps of the f32 model at full width and
    4 layers on cuda and on the CPU (plain versions), same weights and
    batch: losses within 1e-3 (atol = rtol) and every param within 1e-3;
    and each leaf's update (params after - before) within 5e-2 of the
    CPU's in norm.  lr 1e-4, so an element whose gradient sign the two
    devices' rounding flips moves at most 2e-4 apart a step."""
    train = TrainConfig(optimizer=OptimizerConfig(
        name="adamw", lr=1e-4, warmup_steps=1, total_steps=1000),
        remat="full")
    dc = DataConfig(vocab_size=cfg4.vocab_size, batch_size=2, seq_len=128)
    runs = {}
    for dev in (DEVICE, "cpu"):
        params = map_tree(lambda x: x.to(dev), params4)
        step_fn = make_train_step(cfg4, train)
        opt = init_train_state(cfg4, train, params)
        losses = []
        for s in range(3):
            params, opt, m = step_fn(params, opt,
                                     make_batch(dc, s, device=dev))
            losses.append(m["loss"].item())
        runs[dev] = (map_tree(lambda x: x.cpu(), params), losses)
    (pg, lg), (pc, lc) = runs[DEVICE], runs["cpu"]
    p0 = map_tree(lambda x: x.cpu(), params4)
    worst = max((a - b).abs().max().item()
                for a, b in zip(tree_leaves(pg), tree_leaves(pc)))
    upd = max(((a - z) - (b - z)).norm().item() / max((b - z).norm().item(),
                                                      1e-30)
              for a, b, z in zip(tree_leaves(pg), tree_leaves(pc),
                                 tree_leaves(p0)))
    print(f"  losses cuda {lg}, cpu {lc}; largest param gap {worst:.3e}; "
          f"largest relative update gap {upd:.3e}")
    require(np.allclose(lg, lc, atol=1e-3, rtol=1e-3),
            f"f32 training losses cuda {lg} vs cpu {lc}")
    require(worst <= 1e-3, f"f32 training params differ by {worst}")
    require(upd <= 5e-2, f"f32 training updates differ by {upd} in norm")


# ---------------------------------------------------------------------------
# serving + cross-check
# ---------------------------------------------------------------------------

class LastStageLogits:
    """Records last-stage logits per request while active, on paged and
    dense stage engines: the final prefill pass's (the last chunk wins) and
    every decode pass's (by position); ``engines`` names each node's
    engine class in the last run (``_recorded_run``)."""

    def __init__(self):
        self.prefill, self.decode = {}, {}

    def __enter__(self):
        self._orig = (PagedStageEngine.prefill_chunk,
                      StageEngine.prefill_stage,
                      PagedStageEngine.prefill_stage,
                      _StageEngineBase.decode_stage)
        rec = self
        orig_chunk, orig_stage, orig_paged_stage, orig_dec = self._orig

        def record(eng, slot, out):
            if eng.is_last:
                rec.prefill[eng.slots[slot]] = np.array(out)
            return out

        def prefill_chunk(eng, slot, x, entry, start):
            return record(eng, slot, orig_chunk(eng, slot, x, entry, start))

        def prefill_stage(eng, slot, x, entry):
            return record(eng, slot, orig_stage(eng, slot, x, entry))

        def paged_prefill_stage(eng, slot, x, entry):
            return record(eng, slot, orig_paged_stage(eng, slot, x, entry))

        def decode_stage(eng, items):
            outs = orig_dec(eng, items)
            if eng.is_last:
                for it, o in zip(items, outs):
                    rec.decode.setdefault(eng.slots[it.slot], {})[it.pos] = \
                        np.array(o.logits)
            return outs

        PagedStageEngine.prefill_chunk = prefill_chunk
        StageEngine.prefill_stage = prefill_stage
        PagedStageEngine.prefill_stage = paged_prefill_stage
        _StageEngineBase.decode_stage = decode_stage
        return self

    def __exit__(self, *exc):
        (PagedStageEngine.prefill_chunk, StageEngine.prefill_stage,
         PagedStageEngine.prefill_stage,
         _StageEngineBase.decode_stage) = self._orig


def zero_counts():
    k1.launches = 0
    k1.split_launches = 0
    k2.launches = 0
    k2.tc_launches = 0
    k2.window_launches = 0
    k2.bwd_launches = 0
    k2.bwd_window_launches = 0


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


def check_head(cfg, rt):
    """Every last-stage engine holds the final norm and, with untied
    embeddings, ``lm_head`` and no ``embed`` (tied: ``embed``, no
    ``lm_head``)."""
    for n, e in rt.engines.items():
        if e.is_last:
            keys = set(e.sparams)
            require("final_norm" in keys and
                    ("lm_head" in keys) != cfg.tie_embeddings and
                    ("embed" in keys) == cfg.tie_embeddings,
                    f"{n}: last stage of {cfg.name} holds {sorted(keys)}")


def serving_phase(cfg, params, argv=SERVE_ARGV):
    """Paged cluster serving: K1 in every decode pass of every layer, K2
    never."""
    args = serve.parse_args(argv + ["--device", DEVICE])
    warm = serve.parse_args(argv + ["--device", DEVICE,
                                    "--new-tokens", "2"])
    serve.run_cluster(cfg, warm, params, verbose=False)     # CUDA warm-up
    zero_counts()
    with LastStageLogits() as rec:
        rt, reqs, p, dt = serve.run_cluster(cfg, args, params)
    launches, k2_launches = k1.launches, k2.launches
    split_launches = k1.split_launches
    toks = sum(len(r.output) for r in reqs)
    check_requests(cfg, reqs, args.new_tokens, rt.served, rec)
    check_head(cfg, rt)
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


def dense_serving_phase(cfg, params, card, argv=DENSE_ARGV):
    """Dense cluster serving (``--dense``): K2 in every prefill of every
    layer, K1 never (dense decode is plain torch)."""
    args = serve.parse_args(argv + ["--device", DEVICE])
    warm = serve.parse_args(argv + ["--device", DEVICE,
                                    "--new-tokens", "2"])
    serve.run_cluster(cfg, warm, params, verbose=False)     # CUDA warm-up
    zero_counts()
    with LastStageLogits() as rec:
        rt, reqs, p, dt = serve.run_cluster(cfg, args, params)
    launches, tc_launches, k1_launches = (k2.launches, k2.tc_launches,
                                          k1.launches)
    toks = sum(len(r.output) for r in reqs)
    check_requests(cfg, reqs, args.new_tokens, rt.served, rec)
    check_head(cfg, rt)
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
    cluster = full_mesh_cluster(len(placement.assignment),
                                bandwidth=LINK_BYTES_PER_S,
                                latency_s=LINK_DELAY_S)
    return plan(cluster, model_profile(cfg), placement=placement)


def model_profile(cfg):
    """``cfg``'s analytic profile, with the port's KV page size."""
    return ModelProfile.from_dims(
        cfg.name, cfg.num_layers, cfg.d_model, max(cfg.d_ff, 1),
        cfg.vocab_size, cfg.num_kv_heads, cfg.resolved_head_dim,
        kv_page_size=PAGE)


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


# ---------------------------------------------------------------------------
# cancellation and live autoscaling
# ---------------------------------------------------------------------------

# the autoscaler's catalog: A100s whose token rate is capped at
# AS_TOKEN_RATE (the reference test's ``_capped_a100``); the mix is solved
# with AS_HEADROOM, and a load must hold AS_PATIENCE ticks
AS_TOKEN_RATE = 1000.0
AS_HEADROOM = 1.2
AS_PATIENCE = 2
# what the phase-10 cross-check holds equal between cuda and the CPU
CANCEL_COUNTERS = ("cancelled_requests", "cancelled_inflight", "completed",
                   "tokens_produced")
# the straggler run's fabricated telemetry: n2 ten times slower
STRAGGLER_SEED = ({"n0": 1.0, "n1": 1.0, "n2": 10.0},
                  {"n0": 100, "n1": 100, "n2": 100})


class Listeners:
    """The ``on_token`` and ``on_done`` listeners of a run's requests."""

    def __init__(self):
        self.tokens, self.done = {}, []

    def submit(self, rt, reqs):
        for r in reqs:
            self.tokens[r.request_id] = []
            rt.submit(r, on_token=self.tokens[r.request_id].append,
                      on_done=lambda rr: self.done.append(
                          (rr.request_id, rr.finish_reason)))

    def check(self, reqs, name):
        """``on_token`` saw exactly each request's confirmed tokens, in
        order; ``on_done`` fired once per request."""
        require(all(self.tokens[r.request_id] == r.output for r in reqs),
                f"({name}) on_token did not see the confirmed tokens")
        require(sorted(self.done) ==
                sorted((r.request_id, r.finish_reason) for r in reqs),
                f"({name}) on_done calls {self.done}")


def step_until(rt, pred, name, max_steps=10000):
    """Step ``rt`` until ``pred()`` holds; returns the steps taken."""
    for n in range(max_steps):
        if pred():
            return n
        rt.step()
    raise RuntimeError(f"chip_smoke check failed: ({name}) the state to "
                       f"cancel in never came in {max_steps} steps")


def cancel_from_thread(rt, rid):
    th = threading.Thread(target=rt.cancel, args=(rid,))
    th.start()
    th.join(timeout=60)
    require(not th.is_alive(), "the cancelling thread did not finish")


def check_cancel_run(rt, reqs, lis, engines, cancelled, ref_tokens, name,
                     device):
    """A run with cancels: the cancelled requests end as "cancelled" with a
    prefix of their reference tokens, the others with all of them; the
    listeners, drained pools, free draft slots, ``pending() == 0``; on
    ``DEVICE`` K1 launches == decode passes x paged layers over ``engines``
    (none split), K2 launches == the draft's prefills x its layers (all
    tensor-core) or none."""
    for r in reqs:
        want = ref_tokens[r.request_id % 100]
        if r.request_id in cancelled:
            require(r.finish_reason == "cancelled" and
                    len(r.output) < len(want) and
                    r.output == want[:len(r.output)],
                    f"({name}) cancelled req{r.request_id}: "
                    f"{r.finish_reason} {r.output}, reference {want}")
        else:
            require(r.finish_reason == "length" and r.output == want,
                    f"({name}) req{r.request_id} {r.output} differs from "
                    f"the reference's {want}")
    require(rt.cancelled_requests == len(cancelled),
            f"({name}) cancelled_requests {rt.cancelled_requests}")
    lis.check(reqs, name)
    check_drained(rt, name)
    if rt.draft is not None:
        require(rt.draft.free_slots == len(rt.draft.slots) and
                rt.draft.kv_tokens_used() == 0,
                f"({name}) draft slots not released")
    require(rt.pending() == 0, f"({name}) pending() {rt.pending()}")
    if device != DEVICE:
        return                       # the cross-check's CPU run: no kernel
    want = k1_expected(engines)
    require(k1.launches == want > 0 and k1.split_launches == 0,
            f"({name}) K1 {k1.launches} ({k1.split_launches} split), "
            f"expected {want} (none split)")
    dl = rt.draft.layers.num_layers if rt.draft is not None else 0
    want2 = rt.draft.prefills * dl if rt.draft is not None else 0
    require(k2.launches == want2 and k2.tc_launches == k2.launches,
            f"({name}) K2 {k2.launches} ({k2.tc_launches} tensor-core), "
            f"expected {want2}")


def summary(rt, reqs, **extra):
    """What the f32 cross-check holds equal between cuda and the CPU."""
    return dict(tokens=[r.output for r in reqs],
                reasons=[r.finish_reason for r in reqs],
                counters={k: getattr(rt, k) for k in CANCEL_COUNTERS},
                ledger=dict(rt.transport.transfers), **extra)


def serving_args(device, *extra):
    return serve.parse_args(SERVE_ARGV + ["--device", device, *extra])


def cancel_paged_run(cfg, params, p, ref_tokens, device):
    """(f) phase 5's plan and requests at depth 2: request 1 cancelled
    right after its submit, still queued; request 2 cancelled from
    another thread once it has two confirmed tokens."""
    args = serving_args(device, "--max-inflight", "2")
    rt = ClusterRuntime(cfg, params, p, serve.engine_config(args),
                        page_size=args.page_size, max_inflight=2,
                        device=device)
    reqs, lis, st = serve.make_requests(cfg, args), Listeners(), {}

    def run():
        lis.submit(rt, reqs)
        rt.cancel(1)
        st["steps"] = step_until(rt, lambda: len(reqs[2].output) >= 2, "f")
        st["before"] = len(reqs[2].output)
        cancel_from_thread(rt, 2)
        rt.run_until_done()
    zero_counts()
    dt = serve.timed(torch.device(device), run)
    check_cancel_run(rt, reqs, lis, rt.engines.values(), {1, 2}, ref_tokens,
                     "f cancel", device)
    require(reqs[1].output == [], f"(f) the queued request decoded "
                                  f"{reqs[1].output}")
    return rt, reqs, dt, summary(rt, reqs, steps=st["steps"],
                                 before=st["before"])


def cancel_spec_run(cfg, params, p, ref_tokens, device):
    """(g) phase 6's perfect draft, γ = 4, on modelled links: request 0
    cancelled while a verify round is in flight."""
    args = serve.parse_args(SPEC_ARGV + ["--device", device])
    rt = ClusterRuntime(cfg, params, p, serve.engine_config(args),
                        page_size=args.page_size, transport=link_model(),
                        device=device, draft_cfg=cfg, draft_params=params,
                        spec_tokens=args.spec_tokens)
    reqs, lis, st = serve.make_requests(cfg, args), Listeners(), {}

    def run():
        lis.submit(rt, reqs)
        st["steps"] = step_until(
            rt, lambda: 0 in rt.jobs and rt.jobs[0].draft_slot is not None
            and rt.jobs[0].inflight > 0 and rt.spec_rounds > 0, "g")
        st["before"] = len(reqs[0].output)
        rt.cancel(0)
        rt.run_until_done()
    zero_counts()
    dt = serve.timed(torch.device(device), run)
    check_cancel_run(rt, reqs, lis, rt.engines.values(), {0}, ref_tokens,
                     "g cancel speculative", device)
    return rt, reqs, dt, summary(rt, reqs, steps=st["steps"],
                                 before=st["before"])


def cancel_handoff_run(cfg, params, ref_tokens, device):
    """(h) phase 11's plan (a) at depth 2: the first request with a KV
    handoff in flight is cancelled while it holds slots on the prefill
    node and the decode replica."""
    args = serving_args(device, "--max-inflight", "2")
    p = disagg_plan(cfg, *disagg_layouts(cfg.num_layers)[0])
    rt = ClusterRuntime(cfg, params, p, serve.engine_config(args),
                        page_size=args.page_size, max_inflight=2,
                        transport=link_model(), device=device)
    reqs, lis, st = serve.make_requests(cfg, args), Listeners(), {}

    def run():
        lis.submit(rt, reqs)
        st["steps"] = step_until(
            rt, lambda: any(j.kv_pending for j in rt.jobs.values()), "h")
        victim = next(j for j in rt.jobs.values() if j.kv_pending)
        st["victim"] = victim.req.request_id
        st["held"] = sorted(victim.slots)
        st["pending"] = sorted(victim.kv_pending)
        rt.cancel(victim.req.request_id)
        rt.run_until_done()
    zero_counts()
    dt = serve.timed(torch.device(device), run)
    require("n0" in st["held"] and {"n1", "n2"} & set(st["held"]),
            f"(h) the victim held slots on {st['held']} only")
    check_cancel_run(rt, reqs, lis, rt.engines.values(), {st["victim"]},
                     ref_tokens, "h cancel handoff", device)
    return rt, reqs, dt, summary(rt, reqs, **st)


def capped_a100(rate):
    return dataclasses.replace(DEVICE_PROFILES["A100"],
                               max_tokens_per_s=rate)


def capped_plan(cfg, layout, dev):
    """A plan of ``layout`` ({node: (start, end)}) on a full mesh of nodes
    of device ``dev`` at 1 ms / 10 Gb/s."""
    cluster = full_mesh_cluster(len(layout), bandwidth=LINK_BYTES_PER_S,
                                latency_s=LINK_DELAY_S)
    cluster = dataclasses.replace(cluster, nodes={
        n: dataclasses.replace(spec, device=dev)
        for n, spec in cluster.nodes.items()})
    placement = Placement({n: LayerRange(*r) for n, r in layout.items()},
                          cfg.num_layers)
    return plan(cluster, model_profile(cfg), placement=placement)


def autoscale_loads(cfg):
    """The capped A100 and the phase's loads, from ``ThroughputTable.
    profile`` on ``cfg``'s profile for phase 5's requests (one bucket of
    40 prompt + 16 new tokens): ``base`` fits two nodes with the headroom
    and leaves none to retire, ``step`` needs four, ``low`` leaves one of
    three to retire.  Returns (device, {load: TrafficProfile}, node rate
    in requests/s)."""
    dev = capped_a100(AS_TOKEN_RATE)
    args = serve.parse_args(SERVE_ARGV)
    bucket = Bucket(int(args.prompt), args.new_tokens)
    table = ThroughputTable.profile(model_profile(cfg), [bucket], ["A100"],
                                    devices={"A100": dev})
    node_rps = table.rates["A100"][0]
    loads = {k: TrafficProfile(rate_rps=f * node_rps, buckets=[bucket],
                               weights=[1.0])
             for k, f in (("base", 1 / AS_HEADROOM), ("step", 3.0),
                          ("low", 0.2))}

    def fits(load, n):
        return mix_is_feasible(table, dataclasses.replace(
            loads[load], rate_rps=loads[load].rate_rps * AS_HEADROOM,
            weights=[1.0]), {"A100": n})
    require(fits("base", 2) and not fits("step", 2) and fits("step", 4)
            and fits("low", 1), "the autoscaler's loads do not split the "
                                "fleet as planned")
    return dev, loads, node_rps


def events(sc):
    return [(e.t, e.kind, e.detail) for e in sc.events]


def scale_up_run(cfg, params, ref_tokens, device):
    """(i) scale-up: phase 5's 2-stage placement on two capped A100s at
    depth 2, the baseline load for two ticks, phase 5's requests, six
    steps, then the step load for ``AS_PATIENCE`` ticks: the grown plan
    lands between steps; the requests in flight finish, then a second
    batch through the grown fleet."""
    dev, loads, _ = autoscale_loads(cfg)
    L, h = cfg.num_layers, cfg.num_layers // 2
    p = capped_plan(cfg, {"n0": (0, h), "n1": (h, L)}, dev)
    args = serving_args(device, "--max-inflight", "2")
    rt = ClusterRuntime(cfg, params, p, serve.engine_config(args),
                        page_size=args.page_size, max_inflight=2,
                        transport=link_model(), device=device)
    load = {"t": loads["base"]}
    sc = Autoscaler(rt, p, catalog={"A100": dev}, patience=AS_PATIENCE,
                    headroom=AS_HEADROOM, traffic_fn=lambda: load["t"])
    reqs = serve.make_requests(cfg, args)
    batch2 = [dataclasses.replace(r, request_id=100 + r.request_id)
              for r in serve.make_requests(cfg, args)]
    lis, acts, st = Listeners(), [], {}

    def run():
        acts.extend(sc.tick() for _ in range(2))
        lis.submit(rt, reqs)
        for _ in range(6):
            rt.step()
        st["inflight"] = sorted(rt.jobs)
        load["t"] = loads["step"]
        acts.extend(sc.tick() for _ in range(AS_PATIENCE))
        rt.step()                    # the queued apply_plan lands here
        rt.run_until_done()
        lis.submit(rt, batch2)
        rt.run_until_done()
    zero_counts()
    dt = serve.timed(torch.device(device), run)
    new = sorted(set(rt.engines) - {"n0", "n1"})
    require(acts == [None, None] + [None] * (AS_PATIENCE - 1) + ["scale_up"]
            and st["inflight"], f"(i) actions {acts}, in flight at the "
                                f"load step {st['inflight']}")
    require(new and all(n.startswith("a100-as") for n in new) and
            all(rt.placement.assignment[n] == p.placement.assignment[n]
                for n in ("n0", "n1")) and
            rt.cluster.cost_per_hour() > p.cluster.cost_per_hour(),
            f"(i) grown to {rt.placement.assignment}")
    require(all(rt.engines[n].device.type == torch.device(device).type
                for n in new), "(i) a new engine is not on the device")
    require(sum(rt.engines[n].decode_steps for n in new) > 0,
            "(i) no request decoded on the new nodes")
    all_reqs = reqs + batch2
    check_cancel_run(rt, all_reqs, lis, rt.engines.values(), set(),
                     ref_tokens, "i scale-up", device)
    grown = {n: (r.start, r.end) for n, r in rt.placement.assignment.items()}
    return rt, sc, all_reqs, dt, summary(rt, all_reqs, events=events(sc),
                                         placement=grown,
                                         inflight=st["inflight"])


def drain_retire_run(cfg, params, ref_tokens, device):
    """(i) drain and retire: three full replicas on capped A100s at the
    low load, phase 5's requests in flight; the drained node is retired
    once the loop thread's probe finds it empty, then a second batch on
    the survivors."""
    dev, loads, _ = autoscale_loads(cfg)
    L = cfg.num_layers
    p = capped_plan(cfg, {n: (0, L) for n in ("n0", "n1", "n2")}, dev)
    args = serving_args(device, "--max-inflight", "2")
    rt = ClusterRuntime(cfg, params, p, serve.engine_config(args),
                        page_size=args.page_size, max_inflight=2,
                        transport=link_model(), device=device)
    sc = Autoscaler(rt, p, catalog={"A100": dev}, patience=1,
                    headroom=AS_HEADROOM, traffic_fn=lambda: loads["low"])
    reqs = serve.make_requests(cfg, args)
    batch2 = [dataclasses.replace(r, request_id=100 + r.request_id)
              for r in serve.make_requests(cfg, args)]
    lis, acts, st = Listeners(), [], {}
    seen = dict.fromkeys(rt.engines.values())

    def run():
        lis.submit(rt, reqs)
        for _ in range(4):
            rt.step()
        acts.append(sc.tick())
        st["victim"] = sc._draining
        st["busy"] = sorted(j.req.request_id for j in rt.jobs.values()
                            if st["victim"] in j.slots)
        for _ in range(10000):
            rt.step()
            act = sc.tick()
            acts.append(act)
            if act == "retire":
                break
        rt.step()                    # the plan without the victim lands
        rt.run_until_done()
        lis.submit(rt, batch2)
        rt.run_until_done()
    zero_counts()
    cost = rt.cluster.cost_per_hour()
    dt = serve.timed(torch.device(device), run)
    victim = st["victim"]
    require(acts[0] == "drain" and acts[-1] == "retire" and
            all(a is None for a in acts[1:-1]) and victim is not None and
            victim not in rt.engines and victim not in rt.cluster.nodes and
            rt.cluster.cost_per_hour() < cost,
            f"(i) drain/retire: actions {acts}, victim {victim}, engines "
            f"{sorted(rt.engines)}")
    all_reqs = reqs + batch2
    check_cancel_run(rt, all_reqs, lis, seen, set(), ref_tokens,
                     "i drain and retire", device)
    return rt, sc, all_reqs, dt, dict(victim=victim, busy=st["busy"],
                                      ticks=len(acts), cost=cost)


def straggler_run(cfg, params, ref_tokens, device):
    """(i) straggler: three full replicas, telemetry fabricated to show n2
    ten times slower than the others; the reweight lands in place (the
    same engine objects) and phase 5's requests keep their tokens."""
    dev, _, _ = autoscale_loads(cfg)
    L = cfg.num_layers
    p = capped_plan(cfg, {n: (0, L) for n in ("n0", "n1", "n2")}, dev)
    args = serving_args(device)
    rt = ClusterRuntime(cfg, params, p, serve.engine_config(args),
                        page_size=args.page_size, transport=link_model(),
                        device=device)
    sc = Autoscaler(rt, p, traffic_fn=lambda: None, patience=1,
                    min_decode_tokens=1)
    rt.node_decode_s.update(STRAGGLER_SEED[0])
    rt.node_decode_tokens.update(STRAGGLER_SEED[1])
    before = dict(rt.engines)
    require(sc.tick() is None and
            abs(sc._reweighted.get("n2", 1.0) - 0.1) < 1e-9,
            f"(i) straggler: reweighted {sc._reweighted}")
    reqs, lis = serve.make_requests(cfg, args), Listeners()

    def run():
        rt.step()                    # the reweighted plan lands here
        lis.submit(rt, reqs)
        rt.run_until_done()
    zero_counts()
    dt = serve.timed(torch.device(device), run)
    require(rt.engines.keys() == before.keys() and
            all(rt.engines[n] is e for n, e in before.items()),
            "(i) straggler: engines were rebuilt")
    check_cancel_run(rt, reqs, lis, rt.engines.values(), set(), ref_tokens,
                     "i straggler", device)
    return rt, sc, reqs, dt


def telemetry(rt, fabricated=None):
    """Per node: measured decode seconds, tokens and ms per token (the
    fabricated seed of a straggler run taken out)."""
    fab_s, fab_n = fabricated or ({}, {})
    out = {}
    for n in sorted(rt.node_decode_tokens):
        s = rt.node_decode_s[n] - fab_s.get(n, 0.0)
        k = rt.node_decode_tokens[n] - fab_n.get(n, 0)
        out[n] = (round(s, 6), k, round(1e3 * s / k, 4) if k else None)
    return out


def cancel_autoscale_phase(cfg, params, ref_tokens, card):
    """Phase 12, runs (f)-(i): see the module note.  Returns each run's
    launch counts."""
    args = serving_args(DEVICE)
    p5 = serve.make_plan(cfg, args)
    out = {}

    def report(name, rt, reqs, dt, extra):
        toks = sum(len(r.output) for r in reqs)
        out[name] = dict(k1=k1.launches, k2=k2.launches,
                         tokens_per_s=toks / dt)
        print(f"  ({name}) {len(reqs)} requests, {toks} tokens in {dt:.4f} "
              f"s = {toks / dt:.2f} tokens/s on {card} (host clock); "
              f"cancelled_requests {rt.cancelled_requests}, "
              f"cancelled_inflight {rt.cancelled_inflight}, completed "
              f"{rt.completed}, tokens_produced {rt.tokens_produced}; K1 "
              f"{k1.launches} = decode passes x paged layers, none split; "
              f"K2 {k2.launches}{extra}")

    rt, reqs, dt, s = cancel_paged_run(cfg, params, p5, ref_tokens, DEVICE)
    report("f cancel", rt, reqs, dt, f"; req1 cancelled queued (0 tokens), "
           f"req2 from another thread after {s['steps']} steps with "
           f"{s['before']} tokens ({len(reqs[2].output)} confirmed in all); "
           "reqs 0 and 3 equal to phase 5's")
    rt, reqs, dt, s = cancel_spec_run(cfg, params, p5, ref_tokens, DEVICE)
    report("g cancel speculative", rt, reqs, dt,
           f" = {rt.draft.prefills} draft prefills x "
           f"{rt.draft.layers.num_layers} layers, all tensor-core; req0 "
           f"cancelled with a verify round in flight after {s['steps']} "
           f"steps ({s['before']} tokens); {rt._spec_note()}; draft slots "
           "free")
    rt, reqs, dt, s = cancel_handoff_run(cfg, params, ref_tokens, DEVICE)
    report("h cancel handoff", rt, reqs, dt,
           f"; req{s['victim']} cancelled after {s['steps']} steps with "
           f"handoffs {s['pending']} pending, slots on {s['held']}; pools "
           f"of n0, n1 and n2 drained; {rt.transport.describe()}")

    dev, loads, node_rps = autoscale_loads(cfg)
    print(f"  (i) catalog: A100 capped at {dev.max_tokens_per_s:.0f} "
          f"tokens/s = {node_rps:.4f} requests/s of the (40, 16) bucket "
          f"per node (ThroughputTable.profile); loads (requests/s): "
          + ", ".join(f"{k} {t.rate_rps:.4f}" for k, t in loads.items())
          + f"; headroom {AS_HEADROOM}, patience {AS_PATIENCE}")
    rt, sc, reqs, dt, s = scale_up_run(cfg, params, ref_tokens, DEVICE)
    report("i scale-up", rt, reqs, dt,
           f"; events {s['events']}; in flight at the step "
           f"{s['inflight']}; grown to {s['placement']}, "
           f"${rt.cluster.cost_per_hour():.2f}/hr; decode passes "
           f"{({n: e.decode_steps for n, e in rt.engines.items()})}")
    print(f"  (i scale-up) measured decode telemetry per node (s, tokens, "
          f"ms/token; device synchronised): {telemetry(rt)}")
    rt, sc, reqs, dt, s = drain_retire_run(cfg, params, ref_tokens, DEVICE)
    report("i drain and retire", rt, reqs, dt,
           f" over every engine that ran (the retired one too); "
           f"{s['victim']} drained with requests {s['busy']} on it, retired "
           f"after {s['ticks']} ticks: ${s['cost']:.2f} -> "
           f"${rt.cluster.cost_per_hour():.2f}/hr; events {events(sc)}")
    print(f"  (i drain and retire) measured decode telemetry per node: "
          f"{telemetry(rt)}")
    rt, sc, reqs, dt = straggler_run(cfg, params, ref_tokens, DEVICE)
    report("i straggler", rt, reqs, dt,
           f"; events {events(sc)}; same engine objects; flows "
           + ", ".join(f"{k[0]}->{k[1]}={v:.1f}" for k, v in
                       sorted(sc.plan.flows.items()) if k[0] == "coordinator"))
    print(f"  (i straggler) measured decode telemetry per node (the "
          f"fabricated seed taken out): {telemetry(rt, STRAGGLER_SEED)}")
    return out


def cancel_autoscale_cross_check(cfg4, params4):
    """Phase 12's (f), (h) and (i)'s scale-up in f32 at 4 layers on cuda
    and on the CPU: equal tokens, finish reasons, counters, link ledgers,
    steps and autoscaler events."""
    cpu_params = map_tree(lambda t: t.cpu(), params4)
    p5 = serve.make_plan(cfg4, serving_args(DEVICE))
    _, reqs, _, _ = serve.run_cluster(cfg4, serving_args(DEVICE), params4,
                                      plan=p5, verbose=False)
    ref = [r.output for r in reqs]
    runs = {}
    for dev, prm in ((DEVICE, params4), ("cpu", cpu_params)):
        runs[dev] = {
            "f": cancel_paged_run(cfg4, prm, p5, ref, dev)[3],
            "h": cancel_handoff_run(cfg4, prm, ref, dev)[3],
            "i": scale_up_run(cfg4, prm, ref, dev)[4]}
    for name in ("f", "h", "i"):
        a, b = runs[DEVICE][name], runs["cpu"][name]
        print(f"  ({name}) cuda: {a}")
        require(a == b, f"({name}) f32 cuda and cpu runs differ: cpu {b}")
    print(f"  runs (f), (h) and (i) scale-up equal on cuda and the CPU: "
          "tokens, finish reasons, counters, link ledgers, steps, events")


# ---------------------------------------------------------------------------
# phase 13: stage workers, the wall clock and the front door
# ---------------------------------------------------------------------------

WORKER_TIMEOUT_S = 300.0
HTTP_TIMEOUT_S = 120.0


def failover_layout(L):
    """(l)'s placement over L layers: a 2-stage pipeline n0 -> n1 beside a
    full-model node n2."""
    return {"n0": (0, L // 2), "n1": (L // 2, L), "n2": (0, L)}


def mesh_plan(cfg, layout):
    """A plan of ``layout`` ({node: (start, end)}) on a full mesh of A100s
    at 1 ms / 10 Gb/s."""
    placement = Placement({n: LayerRange(*r) for n, r in layout.items()},
                          cfg.num_layers)
    cluster = full_mesh_cluster(len(layout), bandwidth=LINK_BYTES_PER_S,
                                latency_s=LINK_DELAY_S)
    return plan(cluster, model_profile(cfg), placement=placement)


class RpcLog:
    """While active, records every engine RPC the coordinator sends (node,
    method, seconds) and every engine the runtime makes (node, seconds:
    for a worker, the host copy of the params, the ``init`` RPC that ships
    them and the engine built on the worker's device)."""

    def __init__(self):
        self.calls, self.makes = [], []

    def __enter__(self):
        self._orig = (WorkerChannel.call, ClusterRuntime._make_engine)
        log = self
        orig_call, orig_make = self._orig

        def call(ch, method, *args):
            t0 = time.perf_counter()
            out = orig_call(ch, method, *args)
            log.calls.append((ch.node, method, time.perf_counter() - t0))
            return out

        def make(rt, node, rng):
            t0 = time.perf_counter()
            out = orig_make(rt, node, rng)
            log.makes.append((node, time.perf_counter() - t0))
            return out

        WorkerChannel.call = call
        ClusterRuntime._make_engine = make
        return self

    def __exit__(self, *exc):
        WorkerChannel.call, ClusterRuntime._make_engine = self._orig

    def count(self, method):
        out = {}
        for node, m, _ in self.calls:
            if m == method:
                out[node] = out.get(node, 0) + 1
        return out

    def seconds(self, method):
        return [s for _, m, s in self.calls if m == method]


def param_bytes(params):
    total = [0]
    map_tree(lambda t: total.__setitem__(0, total[0] +
                                         t.numel() * t.element_size()),
             params)
    return total[0]


def worker_runtime(cfg, params, p, args, device, **kw):
    """``spawn_workers`` on plan ``p`` with ``args``' engine config."""
    return ClusterRuntime.spawn_workers(
        cfg, params, p, serve.engine_config(args), paged=not args.dense,
        page_size=args.page_size, max_inflight=args.max_inflight,
        device=device, stall_timeout_s=120.0,
        worker_timeout_s=WORKER_TIMEOUT_S, **kw)


def fresh_requests(cfg, args, base):
    """``args``' requests with ids from ``base`` (a runtime serves several
    batches)."""
    return [dataclasses.replace(r, request_id=base + r.request_id)
            for r in serve.make_requests(cfg, args)]


def one_at_a_time(rt, reqs):
    """Each request submitted after the previous one finished: every
    decode batch holds one row."""
    for r in reqs:
        rt.submit(r)
        rt.run_until_done()
    return [r.output for r in reqs]


def together(rt, reqs):
    for r in reqs:
        rt.submit(r)
    rt.run_until_done()
    return [r.output for r in reqs]


def check_remote_drained(rt, name):
    """Every worker's pool (paged) and KV rows (dense) empty, asked over
    RPC; nothing pending."""
    used = rt.pool_pages_used()
    held = {n: t for n, e in rt.engines.items()
            if (t := e.kv_tokens_used())}
    require(all(u == 0 for u in used.values()) and not held and
            rt.pending() == 0,
            f"({name}) remote pages {used} or KV tokens {held} not "
            f"released, pending {rt.pending()}")
    return used


def check_done(reqs, n, name):
    require(all(r.done and len(r.output) == n for r in reqs),
            f"({name}) not every request finished with {n} tokens: "
            f"{[len(r.output) for r in reqs]}")


def agreeing(toks, ref):
    return sum(a == b for a, b in zip(toks, ref))


def solo_inprocess(cfg, params, p, args, device):
    """The in-process virtual-clock cluster on ``p``, one request at a
    time: (tokens, host seconds)."""
    rt = ClusterRuntime(cfg, params, p, serve.engine_config(args),
                        paged=not args.dense, page_size=args.page_size,
                        max_inflight=args.max_inflight, device=device)
    reqs = serve.make_requests(cfg, args)
    t0 = time.perf_counter()
    toks = one_at_a_time(rt, reqs)
    return toks, time.perf_counter() - t0


def worker_runs(cfg, params, p, args, solo, batched, device, name, *,
                direct, keep=False):
    """One ``spawn_workers`` runtime on ``p`` at depth 1, then depth 2 (set
    between runs, nothing in flight): each depth serves ``args``' requests
    one at a time (tokens must equal ``solo``, the in-process one-at-a-time
    run) and then together (all complete; the count equal to ``batched``
    is reported).  Remote pools drain after every run.  Returns (runtime if
    ``keep`` else None, report lines, seconds by part, the together runs'
    tokens by depth)."""
    lines, secs, batch = [], {}, {}
    t0 = time.perf_counter()
    rt = worker_runtime(cfg, params, p, args, device,
                        direct_links=direct)
    secs["spawn"] = time.perf_counter() - t0
    try:
        require(all(isinstance(e, RemoteStageEngine)
                    for e in rt.engines.values()),
                f"({name}) engines not remote")
        base = 0
        for depth in (1, 2):
            rt.max_inflight = depth
            t0 = time.perf_counter()
            reqs = fresh_requests(cfg, args, base)
            toks = one_at_a_time(rt, reqs)
            secs[f"solo d{depth}"] = time.perf_counter() - t0
            check_done(reqs, args.new_tokens, name)
            require(toks == solo, f"({name}, depth {depth}) one-at-a-time "
                                  f"tokens {toks} differ from the "
                                  f"in-process run's {solo}")
            check_remote_drained(rt, name)
            t0 = time.perf_counter()
            reqs = fresh_requests(cfg, args, base + 100)
            toks = batch[depth] = together(rt, reqs)
            secs[f"together d{depth}"] = time.perf_counter() - t0
            check_done(reqs, args.new_tokens, name)
            used = check_remote_drained(rt, name)
            lines.append(
                f"depth {depth}: one at a time equal to the in-process "
                f"run ({secs[f'solo d{depth}']:.2f} s); together "
                f"{secs[f'together d{depth}']:.2f} s, "
                f"{sum(len(t) for t in toks)} tokens, "
                f"{agreeing(toks, batched)} of {len(toks)} requests' "
                f"tokens equal to the batched in-process run's; remote "
                f"pools {used}")
            base += 1000
        lines.append(rt.transport.describe())
    except BaseException:
        rt.shutdown()
        raise
    if keep:
        return rt, lines, secs, batch
    rt.shutdown()
    return None, lines, secs, batch


def kill_run(cfg, params, args, solo, device):
    """(l) ``failover_layout`` over three workers, depth 1, ``args``'
    requests together: once a request routed through n1 has its first
    token (a decode pass in flight), SIGKILL n1's worker, ``fail_node``,
    ``replan_after_failure`` and ``apply_plan``; the survivors finish with
    ``solo``'s tokens and every remote pool drains."""
    p = mesh_plan(cfg, failover_layout(cfg.num_layers))
    rt = worker_runtime(cfg, params, p, args, device)
    try:
        reqs = fresh_requests(cfg, args, 0)
        for r in reqs:
            rt.submit(r)
        for _ in range(100000):
            hit = [j for j in rt.jobs.values()
                   if "n1" in j.route.nodes and j.req.output]
            if hit:
                break
            if not rt.step():
                require(rt._await_delivery(120.0), "(l) runtime stalled")
        require(hit, "(l) no request through n1 decoded")
        before = [len(r.output) for r in reqs]
        rt.kill_worker("n1")
        rt.fail_node("n1")
        new = replan_after_failure(p, "n1", MILPOptions(
            time_limit_s=5.0, lns_rounds=0, fgls_rounds=10))
        rt.apply_plan(new)
        rt.run_until_done()
        check_done(reqs, args.new_tokens, "l")
        toks = [r.output for r in reqs]
        require(toks == solo, f"(l) tokens after the kill {toks} differ "
                              f"from the one-at-a-time run's {solo}")
        require("n1" not in rt.engines and "n1" not in rt.workers and
                sum(r.preemptions for r in reqs) > 0,
                f"(l) engines {sorted(rt.engines)}, workers "
                f"{sorted(rt.workers)}, preemptions "
                f"{[r.preemptions for r in reqs]}")
        used = check_remote_drained(rt, "l")
        return (f"killed n1 with tokens {before} confirmed "
                f"({[r.preemptions for r in reqs]} preemptions), replanned "
                "to " + ", ".join(f"{n}=[{r.start},{r.end})" for n, r in
                                  sorted(new.placement.assignment.items()))
                + f"; tokens equal to the one-at-a-time run's; remote "
                f"pools {used}")
    finally:
        rt.shutdown()


def http_stream(url, body):
    """POST a streaming completion: (token ids, finish reason)."""
    req = urllib.request.Request(
        url + "/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    toks, finish = [], None
    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as resp:
        for raw in resp:
            line = raw.strip()
            if line == b"data: [DONE]":
                break
            if line.startswith(b"data: "):
                c = json.loads(line[6:])["choices"][0]
                if c.get("token_id") is not None:
                    toks.append(c["token_id"])
                finish = c.get("finish_reason") or finish
    return toks, finish


def http_get(url, path):
    with urllib.request.urlopen(url + path, timeout=HTTP_TIMEOUT_S) as r:
        return json.load(r)


def wait_for(pred, name, timeout_s=HTTP_TIMEOUT_S):
    deadline = time.monotonic() + timeout_s
    while not pred():
        require(time.monotonic() < deadline, f"({name}) timed out")
        time.sleep(0.01)


def disconnect_mid_stream(host, port, prompt):
    """A raw client that reads two SSE chunks of a long stream, then
    resets its socket."""
    body = json.dumps({"prompt": prompt, "max_tokens": 48,
                       "stream": True}).encode()
    s = socket.create_connection((host, port), timeout=HTTP_TIMEOUT_S)
    try:
        s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\n" +
                  f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        buf = b""
        while buf.count(b"data: ") < 2:
            chunk = s.recv(4096)
            require(chunk, "the server closed the stream early")
            buf += chunk
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     struct.pack("ii", 1, 0))       # RST on close
    finally:
        s.close()


def front_door_run(rt, cfg, args, solo, batched, name):
    """(m) ``Frontend`` over ``rt``: request 0 streamed alone (tokens equal
    ``solo[0]``), then all of ``args``' requests as concurrent streams
    (all complete; the count equal to ``batched`` reported), then a client
    that disconnects mid-stream (``cancelled_requests`` >= 1, every pool 0
    on ``/healthz``).  Returns the report line and ``summarize``'s
    summary."""
    fe = Frontend(rt, max_pending=16)
    host, port = fe.serve("127.0.0.1", 0)
    url = f"http://{host}:{port}"
    try:
        prompts = [[int(t) for t in r.prompt]
                   for r in serve.make_requests(cfg, args)]
        toks, finish = http_stream(url, {"prompt": prompts[0],
                                         "max_tokens": args.new_tokens,
                                         "stream": True})
        require(toks == solo[0] and finish == "length",
                f"({name}) streamed {toks} ({finish}), one-at-a-time run "
                f"{solo[0]}")
        res = [None] * len(prompts)

        def fire(i):
            res[i] = http_stream(url, {"prompt": prompts[i],
                                       "max_tokens": args.new_tokens,
                                       "stream": True})
        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=HTTP_TIMEOUT_S)
        require(all(r is not None and len(r[0]) == args.new_tokens and
                    r[1] == "length" for r in res),
                f"({name}) concurrent streams {res}")
        same = agreeing([r[0] for r in res], batched)
        disconnect_mid_stream(host, port, prompts[1])
        wait_for(lambda: rt.cancelled_requests >= 1 and rt.pending() == 0,
                 name)
        h = http_get(url, "/healthz")
        require(h["cancelled_requests"] >= 1 and h["pending"] == 0 and
                all(v == 0 for v in h["pool_pages_used"].values()),
                f"({name}) /healthz after the disconnect: cancelled "
                f"{h['cancelled_requests']}, pending {h['pending']}, pools "
                f"{h['pool_pages_used']}")
        summary = fe.summary()
    finally:
        fe.shutdown(drain=True, timeout_s=HTTP_TIMEOUT_S)
    require(fe.loop_error is None, f"({name}) loop died: {fe.loop_error!r}")
    return (f"stream of request 0 equal to the one-at-a-time run's; "
            f"{len(prompts)} concurrent streams, {same} equal to the "
            f"batched run's; a client reset mid-stream: cancelled_requests "
            f"{h['cancelled_requests']}, pools {h['pool_pages_used']} on "
            "/healthz"), summary


def fmt_ms(d):
    return "/".join(f"{1e3 * d[k]:.2f}" for k in ("p50", "p95", "p99"))


def thread_workers(n, port, device):
    """``n`` workers dialing ``127.0.0.1:port`` through ``run_worker`` (the
    module's entry point) on threads of this process, so their kernel
    launches count here; each retries until the coordinator listens."""
    errors = []

    def work():
        for _ in range(1200):
            try:
                run_worker("127.0.0.1", port, timeout_s=WORKER_TIMEOUT_S,
                           device=device)
                return
            except ConnectionRefusedError:
                time.sleep(0.05)
            except BaseException as e:
                errors.append(e)
                return
        errors.append(RuntimeError("never reached the coordinator"))

    threads = [threading.Thread(target=work, daemon=True) for _ in range(n)]
    for t in threads:
        t.start()
    return threads, errors


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def counted_run(cfg, params, p, args, device, name):
    """(j) or (k) once more over workers on threads of this process
    (``spawn_workers(connect=...)``), the requests together at depth 1
    over direct links: K1 and K2 launches against the RPCs that ran
    them."""
    port = free_port()
    threads, errors = thread_workers(len(p.placement.assignment), port,
                                     device)
    rt = worker_runtime(cfg, params, p, args, device, direct_links=True,
                        connect=f"127.0.0.1:{port}")
    try:
        reqs = fresh_requests(cfg, args, 0)
        with RpcLog() as log:
            zero_counts()
            t0 = time.perf_counter()
            together(rt, reqs)
            dt = time.perf_counter() - t0
            got = dict(k1=k1.launches, k1_split=k1.split_launches,
                       k2=k2.launches, k2_tc=k2.tc_launches)
        check_done(reqs, args.new_tokens, name)
        check_remote_drained(rt, name)
        layers = {n: r.num_layers for n, r in p.placement.assignment.items()}
        dec = log.count("decode_stage")
        pre = log.count("prefill_stage")
        want_k1 = 0 if args.dense else sum(dec[n] * layers[n] for n in dec)
        want_k2 = sum(pre.get(n, 0) * layers[n] for n in layers)
        require(got["k1"] == want_k1 and got["k1_split"] == 0 and
                got["k2"] == want_k2 and got["k2_tc"] == got["k2"] and
                (got["k1"] if not args.dense else got["k2"]) > 0,
                f"({name}) launches {got}, expected K1 {want_k1} (decode "
                f"RPCs {dec} x layers {layers}), K2 {want_k2} (prefill "
                f"RPCs {pre})")
    finally:
        rt.shutdown()
        for t in threads:
            t.join(timeout=60)
    require(not errors and not any(t.is_alive() for t in threads),
            f"({name}) thread workers: {errors}")
    toks = sum(len(r.output) for r in reqs)
    k1_note = ("none in dense decode" if args.dense else
               f"= decode RPCs {dec} x layers {layers}, none split")
    k2_note = (f"= prefill RPCs {pre} x layers, all tensor-core"
               if args.dense else "none: chunked paged prefill")
    print(f"  ({name}, workers on threads, together, depth 1, direct "
          f"links) {toks} tokens in {dt:.4f} s; K1 {got['k1']} {k1_note}; "
          f"K2 {got['k2']} {k2_note}")
    return got


def workers_phase(cfg, params, paged_tokens, dense_tokens, card):
    """Phase 13, runs (j)-(m): see the module note.  Returns the phase's
    launch counts."""
    args = serving_args(DEVICE)
    p5 = serve.make_plan(cfg, args)
    solo, s1 = solo_inprocess(cfg, params, p5, args, DEVICE)
    solo2, s2 = solo_inprocess(cfg, params, p5, serving_args(
        DEVICE, "--max-inflight", "2"), DEVICE)
    require(solo == solo2, "in-process one-at-a-time runs differ by depth")
    print(f"  in-process virtual clock, one request at a time: {s1:.2f} s "
          f"at depth 1, {s2:.2f} s at depth 2 (host clock); "
          f"{agreeing(solo, paged_tokens)} of {len(solo)} requests' bf16 "
          "tokens equal to phase 5's batched run")
    print(f"  params shipped at each init: "
          f"{param_bytes(params) / 1e9:.3f} GB ({cfg.param_dtype})")
    kept = None
    for direct in (False, True):
        with RpcLog() as log:
            rt, lines, secs, _ = worker_runs(
                cfg, params, p5, args, solo, paged_tokens, DEVICE,
                "j", direct=direct, keep=direct)
        kept = rt or kept
        inits = log.seconds("init")
        makes = [s for _, s in log.makes]
        print(f"  (j) paged over 2 workers, direct_links={direct}: spawn "
              f"{secs['spawn']:.2f} s (init RPCs "
              + ", ".join(f"{s:.2f}" for s in inits) + " s; engines made "
              "in " + ", ".join(f"{s:.2f}" for s in makes) + " s)")
        for line in lines:
            print(f"      {line}")
    try:
        t0 = time.perf_counter()
        line, summ = front_door_run(kept, cfg, args, solo, paged_tokens,
                                    "m workers")
        print(f"  (m) front door over (j)'s workers "
              f"({time.perf_counter() - t0:.2f} s): {line}")
        print(f"      wall clock TTFT p50/p95/p99 {fmt_ms(summ['ttft_s'])} "
              f"ms, TPOT {fmt_ms(summ['tpot_s'])} ms, E2E "
              f"{fmt_ms(summ['e2e_s'])} ms over {summ['requests']} "
              f"requests on {card}")
    finally:
        kept.shutdown()
    rt = ClusterRuntime(cfg, params, p5, serve.engine_config(args),
                        page_size=args.page_size, max_inflight=2,
                        realtime=True, device=DEVICE)
    t0 = time.perf_counter()
    line, summ = front_door_run(rt, cfg, args, solo, paged_tokens,
                                "m in-process")
    print(f"  (m) front door over the realtime in-process runtime "
          f"({time.perf_counter() - t0:.2f} s): {line}")
    print(f"      wall clock TTFT p50/p95/p99 {fmt_ms(summ['ttft_s'])} ms, "
          f"TPOT {fmt_ms(summ['tpot_s'])} ms, E2E {fmt_ms(summ['e2e_s'])} "
          f"ms over {summ['requests']} requests on {card}")

    dargs = serve.parse_args(DENSE_ARGV + ["--device", DEVICE])
    pd = serve.make_plan(cfg, dargs)
    dsolo, ds = solo_inprocess(cfg, params, pd, dargs, DEVICE)
    _, lines, secs, _ = worker_runs(cfg, params, pd, dargs, dsolo,
                                    dense_tokens, DEVICE, "k", direct=True)
    print(f"  (k) dense over 2 workers, direct links: spawn "
          f"{secs['spawn']:.2f} s; in-process one at a time ({ds:.2f} s "
          f"at depth 1): {agreeing(dsolo, dense_tokens)} of {len(dsolo)} "
          "equal to the dense phase's")
    for line in lines:
        print(f"      {line}")

    t0 = time.perf_counter()
    print(f"  (l) {kill_run(cfg, params, args, solo, DEVICE)} "
          f"({time.perf_counter() - t0:.2f} s)")

    return {"j paged over workers": counted_run(cfg, params, p5, args,
                                                DEVICE, "j"),
            "k dense over workers": counted_run(cfg, params, pd, dargs,
                                                DEVICE, "k")}


def workers_cross_check(cfg4, params4):
    """(j) and (l) in f32 at 4 layers over CUDA workers against the port's
    CPU in-process run: equal tokens."""
    cpu_params = map_tree(lambda t: t.cpu(), params4)
    args = serving_args(DEVICE)
    p = serve.make_plan(cfg4, args)
    ref, _ = solo_inprocess(cfg4, cpu_params, p, serving_args("cpu"),
                            "cpu")
    _, _, _, batch = worker_runs(cfg4, params4, p, args, ref, ref, DEVICE,
                                 "j f32", direct=True)
    require(all(t == ref for t in batch.values()),
            f"(j f32) batched tokens {batch} differ from the CPU run's "
            f"{ref}")
    print(f"  (j) over cuda workers, one at a time and together at depths "
          f"1 and 2: tokens equal to the CPU in-process run's {ref}")
    print(f"  (l) {kill_run(cfg4, params4, args, ref, DEVICE)}")


# kernel names as the profiler shows them
K_NAMES = {"K1": ("paged_attention_split_kernel",
                  "paged_attention_combine_kernel"),
           "K2": ("flash_attention_tc_kernel", "flash_attention_f32_kernel"),
           "K2-bwd": ("fa_bwd_delta_kernel", "fa_bwd_dkdv_tc_kernel",
                      "fa_bwd_dq_tc_kernel", "fa_bwd_dkdv_f32_kernel",
                      "fa_bwd_dq_f32_kernel")}


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


def _recorded_run(cfg, params, argv, dev, plan=None):
    """The cluster of ``argv`` (on ``plan`` when given) on ``dev``,
    last-stage logits recorded: returns (recorder, tokens, seconds)."""
    args = serve.parse_args(argv + ["--device", dev])
    with LastStageLogits() as rec:
        rt, reqs, _, dt = serve.run_cluster(cfg, args, params, plan=plan,
                                            verbose=False)
    rec.engines = {n: type(e).__name__ for n, e in rt.engines.items()}
    return rec, [r.output for r in reqs], dt


def _xcheck_runs(cfg, params, argv, plan=None):
    """The cluster of ``argv`` on cuda and the CPU, last-stage logits
    recorded: returns ((gpu recorder, gpu tokens), (cpu recorder, cpu
    tokens))."""
    runs = {}
    for name, dev, p in (("cuda", DEVICE, params),
                         ("cpu", "cpu", map_tree(lambda t: t.cpu(), params))):
        rec, toks, dt = _recorded_run(cfg, p, argv, dev, plan)
        runs[name] = (rec, toks)
        print(f"  {name}: tokens {toks} ({dt:.2f} s)")
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


def xcheck_depth(cfg32, params32):
    """The f32 model cut to ``DENSE_XCHECK_LAYERS`` layers at full
    width."""
    return (dataclasses.replace(cfg32, repeats=DENSE_XCHECK_LAYERS),
            dict(params32, super=map_tree(lambda t: t[:DENSE_XCHECK_LAYERS],
                                          params32["super"])))


def dense_cross_check(cfg32, params32):
    """Full width at 4 layers, f32: on the card the dense cluster, the
    paged cluster, ``Engine``, ``PagedEngine``, the paged and dense
    clusters speculating with a bad draft and the paged one with a perfect
    draft (its own weights) give the same greedy tokens; the
    dense cluster's first-prefill logits on the card are within 1e-3 of
    the port's CPU run."""
    cfg4, params4 = xcheck_depth(cfg32, params32)
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
# phase 15: the model families
# ---------------------------------------------------------------------------

# on init's weights the cuda-cpu logit gap of each family is held within
# this many times the gap between two cuda runs whose embeddings are one
# rounding apart, where that exceeds 1e-3 (chameleon at 2 layers read
# 3.07x on the H100; olmo and starcoder2 1.51x and 1.56x)
FAMILY_ROUNDING_FACTOR = 4


def family_argv(argv, arch):
    """A serving argv with ``arch`` as its model (argparse keeps the last
    ``--arch``)."""
    return argv + ["--arch", arch]


def family_config(arch, layers=None, dtype=None):
    """The registry's full config of ``arch``, cut to ``layers`` layers
    and in ``dtype`` when given."""
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, repeats=layers)
    if dtype:
        cfg = dataclasses.replace(cfg, param_dtype=dtype,
                                  compute_dtype=dtype)
    return cfg


def release_device_memory():
    """Collect the runtimes of earlier runs (reference cycles keep their
    engines, and the weights those view, alive) and return the freed
    blocks to the card."""
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


def family_params(cfg, seed):
    """Random weights of ``cfg`` from a generator on the device (drawing
    billions of values on the host would take minutes)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return init(cfg, gen, device=DEVICE)


def families_phase(seed, card):
    """Each family at full width in bf16 (chameleon cut in depth):
    phase 5's paged cluster and the dense one, with their checks and
    launch counts (K1 == decode passes x paged layers, none split, K2
    none; K2 == layers x request prefills, all tensor-core, K1 none), the
    last stage holding ``lm_head`` when untied; tokens/s on the host
    clock and peak device memory.  Returns the counts and rates."""
    out = {}
    for arch, layers in FAMILIES.items():
        cfg = family_config(arch, layers)
        full = get_config(arch).num_layers
        print(f"\n  {cfg.name}: {cfg.num_layers}L"
              f"{'' if cfg.num_layers == full else f' (cut from {full})'} "
              f"d={cfg.d_model} H={cfg.num_heads}/KH={cfg.num_kv_heads} "
              f"D={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
              f"vocab={cfg.vocab_size} norm={cfg.norm} ffn={cfg.mlp_kind} "
              f"tied={cfg.tie_embeddings} {cfg.param_dtype}", flush=True)
        release_device_memory()
        reset_peak()
        resident = (torch.cuda.memory_allocated() / 2 ** 30
                    if DEVICE == "cuda" else 0.0)
        t0 = time.perf_counter()
        params = family_params(cfg, seed)
        sync()
        print(f"  {param_bytes(params) / 1e9:.2f} GB of weights drawn on "
              f"the card in {time.perf_counter() - t0:.2f} s")
        (k1n, _), tok_s, _, _, _ = serving_phase(
            cfg, params, family_argv(SERVE_ARGV, arch))
        (k2n, _), dense_tok_s, _, _ = dense_serving_phase(
            cfg, params, card, family_argv(DENSE_ARGV, arch))
        peak = peak_gib()
        print(f"  {cfg.name}: paged {tok_s:.2f} tokens/s, dense "
              f"{dense_tok_s:.2f} tokens/s (host clock) on {card}; peak "
              f"device memory {peak:.2f} GiB ({resident:.2f} GiB resident "
              "before its weights were drawn)", flush=True)
        out[arch] = dict(layers=cfg.num_layers, k1=k1n, k2=k2n,
                         paged_tokens_per_s=tok_s,
                         dense_tokens_per_s=dense_tok_s, peak_gib=peak,
                         resident_gib=resident)
        del params
    release_device_memory()
    return out


def fan_in_scaled(params):
    """``params`` with every stacked block matrix rescaled from the std
    ``init`` gives it, 1/sqrt(depth) (the reference's rule takes a leaf's
    first axis as its fan-in, and a stacked leaf's first axis is the
    depth), to 1/sqrt(its own fan-in): H x D for the attention output
    projection, its second axis for every other matrix."""
    def scale(name, t):
        if t.dim() < 3:
            return t
        fan = t.shape[1] * t.shape[2] if name == "o" else t.shape[1]
        return t * math.sqrt(t.shape[0] / fan)
    return dict(params, super={
        pos: {part: {n: scale(n, t) for n, t in leaves.items()}
              for part, leaves in block.items()}
        for pos, block in params["super"].items()})


def _max_gap(a, b):
    """The largest |a - b| over each request's first-prefill and
    first-decode last-stage logits of two recorded runs."""
    return max(max(float(np.abs(a.prefill[r] - b.prefill[r]).max()),
                   float(np.abs(a.decode[r][min(b.decode[r])] -
                                b.decode[r][min(b.decode[r])]).max()))
               for r in b.prefill)


def families_cross_check(seed):
    """Each family in f32 at full width and FAMILY_XCHECK_LAYERS layers,
    the paged cluster on cuda and on the CPU (plain versions) on the same
    weights.  On ``init``'s weights: greedy tokens equal, and the first-
    prefill and first-decode logit gap within the larger of 1e-3 and
    FAMILY_ROUNDING_FACTOR x the model's own f32 sensitivity, the gap
    between two cuda runs whose embeddings are one rounding apart.  init
    draws a stacked matrix at std 1/sqrt(depth), so at d = 8192 and 2
    layers each projection amplifies its input ~64-fold and fp32 rounding
    alone moves the logits by ~1e-3.  On ``fan_in_scaled`` weights: the
    logits within atol=rtol=1e-3 and greedy tokens equal."""
    for arch in FAMILIES:
        family_cross_check(family_config(arch, FAMILY_XCHECK_LAYERS,
                                         "float32"),
                           family_argv(XCHECK_ARGV, arch), seed)


def family_cross_check(cfg, argv, seed, plan=None):
    """``families_cross_check``'s two gates for one f32 config, served by
    the cluster of ``argv`` (on ``plan`` when given) on cuda and on the
    CPU.  Returns the gaps and limits, and each node's engine class."""
    print(f"  {cfg.name}: {cfg.num_layers}L d={cfg.d_model} float32, "
          "init's weights")
    params = family_params(cfg, seed)
    (g, g_tok), (c, c_tok) = _xcheck_runs(cfg, params, argv, plan)
    require(g.engines == c.engines, f"{cfg.name}: engines on cuda "
                                    f"{g.engines}, on the CPU {c.engines}")
    require(g_tok == c_tok, f"{cfg.name}: greedy tokens differ on "
                            f"init's weights: cuda {g_tok} cpu {c_tok}")
    sign = torch.randint(0, 2, params["embed"].shape, device=DEVICE,
                         generator=torch.Generator(
                             device=DEVICE).manual_seed(seed + 1))
    apart = dict(params, embed=params["embed"] *
                 (1 + (2 * sign - 1) * 2.0 ** -24))
    rec = _recorded_run(cfg, apart, argv, DEVICE, plan)[0]
    gap, rounding = _max_gap(g, c), _max_gap(rec, g)
    limit = max(XCHECK_TOL["atol"], FAMILY_ROUNDING_FACTOR * rounding)
    print(f"  {cfg.name}, init's weights: greedy tokens equal; "
          f"max|cuda-cpu| = {gap:.3e} against {rounding:.3e} between "
          "two cuda runs whose embeddings are one rounding apart; "
          f"limit {limit:.3e}")
    require(gap <= limit, f"{cfg.name}: logits on init's weights "
                          f"differ by {gap:.3e} > {limit:.3e}")
    print(f"  {cfg.name}: fan-in-scaled weights")
    (g, g_tok), (c, c_tok) = _xcheck_runs(cfg, fan_in_scaled(params),
                                          argv, plan)
    worst = _compare_logits(g, c, "decode")
    require(g_tok == c_tok, f"{cfg.name}: greedy tokens differ: "
                            f"cuda {g_tok} cpu {c_tok}")
    print(f"  {cfg.name}, fan-in-scaled weights: greedy tokens equal; "
          f"worst logit gap {worst:.3e}")
    del params, apart
    release_device_memory()
    return dict(init_gap=gap, init_limit=limit, scaled_gap=worst,
                engines=g.engines)


# ---------------------------------------------------------------------------
# phase 16: gemma3-12b whole
# ---------------------------------------------------------------------------

# the dense cluster (the MILP's 2-stage plan on A100,L4) and Engine: prompts
# across the local layers' window of 1024, decode past their rings' ends
GEMMA3_ARGV = ["--arch", GEMMA3, "--cluster", "A100,L4", "--stages", "2",
               "--dense", "--batch", "4", "--prompt",
               ",".join(map(str, GEMMA3_PROMPTS)), "--new-tokens", "16",
               "--max-len", "2128"]
GEMMA3_ENGINE_ARGV = ["--arch", GEMMA3, "--batch", "4", "--prompt",
                      ",".join(map(str, GEMMA3_PROMPTS)), "--new-tokens",
                      "16", "--max-len", "2128"]
# the f32 cross-check: one super-block (5 local layers, 1 global) at full
# width, one 1100-token prompt, on the dense cluster
GEMMA3_XCHECK_ARGV = ["--arch", GEMMA3, "--cluster", "A100,L4", "--stages",
                      "2", "--dense", "--batch", "1", "--prompt", "1100",
                      "--new-tokens", "4", "--max-len", "1112"]


def windowed_layers(cfg):
    return sum(b.attn in ("local", "swa") for b in cfg.blocks)


def check_gemma3_launches(cfg, prefills, what, k1_want=0):
    """K2 launches == layers x prefills, all on the tensor cores, the
    local layers' share with a window; K1 == ``k1_want``."""
    want, want_w = cfg.num_layers * prefills, windowed_layers(cfg) * prefills
    require(k2.launches == want and k2.tc_launches == want and
            k2.window_launches == want_w and k1.launches == k1_want,
            f"{what}: K2 {k2.launches} ({k2.tc_launches} tensor-core, "
            f"{k2.window_launches} windowed), K1 {k1.launches}; expected "
            f"{want} ({want_w} windowed) and {k1_want}")
    return dict(k2=k2.launches, k2_tc=k2.tc_launches,
                k2_window=k2.window_launches, k1=k1.launches,
                k1_split=k1.split_launches)


def gemma3_phase(seed, card):
    """gemma3-12b whole in bf16 (48 layers, d=3840, 16/8 heads, D=256):
    ``launch/serve.py --dense``'s cluster (phase 5's dense checks) and
    ``Engine``, each with exact launch counts (K2 == 48 x 4 prefills, all
    tensor-core, 40 x 4 windowed; K1 none), tokens/s, peak memory and
    wall time.  Returns the counts, rates and the cluster's tokens."""
    t_phase = time.perf_counter()
    cfg = family_config(GEMMA3)
    print(f"  {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"H={cfg.num_heads}/KH={cfg.num_kv_heads} "
          f"D={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size}, {windowed_layers(cfg)} layers of window "
          f"{max(b.window for b in cfg.blocks)}, {cfg.param_dtype}",
          flush=True)
    release_device_memory()
    reset_peak()
    t0 = time.perf_counter()
    params = family_params(cfg, seed)
    sync()
    print(f"  {param_bytes(params) / 1e9:.2f} GB of weights drawn on the "
          f"card in {time.perf_counter() - t0:.2f} s")
    (k2n, _), tok_s, dt, tokens = dense_serving_phase(cfg, params, card,
                                                      GEMMA3_ARGV)
    n_req = len(GEMMA3_PROMPTS)
    cluster = check_gemma3_launches(cfg, n_req, "dense cluster")
    cluster_peak = peak_gib()
    print(f"  dense cluster: K2 launches {k2n} = {cfg.num_layers} layers x "
          f"{n_req} prefills, all tensor-core, "
          f"{cluster['k2_window']} with window 1024; K1 0; {tok_s:.2f} "
          f"tokens/s in {dt:.3f} s; peak device memory {cluster_peak:.2f} "
          "GiB", flush=True)

    args = serve.parse_args(GEMMA3_ENGINE_ARGV + ["--device", DEVICE])
    _run_engine(cfg, params, serve.parse_args(
        GEMMA3_ENGINE_ARGV + ["--device", DEVICE, "--new-tokens", "2"]))
    release_device_memory()
    reset_peak()
    zero_counts()
    eng, reqs, edt = _run_engine(cfg, params, args)
    check_requests(cfg, reqs, args.new_tokens)
    require(not eng.active.any(), "Engine: slots still active")
    engine = check_gemma3_launches(cfg, n_req, "Engine")
    engine_peak = peak_gib()
    etoks = sum(len(r.output) for r in reqs)
    agree = sum(a == b for r, t in zip(reqs, tokens)
                for a, b in zip(r.output, t))
    print(f"  Engine: {len(reqs)} requests, {etoks} tokens in {edt:.3f} s = "
          f"{etoks / edt:.2f} tokens/s; K2 launches {engine['k2']} = "
          f"{cfg.num_layers} x {eng.prefills} prefills, all tensor-core, "
          f"{engine['k2_window']} windowed; K1 0; peak device memory "
          f"{engine_peak:.2f} GiB; tokens agreeing with the dense cluster's "
          f"(bf16, other batch shapes): {agree} of {etoks}", flush=True)
    del params, eng
    release_device_memory()
    wall = time.perf_counter() - t_phase
    print(f"  phase 16 (bf16 runs) wall time {wall:.2f} s", flush=True)
    return dict(layers=cfg.num_layers, cluster=cluster, engine=engine,
                dense_tokens_per_s=tok_s, dense_s=dt,
                engine_tokens_per_s=etoks / edt, engine_s=edt,
                cluster_peak_gib=cluster_peak, engine_peak_gib=engine_peak,
                engine_agree=agree, engine_tokens=etoks, wall_s=wall,
                tokens=tokens)


def gemma3_cross_check(seed):
    """One super-block of gemma3-12b (``repeats=1``: 5 local layers and 1
    global) at full width in f32, the dense cluster on cuda and on the
    CPU on an 1100-token prompt, under phase 15's two gates."""
    return family_cross_check(family_config(GEMMA3, 1, "float32"),
                              GEMMA3_XCHECK_ARGV, seed)


# ---------------------------------------------------------------------------
# phase 18: gemma3-12b whole on the paged paths
# ---------------------------------------------------------------------------

# phase 16's runs without --dense: the paged cluster (serve.py --cluster
# A100,L4 --stages 2) and PagedEngine (serve.py --paged)
GEMMA3_PAGED_ARGV = [a for a in GEMMA3_ARGV if a != "--dense"]
GEMMA3_PAGED_ENGINE_ARGV = GEMMA3_ENGINE_ARGV + ["--paged"]
# the f32 cross-check: one super-block on a plan whose first node holds
# only local layers (a dense StageEngine) and whose second holds the
# global one (a PagedStageEngine)
GEMMA3_PAGED_XCHECK_ARGV = [a for a in GEMMA3_XCHECK_ARGV if a != "--dense"]
GEMMA3_PAGED_XCHECK_LAYOUT = {"n0": (0, 3), "n1": (3, 6)}


def gemma3_paged_phase(seed, card, dense_tokens):
    """gemma3-12b whole in bf16 (weights drawn once) on the paged paths:
    ``launch/serve.py --cluster A100,L4 --stages 2`` (every node a
    ``PagedStageEngine``: global layers in the pool, ring caches for the
    local ones) and ``serve.py --paged`` (``PagedEngine``), phase 16's
    prompts.  Prefill is single-shot: K2 == 48 x 4 prefills, all
    tensor-core, 160 windowed; K1 == decode passes x paged layers on the
    cluster and decode steps x 8 in ``PagedEngine``; pools drained.
    Prints tokens/s, peak memory, wall time and the tokens that agree
    with phase 16's dense cluster's (bf16: not gated).  Returns the counts
    and rates."""
    t_phase = time.perf_counter()
    cfg = family_config(GEMMA3)
    n_req = len(GEMMA3_PROMPTS)
    n_paged = num_paged_layers(cfg)
    release_device_memory()
    reset_peak()
    params = family_params(cfg, seed)
    sync()
    print(f"  {cfg.name}: {cfg.num_layers}L, {n_paged} global layers paged, "
          f"{windowed_layers(cfg)} local layers on ring caches; "
          f"{param_bytes(params) / 1e9:.2f} GB of bf16 weights", flush=True)

    def agreeing_tokens(reqs):
        return sum(a == b for r, t in zip(reqs, dense_tokens)
                   for a, b in zip(r.output, t))

    args = serve.parse_args(GEMMA3_PAGED_ARGV + ["--device", DEVICE])
    serve.run_cluster(cfg, serve.parse_args(
        GEMMA3_PAGED_ARGV + ["--device", DEVICE, "--new-tokens", "2"]),
        params, verbose=False)                              # CUDA warm-up
    zero_counts()
    with LastStageLogits() as rec:
        rt, reqs, p, dt = serve.run_cluster(cfg, args, params)
    check_requests(cfg, reqs, args.new_tokens, rt.served, rec)
    check_head(cfg, rt)
    engines = list(rt.engines.values())
    require(all(isinstance(e, PagedStageEngine) for e in engines),
            f"paged cluster engines: "
            f"{ {n: type(e).__name__ for n, e in rt.engines.items()} }")
    used = rt.pool_pages_used()
    require(all(u == 0 for u in used.values()), f"pages leaked: {used}")
    prefills = n_req + sum(r.preemptions for r in reqs)
    require(sum(e.prefills * e.layers.num_layers for e in engines)
            == cfg.num_layers * prefills,
            f"stage prefills {[e.prefills for e in engines]} for "
            f"{prefills} request prefills")
    cluster = check_gemma3_launches(cfg, prefills, "paged cluster",
                                    k1_expected(engines))
    cluster_peak = peak_gib()
    cluster_agree = agreeing_tokens(reqs)
    toks = sum(len(r.output) for r in reqs)
    # seconds inside decode passes (the card synchronised around each);
    # the rest of the run is the single-shot prefills and the host's loop
    decode_s = dict(rt.node_decode_s)
    print(f"  paged cluster: placement " + ", ".join(
        f"{n}=[{r.start},{r.end})"
        for n, r in sorted(p.placement.assignment.items()))
        + f"; pools {({n: e.pool.num_pages for n, e in rt.engines.items()})}"
        f" pages; K2 launches {cluster['k2']} = {cfg.num_layers} layers x "
        f"{prefills} single-shot prefills, all tensor-core, "
        f"{cluster['k2_window']} windowed; K1 launches {cluster['k1']} = "
        f"decode passes {({n: e.decode_steps for n, e in rt.engines.items()})}"
        f" x paged layers {({n: e.n_paged for n, e in rt.engines.items()})}, "
        f"{cluster['k1_split']} split; {toks / dt:.2f} tokens/s in "
        f"{dt:.3f} s on {card}, of which decode passes "
        f"{({n: round(v, 4) for n, v in decode_s.items()})} s; peak device "
        f"memory {cluster_peak:.2f} GiB; tokens agreeing with phase 16's "
        f"dense cluster's (bf16): {cluster_agree} of {toks}", flush=True)
    del rt, engines
    release_device_memory()

    pargs = serve.parse_args(GEMMA3_PAGED_ENGINE_ARGV + ["--device", DEVICE])
    serve.run_paged(cfg, serve.parse_args(
        GEMMA3_PAGED_ENGINE_ARGV + ["--device", DEVICE, "--new-tokens", "2"]),
        params, verbose=False)                              # CUDA warm-up
    release_device_memory()
    reset_peak()
    zero_counts()
    eng, preqs, pdt = serve.run_paged(cfg, pargs, params, verbose=False)
    check_requests(cfg, preqs, pargs.new_tokens)
    require(eng.pool.used == 0 and not eng.active.any(),
            f"PagedEngine: {eng.pool.used} pages held")
    engine = check_gemma3_launches(cfg, eng.prefills, "PagedEngine",
                                   eng.decode_steps * n_paged)
    engine_peak = peak_gib()
    engine_agree = agreeing_tokens(preqs)
    ptoks = sum(len(r.output) for r in preqs)
    print(f"  PagedEngine: pool {eng.pool.num_pages} pages; K2 launches "
          f"{engine['k2']} = {cfg.num_layers} x {eng.prefills} prefills, all "
          f"tensor-core, {engine['k2_window']} windowed; K1 launches "
          f"{engine['k1']} = {eng.decode_steps} decode steps x {n_paged}, "
          f"{engine['k1_split']} split; {ptoks / pdt:.2f} tokens/s in "
          f"{pdt:.3f} s; peak device memory {engine_peak:.2f} GiB; tokens "
          f"agreeing with phase 16's dense cluster's (bf16): {engine_agree} "
          f"of {ptoks}", flush=True)
    del params, eng
    release_device_memory()
    wall = time.perf_counter() - t_phase
    print(f"  phase 18 (bf16 runs) wall time {wall:.2f} s", flush=True)
    return dict(cluster=cluster, engine=engine,
                cluster_tokens_per_s=toks / dt, cluster_s=dt,
                cluster_decode_s=decode_s,
                engine_tokens_per_s=ptoks / pdt, engine_s=pdt,
                cluster_peak_gib=cluster_peak, engine_peak_gib=engine_peak,
                cluster_agree=cluster_agree, engine_agree=engine_agree,
                tokens=toks, wall_s=wall)


def gemma3_paged_cross_check(seed):
    """One super-block of gemma3-12b at full width in f32 on the paged
    cluster of a forced plan: n0 = [0, 3) holds only local layers (a dense
    ``StageEngine``), n1 = [3, 6) the global one (a ``PagedStageEngine``);
    cuda and the CPU on an 1100-token prompt under phase 15's two
    gates."""
    cfg = family_config(GEMMA3, 1, "float32")
    out = family_cross_check(cfg, GEMMA3_PAGED_XCHECK_ARGV, seed,
                             plan=mesh_plan(cfg, GEMMA3_PAGED_XCHECK_LAYOUT))
    want = {"n0": "StageEngine", "n1": "PagedStageEngine"}
    require(out["engines"] == want, f"engines {out['engines']}, not {want}")
    print(f"  engines {out['engines']}")
    return out


# ---------------------------------------------------------------------------
# phase 17: gemma3-12b training at full width
# ---------------------------------------------------------------------------

# one batch of B x S from make_batch: S past the local layers' window of
# 1024, so their masks cut keys
GEMMA3_TRAIN_BATCH, GEMMA3_TRAIN_SEQ = 2, 2048
# whole super-blocks (5 local layers and 1 global) phase 17 trains: the
# device-memory reckoning in PERF.md section 4 chose one (two would hold
# ~81 GB in AdamW's update alone, its old and new params and moments)
GEMMA3_TRAIN_REPEATS = 1
# AdamW steps at TRAIN_OPT on the fan-in-scaled weights: its lr of 3e-3
# moves a matrix of d = 3840 (std 0.016) by ~20% a step, and the loss
# spikes after the warm-up before it falls; it ends just above half its
# first value, which is printed beside it and not gated: a halving decides
# little about the backward (a partly wrong one trains as well)
GEMMA3_TRAIN_STEPS = 30
GEMMA3_REMAT_STEPS = 3
# the f32 cross-check of the loss and every gradient: one super-block, one
# sequence of this many tokens
GEMMA3_XCHECK_SEQ = 1100


def gemma3_training_phase(seed, card):
    """Phase 17: gemma3-12b at full width and GEMMA3_TRAIN_REPEATS
    super-blocks in bf16 through ``make_train_step`` on one batch from
    ``make_batch``, on the ``fan_in_scaled`` copy of ``init``'s weights
    (at one super-block init draws every block matrix at std 1/sqrt(1):
    62x its fan-in's scale at d = 3840): AdamW (TRAIN_OPT)
    GEMMA3_TRAIN_STEPS steps, the loss below its first value, every step's
    launches exact (``train_run``: K2 and its backward in every layer, the
    local layers' share windowed, K1 none); one step profiled; the first
    step's gradients through K2's backward against its plain version
    (``gemma3_plain_backward_check``); remat none and full over
    GEMMA3_REMAT_STEPS steps, losses and params bit-equal.  Returns the
    counts and rates."""
    t_phase = time.perf_counter()
    cfg = family_config(GEMMA3, GEMMA3_TRAIN_REPEATS)
    B, S = GEMMA3_TRAIN_BATCH, GEMMA3_TRAIN_SEQ
    print(f"  {cfg.name}: {cfg.num_layers} of {get_config(GEMMA3).num_layers}"
          f" layers ({GEMMA3_TRAIN_REPEATS} super-block, "
          f"{windowed_layers(cfg)} of window "
          f"{max(b.window for b in cfg.blocks)}) at d={cfg.d_model}, "
          f"H={cfg.num_heads}/KH={cfg.num_kv_heads} "
          f"D={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size}, {cfg.param_dtype}; batch {B} x {S}",
          flush=True)
    release_device_memory()
    reset_peak()
    params = family_params(cfg, seed)
    sync()
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"  {n_params / 1e9:.3f} B params, {param_bytes(params) / 1e9:.2f} "
          "GB drawn on the card")
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, batch_size=B,
                                  seq_len=S), 0, device=DEVICE)
    adamw = OptimizerConfig(name="adamw", **TRAIN_OPT)
    train = TrainConfig(optimizer=adamw, remat="none")
    params = fan_in_scaled(params)
    reset_peak()
    zero_counts()
    _, losses, times = train_run(cfg, params, train, batch,
                                 GEMMA3_TRAIN_STEPS, "gemma3 AdamW")
    launches = counts()
    peak = peak_gib()
    ms = float(np.median(times[1:]))
    tokens = B * S
    halved = losses[-1] < losses[0] / 2
    print(f"  AdamW on fan-in-scaled weights, remat none, "
          f"{GEMMA3_TRAIN_STEPS} steps: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (half the first {losses[0] / 2:.4f}: "
          f"{'reached' if halved else 'not reached'}; printed, not gated); "
          f"step {ms:.1f} ms median = {tokens / ms * 1e3:.0f} training "
          f"tokens/s on {card}; peak device memory {peak:.2f} GiB; launches "
          f"{launches}", flush=True)
    print(f"  losses {[round(x, 4) for x in losses]}")
    require(losses[-1] < losses[0], f"gemma3: the loss {losses[-1]} is "
            f"not below its first value {losses[0]}")
    prof = train_profile(cfg, params, train, batch, ms)
    plain = gemma3_plain_backward_check(cfg, params, batch, seed)

    series, ends = {}, {}
    for remat in ("none", "full"):
        p, series[remat], _ = train_run(
            cfg, params, TrainConfig(optimizer=adamw, remat=remat), batch,
            GEMMA3_REMAT_STEPS, f"gemma3 remat {remat}")
        ends[remat] = map_tree(lambda x: x.cpu(), p)   # off the card
        del p
    same = all(map(torch.equal, tree_leaves(ends["none"]),
                   tree_leaves(ends["full"])))
    print(f"  remat none / full, {GEMMA3_REMAT_STEPS} steps: losses "
          f"{series['none']} / {series['full']}, final params bit-equal: "
          f"{same}")
    require(series["full"] == series["none"] and same,
            f"gemma3: remat full's losses {series['full']} or params differ "
            f"from none's {series['none']}")
    del params, ends
    release_device_memory()
    wall = time.perf_counter() - t_phase
    print(f"  phase 17 (bf16 runs) wall time {wall:.2f} s", flush=True)
    return dict(layers=cfg.num_layers, params=n_params, launches=launches,
                loss_first=losses[0], loss_last=losses[-1],
                loss_halved=halved, plain_backward=plain, step_ms=ms,
                tokens_s=tokens / ms * 1e3, peak_gib=peak, profile=prof,
                wall_s=wall)


def _loss_and_grads(cfg, params, batch, host=True):
    """The loss and every gradient of ``loss_fn`` (remat none) on the
    params' device, in ``tree_leaves`` order; host tensors unless
    ``host`` is false."""
    live = map_tree(lambda x: x.detach().requires_grad_(True), params)
    loss, _ = loss_fn(cfg, live, batch)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    move = (lambda t: t.cpu()) if host else (lambda t: t)
    return [move(loss.detach())] + [move(g) for g in grads]


def _grad_gap(a, b):
    """The largest |a - b| of the loss and every gradient leaf, each over
    the largest |b| of its leaf: one scale-free number for tensors whose
    magnitudes differ by orders."""
    return max((x - y).abs().max().item() / max(y.abs().max().item(), 1e-30)
               for x, y in zip(a, b))


# phase 17's gate on K2's backward in the model: the first step's gradients
# through the kernels within this many times the gap that one bf16
# rounding of the plain backward's dq, dk and dv makes in them
PLAIN_BWD_FACTOR = 4


@contextlib.contextmanager
def plain_k2_backward(apart=None):
    """The autograd function's backward (``k2_ops``) through K2's plain
    backward on the card, each row's log-sum-exp recomputed from its own
    scores; with ``apart`` (a seeded generator) every element of its bf16
    dq, dk and dv is moved one rounding: x (1 +- 2**-8), the sign drawn
    from ``apart``, then rounded to bf16."""
    def plain(q, k, v, o, do, *, causal, window, out, lse):
        grads = flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                        window=window)
        for dst, g in zip(out, grads):
            if apart is not None:
                sign = torch.randint(0, 2, g.shape, device=g.device,
                                     generator=apart)
                g = g.float() * (1 + (2 * sign - 1) * 2.0 ** -8)
            dst.copy_(g)
    saved = k2_ops.flash_attention_bwd
    k2_ops.flash_attention_bwd = plain
    try:
        yield
    finally:
        k2_ops.flash_attention_bwd = saved


def _rel_gaps(a, b):
    """||a - b|| / ||b|| of each gradient leaf, in fp32."""
    return [torch.linalg.vector_norm(x.float() - y.float()).item()
            / max(torch.linalg.vector_norm(y, dtype=torch.float32).item(),
                  1e-30) for x, y in zip(a, b)]


def gemma3_plain_backward_check(cfg, params, batch, seed):
    """Phase 17's first step, bf16, on its batch and weights: every
    gradient through K2's backward (exactly its launches) against the same
    with the plain backward on the card (no launch), each leaf's gap in
    norm over the plain gradient's norm; the largest within
    PLAIN_BWD_FACTOR x the largest between the plain run and one whose
    attention gradients are one bf16 rounding apart.  A wrong backward
    (a mask, a head's share, a block of D = 256's columns) would move
    dq, dk and dv, and every gradient upstream, by far more than a
    rounding.  Returns the gaps and the limit."""
    t0 = time.perf_counter()
    before = counts()
    kern = _loss_and_grads(cfg, params, batch, host=False)[1:]
    mid = counts()
    with plain_k2_backward():
        plain = _loss_and_grads(cfg, params, batch, host=False)[1:]
    with plain_k2_backward(torch.Generator(device=DEVICE)
                           .manual_seed(seed + 2)):
        apart = _loss_and_grads(cfg, params, batch, host=False)[1:]
    after = counts()
    want = cfg.num_layers * k2.BWD_KERNELS
    require(mid["k2_bwd"] - before["k2_bwd"] == want
            and after["k2_bwd"] == mid["k2_bwd"],
            f"gemma3 plain-backward check: K2-bwd launches {before} -> "
            f"{mid} -> {after}, not {want} through the kernels and none "
            "through the plain version")
    gaps, rounding = _rel_gaps(kern, plain), _rel_gaps(apart, plain)
    del kern, plain, apart
    release_device_memory()
    gap, ref = max(gaps), max(rounding)
    limit = PLAIN_BWD_FACTOR * ref
    worst = max(g / max(r, 1e-30) for g, r in zip(gaps, rounding))
    print(f"  first step's {len(gaps)} gradients through K2's backward vs "
          f"its plain version on the card: largest ||kernel - plain|| / "
          f"||plain|| {gap:.3e} against {ref:.3e} with the plain dq, dk, "
          f"dv one bf16 rounding apart; limit {limit:.3e}; largest ratio "
          f"of a leaf {worst:.3f} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    require(gap <= limit, f"gemma3: gradients through K2's backward differ "
                          f"from the plain backward's by {gap:.3e} > "
                          f"{limit:.3e}")
    return dict(gap=gap, rounding=ref, limit=limit, worst_leaf_ratio=worst)


def gemma3_training_cross_check(seed):
    """Phase 17's f32 check: one super-block of gemma3-12b at full width in
    f32, the loss and every gradient on one B=1 x GEMMA3_XCHECK_SEQ batch
    on cuda (K2 and its backward) and on the CPU (plain versions), same
    fan-in-scaled weights, within 1e-3 of ``_grad_gap``.  (On ``init``'s
    weights one rounding of the embeddings moves the port's own cuda
    gradients by ~1 of a leaf's largest value, so phase 15's rounding
    gate there could not fail: it is not run.)  No optimizer step: AdamW's
    moments would double the CPU's 18.8 GB of params and gradients."""
    cfg = family_config(GEMMA3, 1, "float32")
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, batch_size=1,
                                  seq_len=GEMMA3_XCHECK_SEQ), 0, device="cpu")
    on = {dev: {k: v.to(dev) for k, v in batch.items()}
          for dev in (DEVICE, "cpu")}
    params = family_params(cfg, seed)
    print(f"  {cfg.name}: {cfg.num_layers}L d={cfg.d_model} float32, "
          f"{sum(x.numel() for x in tree_leaves(params)) / 1e9:.3f} B "
          f"params; B=1 S={GEMMA3_XCHECK_SEQ}")
    p = fan_in_scaled(params)
    t0 = time.perf_counter()
    g = _loss_and_grads(cfg, p, on[DEVICE])
    t1 = time.perf_counter()
    c = _loss_and_grads(cfg, map_tree(lambda x: x.cpu(), p), on["cpu"])
    t2 = time.perf_counter()
    gap, limit = _grad_gap(g, c), XCHECK_TOL["atol"]
    print(f"  fan-in-scaled weights: loss cuda {g[0].item():.6f} cpu "
          f"{c[0].item():.6f}; max over the loss and {len(g) - 1} "
          f"gradients of max|cuda-cpu| / max|cpu| = {gap:.3e}; limit "
          f"{limit:.3e} (cuda {t1 - t0:.1f} s, cpu {t2 - t1:.1f} s)",
          flush=True)
    require(gap <= limit, f"gemma3 f32 gradients on fan-in-scaled weights "
                          f"differ by {gap:.3e} > {limit:.3e}")
    del p, g, c, params
    release_device_memory()
    return {"fan-in-scaled": dict(gap=gap, limit=limit)}


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
    """The three kernel sources' nvcc builds (K1, K2 and K2's backward),
    started together.  Prints each instance's registers, shared memory and
    spills (-Xptxas -v) and any ptxas warning; an instance that spills
    fails the run."""
    t0 = time.perf_counter()
    builds = (k1.build, k2.build, k2.build_bwd)
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        libs = list(pool.map(lambda b: b(), builds))
    print(f"  built {', '.join(os.path.relpath(l, ROOT) for l in libs)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for label, log in (("paged_attention.cu", k1.build_log),
                       ("flash_attention.cu", k2.build_log),
                       ("flash_attention_bwd.cu", k2.bwd_build_log)):
        if not log:
            print(f"  {label}: library built before this run, no ptxas "
                  "report")
            continue
        for line in log.splitlines():
            if "warning" in line.lower():
                print("  " + line.strip())
        for e in ptxas_report(log):
            dyn = ""
            fwd = re.match(r"flash_attention_(\w+)_kernel<(\d+)>", e["name"])
            if fwd:
                kind, D = fwd.groups()
                dyn = f", {k2.smem_bytes(kind == 'tc', int(D))} B dynamic smem"
            bwd = re.match(r"fa_bwd_(\w+)_kernel<(?:\d,)?(\d+)>",
                           e["name"])
            if bwd:
                kind, D = bwd.groups()
                dyn = f", {k2.bwd_smem_bytes(kind, int(D))} B dynamic smem"
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
        if label == "flash_attention.cu":
            names = {e["name"] for e in ptxas_report(log)}
            for kind in ("f32", "tc"):
                require(f"flash_attention_{kind}_kernel<256>" in names,
                        f"flash_attention.cu built no D=256 {kind} instance")


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
    # The CPU runs of the cross-checks flush denormals to 0 (set before
    # the first parallel op, so that every thread of the CPU's pool
    # inherits it): on init's weights of full-width gemma3 the FFN's and
    # attention's exponentials underflow into denormals, and the CPU's
    # f32 products slowed ~12x on them; values below 1.2e-38 move no gate.
    torch.set_flush_denormal(True)

    phase("build")
    build_all()

    phase("kernel K1: paged_attention vs plain")
    k1_err, k1_worst = kernel_checks()

    phase("kernel K2: flash_attention vs plain")
    k2_err, k2_worst, k2_d256_cases = k2_checks()
    k2_lse_err = k2_lse_checks()

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

    phase("serving: cancellation and live autoscaling")
    t0 = time.perf_counter()
    cancel_as = cancel_autoscale_phase(cfg, params, paged_tokens, card)
    print(f"  phase 12 took {time.perf_counter() - t0:.2f} s")

    phase("serving: stage workers, wall clock and front door")
    t0 = time.perf_counter()
    workers = workers_phase(cfg, params, paged_tokens, dense_tokens, card)
    print(f"  phase 13 took {time.perf_counter() - t0:.2f} s")

    phase("engines: Engine and PagedEngine")
    engine_k2, engine_k1 = engines_phase(cfg, params)

    phase("profile: where the serving time goes")
    profile_phase(cfg, params, {"paged cluster": paged_s,
                                "dense cluster": dense_s})
    del params

    phase("kernel timings")
    t1 = kernel_timings(pool_pages)
    t2 = k2_timings()

    phase("training: K2's backward vs plain")
    t0 = time.perf_counter()
    kb_err, kb_worst, kb_d256_count = kb_checks()
    tb = kb_timings()

    phase("training: full-width smollm-360m in bf16")
    train = training_phase(cfg, args.seed, card)
    print(f"  phase 14 (n)-(o) took {time.perf_counter() - t0:.2f} s")

    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    params32 = init(cfg32, args.seed, device=DEVICE)
    phase("cross-check f32: paged cluster cuda vs cpu")
    cross_check(cfg32, params32)

    phase(f"cross-check f32, {DENSE_XCHECK_LAYERS} layers: four serving "
          "paths")
    dense_cross_check(cfg32, params32)

    phase(f"cross-check f32, {DENSE_XCHECK_LAYERS} layers: cancellation and "
          "autoscaling, cuda vs cpu")
    cancel_autoscale_cross_check(*xcheck_depth(cfg32, params32))

    phase(f"cross-check f32, {DENSE_XCHECK_LAYERS} layers: workers on cuda "
          "vs the CPU in-process run")
    t0 = time.perf_counter()
    workers_cross_check(*xcheck_depth(cfg32, params32))
    print(f"  took {time.perf_counter() - t0:.2f} s")

    phase(f"cross-check f32, {DENSE_XCHECK_LAYERS} layers: three training "
          "steps, cuda vs cpu")
    t0 = time.perf_counter()
    training_cross_check(*xcheck_depth(cfg32, params32))
    print(f"  took {time.perf_counter() - t0:.2f} s")
    del params32

    phase("model families: olmo-1b, starcoder2-7b, chameleon-34b at full "
          f"width ({FAMILIES['chameleon_34b']} of its 48 layers)")
    t0 = time.perf_counter()
    families = families_phase(args.seed, card)
    phase(f"cross-check f32, {FAMILY_XCHECK_LAYERS} layers: the model "
          "families' paged cluster, cuda vs cpu")
    families_cross_check(args.seed)
    print(f"  phase 15 took {time.perf_counter() - t0:.2f} s")

    phase("gemma3-12b whole: 48 layers at d=3840, K2 at D=256 (window "
          "1024 and full causal), dense cluster and Engine")
    t0 = time.perf_counter()
    gemma3 = gemma3_phase(args.seed, card)
    phase("cross-check f32, one super-block (6 layers): gemma3's dense "
          "cluster, cuda vs cpu")
    gemma3["xcheck"] = gemma3_cross_check(args.seed)
    print(f"  phase 16 took {time.perf_counter() - t0:.2f} s")

    phase(f"gemma3-12b training at full width: {GEMMA3_TRAIN_REPEATS} "
          f"super-block, {GEMMA3_TRAIN_BATCH} x {GEMMA3_TRAIN_SEQ} tokens, "
          "K2 and its backward at D=256 (window 1024 and full causal)")
    t0 = time.perf_counter()
    gemma3_train = gemma3_training_phase(args.seed, card)
    phase("cross-check f32, one super-block (6 layers): gemma3's loss and "
          "every gradient, cuda vs cpu")
    gemma3_train["xcheck"] = gemma3_training_cross_check(args.seed)
    print(f"  phase 17 took {time.perf_counter() - t0:.2f} s")

    phase("gemma3-12b whole on the paged paths: the paged cluster and "
          "PagedEngine (K1 at D=256 in the 8 global layers, ring caches in "
          "the 40 local ones)")
    t0 = time.perf_counter()
    gemma3_paged = gemma3_paged_phase(args.seed, card,
                                      gemma3.pop("tokens"))
    phase("cross-check f32, one super-block (6 layers): gemma3's paged "
          "cluster on [0,3) dense + [3,6) paged, cuda vs cpu")
    gemma3_paged["xcheck"] = gemma3_paged_cross_check(args.seed)
    print(f"  phase 18 took {time.perf_counter() - t0:.2f} s")

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
         "cancel_autoscale_launches": {k: v["k1"]
                                       for k, v in cancel_as.items()},
         "workers_launches": {k: v["k1"] for k, v in workers.items()},
         "train_launches": train["launches"]["k1"],
         "families_launches": {k: v["k1"] for k, v in families.items()},
         "gemma3_paged_launches": {
             k: gemma3_paged[k]["k1"] for k in ("cluster", "engine")},
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
         "cancel_autoscale_launches": {k: v["k2"]
                                       for k, v in cancel_as.items()},
         "workers_launches": {k: v["k2"] for k, v in workers.items()},
         "train_launches": train["launches"]["k2"],
         "families_launches": {k: v["k2"] for k, v in families.items()},
         "gemma3_launches": {"cluster": gemma3["cluster"],
                             "engine": gemma3["engine"]},
         "gemma3_paged_launches": {
             k: {key: gemma3_paged[k][key]
                 for key in ("k2", "k2_tc", "k2_window")}
             for k in ("cluster", "engine")},
         "gemma3_train_launches": {
             key: gemma3_train["launches"][key]
             for key in ("k2", "k2_window")},
         "d256_cases": k2_d256_cases,
         "max_abs_err": k2_err, "worst_err_over_limit": k2_worst,
         "lse_max_abs_err": k2_lse_err,
         "ms": main2["ms"], "plain_ms": main2["plain_ms"],
         "bound_ms": main2["bound_ms"], "bound_by": main2["bound_by"],
         "library_ms": main2["library_ms"], "tflops": main2["tflops"],
         "bound_share": main2["bound_share"], "shape": main2["shape"],
         "S4096": t2["S4096"], "D128_S4096": t2["D128_S4096"],
         "starcoder2_S4096": t2["starcoder2_S4096"],
         "gemma3_S4096": t2["gemma3_S4096"],
         "gemma3_S4096_w1024": t2["gemma3_S4096_w1024"]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/models/attention.py:63 (no Pallas kernel: "
                     "the reference's autodiff of chunked_attention)",
         "launches": train["launches"]["k2_bwd"],
         "gemma3_train_launches": {
             key: gemma3_train["launches"][key]
             for key in ("k2_bwd", "k2_bwd_window")},
         "d256_cases": kb_d256_count,
         "kernels_per_call": k2.BWD_KERNELS,
         "max_abs_err": kb_err, "worst_err_over_limit": kb_worst,
         "ms": tb["train"]["ms"], "plain_ms": tb["train"]["plain_ms"],
         "bound_ms": tb["train"]["bound_ms"],
         "bound_by": tb["train"]["bound_by"],
         "library_ms": tb["train"]["library_ms"],
         "graph_ms": tb["train"]["graph_ms"],
         "library_graph_ms": tb["train"]["library_graph_ms"],
         "graph_bound_share": tb["train"]["graph_bound_share"],
         "shape": tb["train"]["shape"],
         **{key: tb[key] for key in tb if key != "train"}}],
        "training": {key: (float(val) if isinstance(val, np.floating)
                           else val)
                     for key, val in train.items() if key != "launches"},
        "families": families, "gemma3": gemma3,
        "gemma3_training": gemma3_train, "gemma3_paged": gemma3_paged}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
