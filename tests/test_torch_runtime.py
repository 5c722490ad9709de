"""The port's Helix serving path against the JAX package (f32, CPU).

The port's ``ClusterRuntime`` over paged stage engines, and over dense
stage engines (``paged=False``), must produce greedy tokens *equal* to the
reference's single full-model engine (the ``reference`` fixture) on
multi-stage placements, and release every node's pages or slots; the
copied planner must place like the reference's; and the port's serve
driver must run end to end on the CPU (cluster paged and dense, and the
single-node paged engine).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import (ModelProfile as JModelProfile,
                        make_serving_cluster as j_make_serving_cluster,
                        plan as jplan)
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import (LayerRange, ModelProfile, Placement,
                              make_serving_cluster, plan)
from repro_torch.core.cluster import full_mesh_cluster
from repro_torch.serving.engine import EngineConfig, Request
from repro_torch.serving.runtime import ClusterRuntime, InProcessTransport
from repro_torch.serving.stage_engine import StageEngine

from harness import EC as JEC, make_plan as jmake_plan, pool_for_one_request

EC = EngineConfig(**dataclasses.asdict(JEC))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port_model(gqa_model):
    jcfg, jparams = gqa_model
    cfg = dataclasses.replace(get_smoke_config("smollm_360m"),
                              param_dtype=jcfg.param_dtype,
                              compute_dtype=jcfg.compute_dtype)
    return cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")


def port_plan(cfg, assignment):
    """The port's counterpart of ``harness.make_plan``: an explicit layer
    assignment on a full-mesh A100 cluster, planned by the copied core."""
    placement = Placement({n: LayerRange(*r) for n, r in assignment.items()},
                          cfg.num_layers)
    assert placement.validate() == []
    profile = ModelProfile.from_dims(
        cfg.name, cfg.num_layers, cfg.d_model, max(cfg.d_ff, 1),
        cfg.vocab_size, cfg.num_kv_heads, cfg.resolved_head_dim)
    cluster = full_mesh_cluster(len(assignment), bandwidth=10e9 / 8,
                                latency_s=1e-3)
    return plan(cluster, profile, placement=placement)


def serve(cfg, params, p, prompts, **kw):
    rt = ClusterRuntime(cfg, params, p, EC, device="cpu", **kw)
    reqs = [Request(i, pr, max_new_tokens=6) for i, pr in enumerate(prompts)]
    for r in reqs:
        rt.submit(r)
    rt.run_until_done()
    assert all(r.done for r in reqs)
    return rt, reqs


def assert_drained(rt):
    used = rt.pool_pages_used()
    assert used and all(u == 0 for u in used.values()), used


CASES = {
    "2stage": ({"n0": (0, 2), "n1": (2, 4)}, 1, 0.0),
    "3stage": ({"n0": (0, 2), "n1": (2, 3), "n2": (3, 4)}, 1, 2e-3),
    "3stage-depth2": ({"n0": (0, 1), "n1": (1, 3), "n2": (3, 4)}, 2, 2e-3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cluster_runtime_matches_reference_tokens(gqa_model, port_model,
                                                  reference, case):
    """Greedy tokens equal the reference's exactly; the port's plan equals
    the reference's ``make_plan`` plan on the same assignment."""
    assignment, depth, delay = CASES[case]
    cfg, params = port_model
    prompts, ref = reference
    p = port_plan(cfg, assignment)
    jp = jmake_plan(gqa_model[0], assignment)
    assert {n: (r.start, r.end) for n, r in p.placement.assignment.items()} \
        == {n: (r.start, r.end) for n, r in jp.placement.assignment.items()}
    assert p.throughput == pytest.approx(jp.throughput, rel=1e-12)
    rt, reqs = serve(cfg, params, p, prompts, max_inflight=depth,
                     transport=InProcessTransport(default_delay_s=delay))
    assert [r.output for r in reqs] == ref
    assert_drained(rt)
    for i in range(len(prompts)):
        assert len(rt.served[i].stages) == len(assignment)
    # each engine holds only its slice
    assert sorted(len(e.sparams["blocks"]) for e in rt.engines.values()) == \
        sorted(b - a for a, b in assignment.values())


DENSE_CASES = {
    "2stage": ({"n0": (0, 2), "n1": (2, 4)}, 1, 0.0),
    "2stage-depth2": ({"n0": (0, 3), "n1": (3, 4)}, 2, 1e-3),
    "3stage": ({"n0": (0, 2), "n1": (2, 3), "n2": (3, 4)}, 1, 2e-3),
    "3stage-depth2": ({"n0": (0, 1), "n1": (1, 3), "n2": (3, 4)}, 2, 2e-3),
}


def assert_dense_released(rt):
    """Dense nodes have no pool: every slot is free and holds no tokens."""
    assert rt.pool_pages_used() == {}
    for e in rt.engines.values():
        assert isinstance(e, StageEngine)
        assert e.free_slots == EC.max_batch and e.kv_tokens_used() == 0


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_cluster_runtime_matches_reference_tokens(port_model,
                                                        reference, case):
    """``paged=False``: dense stage engines, single-shot prefill (one hop
    per stage, the flash prefill attention kernel's plain version here),
    dense decode; greedy tokens equal the reference's exactly."""
    assignment, depth, delay = DENSE_CASES[case]
    cfg, params = port_model
    prompts, ref = reference
    rt, reqs = serve(cfg, params, port_plan(cfg, assignment), prompts,
                     paged=False, max_inflight=depth,
                     transport=InProcessTransport(default_delay_s=delay))
    assert [r.output for r in reqs] == ref
    assert_dense_released(rt)
    for e in rt.engines.values():
        assert e.prefills == len(prompts)      # one pass per request
    for i in range(len(prompts)):
        assert len(rt.served[i].stages) == len(assignment)


class _DuplicatingTransport(InProcessTransport):
    """Delivers every prefill payload (a prompt, or a multi-token
    activation) twice."""

    def send(self, src, dst, payload, nbytes, deliver):
        super().send(src, dst, payload, nbytes, deliver)
        if getattr(payload, "ndim", 0) and (
                payload.ndim == 1 or payload.shape[1] > 1):
            super().send(src, dst, payload, nbytes, deliver)


def test_dense_prefill_drops_duplicate_deliveries(port_model, reference):
    cfg, params = port_model
    prompts, ref = reference
    rt, reqs = serve(cfg, params, port_plan(cfg, DENSE_CASES["3stage"][0]),
                     prompts, paged=False,
                     transport=_DuplicatingTransport())
    assert [r.output for r in reqs] == ref
    assert [e.prefills for e in rt.engines.values()] == [len(prompts)] * 3
    assert sum(rt.transport.transfers.values()) > 0
    assert_dense_released(rt)


def test_preemption_keeps_tokens(port_model, reference):
    """A pool that fits one full-budget request forces preemption and
    recompute-on-readmit; the tokens stay the reference's."""
    cfg, params = port_model
    prompts, ref = reference
    assignment = {"n0": (0, 2), "n1": (2, 4)}
    p = port_plan(cfg, assignment)
    from repro.core import LayerRange as JLayerRange
    pages = pool_for_one_request(cfg, JLayerRange(2, 4), ec=JEC)
    rt, reqs = serve(cfg, params, p, prompts, pool_pages={"n1": pages})
    assert [r.output for r in reqs] == ref
    assert sum(r.preemptions for r in reqs) > 0
    assert_drained(rt)


def test_planner_copy_places_like_reference():
    """MILP placement of the copied core on a derated A100+L4 serving
    cluster equals the reference planner's, and so do its flows."""
    dims = ("toy", 8, 1024, 4096, 32000, 8, 128)
    jprof = JModelProfile.from_dims(*dims)
    prof = ModelProfile.from_dims(*dims)
    kw = dict(devs=["A100", "L4"], force_stages=2)
    from repro.core import MILPOptions as JOpt
    from repro_torch.core import MILPOptions
    opt = dict(time_limit_s=10.0, lns_rounds=0, fgls_rounds=20)
    jp = jplan(j_make_serving_cluster(jprof, **kw), jprof, JOpt(**opt))
    p = plan(make_serving_cluster(prof, **kw), prof, MILPOptions(**opt))
    assert {n: (r.start, r.end) for n, r in p.placement.assignment.items()} \
        == {n: (r.start, r.end) for n, r in jp.placement.assignment.items()}
    assert len(p.placement.assignment) >= 2
    assert p.throughput == pytest.approx(jp.throughput, rel=1e-9)
    assert p.flows.keys() == jp.flows.keys()


def test_unported_options_raise(port_model):
    """int8 KV pools (also beside a draft model, and on the wall clock)
    are refused, naming their ROADMAP item."""
    cfg, params = port_model
    p = port_plan(cfg, {"n0": (0, 2), "n1": (2, 4)})
    for kw, item in ((dict(kv_dtype="int8"), 1),
                     (dict(kv_dtype="int8", draft_cfg=cfg,
                           draft_params=params), 1),
                     (dict(kv_dtype="int8", realtime=True), 1)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            ClusterRuntime(cfg, params, p, EC, device="cpu", **kw)


def test_entry_points_default_to_cuda(port_model, monkeypatch):
    """Without a card, asking for the default device raises: no silent
    fallback to the CPU."""
    from repro_torch.models import init
    cfg, params = port_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = port_plan(cfg, {"n0": (0, 2), "n1": (2, 4)})
    with pytest.raises(RuntimeError, match="cuda"):
        ClusterRuntime(cfg, params, p, EC)
    with pytest.raises(RuntimeError, match="cuda"):
        init(cfg, 0)


def _serve_cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm_360m", "--smoke", "--device", "cpu", "--new-tokens", "4",
         *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_serve_cli_smoke_on_cpu():
    out = _serve_cli("--cluster", "A100,L4", "--stages", "2", "--prompt",
                     "20")
    assert "pools drained on every node" in out
    assert "n0 -> n1" in out


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_serve_cli_dense_and_paged_on_cpu(mode):
    """``--cluster ... --dense`` (prompts of two lengths) and the
    single-node ``--paged`` engine (prompts past the 16-token chunk)."""
    if mode == "dense":
        out = _serve_cli("--cluster", "A100,L4", "--stages", "2", "--dense",
                         "--prompt", "20,9")
        assert "dense caches released on every node" in out
        assert "cluster (dense): 4 reqs, 16 tokens" in out
    else:
        out = _serve_cli("--paged", "--prompt", "40", "--batch", "3")
        assert "paged: 3 reqs, 12 tokens" in out and "pool drained" in out


def test_serve_cli_spec_decoding_on_cpu():
    """``--draft``: the target's own architecture and seed as the draft;
    the sampled ids equal the non-speculative run's, the draft's slots are
    released with the pools, and the spec counters, the virtual-clock
    decode latency and the cancelled passes are printed."""
    argv = ("--cluster", "A100,L4", "--stages", "2", "--prompt", "20")
    out = _serve_cli(*argv, "--draft", "smollm_360m", "--spec-tokens", "3")
    assert "pools drained on every node" in out
    assert "draft: smollm-smoke (4L d=64 bfloat16), spec_tokens=3" in out
    assert "spec[proposed=" in out and "tokens/rt=" in out
    assert "mean decode latency (virtual clock" in out
    assert "cancelled in-flight passes: " in out

    def ids(text):
        return [ln for ln in text.splitlines() if ln.startswith("sampled")]
    assert ids(out) == ids(_serve_cli(*argv))


def test_serve_cli_mesh_path_raises():
    """Neither --cluster nor --paged: the reference's sharded mesh path,
    not ported."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm_360m", "--smoke", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "NotImplementedError" in res.stderr
    assert "queue 1 item 8" in res.stderr
