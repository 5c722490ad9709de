"""Single-device training of the port against the JAX package.

Params come from the reference (the session ``gqa_model`` fixture: smollm
SMOKE in f32) through ``convert.params_from_jax``, optimizer state through
``convert.opt_state_from_jax``, batches from each package's ``make_batch``
(equal exactly).  Tolerances, f32 on the CPU:
- ``lr_at``, clipping and the optimizer updates on random trees: atol =
  rtol = 1e-6 (the same fp32 formulas); bf16 AdamW state: one bf16 ulp
  (2**-7 relative), since an fp32 ulp apart can round to neighbours;
- ``loss_fn`` and every gradient: atol = rtol = 1e-4, as the model tests
  (four layers of f32 matmuls summed in another order);
- five train steps: losses at atol = rtol = 1e-4; optimizer state at
  atol = 1e-4; params: at least 99.9% of each leaf's elements within
  1e-4, and every element within lr = 1e-3.  On random weights the logits
  are near uniform, so each gradient is a sum with cancellation and the
  packages' gradients agree to ~1.5e-5 in norm, not elementwise; AdamW
  and Adafactor normalise each element's step, so an element with a small
  gradient can take a step up to lr apart;
- checkpoints: exact (files byte for byte, restarts bit for bit).
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.models import init as jinit
from repro.models.model import loss_fn as j_loss_fn
from repro.training import checkpoint as jckpt
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training import train_step as jstep
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.launch import train as train_driver
from repro_torch.models import init as tinit
from repro_torch.models.common import map_tree, tree_leaves
from repro_torch.models.model import loss_fn
from repro_torch.training import (AsyncCheckpointer, DataConfig,
                                  OptimizerConfig, TrainConfig,
                                  init_train_state, latest_step, make_batch,
                                  make_train_step, restore, save)
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tstep

OPT_TOL = dict(atol=1e-6, rtol=1e-6)
MODEL = dict(atol=1e-4, rtol=1e-4)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
STATE_TOL = dict(atol=1e-4, rtol=0)
PARAM_ATOL, PARAM_MAX, PARAM_SHARE = 1e-4, 1e-3, 0.999
N_STEPS = 5
DC = dict(vocab_size=512, batch_size=4, seq_len=16)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The SMOKE steps are a few hundred tiny ops each: more intra-op
    threads only add overhead (4.3 s for the overfit loop on 2 threads
    against 8.6 s on 8)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def port_cfg(jcfg):
    cfg = dataclasses.replace(port_smoke_config("smollm_360m"),
                              param_dtype=jcfg.param_dtype,
                              compute_dtype=jcfg.compute_dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t(a):
    return torch.from_numpy(np.array(a))


def assert_trees_close(port_tree, ref_tree, **tol):
    got = tree_leaves(port_tree)
    want = jax.tree.leaves(ref_tree)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **tol,
                                   err_msg=f"leaf {i}")


def assert_params_close(port_tree, ref_tree):
    """Every element within PARAM_MAX (lr), and PARAM_SHARE of each leaf's
    elements within PARAM_ATOL (see the module note)."""
    got = tree_leaves(port_tree)
    want = jax.tree.leaves(ref_tree)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        d = np.abs(g.float().numpy() - np.asarray(w, np.float32))
        assert d.max() <= PARAM_MAX, (i, d.max())
        assert (d <= PARAM_ATOL).mean() >= PARAM_SHARE, \
            (i, (d > PARAM_ATOL).sum(), d.size)


def random_tree(seed):
    """A params-like tree (nested dicts, a list, a "v" key as in attention
    blocks, leaves of 1-3 dims) of f32 numpy arrays."""
    rng = np.random.RandomState(seed)
    return {"embed": rng.randn(24, 16).astype(np.float32),
            "blocks": [{"v": rng.randn(2, 16, 12).astype(np.float32),
                        "scale": rng.randn(16).astype(np.float32)},
                       {"v": rng.randn(2, 16, 12).astype(np.float32),
                        "scale": rng.randn(16).astype(np.float32)}],
            "final": {"w": rng.randn(12, 9).astype(np.float32)}}


def to_port(tree):
    return map_tree(lambda a: t(a), tree)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


# --- data --------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 11])
def test_make_batch_equals_reference(seed):
    cfg = DataConfig(vocab_size=97, batch_size=3, seq_len=29, seed=seed)
    jcfg = jdata.DataConfig(vocab_size=97, batch_size=3, seq_len=29,
                            seed=seed)
    for step in (0, 1, 7, 123456):
        got = make_batch(cfg, step, device="cpu")
        want = jdata.make_batch(jcfg, step)
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))


# --- optimizer -----------------------------------------------------------------

def test_lr_schedule_and_clipping_match_reference():
    cfg = OptimizerConfig(lr=3e-3, warmup_steps=7, total_steps=50)
    jcfg = jopt.OptimizerConfig(lr=3e-3, warmup_steps=7, total_steps=50)
    steps = np.arange(0, 60, dtype=np.int32)
    np.testing.assert_allclose(
        topt.lr_at(cfg, t(steps)).numpy(),
        np.asarray(jopt.lr_at(jcfg, jnp.asarray(steps))), **OPT_TOL)
    tree = random_tree(0)
    np.testing.assert_allclose(topt.global_norm(to_port(tree)).item(),
                               float(jopt.global_norm(to_jax(tree))),
                               **OPT_TOL)
    for max_norm in (1.0, 1e3):
        got, gn = topt.clip_by_global_norm(to_port(tree), max_norm)
        want, jn = jopt.clip_by_global_norm(to_jax(tree), max_norm)
        np.testing.assert_allclose(gn.item(), float(jn), **OPT_TOL)
        assert_trees_close(got, want, **OPT_TOL)


def _run_updates(name, port_cfg_, ref_cfg, n=3):
    """n updates of both packages from their init, on the same random
    params and gradients; returns (port params, state), (ref params,
    state)."""
    params = random_tree(1)
    p, jp = to_port(params), to_jax(params)
    s = topt.opt_init(port_cfg_, p)
    js = jopt.opt_init(ref_cfg, jp)
    for i in range(n):
        g = random_tree(10 + i)
        p, s, m = topt.opt_update(port_cfg_, to_port(g), s, p)
        jp, js, jm = jopt.opt_update(ref_cfg, to_jax(g), js, jp)
        np.testing.assert_allclose(m["lr"].item(), float(jm["lr"]),
                                   **OPT_TOL)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), **OPT_TOL)
        assert s["step"].dtype == torch.int32
        assert s["step"].item() == int(js["step"]) == i + 1
    return (p, s), (jp, js)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(state_dtype):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              clip_norm=5.0, state_dtype=state_dtype)
    (p, s), (jp, js) = _run_updates(
        "adamw", OptimizerConfig(**kw), jopt.OptimizerConfig(**kw))
    state_tol = OPT_TOL if state_dtype == "float32" else \
        dict(atol=1e-6, rtol=2 ** -7)
    assert tree_leaves(s["m"])[0].dtype == (
        torch.float32 if state_dtype == "float32" else torch.bfloat16)
    assert_trees_close(p, jp, **(OPT_TOL if state_dtype == "float32"
                                 else dict(atol=1e-5, rtol=1e-5)))
    assert_trees_close(s["m"], js["m"], **state_tol)
    assert_trees_close(s["v"], js["v"], **state_tol)


@pytest.mark.parametrize("min_dim", [8, 10_000], ids=["factored",
                                                      "unfactored"])
def test_adafactor_update_matches_reference(min_dim):
    kw = dict(name="adafactor", lr=1e-2, warmup_steps=2, total_steps=10,
              weight_decay=0.1, min_dim_factored=min_dim)
    (p, s), (jp, js) = _run_updates(
        "adafactor", OptimizerConfig(**kw), jopt.OptimizerConfig(**kw))
    assert any("vr" in x for x in s["v"]) == (min_dim == 8)
    assert_trees_close(p, jp, **OPT_TOL)
    assert_trees_close(s["v"], js["v"], **OPT_TOL)


# --- loss and gradients -----------------------------------------------------------

@pytest.fixture(scope="module")
def both(gqa_model):
    jcfg, jparams = gqa_model
    cfg = port_cfg(jcfg)
    return jcfg, jparams, cfg, params_from_jax(np_tree(jparams), cfg,
                                               device="cpu")


def test_loss_and_every_gradient_match_reference(both):
    jcfg, jparams, cfg, params = both
    batch = make_batch(DataConfig(**DC), 0, device="cpu")
    batch["labels"][0, :5] = -100            # ignored labels
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: j_loss_fn(jcfg, p, jbatch), has_aux=True))(jparams)
    live = map_tree(lambda x: x.clone().requires_grad_(True), params)
    loss, metrics = loss_fn(cfg, live, batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **MODEL)
    np.testing.assert_allclose(metrics["ce"].item(), float(jm["ce"]),
                               **MODEL)
    assert metrics["aux"].item() == float(jm["aux"]) == 0.0
    assert metrics["tokens"].item() == float(jm["tokens"]) == 4 * 16 - 5
    grads = map_tree(lambda x: x.grad, live)
    assert all(g is not None and g.abs().max() > 0
               for g in tree_leaves(grads))
    assert_trees_close(grads, jg, **MODEL)


# --- train steps --------------------------------------------------------------------

OPT_KW = dict(lr=1e-3, warmup_steps=2, total_steps=10)


@functools.lru_cache(maxsize=None)
def reference_run(jcfg, opt_name, microbatches):
    """The reference's jitted train step (remat "none"), N_STEPS steps from
    its init: [(params, opt state) before each step and after the last],
    losses, as numpy."""
    params = jinit(jcfg, jax.random.key(0))
    tc = jstep.TrainConfig(optimizer=jopt.OptimizerConfig(
        name=opt_name, **OPT_KW), remat="none", microbatches=microbatches)
    step_fn = jax.jit(jstep.make_train_step(jcfg, tc))
    opt = jstep.init_train_state(jcfg, tc, params)
    dc = jdata.DataConfig(**DC)
    states, losses = [(np_tree(params), np_tree(opt))], []
    for s in range(N_STEPS):
        params, opt, m = step_fn(params, opt, jdata.make_batch(dc, s))
        states.append((np_tree(params), np_tree(opt)))
        losses.append(float(m["loss"]))
    return states, losses


def port_run(cfg, params, opt, train, start=0):
    step_fn = make_train_step(cfg, train)
    dc = DataConfig(**DC)
    losses = []
    for s in range(start, N_STEPS):
        params, opt, m = step_fn(params, opt, make_batch(dc, s, device="cpu"))
        losses.append(m["loss"].item())
    return params, opt, losses


CASES = [("adamw", "none", 1), ("adamw", "full", 1), ("adamw", "dots", 1),
         ("adafactor", "none", 1), ("adafactor", "full", 1),
         ("adafactor", "dots", 1), ("adamw", "none", 2)]


@pytest.mark.parametrize("opt_name,remat,mb", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_train_steps_match_reference(both, opt_name, remat, mb):
    """Five steps from the reference's init (params and optimizer state
    converted), against the reference's jitted step; every remat against
    the reference's "none" (remat changes memory, not numbers)."""
    jcfg, _, cfg, _ = both
    states, want_losses = reference_run(jcfg, opt_name, mb)
    p0, o0 = states[0]
    train = TrainConfig(optimizer=OptimizerConfig(name=opt_name, **OPT_KW),
                        remat=remat, microbatches=mb)
    params, opt, losses = port_run(
        cfg, params_from_jax(p0, cfg, device="cpu"),
        opt_state_from_jax(o0, device="cpu"), train)
    np.testing.assert_allclose(losses, want_losses, **STEP_TOL)
    p5, o5 = states[-1]
    assert_params_close(params, p5)
    assert opt["step"].item() == N_STEPS
    assert_trees_close({k: v for k, v in opt.items() if k != "step"},
                       {k: v for k, v in o5.items() if k != "step"},
                       **STATE_TOL)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_port_trains_on_from_reference_state(both, opt_name):
    """``opt_state_from_jax`` carries a live state: the port resumes the
    reference's run after two steps and ends where the reference ends."""
    jcfg, _, cfg, _ = both
    states, want_losses = reference_run(jcfg, opt_name, 1)
    p2, o2 = states[2]
    train = TrainConfig(optimizer=OptimizerConfig(name=opt_name, **OPT_KW),
                        remat="none")
    params, _, losses = port_run(cfg, params_from_jax(p2, cfg, device="cpu"),
                                 opt_state_from_jax(o2, device="cpu"), train,
                                 start=2)
    np.testing.assert_allclose(losses, want_losses[2:], **STEP_TOL)
    assert_params_close(params, states[-1][0])


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_training_reduces_loss(opt_name):
    """The reference's overfit test (tests/test_serving_training.py) on the
    port: 100 steps on one fixed batch halve the loss."""
    cfg = port_smoke_config("smollm_360m")
    params = tinit(cfg, 0, device="cpu")
    tc = TrainConfig(optimizer=OptimizerConfig(
        name=opt_name, lr=3e-3, warmup_steps=5, total_steps=1000,
        weight_decay=0.0), remat="none")
    step_fn = make_train_step(cfg, tc)
    opt_state = init_train_state(cfg, tc, params)
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, batch_size=4,
                                  seq_len=32, seed=3), 0, device="cpu")
    losses = []
    for _ in range(100):
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(metrics["loss"].item())
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.5, losses[::20]


def test_sharded_train_step_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 8"):
        tstep.make_sharded_train_step(None, TrainConfig(), None)


# --- checkpoints ----------------------------------------------------------------

def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_checkpoint_roundtrip(tmp_path):
    cfg = dataclasses.replace(port_smoke_config("smollm_360m"),
                              param_dtype="bfloat16")
    params = tinit(cfg, 0, device="cpu")
    state = {"params": params,
             "opt": init_train_state(cfg, TrainConfig(), params)}
    d = str(tmp_path / "ckpt")
    save(d, 7, state, metadata={"data_step": 7})
    assert latest_step(d) == 7
    restored, step, meta = restore(d, None, state)
    assert step == 7 and meta == {"data_step": 7}
    assert _equal_trees(restored, state)
    with pytest.raises(AssertionError, match="leaf count"):
        restore(d, 7, {"params": params})
    bad = dict(state, opt=dict(state["opt"], step=torch.zeros(2)))
    with pytest.raises(ValueError, match="shape"):
        restore(d, 7, bad)


def test_checkpoint_restart_equals_uninterrupted_run(tmp_path):
    """Six steps, against three, a save, a restore and three more: equal
    bit for bit on the CPU."""
    cfg = port_smoke_config("smollm_360m")
    tc = TrainConfig(optimizer=OptimizerConfig(lr=1e-3, warmup_steps=2,
                                               total_steps=10), remat="none")
    dc = DataConfig(**DC)
    step_fn = make_train_step(cfg, tc)

    def run(n0, n1, params, opt):
        for s in range(n0, n1):
            params, opt, _ = step_fn(params, opt,
                                     make_batch(dc, s, device="cpu"))
        return params, opt

    params0 = tinit(cfg, 0, device="cpu")
    opt0 = init_train_state(cfg, tc, params0)
    ref = run(0, 6, params0, opt0)
    params, opt = run(0, 3, params0, opt0)
    d = str(tmp_path / "ckpt")
    save(d, 3, {"params": params, "opt": opt}, metadata={"data_step": 3})
    state, _, meta = restore(d, None, {"params": params0, "opt": opt0})
    resumed = run(meta["data_step"], 6, state["params"], state["opt"])
    assert _equal_trees(resumed, ref)


def test_async_checkpointer_keeps_the_newest(tmp_path):
    params = tinit(port_smoke_config("smollm_360m"), 0, device="cpu")
    d = str(tmp_path / "ckpt")
    ck = AsyncCheckpointer(d, keep=2)
    for s in (1, 2, 3):
        ck.save_async(s, params, metadata={"s": s})
    ck.wait()
    assert latest_step(d) == 3
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000003"]
    restored, step, meta = restore(d, None, params)
    assert step == 3 and meta == {"s": 3} and _equal_trees(restored, params)


def test_checkpoint_files_equal_the_reference(gqa_model, tmp_path):
    """The same state (bf16 params, bf16 AdamW moments, the int32 step)
    saved by both packages: every leaf file is the same bytes, and the
    indexes agree on each leaf's dtype and shape."""
    jcfg, jparams = gqa_model
    jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    bf16 = functools.partial(jax.tree.map, lambda x: x.astype(jnp.bfloat16))
    jparams = bf16(jparams)
    jopt_state = {"m": bf16(jax.tree.map(lambda x: x * 0.1, jparams)),
                  "v": bf16(jax.tree.map(lambda x: x * x, jparams)),
                  "step": jnp.asarray(3, jnp.int32)}
    cfg = port_cfg(jcfg)
    state = {"params": params_from_jax(np_tree(jparams), cfg, device="cpu"),
             "opt": opt_state_from_jax(np_tree(jopt_state), device="cpu")}
    jckpt.save(str(tmp_path / "ref"), 4, {"params": jparams,
                                          "opt": jopt_state})
    save(str(tmp_path / "port"), 4, state)
    rdir, pdir = (str(tmp_path / x / "step_00000004") for x in ("ref", "port"))
    n = len(tree_leaves(state))
    assert n == len(jax.tree.leaves({"params": jparams, "opt": jopt_state}))
    for i in range(n):
        name = f"arr_{i:05d}.npy"
        with open(os.path.join(rdir, name), "rb") as a, \
                open(os.path.join(pdir, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(rdir, "index.msgpack"), "rb") as f:
        rindex = msgpack.unpackb(f.read())
    with open(os.path.join(pdir, "index.json")) as f:
        pindex = json.load(f)
    assert pindex["leaves"] == rindex["leaves"]
    assert {x["dtype"] for x in pindex["leaves"]} == {"bfloat16", "int32"}


# --- driver ---------------------------------------------------------------------

def test_train_driver_runs_and_resumes_on_cpu(tmp_path, capsys):
    params, opt = train_driver.main(
        ["--arch", "smollm_360m", "--smoke", "--device", "cpu", "--steps",
         "2"])
    out = capsys.readouterr().out
    assert "step 1: loss" in out and "tokens/s" in out
    assert opt["step"].item() == 2
    assert all(torch.isfinite(x.float()).all() for x in tree_leaves(params))
    d = str(tmp_path / "ckpt")
    argv = ["--arch", "smollm_360m", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-dir", d]
    whole, _ = train_driver.main(argv + ["--steps", "3"])
    d2 = str(tmp_path / "ckpt2")
    argv[-1] = d2
    train_driver.main(argv + ["--steps", "1"])
    resumed, opt = train_driver.main(argv + ["--steps", "3", "--resume"])
    assert "resumed at data step 1" in capsys.readouterr().out
    assert opt["step"].item() == 3 and latest_step(d2) == 3
    assert _equal_trees(resumed, whole)


def test_train_driver_needs_cuda_or_cpu_and_one_device():
    with pytest.raises(NotImplementedError, match="item 8"):
        train_driver.main(["--arch", "smollm_360m", "--smoke", "--device",
                           "cpu", "--mesh", "2,4"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_driver.main(["--arch", "smollm_360m", "--smoke"])
