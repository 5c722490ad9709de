"""Train step: loss -> grad -> optimizer, with remat and microbatching —
counterpart of ``repro.training.train_step``.

``make_train_step`` returns a function ``(params, opt_state, batch) ->
(params, opt_state, metrics)`` that runs eagerly on the params' device;
gradients come from ``torch.autograd`` (attention's through K2's backward
kernels on the card).  ``remat`` picks what each block keeps for backward
(``models.model.loss_fn``), never the numbers.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from ..configs.base import ModelConfig
from ..models.common import tree_leaves, tree_unflatten
from ..models.model import loss_fn
from .optimizer import OptimizerConfig, opt_init, opt_update

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    remat: str = "full"              # full | dots | none
    microbatches: int = 1            # sequential grad accumulation
    skip_masked_chunks: bool = False # accepted; K2 skips masked tiles itself


def make_loss(cfg: ModelConfig, train: TrainConfig) -> Callable:
    return functools.partial(loss_fn, cfg,
                             skip_masked_chunks=train.skip_masked_chunks,
                             remat=train.remat)


def _value_and_grad(loss: Callable, params, batch):
    """(loss, metrics, grads): grads a tree like ``params`` in its dtypes."""
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        val, metrics = loss(tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(val, live)
    return (val.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, list(grads)))


def make_train_step(cfg: ModelConfig, train: TrainConfig) -> Callable:
    loss = make_loss(cfg, train)

    def train_step(params, opt_state, batch):
        if train.microbatches > 1:
            mb = train.microbatches
            B = batch["tokens"].shape[0]
            assert B % mb == 0, (B, mb)
            split = {k: v.reshape(mb, B // mb, *v.shape[1:])
                     for k, v in batch.items()}
            g_acc = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                     for p in tree_leaves(params)]
            loss_val = torch.zeros((), dtype=torch.float32,
                                   device=batch["tokens"].device)
            for i in range(mb):
                l, _, g = _value_and_grad(
                    loss, params, {k: v[i] for k, v in split.items()})
                g_acc = [a + b.float() / mb
                         for a, b in zip(g_acc, tree_leaves(g))]
                loss_val = loss_val + l / mb
            grads = tree_unflatten(params, g_acc)
            metrics = {"ce": loss_val}
        else:
            loss_val, metrics, grads = _value_and_grad(loss, params, batch)
        new_params, new_opt, opt_metrics = opt_update(
            train.optimizer, grads, opt_state, params)
        out_metrics = {"loss": loss_val, **metrics, **opt_metrics}
        return new_params, new_opt, out_metrics

    return train_step


def init_train_state(cfg: ModelConfig, train: TrainConfig, params):
    return opt_init(train.optimizer, params)


def make_sharded_train_step(cfg: ModelConfig, train: TrainConfig, mesh,
                            rules=None, donate: bool = True):
    raise NotImplementedError(
        "the sharded train step needs the distribution layer, which is not "
        "ported yet (ROADMAP queue 1 item 8: dist); make_train_step runs on "
        "one device")
