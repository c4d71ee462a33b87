"""The train step: loss -> gradients -> clip -> AdamW (``repro/train/step.py``).

``build_train_step(model, ...)`` returns ``train_step(params, opt_state,
batch, step) -> (params, opt_state, metrics)``.  The gradients are taken
over every floating-point leaf of ``params`` by ``torch.autograd.grad``
(the parameters are used as they are: the step sets and clears
``requires_grad`` on them itself), clipped by their global norm, and the
learning rate of ``step`` feeds :func:`optim.adamw.adamw_update`.  With
``grad_accum > 1`` the batch's leading axis is cut into that many
microbatches; their gradients are summed in float32 and divided, and the
loss is their mean, as the reference's ``lax.scan`` does (its metrics are
then ``loss``, ``grad_norm`` and ``lr`` only).  The reference runs the step
under ``jit`` with the state donated; here it runs eagerly, and the new
parameters and moments are new tensors.

Under sharding rules (``models/lm/sharding.use_rules``) the step runs over
the mesh as it stands: ``params`` and the moments are trees of ``Sharded``
leaves (``shard_params``, ``adamw_init`` of them), the loss and its
gradients are the model's over the mesh, each block's gradient is summed
over the shards that use it, and the data-parallel gradient all-reduce that
this sum stands for is counted in ``collectives.STATS``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.lm.collectives import count_gradient_sync
from repro_torch.models.lm.sharding import active_rules
from repro_torch.optim.adamw import (
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    tree_leaves,
    tree_map,
)

__all__ = ["build_train_step", "init_train_state", "loss_and_grads"]

f32 = torch.float32


def init_train_state(params) -> AdamWState:
    return adamw_init(params)


def loss_and_grads(model, params, batch):
    """``(loss, metrics, grads)`` of ``model.train_loss(params, batch)``;
    grads has the params' tree and types."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = model.train_loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    it = iter(torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads))
    metrics = {k: v.detach() for k, v in metrics.items()}
    rules = active_rules()
    if rules is not None:
        count_gradient_sync(rules, params)
    return loss.detach(), metrics, tree_map(lambda _: next(it), params)


def _microbatches(batch: dict, n: int) -> list[dict]:
    for name, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch[{name!r}]: {x.shape[0]} rows do not split into {n}")
    return [{name: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i] for name, x in batch.items()}
            for i in range(n)]


def build_train_step(
    model,
    *,
    lr_schedule: Callable | None = None,
    grad_accum: int = 1,
    max_grad_norm: float = 1.0,
    weight_decay: float = 0.1,
) -> Callable:
    lr_schedule = lr_schedule or (lambda step: 3e-4)

    def train_step(params, opt_state: AdamWState, batch, step):
        if grad_accum == 1:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=f32, device=p.device), params)
            loss = torch.zeros((), dtype=f32, device=tree_leaves(params)[0].device)
            for mb in _microbatches(batch, grad_accum):
                l, _, g = loss_and_grads(model, params, mb)
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / grad_accum, grads)
            loss = loss / grad_accum
            metrics = {}
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = lr_schedule(step)
        params, opt_state = adamw_update(grads, opt_state, params, lr,
                                         weight_decay=weight_decay)
        out = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        out.update(metrics)
        return params, opt_state, out

    return train_step
