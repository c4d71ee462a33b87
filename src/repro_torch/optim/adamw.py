"""AdamW, gradient clipping and LR schedules: ``repro/optim/adamw.py``.

The optimizer state mirrors the params tree (nested dicts, lists and
tuples of tensors).  Moments are float32 whatever the parameters' type; the
update is computed in float32 and cast back to each parameter's type.
The global norm of :func:`clip_by_global_norm` and the schedules are
float32, as in the reference; a schedule takes the step as an int or a
0-d tensor and returns a 0-d float32 tensor on the step's device.

A tree of parameters placed on a mesh (``models/lm/sharding.Sharded``
leaves) is a tree of its distinct blocks here: the moments are sharded like
the parameters, and the global norm counts each element once, a sharded
leaf over all of its blocks and a replicated one once.  The blocks may lie
on several cards; each update runs on its block's card.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import math

import torch

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_schedule",
    "linear_warmup_cosine",
    "tree_leaves",
    "tree_map",
]

f32 = torch.float32
PyTree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: PyTree          # first moment
    nu: PyTree          # second moment


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the tensor leaves of ``tree`` and trees of the same structure
    (a ``Sharded`` leaf is a node over its blocks)."""
    if hasattr(tree, "like"):
        return tree.like(tree_map(fn, *(t.blocks for t in (tree, *rest))))
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest)) for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *leaves) for leaves in zip(tree, *rest))
    return fn(tree, *rest)


def adamw_init(params: PyTree) -> AdamWState:
    device = next(iter(tree_leaves(params))).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=tree_map(lambda p: torch.zeros_like(p, dtype=f32), params),
        nu=tree_map(lambda p: torch.zeros_like(p, dtype=f32), params),
    )


def tree_leaves(tree: PyTree) -> list:
    """The tensor leaves of ``tree``, in its order."""
    out: list = []
    tree_map(out.append, tree)
    return out


@torch.no_grad()
def adamw_update(
    grads: PyTree,
    state: AdamWState,
    params: PyTree,
    lr: torch.Tensor | float,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> tuple[PyTree, AdamWState]:
    """One AdamW step; returns (new_params, new_state)."""
    step = state.step + 1
    t = step.to(f32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=f32, device=t.device), t)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=f32, device=t.device), t)

    def upd(g, m, v, p):
        dev = p.device
        g = g.to(f32)
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        delta = (m / c1.to(dev)) / (torch.sqrt(v / c2.to(dev)) + eps) + weight_decay * p.to(f32)
        return (p.to(f32) - _on(lr, dev) * delta).to(p.dtype), m, v

    new: list = []
    tree_map(lambda *leaves: new.append(upd(*leaves)), grads, state.mu, state.nu, params)

    def rebuild(i):
        it = iter(out[i] for out in new)
        return tree_map(lambda _: next(it), grads)

    return rebuild(0), AdamWState(step=step, mu=rebuild(1), nu=rebuild(2))


@torch.no_grad()
def clip_by_global_norm(grads: PyTree, max_norm: float) -> tuple[PyTree, torch.Tensor]:
    """``grads`` scaled by ``min(1, max_norm / max(‖g‖, 1e-12))`` (in float32,
    cast back to each leaf's type) and the float32 global norm ‖g‖."""
    leaves = tree_leaves(grads)
    sq = torch.zeros((), dtype=f32, device=leaves[0].device)
    for g in leaves:
        sq = sq + torch.sum(torch.square(g.to(f32))).to(sq.device)
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.to(f32) * scale.to(g.device)).to(g.dtype), grads), gnorm


def _on(x, device):
    return x.to(device) if torch.is_tensor(x) else x


def _step_f32(step) -> torch.Tensor:
    if torch.is_tensor(step):
        return step.to(f32)
    return torch.tensor(step, dtype=f32)


def cosine_schedule(base_lr: float, total_steps: int) -> Callable:
    def sched(step):
        frac = torch.clamp(_step_f32(step) / total_steps, 0.0, 1.0)
        return base_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))

    return sched


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         min_frac: float = 0.1) -> Callable:
    def sched(step):
        s = _step_f32(step)
        warm = s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total_steps - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1.0 - min_frac) * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return base_lr * torch.where(s < warmup, warm, cos)

    return sched
