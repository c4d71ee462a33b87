"""Collectives over the axes of an LM mesh, as plain tensor operations.

One process drives every shard of a mesh (``launch/mesh.LMMesh``), so a
value that the reference holds once a device under ``shard_map`` or GSPMD is
here a list with one tensor a shard, in the mesh's order, and a collective
is a function of such a list.  It has no counterpart module in the
reference, where these are ``psum``, ``pmax`` and the partitioner's
all-gathers:

* :func:`all_reduce_sum` and :func:`all_reduce_max` over an axis (or a tuple
  of axes): every shard of a group gets the group's sum or maximum, summed
  in the group's order so that the shards agree bit for bit.  Where the
  group's shards share one device the result is one tensor that they all
  hold; across cards it is a peer copy and an add on each card.
* :func:`all_gather`: the group's tensors concatenated along a dim on each
  shard (FSDP's weight gather over the data axes, ``sharding.Sharded.locals``);
* :func:`all_to_all`: blocks split along one dim re-split along another
  (the unembedding, split over its rows by the rules, split over the
  vocabulary for the loss, as the reference's ``shard_map`` re-shards it).

Autograd sees only differentiable tensor operations, so the backward of a
sum that every shard holds is the sum of the shards' cotangents, as in the
reference.

Every call adds its traffic to :data:`STATS`, one operation a call (all of
its groups at once, as one HLO collective is), with the bytes of one shard's
buffer weighted by the ring factors of the reference's
``launch/hlo_stats.py`` (``CollectiveStats.add``): all-gather and
reduce-scatter (g−1)/g, all-reduce 2(g−1)/g.  The backward's collectives
(Megatron's: an all-reduce of the cotangents where a replicated activation
fans out to the shards' column-parallel products, a reduce-scatter where a
weight was gathered) are counted when autograd reaches them, and the
data-parallel gradient all-reduce by :func:`count_gradient_sync`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

__all__ = [
    "STATS",
    "CollectiveStats",
    "all_gather",
    "all_to_all",
    "all_reduce_max",
    "all_reduce_sum",
    "count_gradient_sync",
    "nbytes",
    "reset_stats",
]


@dataclass
class CollectiveStats:
    """Collective traffic a shard: raw buffer bytes and the number of
    operations by kind, and the ring-weighted link bytes."""

    per_op_bytes: dict = field(default_factory=dict)
    per_op_count: dict = field(default_factory=dict)
    link_bytes: float = 0.0

    def add(self, kind: str, nbytes: float, group: int):
        self.per_op_bytes[kind] = self.per_op_bytes.get(kind, 0.0) + nbytes
        self.per_op_count[kind] = self.per_op_count.get(kind, 0) + 1
        g = max(group, 1)
        if kind == "all-reduce":
            w = 2.0 * (g - 1) / g
        elif kind == "collective-permute":
            w = 1.0
        else:
            w = (g - 1) / g
        self.link_bytes += nbytes * w

    def as_dict(self):
        return {
            "per_op_bytes": dict(self.per_op_bytes),
            "per_op_count": dict(self.per_op_count),
            "link_bytes": self.link_bytes,
        }


#: The process's counter; :func:`reset_stats` sets it to zero.
STATS = CollectiveStats()


def reset_stats() -> None:
    STATS.per_op_bytes.clear()
    STATS.per_op_count.clear()
    STATS.link_bytes = 0.0


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _count(kind: str, t: torch.Tensor, group: int) -> None:
    if group > 1:
        STATS.add(kind, nbytes(t), group)


def _count_backward(t: torch.Tensor, kind: str, group: int) -> None:
    """Count ``kind`` when autograd reaches ``t`` in a backward pass."""
    if group > 1 and kind and t.requires_grad:
        t.register_hook(lambda g: _count(kind, g, group))


def _reduce(xs, mesh, axis, op, kind, backward):
    out = [None] * len(xs)
    groups = mesh.groups(axis)
    for grp in groups:
        devices = {xs[n].device for n in grp}
        if len(devices) == 1:
            total = xs[grp[0]]
            for n in grp[1:]:
                total = op(total, xs[n])
            for n in grp:
                out[n] = total
        else:
            for n in grp:
                dev = xs[n].device
                total = xs[grp[0]].to(dev)
                for m in grp[1:]:
                    total = op(total, xs[m].to(dev))
                out[n] = total
    g = len(groups[0])
    _count(kind, xs[0], g)
    _count_backward(out[0], backward, g)
    return out


def all_reduce_sum(xs, mesh, axis, *, backward: str | None = "all-reduce") -> list:
    """Each shard's tensor replaced by the sum over its group along ``axis``.

    ``backward`` names the collective that the backward pass counts where a
    cotangent reaches the sum (Megatron's all-reduce at the block's input);
    ``None`` for a sum whose cotangent needs none, as the vocab-sharded
    embedding's."""
    return _reduce(xs, mesh, axis, torch.add, "all-reduce", backward)


def all_reduce_max(xs, mesh, axis) -> list:
    """Each shard's tensor replaced by the elementwise maximum over its group
    (no gradient: the reference's ``pmax`` of a ``stop_gradient``)."""
    return _reduce([x.detach() for x in xs], mesh, axis, torch.maximum, "all-reduce", None)


def all_gather(xs, mesh, axis, dim: int) -> list:
    """Each shard's tensor replaced by its group's tensors concatenated along
    ``dim`` in the group's order; the backward is a reduce-scatter."""
    out = [None] * len(xs)
    groups = mesh.groups(axis)
    for grp in groups:
        by_device: dict = {}
        for n in grp:
            dev = xs[n].device
            if dev not in by_device:
                by_device[dev] = torch.cat([xs[m].to(dev) for m in grp], dim=dim)
            out[n] = by_device[dev]
    g = len(groups[0])
    _count("all-gather", out[0], g)
    _count_backward(out[0], "reduce-scatter", g)
    return out


def all_to_all(xs, mesh, axis, split_dim: int, concat_dim: int) -> list:
    """Each shard's block, split along ``concat_dim`` over its group, re-split
    along ``split_dim``: shard i of a group gets the group's blocks
    concatenated along ``concat_dim``, its i-th slice along ``split_dim``."""
    out = [None] * len(xs)
    groups = mesh.groups(axis)
    for grp in groups:
        full: dict = {}
        for i, n in enumerate(grp):
            dev = xs[n].device
            if dev not in full:
                full[dev] = torch.cat([xs[m].to(dev) for m in grp], dim=concat_dim)
            size = full[dev].shape[split_dim] // len(grp)
            out[n] = full[dev].narrow(split_dim, i * size, size)
    g = len(groups[0])
    _count("all-to-all", xs[0], g)
    _count_backward(out[0], "all-to-all", g)
    return out


def count_gradient_sync(rules, params) -> None:
    """Count the data-parallel all-reduce of the gradients of ``params`` (a
    tree of ``sharding.Sharded`` leaves): one a leaf that is not split over
    the data axes, of its block's bytes, over the data replicas.  A leaf
    split over them (FSDP) has its reduce-scatter counted by the gather."""
    from repro_torch.models.lm.sharding import Sharded

    dp = rules.dp()

    def walk(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)
        elif isinstance(tree, Sharded) and not tree.split_over(rules.dp_axes):
            _count("all-reduce", tree.blocks[0], dp)

    walk(params)
