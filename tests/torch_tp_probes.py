"""Probes of the tensor-parallel blocks, shared by
``tests/test_torch_tensor_parallel_ssm.py`` and
``tests/test_torch_tensor_parallel_decode.py`` (on the CPU) and
``chip_smoke.py`` phases 20 and 21 (on the card); they import torch and the
port only.

* ``planted(fault)``: a fault planted in the sharded program while active,
  which each check must see:

  - ``norm_over_own_slice``: Mamba2's (and the mLSTM's) RMS norm over the
    shard's block of the inner width alone, with no all-reduce of the sums
    of squares;
  - ``p_split_without_gather``: the mLSTM with no gather where a shard holds
    part of a head: each shard's cell sees its own columns of q, k and v,
    the others' zero (P is split inside the cell's chunk products);
  - ``replicated_grad_summed``: every replicated leaf's copy on a shard gets
    the sum over "model" of all the copies' gradients (a spurious
    all-reduce of a replicated weight's gradient), so the stored block's
    gradient comes out tp times too large;
  - ``split_k_own_max``: decode's split-K combine without the all-reduce of
    the partials' maxima, each shard weighing its partial by its own;
  - ``split_k_dropped_partial``: the first shard's partial dropped from
    the split-K sums (its slots' keys never count);
  - ``new_key_on_every_shard``: decode's new key and value written by every
    shard at its own local slot ``slot % S_loc``, not by the owner of the
    slot alone;
  - ``state_blocks_rotated``: the SSM decode's new state blocks each
    written to the next shard's block (an off-by-one in the blocks'
    order), the one decode fault above that reaches xlstm, which has no
    attention.

* ``float64_port(lm)``: the port's arithmetic in float64 while active, for
  the SSM and hybrid families on the CPU (no attention kernel takes
  float64).  Its float32 steps, the cache's states included, are written
  against each module's ``f32`` and ``lm.dtype``; both become float64, so
  the same code on float64 weights rounds at float64.  Where
  float32's rounding is amplified past a bound (full-width xlstm at
  depth), the sharded and unsharded programs in float64 still agree to
  far below it unless the layout is wrong.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.models.lm import cache, layers, model
from repro_torch.models.lm import ssm as ssm_lib
from repro_torch.models.lm.sharding import Sharded
from repro_torch.train import step

__all__ = ["FAULTS", "float64_port", "planted"]


def _norm_over_own_slice(real):
    return lambda rules, ys, ws, width, eps, split: [
        layers.rms_norm(y, w, eps) for y, w in zip(ys, ws)]


def _p_split_without_gather(real):
    def head_columns(rules, leaf, xs, p_dim):
        got, firsts = real(rules, leaf, xs, p_dim)
        if got is xs:
            return got, firsts
        offs, total = leaf.offsets(-1), leaf.shape[-1]
        return ([F.pad(x, (o, total - o - x.shape[-1])) for x, o in zip(xs, offs)],
                [0] * len(xs))

    return head_columns


def _replicated_grad_summed(real):
    def locals_(self):
        xs = real(self)
        if self.split_dim() is not None:
            return xs
        out = list(xs)
        for grp in self.mesh.groups(self.tp_axis):
            total = sum(xs[n] for n in grp)
            for n in grp:
                out[n] = xs[n].detach() + (total - total.detach())
        return out

    return locals_


def _split_k_own_max(real):
    return lambda rules, ms: list(ms)


def _split_k_dropped_partial(real):
    def split_k_sum(rules, parts):
        parts = list(parts)
        parts[0] = torch.zeros_like(parts[0])
        return real(rules, parts)

    return split_k_sum


def _state_blocks_rotated(real):
    return lambda blocks, new: real(blocks, list(new[1:]) + list(new[:1]))


def _new_key_on_every_shard(real):
    def write_slot(blocks, offsets, slot, new):
        for blk, x in zip(blocks, new):
            blk[:, slot % blk.shape[1]] = x.to(blk.dtype)

    return write_slot


# fault -> (owner, attribute, the faulty attribute made from the real one)
FAULTS = {
    "norm_over_own_slice": (ssm_lib, "_rms_norm_shards", _norm_over_own_slice),
    "p_split_without_gather": (ssm_lib, "_head_columns", _p_split_without_gather),
    "replicated_grad_summed": (Sharded, "locals", _replicated_grad_summed),
    "split_k_own_max": (layers, "_global_max", _split_k_own_max),
    "split_k_dropped_partial": (layers, "_split_k_sum", _split_k_dropped_partial),
    "new_key_on_every_shard": (layers, "_write_slot", _new_key_on_every_shard),
    "state_blocks_rotated": (ssm_lib, "_write", _state_blocks_rotated),
}


@contextlib.contextmanager
def planted(fault: str):
    owner, name, make = FAULTS[fault]
    real = getattr(owner, name)
    setattr(owner, name, make(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


@contextlib.contextmanager
def float64_port(lm):
    """``lm`` and the port's modules compute in float64 while active (its
    weights must be cast by the caller)."""
    modules = (ssm_lib, model, layers, step, cache)
    saved = [m.f32 for m in modules], lm.dtype
    for m in modules:
        m.f32 = torch.float64
    lm.dtype = torch.float64
    try:
        yield
    finally:
        for m, f in zip(modules, saved[0]):
            m.f32 = f
        lm.dtype = saved[1]
