"""Serving state: ``repro/models/lm/cache.py``, all six families.

Cache layouts (leading stacked-layer axes first):

* dense / vlm / moe : {"k","v": (L, B, S, Hkv, hd), "pos"}
* deepseek (MLA)    : {"ckv": (L, B, S, kv_lora), "kpe": (L, B, S, rope), "pos"}
* hybrid (zamba2)   : {"conv": (G, per, B, K-1, C), "ssm": (G, per, B, H, N, P)
                       float32, "k","v": (G, B, W, Hkv, hd), "pos"}: a ring of
                       W slots for the shared attention block
* ssm (xlstm)       : {"mC": (G, M, B, H, P, P), "mn", "mm", "sc", "sn", "sm",
                       "sh", "pos"}, float32
* audio (seamless)  : {"k","v": self-attention, "ck","cv": (L, B, S_enc, Hkv,
                       hd), "pos"}

``pos`` is a Python int: decode runs eagerly, so the capacity guard reads
it without a synchronisation.  The guard covers the absolute-slot caches
(dense, VLM, MoE, audio) only, as in the reference: the hybrid's ring wraps
and the xLSTM's state is O(1).  ``decode_step`` writes each layer's slot or
state in place and returns the same dict with ``pos + 1``; prefill writes
each layer's keys, values and states straight into the cache.

The hybrid's ring is the reference's, quirks included: prefill sizes it to
``w = min(sliding_window or S, S)`` and keeps the last w keys, and decode
writes slot ``pos % w``.  So below the window (S < W) the first decode
step overwrites position 0, and past it with S % W ≠ 0 the slots are
misaligned with ``pos % W``; ``init_cache`` sizes its ring by ``max_seq``
instead (ROADMAP Queue 3).

The cached prefill is the model's own forward (``LM._forward``) with a
:class:`CacheSink`, to which each block hands its keys, values or final
states, and :func:`decode_step` runs the blocks' decode
(``layers.attention_block_decode_shards`` and its MLA and cross-attention
siblings, ``ssm.*_decode_shards``), with or without sharding rules: with
none, on one shard, the sink writes into the plain tensors of the layout
above and each decode block is the unsharded step.  Over a mesh of shards
(under ``sharding.use_rules``, with the parameters of
``sharding.shard_params``) the cache is a dict of ``sharding.Sharded``
leaves placed leaf for leaf by ``cache_pspecs`` (the batch on the data axes
where it divides, the cached sequence of every k, v, ``ckv`` and ``kpe`` on
"model", the SSM and conv states split as the spec says, ``ck``, ``cv``
whole) and the Python int ``pos``; ``sharding.gather_cache`` gives the
layout above again, ``init_cache`` places an empty one, and the decode's
attention reduces over the cached sequence split over "model" (split-K).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.lm import ssm as ssm_lib
from repro_torch.models.lm.collectives import all_gather, all_to_all
from repro_torch.models.lm.layers import (
    attention_block_decode_shards,
    cross_attention_decode_shards,
    glu_ffn_shards,
    mla_block_decode_shards,
)
from repro_torch.models.lm.model import stacked
from repro_torch.models.lm.sharding import Sharded, active_rules, empty_cache, split_batch

__all__ = ["DECODE_RESERVE", "CacheSink", "build_prefill_cache", "decode_step", "init_cache"]

f32 = torch.float32
# Decode slots reserved past the prefill length when the caller does not pass
# an explicit ``max_seq``.  Positions past ``pos`` are masked in attention, so
# the zero padding never leaks into logits.
DECODE_RESERVE = 64


def _leaves(model, batch: int, max_seq: int) -> dict:
    """Cache leaf -> (shape, type, fill) of an empty cache (the reference's
    ``init_cache``)."""
    cfg, dt = model.cfg, model.dtype
    fam = cfg.family
    kv = (cfg.n_kv_heads, cfg.resolved_head_dim)
    if fam == "hybrid":
        s = cfg.ssm
        per = cfg.attn_every
        g = cfg.n_layers // per
        di = s.expand * cfg.d_model
        w = min(cfg.sliding_window or max_seq, max_seq)
        return {"conv": ((g, per, batch, s.d_conv - 1, di + 2 * s.d_state), dt, 0.0),
                "ssm": ((g, per, batch, di // s.head_dim, s.d_state, s.head_dim), f32, 0.0),
                "k": ((g, batch, w, *kv), dt, 0.0), "v": ((g, batch, w, *kv), dt, 0.0)}
    if fam == "ssm":
        s = cfg.ssm
        g, m = cfg.n_layers // s.slstm_every, s.slstm_every - 1
        h, d = cfg.n_heads, cfg.d_model
        p_dim = s.expand * d // h
        return {"mC": ((g, m, batch, h, p_dim, p_dim), f32, 0.0),
                "mn": ((g, m, batch, h, p_dim), f32, 0.0),
                "mm": ((g, m, batch, h), f32, -1e30),
                "sc": ((g, batch, d), f32, 0.0), "sn": ((g, batch, d), f32, 0.0),
                "sm": ((g, batch, d), f32, -1e30), "sh": ((g, batch, d), f32, 0.0)}
    n_layers = cfg.n_layers
    if cfg.mla:
        per_token = {"ckv": (cfg.mla.kv_lora,), "kpe": (cfg.mla.rope_dim,)}
    else:
        per_token = {"k": kv, "v": kv}
    leaves = {name: ((n_layers, batch, max_seq, *shape), dt, 0.0)
              for name, shape in per_token.items()}
    if fam == "audio":
        enc = (n_layers, batch, cfg.n_frontend_tokens, *kv)
        leaves.update(ck=(enc, dt, 0.0), cv=(enc, dt, 0.0))
    return leaves


def _empty(rules, leaves: dict, batch: int, device, written=()) -> dict:
    """An empty cache of ``leaves`` (name -> (shape, type, fill)): placed on
    the mesh of ``rules``, else plain tensors on ``device``, those that the
    caller writes whole (``written``) left unfilled; ``pos`` 0."""
    if rules is not None:
        cache = empty_cache(rules, leaves, batch)
    else:
        cache = {name: torch.empty(shape, dtype=dtype, device=device) if name in written
                 else torch.full(shape, fill, dtype=dtype, device=device)
                 for name, (shape, dtype, fill) in leaves.items()}
    cache["pos"] = 0
    return cache


def init_cache(model, batch: int, max_seq: int, device=None) -> dict:
    """An empty cache of ``max_seq`` positions on ``device`` (default the
    card); under sharding rules placed on their mesh's devices instead
    (``device`` unused)."""
    rules = active_rules()
    dev = None if rules is not None else resolve_device(device)
    return _empty(rules, _leaves(model, batch, max_seq), batch, dev)


# ==========================================================================
# prefill
# ==========================================================================
def _cache_len(s: int, max_seq: int | None) -> int:
    """The reference's ``_pad_seq`` length: ``max_seq`` (default s +
    ``DECODE_RESERVE``), never below the prefill length s."""
    target = s + DECODE_RESERVE if max_seq is None else max_seq
    return max(s, target)


class CacheSink:
    """Where the blocks of the cached prefill (``LM._forward``) leave their
    keys, values and final states, one tensor a shard: it lays each out in
    ``cache`` at the layer that :meth:`at` names.  Over a mesh (``rules``)
    the leaves are ``sharding.Sharded``, placed by ``cache_pspecs``, and each
    block is written by its home shard (a block that several shards share
    gets the same values from each); with no rules they are plain tensors,
    written by the one shard."""

    def __init__(self, rules, cache: dict, batch_split: bool, layer: tuple = ()):
        self.rules, self.cache, self.batch_split, self.layer = rules, cache, batch_split, layer

    def at(self, *layer) -> "CacheSink":
        """The sink for the leaves' layer ``layer`` (their leading indices)."""
        return CacheSink(self.rules, self.cache, self.batch_split, layer)

    def _leaf(self, name: str):
        leaf = self.cache[name]
        for i in self.layer:
            leaf = leaf[i]
        return leaf

    @staticmethod
    def _write(leaf, xs: list) -> None:
        if not isinstance(leaf, Sharded):
            blocks, homes, spec = [leaf], [True], "whole"
        else:
            blocks, homes, spec = leaf.own(), leaf.homes(), leaf.spec
        for blk, home, x in zip(blocks, homes, xs):
            if tuple(x.shape) != tuple(blk.shape):
                raise ValueError(f"a block of shape {tuple(x.shape)} for the cache's "
                                 f"{tuple(blk.shape)} (spec {spec})")
            if home:
                blk.copy_(x)

    def put(self, name: str, xs: list) -> None:
        """Each shard's block of ``name``, already in the cache's layout."""
        self._write(self._leaf(name), xs)

    def put_cut(self, name: str, xs: list) -> None:
        """Each shard's whole tensor of ``name`` (its rows): the block of the
        dim that the leaf splits over "model" is cut out."""
        leaf = self._leaf(name)
        d = leaf.split_dim() if isinstance(leaf, Sharded) else None
        if d is not None:
            size = leaf.shape[d] // leaf.grid[d]
            xs = [x.narrow(d, off, size) for x, off in zip(xs, leaf.offsets(d))]
        self._write(leaf, xs)

    def put_seq(self, name: str, xs: list, *, heads_split: bool) -> None:
        """Each shard's (B_loc, S, ...) keys of ``name`` for its rows: the last
        positions that the leaf's sequence holds (the hybrid's ring keeps the
        last w), the slots past them zero, as ``_cache_len`` pads; where
        ``heads_split`` (a shard holds its block of the KV heads) re-split
        from heads to sequence blocks by one all-to-all over "model", else
        (every head on every shard) cut to the shard's sequence block.  With
        no rules they are written into their slots of the zeroed leaf."""
        leaf = self._leaf(name)
        cap = leaf.shape[1]
        if not isinstance(leaf, Sharded):
            x = xs[0] if xs[0].shape[1] <= cap else xs[0][:, -cap:]
            leaf[:, :x.shape[1]] = x
            return
        xs = [x[:, -cap:] for x in xs]
        if xs[0].shape[1] < cap:
            xs = [torch.cat([x, x.new_zeros((x.shape[0], cap - x.shape[1], *x.shape[2:]))], dim=1)
                  for x in xs]
        if heads_split:
            xs = all_to_all(xs, self.rules.mesh, self.rules.tp_axis, split_dim=1, concat_dim=2)
            self._write(leaf, xs)
        else:
            self.put_cut(name, xs)

    def put_whole(self, name: str, xs: list, *, heads_split: bool) -> None:
        """A replicated leaf (the audio's cross cache) from each shard's KV
        heads of its rows: gathered over "model" where the heads are split
        and over the data axes where the rows are."""
        rules = self.rules
        if heads_split:
            xs = all_gather(xs, rules.mesh, rules.tp_axis, dim=2)
        if self.batch_split and rules is not None and rules.dp() > 1:
            xs = all_gather(xs, rules.mesh, rules.axis("batch"), dim=0)
        self._write(self._leaf(name), xs)


def build_prefill_cache(model, params, tokens, frontend=None, max_seq=None):
    """Run the full-sequence forward, returning (last logits, decode cache).

    ``max_seq`` bounds the total sequence (prefill + decode steps) that an
    absolute-slot cache can hold; defaults to ``prefill_len +
    DECODE_RESERVE``.  The VLM prepends ``frontend @ frontend_adapter`` to
    the token embeddings; the audio family encodes ``frontend`` and
    attends to it.  The SSM and hybrid families ignore ``max_seq``.  The
    cache is an empty one of these sizes (placed by ``cache_pspecs`` under
    sharding rules, over their mesh), filled by the forward's blocks through
    a :class:`CacheSink`.
    """
    rules = active_rules()
    cfg = model.cfg
    fam = cfg.family
    b, s = tokens.shape
    if fam == "vlm" and frontend is not None:
        s += frontend.shape[1]
    if fam == "hybrid":
        # the reference's ring: the last w keys, w = min(window or s, s) (module docstring)
        leaves = _leaves(model, b, min(cfg.sliding_window or s, s))
    elif fam == "ssm":
        leaves = _leaves(model, b, s)
    else:
        leaves = _leaves(model, b, _cache_len(s, max_seq))
    if fam == "audio":
        shape, dt, fill = leaves["ck"]
        enc = (*shape[:2], frontend.shape[1], *shape[3:])
        leaves.update(ck=(enc, dt, fill), cv=(enc, dt, fill))
    batch_split = rules is None or b % rules.dp() == 0
    xs = model._embed(rules, params["embed"], split_batch(rules, tokens))
    # every state, ring slot and cross key is written; absolute slots past s stay zero
    written = set(leaves) if fam in ("ssm", "hybrid") else {"ck", "cv"}
    cache = _empty(rules, leaves, b, xs[0].device, written)
    hs = model._forward(params, xs, frontend, batch_split,
                        sink=CacheSink(rules, cache, batch_split))
    cache["pos"] = s
    return model._last_logits(params, hs, batch_split), cache


# ==========================================================================
# decode step
# ==========================================================================
def _check_cache_capacity(pos: int, limit: int) -> None:
    """Refuse writes past the cache's sequence capacity."""
    if pos >= limit:
        raise ValueError(
            f"KV cache exhausted: decode position {pos} >= capacity {limit}; "
            f"re-prefill with a larger max_seq (see cache.DECODE_RESERVE)"
        )


def decode_step(model, params, cache, tokens):
    """tokens (B, 1) -> (logits (B, Vp), the cache updated in place); under
    sharding rules over their mesh, on a placed cache (module docstring)."""
    cfg = model.cfg
    pos = cache["pos"]
    fam = cfg.family
    if fam not in ("ssm", "hybrid"):
        # the global capacity: a placed leaf's shape is the whole leaf's
        _check_cache_capacity(pos, cache["ckv" if cfg.mla else "k"].shape[2])
    rules = active_rules()
    if rules is not None:
        bad = [name for name, leaf in cache.items()
               if name != "pos" and not isinstance(leaf, Sharded)]
        if bad:
            raise TypeError(f"decode_step under sharding rules takes a placed cache "
                            f"(sharding.shard_cache or init_cache under the rules); "
                            f"{bad} are not")
    batch_split = rules is None or tokens.shape[0] % rules.dp() == 0
    xs = model._embed(rules, params["embed"], split_batch(rules, tokens))
    step = {"ssm": _decode_ssm_shards, "hybrid": _decode_hybrid_shards,
            "audio": _decode_audio_shards}.get(fam, _decode_attn_shards)
    xs = step(model, rules, params, cache, xs, pos, batch_split)
    cache["pos"] = pos + 1
    return model._last_logits(params, xs, batch_split), cache


def _residual(xs: list, ys: list) -> list:
    return [x + y for x, y in zip(xs, ys)]


def _decode_attn_shards(model, rules, params, cache, xs, pos, batch_split):
    cfg = model.cfg
    for i, bp in enumerate(model.layers(params)):
        hs = model._norm(xs, bp["ln1"])
        if cfg.mla:
            a = mla_block_decode_shards(rules, bp["attn"], hs, cache["ckv"][i], cache["kpe"][i],
                                        pos, cfg)
        else:
            a = attention_block_decode_shards(rules, bp["attn"], hs, cache["k"][i],
                                              cache["v"][i], pos, cfg)
        xs = model._ffn(rules, bp, _residual(xs, a), batch_split)
    return xs


def _decode_hybrid_shards(model, rules, params, cache, xs, pos, batch_split):
    cfg = model.cfg
    shared = params["shared_block"]
    w = cache["k"].shape[2]
    for g, (mamba, _) in enumerate(model.groups(params)):
        for j, mp in enumerate(stacked(mamba)):
            xs = _residual(xs, ssm_lib.mamba2_decode_shards(
                rules, mp["cell"], model._norm(xs, mp["ln"]), cache["conv"][g][j],
                cache["ssm"][g][j], cfg))
        a = attention_block_decode_shards(rules, shared["attn"], model._norm(xs, shared["ln1"]),
                                          cache["k"][g], cache["v"][g], pos, cfg, window=w)
        xs = model._ffn(rules, shared, _residual(xs, a), batch_split)
    return xs


def _decode_ssm_shards(model, rules, params, cache, xs, pos, batch_split):
    cfg = model.cfg
    for g, (mlstm, slstm) in enumerate(model.groups(params)):
        for j, mp in enumerate(stacked(mlstm)):
            state = tuple(cache[name][g][j] for name in ("mC", "mn", "mm"))
            xs = _residual(xs, ssm_lib.mlstm_decode_shards(
                rules, mp["cell"], model._norm(xs, mp["ln"]), state, cfg))
        state = tuple(cache[name][g] for name in ("sc", "sn", "sm", "sh"))
        xs = _residual(xs, ssm_lib.slstm_decode_shards(
            rules, slstm["cell"], model._norm(xs, slstm["ln"]), state, cfg))
    return xs


def _decode_audio_shards(model, rules, params, cache, xs, pos, batch_split):
    cfg = model.cfg
    for i, bp in enumerate(stacked(params["dec_blocks"])):
        xs = _residual(xs, attention_block_decode_shards(
            rules, bp["self_attn"], model._norm(xs, bp["ln1"]), cache["k"][i],
            cache["v"][i], pos, cfg))
        xs = _residual(xs, cross_attention_decode_shards(
            rules, bp["cross_attn"], model._norm(xs, bp["ln_x"]), cache["ck"][i],
            cache["cv"][i], batch_split))
        xs = _residual(xs, glu_ffn_shards(rules, bp["ffn"], model._norm(xs, bp["ln2"]), cfg.act))
    return xs
