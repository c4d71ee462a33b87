"""Mixture-of-Experts FFN: ``repro/models/lm/moe.py``, token-choice top-k.

Two dispatch backends, as in the reference:

* ``moe_ffn_einsum`` — GShard-style grouped one-hot einsum dispatch (the
  LM's default): tokens in groups of ``cfg.group_size``, each (token, k)
  placed in its expert's queue by an exclusive cumulative sum of one-hots;
* ``moe_ffn_sorted`` — sort-based ragged dispatch: a stable sort by expert,
  the kept rows copied into (E, C, D) buffers, batched expert products, the
  contributions gathered back.

Both keep capacity ``C = ⌊tokens·top_k / E · capacity_factor⌋`` (at least
1) and drop a (token, k) that comes past it, first come first served in
(token, k) order, with renormalised top-k gates.  The router runs in
float32 (its weight is float32 in every model).  The expert products are
``torch.matmul`` / ``einsum``: the reference has no Pallas MoE kernel.

Determinism on the card: the reference's ``y.at[tok_s].add(contrib)``
has ``top_k`` writers a token, which ``index_add_`` would make atomic and
its order vary from run to run.  Here the contributions are gathered back
into (token, expert) order and summed over k in a fixed order (increasing
expert id, the order the stable sort gives them), so a run is bitwise the
next.

Over a mesh of shards (:func:`moe_ffn_shards`) the layout is the
reference's rules': its dense-FFN patterns ``(w_gate|w_up)$`` and
``w_down$`` match the expert leaves before the expert patterns do, so every
shard holds every expert and a 1/tp slice of each expert's hidden width
(``d_ff_expert``), and the shared experts' width likewise.  Each shard
routes its own tokens (the router is replicated), dispatches them to all
experts, runs the expert products on its slice and combines a partial
output; the partials, routed and shared, are summed by one all-reduce over
"model".  Capacity is the whole batch's, as GSPMD keeps the unsharded
program's meaning: where the batch is split over the data axes, a shard's
queue positions start after those that the tokens of the data shards
before it took (their per-expert counts, exchanged by an all-gather).
:func:`moe_ffn` is the one shard of :func:`moe_ffn_shards`.
"""
from __future__ import annotations

from dataclasses import replace

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.lm.layers import _normal, shard_dicts
from repro_torch.models.lm.sharding import split_dim_of

__all__ = ["capacity", "dropless", "init_moe", "moe_ffn", "moe_ffn_einsum", "moe_ffn_shards",
           "moe_ffn_sorted"]

f32 = torch.float32


def init_moe(generator: torch.Generator, d: int, cfg: MoEConfig, dtype, lead=()) -> dict:
    """MoE parameters, with leading axes ``lead``; the router in float32."""
    e, fe = cfg.n_experts, cfg.d_ff_expert
    lead = tuple(lead)
    p = {
        "router": _normal(generator, (*lead, d, e), d ** -0.5).to(f32),
        "w_gate": _normal(generator, (*lead, e, d, fe), d ** -0.5).to(dtype),
        "w_up": _normal(generator, (*lead, e, d, fe), d ** -0.5).to(dtype),
        "w_down": _normal(generator, (*lead, e, fe, d), fe ** -0.5).to(dtype),
    }
    if cfg.n_shared:
        fs = max(cfg.d_ff_shared, cfg.d_ff_expert) * cfg.n_shared
        p["shared"] = {
            "w_gate": _normal(generator, (*lead, d, fs), d ** -0.5).to(dtype),
            "w_up": _normal(generator, (*lead, d, fs), d ** -0.5).to(dtype),
            "w_down": _normal(generator, (*lead, fs, d), fs ** -0.5).to(dtype),
        }
    return p


def _router(p, x_flat: torch.Tensor, cfg: MoEConfig):
    """Top-k routing with renormalised gates; router math in float32."""
    logits = x_flat.to(f32) @ p["router"]                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)        # (T, K), sorted
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx


def _silu(g: torch.Tensor, dtype) -> torch.Tensor:
    return F.silu(g.to(f32)).to(dtype)


def _expert_gemm(p, h: torch.Tensor, act_dtype) -> torch.Tensor:
    """(E, C, D) -> (E, C, D) batched SwiGLU expert FFN."""
    g = torch.bmm(h, p["w_gate"])
    u = torch.bmm(h, p["w_up"])
    return torch.bmm(_silu(g, act_dtype) * u, p["w_down"])


def _shared_ffn(p, x: torch.Tensor) -> torch.Tensor:
    sp = p["shared"]
    g = _silu(x @ sp["w_gate"], x.dtype)
    return (g * (x @ sp["w_up"])) @ sp["w_down"]


def capacity(tokens: int, cfg: MoEConfig) -> int:
    """An expert's queue length for ``tokens`` tokens (the reference's float formula)."""
    return max(int(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 1)


def dropless(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with a capacity factor of 1.01·E/top_k: every expert's queue
    holds at least all the tokens of a call (or group), so no (token, k) is
    dropped.  Prefill and decode then agree whatever their token counts."""
    m = cfg.moe
    return replace(cfg, moe=replace(m, capacity_factor=1.01 * m.n_experts / m.top_k))


def einsum_queues(idx: torch.Tensor, n_experts: int, cap: int, offset=None):
    """Queue positions of the grouped dispatch.  idx (G, g, K) -> (positions
    (G, g, K, E) float32, kept (G, g, K, E) bool): a (token, k)'s place in
    its expert's queue within the group, counted in (token, k) order, and
    whether it is below ``cap``.

    ``offset`` (G, E), where given, is each queue's length before the group's
    first place here (the places that tokens of the group held by earlier
    data shards took); an index below 0 then marks an empty place (another
    shard's token), which no queue counts."""
    n_groups, gsz, k = idx.shape
    onehot = F.one_hot(idx.clamp(min=0), n_experts).to(f32)  # (G,g,K,E)
    if offset is not None:
        onehot = onehot * (idx >= 0)[..., None]
    flat = onehot.reshape(n_groups, gsz * k, n_experts)
    pos = torch.cumsum(flat, dim=1).reshape(onehot.shape) - onehot  # exclusive
    if offset is not None:
        pos = pos + offset[:, None, None, :]
    return pos, (pos < cap) & (onehot > 0)


def _einsum_dispatch(p, xg: torch.Tensor, gates: torch.Tensor, pos, within, cap: int):
    """The routed experts' output of the grouped dispatch, (G, g, D), from the
    groups' tokens xg (G, g, D), their gates (G, g, K) and queues
    (:func:`einsum_queues`); ``p``'s expert leaves may hold a slice of
    ``d_ff_expert`` (a partial output then).

    The (G, g, K, E, C) one-hots of the reference are built by one scatter
    of the kept (token, k)'s into zeros of the model's type: the same 0/1
    tensor, without ``one_hot``'s int64 intermediate."""
    keep = torch.zeros((*pos.shape, cap), dtype=xg.dtype, device=xg.device)  # (G,g,K,E,C)
    slot = pos.to(torch.int64).clamp(max=cap - 1)[..., None]
    keep.scatter_(-1, slot, within[..., None].to(xg.dtype))
    dispatch = keep.sum(2)                                   # (G,g,E,C)
    combine = (gates[..., None, None].to(xg.dtype) * keep).sum(2)
    del keep
    h = torch.einsum("gtec,gtd->gecd", dispatch, xg)         # (G,E,C,D)
    hg = torch.einsum("gecd,edf->gecf", h, p["w_gate"])
    hu = torch.einsum("gecd,edf->gecf", h, p["w_up"])
    out = torch.einsum("gecf,efd->gecd", _silu(hg, xg.dtype) * hu, p["w_down"])
    return torch.einsum("gtec,gecd->gtd", combine, out)      # (G,g,D)


def sorted_queues(idx: torch.Tensor, n_experts: int, cap: int, offset=None):
    """The sorted dispatch's queues.  idx (T, K) -> (order (T·K,), the stable
    sort of the flat (token, k)'s by expert; slot (T·K,) in the (E·C + 1)
    buffer, E·C for a dropped one; keep (T·K,) bool), the last two in sorted
    order.  ``offset`` (E,), where given, is each queue's length before the
    first (token, k) here (the choices of earlier data shards' tokens)."""
    t, k = idx.shape
    e_flat = idx.reshape(t * k)
    order = torch.argsort(e_flat, stable=True)
    e_s = e_flat[order]
    counts = torch.bincount(e_flat, minlength=n_experts)
    seg_start = torch.cumsum(counts, 0) - counts             # (E,)
    pos = torch.arange(t * k, device=idx.device) - seg_start[e_s]
    if offset is not None:
        pos = pos + offset[e_s]
    keep = pos < cap
    slot = torch.where(keep, e_s * cap + pos, n_experts * cap)
    return order, slot, keep


def _sorted_dispatch(p, xt: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor, cap: int,
                     offset=None) -> torch.Tensor:
    """The routed experts' output of the sorted dispatch, (T, D), from the
    tokens xt (T, D) and their routing (T, K); ``p``'s expert leaves may hold
    a slice of ``d_ff_expert`` (a partial output then)."""
    t, d = xt.shape
    k, e = idx.shape[1], p["w_gate"].shape[0]
    order, slot, keep = sorted_queues(idx, e, cap, offset)
    tok_s = order // k
    g_s = gates.reshape(t * k)[order]

    # at most one writer a kept slot: a plain indexed copy
    buf = torch.zeros((e * cap, d), dtype=xt.dtype, device=xt.device)
    buf[slot[keep]] = xt[tok_s[keep]]
    out = _expert_gemm(p, buf.reshape(e, cap, d), xt.dtype).reshape(e * cap, d)
    contrib = out[torch.clamp(slot, max=e * cap - 1)] * (
        g_s * keep.to(f32)
    )[:, None].to(xt.dtype)
    # back to (token, k) order, then each token's k in increasing expert id
    back = torch.empty_like(contrib)
    back[order] = contrib
    by_expert = torch.argsort(idx, dim=-1)                    # (T,K)
    back = back.reshape(t, k, d).gather(1, by_expert[..., None].expand(t, k, d))
    y = back[:, 0]
    for j in range(1, k):
        y = y + back[:, j]
    return y


def moe_ffn(p: dict, x: torch.Tensor, cfg: MoEConfig, backend: str = "einsum"):
    """The routed experts (and the shared ones) of ``x`` (B, S, D): the one
    shard of :func:`moe_ffn_shards`."""
    return moe_ffn_shards(None, p, [x], cfg, backend)[0]


def moe_ffn_einsum(p: dict, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """GShard grouped-einsum dispatch.  x: (B, S, D) -> (B, S, D)."""
    return moe_ffn(p, x, cfg, "einsum")


def moe_ffn_sorted(p: dict, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Sort-based ragged dispatch (no dispatch matmul).  x: (B, S, D)."""
    return moe_ffn(p, x, cfg, "sorted")


# --------------------------------------------------------------------------
# Over a mesh of shards (tensor parallel over d_ff_expert), or one shard
# --------------------------------------------------------------------------
def _earlier_counts(rules, counts: list) -> list:
    """Each shard's exclusive sum, over the data shards before it, of the
    per-expert counts ``counts`` (one integer tensor a shard): all-gathered
    over the data axes, then summed up to the shard's own data index."""
    from repro_torch.models.lm.collectives import all_gather

    mesh, dp_axis = rules.mesh, rules.axis("batch")
    gathered = all_gather([c[None] for c in counts], mesh, dp_axis, dim=0)
    return [g[:mesh.axis_index(coord, dp_axis)].sum(0)
            for coord, g in zip(mesh.coords, gathered)]


def _einsum_shards(rules, leaves: list, hs: list, cfg: MoEConfig, batch_split: bool) -> list:
    """Each shard's routed partial by the grouped dispatch, its tokens queued
    at their places in the whole batch's groups (one shard: the batch's
    groups)."""
    b_loc, s, d = hs[0].shape
    t_loc = b_loc * s
    dp = rules.dp() if batch_split and rules is not None else 1
    t = t_loc * dp
    gsz = min(cfg.group_size, t)
    if t % gsz:
        raise ValueError(f"tokens {t} not divisible by group {gsz}")
    cap, e, k = capacity(gsz, cfg), cfg.n_experts, cfg.top_k
    # a group spans two data shards: each shard lays its tokens out at their
    # places in its groups, the other shards' places empty (index -1, zero
    # rows), and the counts of the shards before it offset its queues
    straddle = t_loc % gsz != 0
    placed, counts = [], []
    for n, (p, h) in enumerate(zip(leaves, hs)):
        lead = g0 = 0
        if straddle:
            x = h.reshape(t_loc, d)
            gates, idx = _router(p, x, cfg)
            t0 = rules.mesh.axis_index(rules.mesh.coords[n], rules.axis("batch")) * t_loc
            lead, g0 = t0 % gsz, t0 // gsz
            pad = (0, 0, lead, -(lead + t_loc) % gsz)
            x, gates, idx = F.pad(x, pad), F.pad(gates, pad), F.pad(idx, pad, value=-1)
            mine = F.one_hot(idx.clamp(min=0), e) * (idx >= 0)[..., None]
            count = idx.new_zeros((t // gsz, e))
            count[g0:g0 + idx.shape[0] // gsz] = mine.reshape(-1, gsz * k, e).sum(1)
            counts.append(count)
            xg = x.reshape(-1, gsz, d)
        else:
            xg = h.reshape(-1, gsz, d)
            gates, idx = _router(p, xg.reshape(t_loc, d), cfg)
        n_loc = xg.shape[0]
        placed.append((lead, g0, xg, gates.reshape(n_loc, gsz, k), idx.reshape(n_loc, gsz, k)))
    before = _earlier_counts(rules, counts) if straddle else [None] * len(hs)
    outs = []
    for p, off, (lead, g0, xg, gates, idx) in zip(leaves, before, placed):
        if off is not None:
            off = off[g0:g0 + xg.shape[0]].to(f32)
        pos, within = einsum_queues(idx, e, cap, off)
        y = _einsum_dispatch(p, xg, gates, pos, within, cap)
        if straddle:
            y = y.reshape(-1, d)[lead:lead + t_loc]
        outs.append(y.reshape(b_loc, s, d))
    return outs


def _sorted_shards(rules, leaves: list, hs: list, cfg: MoEConfig, batch_split: bool) -> list:
    """Each shard's routed partial by the sorted dispatch: the whole batch's
    capacity, its queues offset by the earlier data shards' choices."""
    b_loc, s, d = hs[0].shape
    t_loc = b_loc * s
    dp = rules.dp() if batch_split and rules is not None else 1
    cap = capacity(t_loc * dp, cfg)
    xts = [h.reshape(t_loc, d) for h in hs]
    routed = [_router(p, xt, cfg) for p, xt in zip(leaves, xts)]
    if dp > 1:
        before = _earlier_counts(rules, [torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
                                         for _, idx in routed])
    else:
        before = [None] * len(hs)
    return [_sorted_dispatch(p, xt, gates, idx, cap, off).reshape(b_loc, s, d)
            for p, xt, (gates, idx), off in zip(leaves, xts, routed, before)]


def moe_ffn_shards(rules, p: dict, hs: list, cfg: MoEConfig, backend: str = "einsum", *,
                   batch_split: bool = True) -> list:
    """:func:`moe_ffn` over the shards of ``rules.mesh`` (module docstring):
    ``p`` holds ``sharding.Sharded`` leaves, ``hs`` one (B_loc, S, D) input a
    shard, each the rows of its data shard where ``batch_split`` (else every
    row); returns one output a shard.  The routed and shared partials are
    summed by one all-reduce over "model"; a leaf that the divisibility guard
    replicated gives a whole output, added after it.  With no rules
    (``rules`` None, ``p`` tensors, ``hs`` one input) it is the one shard."""
    from repro_torch.models.lm.collectives import all_reduce_sum

    leaves = shard_dicts({name: leaf for name, leaf in p.items() if name != "shared"})
    if backend == "einsum":
        routed = _einsum_shards(rules, leaves, hs, cfg, batch_split)
    elif backend == "sorted":
        routed = _sorted_shards(rules, leaves, hs, cfg, batch_split)
    else:
        raise ValueError(backend)
    partial, whole = [], []
    (partial if split_dim_of(p["w_down"]) is not None else whole).append(routed)
    if "shared" in p:
        shared = [_shared_ffn({"shared": sp}, h) for sp, h in zip(shard_dicts(p["shared"]), hs)]
        (partial if split_dim_of(p["shared"]["w_down"]) is not None else whole).append(shared)
    outs = [sum(parts[1:], parts[0]) for parts in zip(*partial)] if partial else None
    if outs is not None:
        outs = all_reduce_sum(outs, rules.mesh, rules.tp_axis)
    for part in whole:
        outs = part if outs is None else [o + y for o, y in zip(outs, part)]
    return outs
