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
"""
from __future__ import annotations

from dataclasses import replace

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.lm.layers import _normal

__all__ = ["capacity", "dropless", "init_moe", "moe_ffn", "moe_ffn_einsum", "moe_ffn_sorted"]

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


def einsum_queues(idx: torch.Tensor, n_experts: int, cap: int):
    """Queue positions of the grouped dispatch.  idx (G, g, K) -> (positions
    (G, g, K, E) float32, kept (G, g, K, E) bool): a (token, k)'s place in
    its expert's queue within the group, counted in (token, k) order, and
    whether it is below ``cap``."""
    n_groups, gsz, k = idx.shape
    onehot = F.one_hot(idx, n_experts).to(f32)               # (G,g,K,E)
    flat = onehot.reshape(n_groups, gsz * k, n_experts)
    pos = torch.cumsum(flat, dim=1).reshape(onehot.shape) - onehot  # exclusive
    return pos, (pos < cap) & (onehot > 0)


def moe_ffn_einsum(p: dict, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """GShard grouped-einsum dispatch.  x: (B, S, D) -> (B, S, D).

    The (G, g, K, E, C) one-hots of the reference are built by one scatter
    of the kept (token, k)'s into zeros of the model's type: the same 0/1
    tensor, without ``one_hot``'s int64 intermediate."""
    b, s, d = x.shape
    t = b * s
    gsz = min(cfg.group_size, t)
    n_groups = t // gsz
    if n_groups * gsz != t:
        raise ValueError(f"tokens {t} not divisible by group {gsz}")
    cap = capacity(gsz, cfg)
    e = cfg.n_experts
    xg = x.reshape(n_groups, gsz, d)

    gates, idx = _router(p, xg.reshape(t, d), cfg)           # (T,K)
    gates = gates.reshape(n_groups, gsz, cfg.top_k)
    idx = idx.reshape(n_groups, gsz, cfg.top_k)
    pos, within = einsum_queues(idx, e, cap)
    keep = torch.zeros((*pos.shape, cap), dtype=x.dtype, device=x.device)  # (G,g,K,E,C)
    slot = pos.to(torch.int64).clamp(max=cap - 1)[..., None]
    keep.scatter_(-1, slot, within[..., None].to(x.dtype))
    dispatch = keep.sum(2)                                   # (G,g,E,C)
    combine = (gates[..., None, None].to(x.dtype) * keep).sum(2)
    del keep
    h = torch.einsum("gtec,gtd->gecd", dispatch, xg)         # (G,E,C,D)
    hg = torch.einsum("gecd,edf->gecf", h, p["w_gate"])
    hu = torch.einsum("gecd,edf->gecf", h, p["w_up"])
    out = torch.einsum("gecf,efd->gecd", _silu(hg, x.dtype) * hu, p["w_down"])
    y = torch.einsum("gtec,gecd->gtd", combine, out)         # (G,g,D)
    y = y.reshape(b, s, d)
    if "shared" in p:
        y = y + _shared_ffn(p, x)
    return y


def sorted_queues(idx: torch.Tensor, n_experts: int, cap: int):
    """The sorted dispatch's queues.  idx (T, K) -> (order (T·K,), the stable
    sort of the flat (token, k)'s by expert; slot (T·K,) in the (E·C + 1)
    buffer, E·C for a dropped one; keep (T·K,) bool), the last two in sorted
    order."""
    t, k = idx.shape
    e_flat = idx.reshape(t * k)
    order = torch.argsort(e_flat, stable=True)
    e_s = e_flat[order]
    counts = torch.bincount(e_flat, minlength=n_experts)
    seg_start = torch.cumsum(counts, 0) - counts             # (E,)
    pos = torch.arange(t * k, device=idx.device) - seg_start[e_s]
    keep = pos < cap
    slot = torch.where(keep, e_s * cap + pos, n_experts * cap)
    return order, slot, keep


def moe_ffn_sorted(p: dict, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Sort-based ragged dispatch (no dispatch matmul).  x: (B, S, D)."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    gates, idx = _router(p, xt, cfg)                          # (T,K)
    k, e = cfg.top_k, cfg.n_experts
    cap = capacity(t, cfg)
    order, slot, keep = sorted_queues(idx, e, cap)
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
    y = y.reshape(b, s, d)
    if "shared" in p:
        y = y + _shared_ffn(p, x)
    return y


def moe_ffn(p: dict, x: torch.Tensor, cfg: MoEConfig, backend: str = "einsum"):
    if backend == "einsum":
        return moe_ffn_einsum(p, x, cfg)
    if backend == "sorted":
        return moe_ffn_sorted(p, x, cfg)
    raise ValueError(backend)
