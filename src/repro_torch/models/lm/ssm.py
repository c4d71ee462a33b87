"""State-space and recurrent blocks: ``repro/models/lm/ssm.py``.

Mamba2 (SSD) for the hybrid family (zamba2) and the xLSTM cells (mLSTM,
sLSTM) for the SSM family (xlstm).  Prefill runs the chunked-parallel forms
(a loop over chunks, ``scan.scan``, where the reference uses ``lax.scan``): within a
chunk the work is batched products, and only the O(L/Q) inter-chunk state
recurrence is sequential.  Decode runs the exact O(1)-per-token recurrence
on the carried state.  The sLSTM is a sequential loop over positions in
both, as in the reference.

These are plain PyTorch on either device: the reference computes them in
``jnp`` and ``lax.scan`` with no Pallas kernel.  Over a mesh of shards
(``sharding.py``), :func:`mamba2_block_shards`, :func:`mlstm_block_shards`
and :func:`slstm_block_shards` run the three blocks tensor-parallel under
the reference's rules, handing a cache sink their final states in the
layout of ``cache_pspecs``, and :func:`mamba2_decode_shards`,
:func:`mlstm_decode_shards` and :func:`slstm_decode_shards` continue from
those states, in place (the two sections at the end of this module).  Each
is one body: with no rules it is the block on one shard, and the
reference's :func:`mamba2_block`, :func:`mamba2_decode`,
:func:`mlstm_block`, :func:`mlstm_decode`, :func:`slstm_block` and
:func:`slstm_decode` call it so.  Numerics follow the
reference: decays in log space and ≤ 0 before exponentiation (Mamba2), or
stabilised by running maxima (mLSTM, sLSTM); states, gates and log
arithmetic in float32.  Where the reference mixes bf16 and float32
operands, JAX promotes them silently; here each is cast explicitly at the
same place (a bf16 value is exact in float32, so "bf16 operands, float32
accumulation" is the float32 product of the bf16 values).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import collectives, scan
from repro_torch.models.lm.layers import _normal, rms_norm
from repro_torch.models.lm.sharding import locals_of, offsets_of, own_of, split_dim_of

__all__ = [
    "init_mamba2",
    "init_mlstm",
    "init_slstm",
    "mamba2_block",
    "mamba2_block_shards",
    "mamba2_decode",
    "mamba2_decode_shards",
    "mlstm_block",
    "mlstm_block_shards",
    "mlstm_decode",
    "mlstm_decode_shards",
    "slstm_block",
    "slstm_block_shards",
    "slstm_decode",
    "slstm_decode_shards",
]

f32 = torch.float32


def _fit_chunk(length: int, chunk: int) -> int:
    """Largest divisor of ``length`` not exceeding ``chunk`` (>=1)."""
    q = min(chunk, length)
    while length % q != 0:
        q -= 1
    return q


def _full(shape, value, dtype, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype, device=device)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (torch's switches to x past 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _chunks(t: torch.Tensor, q: int):
    """(B, L, ...) -> the L/q chunks (B, q, ...) in order."""
    return t.split(q, dim=1)


# ==========================================================================
# Mamba2 / SSD
# ==========================================================================
def init_mamba2(generator: torch.Generator, cfg: ModelConfig, dtype, lead=()) -> dict:
    """Mamba2 parameters with leading axes ``lead``, with the reference's
    stds; ``dt_bias``, ``a_log`` and ``d_skip`` float32 (A = −1 at init)."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    h = di // s.head_dim
    n = s.d_state
    lead = tuple(lead)
    dev = generator.device
    d_in = 2 * di + 2 * n + h  # z, x, B, C, dt
    return {
        "in_proj": _normal(generator, (*lead, d, d_in), d ** -0.5).to(dtype),
        "conv_w": _normal(generator, (*lead, s.d_conv, di + 2 * n), 0.1).to(dtype),
        "conv_b": _full((*lead, di + 2 * n), 0.0, dtype, dev),
        "dt_bias": _full((*lead, h), 0.0, f32, dev),
        "a_log": _full((*lead, h), 0.0, f32, dev),
        "d_skip": _full((*lead, h), 1.0, f32, dev),
        "out_norm": _full((*lead, di), 1.0, dtype, dev),
        "out_proj": _normal(generator, (*lead, di, d), di ** -0.5).to(dtype),
    }


def _split_mamba_proj(proj: torch.Tensor, cfg: ModelConfig):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    h = di // s.head_dim
    n = s.d_state
    z, xbc, dt = proj.split([di, di + 2 * n, h], dim=-1)
    return z, xbc, dt, di, h, n


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, window K.  xbc: (B, L, C); w: (K, C)."""
    k, length = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, :length] * w[0]
    for i in range(1, k):
        out = out + pad[:, i : i + length] * w[i]
    return F.silu((out + b).to(f32)).to(xbc.dtype)


def _ssd_chunked(
    x: torch.Tensor,   # (B, L, H, P)
    dt: torch.Tensor,  # (B, L, H) positive
    a: torch.Tensor,   # (H,) negative
    b_: torch.Tensor,  # (B, L, N)
    c_: torch.Tensor,  # (B, L, N)
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (Mamba2 paper §6) from the zero state; returns
    (y (B, L, H, P), final state (B, H, N, P))."""
    bsz, length, n_heads, p_dim = x.shape
    q = _fit_chunk(length, chunk)
    lga = (dt * a[None, None, :]).to(f32)          # (B,L,H) log-decay <= 0
    xbar = x.to(f32) * dt[..., None]               # (B,L,H,P)
    h = torch.zeros((bsz, n_heads, b_.shape[-1], p_dim), dtype=f32, device=x.device)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))

    def trip(carry, xs):
        (h,), (lg, xc, bc, cc) = carry, xs
        cum = torch.cumsum(lg, dim=1)              # (B,Q,H) inclusive
        cum_t = cum.transpose(1, 2)                # (B,H,Q)
        total = cum_t[:, :, -1]                    # (B,H)
        # ---- intra-chunk (masked decay attention) --------------------------
        scores = cc @ bc.transpose(1, 2)           # (B,Q,Q)
        decay = torch.exp(cum_t[:, :, :, None] - cum_t[:, :, None, :])  # (B,H,Q,Q)
        w = scores[:, None] * torch.where(mask, decay, 0.0)
        y = torch.einsum("bhij,bjhp->bihp", w, xc)
        # ---- inter-chunk (carried state) -----------------------------------
        y = y + torch.einsum("bin,bhnp->bihp", cc, h) * torch.exp(cum)[..., None]
        # ---- state update --------------------------------------------------
        to_end = torch.exp(total[:, None, :] - cum)  # (B,Q,H)
        xw = xc * to_end[..., None]
        h = torch.exp(total)[:, :, None, None] * h + torch.einsum("bjn,bjhp->bhnp", bc, xw)
        return (h,), y

    (h,), ys = scan.scan("ssd", trip, (h,), (_chunks(lga, q), _chunks(xbar, q),
                                             _chunks(b_.to(f32), q), _chunks(c_.to(f32), q)))
    return torch.cat(ys, dim=1), h


def _mamba2_mix(p: dict, proj: torch.Tensor, cfg: ModelConfig, heads: slice):
    """The causal conv and the SSD scan of the Mamba2 heads ``heads`` on the
    whole in-projection ``proj`` (B, L, d_in), each head on its own x
    channels and every head on the shared B and C.  Returns (y (B, L, n·P)
    float32 with the skip, before the gate; the final state (B, n, N, P);
    the conv's input (B, L, n·P + 2N))."""
    s = cfg.ssm
    _, xbc_raw, dtr, di, h, n = _split_mamba_proj(proj, cfg)
    conv_w, conv_b = p["conv_w"], p["conv_b"]
    if heads != slice(0, h):
        cols = slice(heads.start * s.head_dim, heads.stop * s.head_dim)
        xbc_raw, conv_w, conv_b = (torch.cat([t[..., cols], t[..., di:]], dim=-1)
                                   for t in (xbc_raw, conv_w, conv_b))
    xbc = _causal_conv(xbc_raw, conv_w, conv_b)
    width = xbc.shape[-1] - 2 * n
    xs, b_, c_ = xbc.split([width, n, n], dim=-1)
    dt = softplus(dtr[..., heads].to(f32) + p["dt_bias"][heads])      # (B,L,n)
    a = -torch.exp(p["a_log"][heads])
    xh = xs.reshape(*xs.shape[:2], -1, s.head_dim)
    y, h_fin = _ssd_chunked(xh, dt, a, b_, c_, s.chunk)
    y = y + p["d_skip"][heads][None, None, :, None] * xh.to(f32)
    return y.reshape(*xs.shape[:2], width), h_fin, xbc_raw


def mamba2_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *, return_state: bool = False):
    """Full-sequence Mamba2 block (prefill).  x: (B, L, D): the one shard of
    :func:`mamba2_block_shards`.

    With ``return_state`` also returns (final SSM state (B, H, N, P) float32,
    the conv window's tail (B, K−1, di + 2N)): what :func:`mamba2_decode`
    needs to continue the sequence.
    """
    kept = _Kept() if return_state else None
    out = mamba2_block_shards(None, p, [x], cfg, sink=kept)[0]
    if return_state:
        return out, kept.states["ssm"], kept.states["conv"]
    return out


def mamba2_decode(
    p: dict,
    x: torch.Tensor,            # (B, 1, D)
    conv_state: torch.Tensor,   # (B, K-1, di + 2N)
    ssm_state: torch.Tensor,    # (B, H, N, P)
    cfg: ModelConfig,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """O(1) recurrent decode step: (out (B, 1, D), conv state, SSM state), the
    one shard of :func:`mamba2_decode_shards` on copies of the states."""
    conv_state, ssm_state = conv_state.clone(), ssm_state.clone()
    out = mamba2_decode_shards(None, p, [x], conv_state, ssm_state, cfg)[0]
    return out, conv_state, ssm_state


# ==========================================================================
# mLSTM (xLSTM matrix-memory cell), chunkwise-parallel + recurrent
# ==========================================================================
def init_mlstm(generator: torch.Generator, cfg: ModelConfig, dtype, lead=()) -> dict:
    """mLSTM parameters with leading axes ``lead``; the gates' ``w_i``,
    ``w_f``, ``b_i`` and ``b_f`` float32 (forget gates open: ``b_f`` = 3)."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    h = cfg.n_heads
    lead = tuple(lead)
    dev = generator.device
    std = d ** -0.5
    return {
        "w_q": _normal(generator, (*lead, d, di), std).to(dtype),
        "w_k": _normal(generator, (*lead, d, di), std).to(dtype),
        "w_v": _normal(generator, (*lead, d, di), std).to(dtype),
        "w_i": _normal(generator, (*lead, d, h), std),
        "w_f": _normal(generator, (*lead, d, h), std),
        "b_i": _full((*lead, h), 0.0, f32, dev),
        "b_f": _full((*lead, h), 3.0, f32, dev),
        "w_gate": _normal(generator, (*lead, d, di), std).to(dtype),
        "out_norm": _full((*lead, di), 1.0, dtype, dev),
        "out_proj": _normal(generator, (*lead, di, d), di ** -0.5).to(dtype),
    }


def _mlstm_chunked(q, k, v, log_i, log_f, chunk, compute_dtype=f32):
    """Stabilized chunkwise mLSTM from the empty state.

    q, k, v: (B, L, H, P); log_i, log_f: (B, L, H) float32.  Returns (h (B,
    L, H, P) float32, final state (C (B, H, P, P), n (B, H, P), m (B, H)),
    float32, with true scale exp(m)·stored).

    ``compute_dtype`` is the type of the chunk products' q, k, v operands
    (the model's), accumulated in float32; ``q · P^-½`` is rounded to it, as
    the reference's weakly typed scale leaves it.  The state update
    contracts pairwise, ``(sw·k)ᵀ @ v``, never forming (B, H, Q, P, P).
    """
    bsz, length, n_heads, p_dim = q.shape
    q_len = _fit_chunk(length, chunk)
    scale = p_dim ** -0.5
    dev = q.device
    c_mem = torch.zeros((bsz, n_heads, p_dim, p_dim), dtype=f32, device=dev)
    n_mem = torch.zeros((bsz, n_heads, p_dim), dtype=f32, device=dev)
    m = torch.full((bsz, n_heads), -1e30, dtype=f32, device=dev)
    mask = torch.tril(torch.ones((q_len, q_len), dtype=torch.bool, device=dev))

    def trip(state, xs):
        (c_mem, n_mem, m), (qt, kt, vt, li, lf) = state, xs
        kf, vf = kt.to(f32), vt.to(f32)
        qs = (qt * scale).to(f32)
        b = torch.cumsum(lf, dim=1).transpose(1, 2)        # (B,H,Q) inclusive
        li_t = li.transpose(1, 2)                          # (B,H,Q)
        total = b[:, :, -1]                                # (B,H)
        # log-weight of key j for query i (j <= i): b_i - b_j + log_i_j
        logw = b[:, :, :, None] - b[:, :, None, :] + li_t[:, :, None, :]
        logw = torch.where(mask, logw, -torch.inf)
        m_intra = logw.amax(dim=-1)                        # (B,H,Q)
        m_inter = m[:, :, None] + b                        # (B,H,Q)
        m_i = torch.clamp(torch.maximum(m_intra, m_inter), min=-1e30)
        w = torch.exp(logw - m_i[..., None])               # (B,H,Q,Q)
        qk = torch.einsum("bihp,bjhp->bhij", qt.to(f32), kf) * scale
        wqk = w * qk
        num = torch.einsum("bhij,bjhp->bihp", wqk, vf)
        den = wqk.sum(dim=-1)                              # (B,H,Q)
        inter_scale = torch.exp(m_inter - m_i)             # (B,H,Q)
        num = num + torch.einsum("bihp,bhpr->bihr", qs, c_mem) * (
            inter_scale.transpose(1, 2)[..., None])
        den = den + torch.einsum("bihp,bhp->bhi", qs, n_mem) * inter_scale
        hden = torch.maximum(den.abs(), torch.exp(-m_i))   # (B,H,Q)
        y = num / hden.transpose(1, 2)[..., None]          # (B,Q,H,P)
        # ---- state update -------------------------------------------------
        lw_state = total[:, :, None] - b + li_t            # (B,H,Q) log-weights
        m_new = torch.maximum(m + total, lw_state.amax(dim=-1))
        sw = torch.exp(lw_state - m_new[:, :, None])       # (B,H,Q)
        swk = sw.transpose(1, 2)[..., None] * kf           # (B,Q,H,P)
        carry = torch.exp(m + total - m_new)
        c_mem = carry[:, :, None, None] * c_mem + swk.permute(0, 2, 3, 1) @ vf.transpose(1, 2)
        n_mem = carry[:, :, None] * n_mem + swk.sum(dim=1)
        return (c_mem, n_mem, m_new), y

    xs = (*(_chunks(t.to(compute_dtype), q_len) for t in (q, k, v)),
          _chunks(log_i, q_len), _chunks(log_f, q_len))
    state, hs = scan.scan("mlstm", trip, (c_mem, n_mem, m), xs)
    return torch.cat(hs, dim=1), state


def mlstm_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *, return_state: bool = False):
    """Full-sequence mLSTM block (prefill).  x: (B, L, D): the one shard of
    :func:`mlstm_block_shards`; ``return_state`` adds the final (C, n, m)."""
    kept = _Kept() if return_state else None
    out = mlstm_block_shards(None, p, [x], cfg, sink=kept)[0]
    if return_state:
        return out, tuple(kept.states[name] for name in ("mC", "mn", "mm"))
    return out


def mlstm_decode(p: dict, x: torch.Tensor, state: tuple, cfg: ModelConfig):
    """x: (B, 1, D); state: (C, n, m) -> (out (B, 1, D), new state): the one
    shard of :func:`mlstm_decode_shards` on copies of the states."""
    state = tuple(t.clone() for t in state)
    return mlstm_decode_shards(None, p, [x], state, cfg)[0], state


# ==========================================================================
# sLSTM (scalar-memory cell with exponential gating)
# ==========================================================================
def init_slstm(generator: torch.Generator, cfg: ModelConfig, dtype, lead=()) -> dict:
    """sLSTM parameters with leading axes ``lead``; ``w``, ``r`` and ``b``
    float32 (the forget gate's third of ``b`` at 3)."""
    d = cfg.d_model
    hs = cfg.n_heads
    dh = d // hs
    lead = tuple(lead)
    dev = generator.device
    b = torch.cat([torch.zeros((2 * d,), device=dev), torch.full((d,), 3.0, device=dev),
                   torch.zeros((d,), device=dev)])
    return {
        "w": _normal(generator, (*lead, d, 4 * d), d ** -0.5),
        "r": _normal(generator, (*lead, hs, dh, 4 * dh), dh ** -0.5),
        "b": b.expand(*lead, 4 * d).clone(),
        "out_norm": _full((*lead, d), 1.0, dtype, dev),
        "up": _normal(generator, (*lead, d, 4 * d // 3), d ** -0.5).to(dtype),
        "down": _normal(generator, (*lead, 4 * d // 3, d), (4 * d // 3) ** -0.5).to(dtype),
    }


def _slstm_scan(p, wx: torch.Tensor, cfg: ModelConfig, state=None):
    """wx: (B, L, 4D), the input part ``x @ w + b`` in float32 -> (h (B, L, D)
    float32, final state (c, n, m, h)).

    A sequential loop over the L positions (``scan.scan``)."""
    bsz, length, d = wx.shape[0], wx.shape[1], wx.shape[2] // 4
    hs = cfg.n_heads
    dh = d // hs
    if state is None:
        zeros = torch.zeros((bsz, d), dtype=f32, device=wx.device)
        state = (zeros, zeros, torch.full((bsz, d), -1e30, dtype=f32, device=wx.device), zeros)

    def trip(carry, xs, r):
        (c, n, m, h), (x,) = carry, xs
        rec = torch.bmm(h.reshape(bsz, hs, dh).transpose(0, 1), r).transpose(0, 1)
        za, ia, fa, oa = (x + rec.reshape(bsz, 4 * d)).chunk(4, dim=-1)
        z = torch.tanh(za)
        log_f = F.logsigmoid(fa)
        o = torch.sigmoid(oa)
        m_new = torch.maximum(log_f + m, ia)
        keep, take = torch.exp(log_f + m - m_new), torch.exp(ia - m_new)
        c = keep * c + take * z
        n = keep * n + take
        h = o * c / torch.maximum(n, torch.exp(-m_new))
        return (c, n, m_new, h), h

    state, outs = scan.scan("slstm", trip, tuple(state), (wx.unbind(1),), (p["r"],))
    return torch.stack(outs, dim=1), state


def _slstm_out(p, h: torch.Tensor, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(h.to(x.dtype), p["out_norm"], cfg.norm_eps)
    u = F.gelu((h @ p["up"]).to(f32), approximate="tanh").to(x.dtype)
    return u @ p["down"]


def slstm_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *, return_state: bool = False):
    """Full-sequence sLSTM block (prefill).  x: (B, L, D): the one shard of
    :func:`slstm_block_shards`; ``return_state`` adds the final (c, n, m, h)."""
    kept = _Kept() if return_state else None
    out = slstm_block_shards(None, p, [x], cfg, sink=kept)[0]
    if return_state:
        return out, tuple(kept.states[name] for name in ("sc", "sn", "sm", "sh"))
    return out


def slstm_decode(p: dict, x: torch.Tensor, state: tuple, cfg: ModelConfig):
    """x: (B, 1, D); state: (c, n, m, h) -> (out (B, 1, D), new state): the
    one shard of :func:`slstm_decode_shards` on copies of the states."""
    state = tuple(t.clone() for t in state)
    return slstm_decode_shards(None, p, [x], state, cfg)[0], state


# ==========================================================================
# Over a mesh of shards (tensor parallel), or one shard (no rules)
# ==========================================================================
# ``p`` holds ``sharding.Sharded`` leaves laid out by the reference's rules,
# ``hs`` one (B_loc, L, D) input a shard; each function returns one output a
# shard.  A shard computes the heads that cover its block of the inner
# width ``di`` (the rows of ``out_proj``), gates and normalises that block,
# and multiplies it by its rows of ``out_proj``; one all-reduce over "model"
# sums the partials.  Where the divisibility guard replicates a leaf, the
# shard holds all of it and nothing is gathered or reduced for it.  With no
# rules (``rules`` None, ``p`` tensors, ``hs`` one input) each is the block
# on one shard, which holds every head: the unsharded block.
class _Kept:
    """A cache sink that keeps the final states a block hands it (the
    blocks' ``return_state``)."""

    def __init__(self):
        self.states: dict = {}

    def put(self, name: str, xs: list) -> None:
        self.states[name] = xs[0]

    put_cut = put


def _cols(t: torch.Tensor, off: int, width: int) -> torch.Tensor:
    """Entries ``off .. off + width - 1`` of ``t``'s last dim (``t`` itself
    where they are all of them)."""
    return t if off == 0 and width == t.shape[-1] else t.narrow(-1, off, width)


def _covering_heads(off: int, width: int, p_dim: int) -> slice:
    """The heads of size ``p_dim`` that columns ``off .. off + width - 1`` of
    the inner width lie in."""
    return slice(off // p_dim, -(-(off + width) // p_dim))


def _rms_norm_shards(rules, ys: list, ws: list, width: int, eps: float, split: bool) -> list:
    """:func:`layers.rms_norm` of rows of ``width`` of which each shard holds
    its block (``ys``, with its block of the scale ``ws``): where ``split``,
    the sums of squares are all-reduced over "model" before the division by
    the whole ``width``; else each shard holds whole rows."""
    if not split:
        return [rms_norm(y, w, eps) for y, w in zip(ys, ws)]
    sq = [torch.sum(y.to(f32) * y.to(f32), dim=-1, keepdim=True) for y in ys]
    sq = collectives.all_reduce_sum(sq, rules.mesh, rules.tp_axis)
    return [((y.to(f32) * torch.rsqrt(q / width + eps)) * w.to(f32)).to(y.dtype)
            for y, q, w in zip(ys, sq, ws)]


def _out_shards(rules, p: dict, leaves: dict, ys: list, zs: list, width: int, eps: float) -> list:
    """Each shard's block of y (B_loc, L, di_loc), gated by its block of z,
    normalised over the whole inner ``width`` and multiplied by its rows of
    ``out_proj``; the partials all-reduced over "model" where they are."""
    split = split_dim_of(p["out_proj"]) is not None
    offs, di_loc = offsets_of(p["out_proj"], 0), leaves["out_proj"][0].shape[0]
    ys = [(y.to(z.dtype) * F.silu(z.to(f32)).to(z.dtype)) for y, z in zip(ys, zs)]
    norms = [_cols(w, o, di_loc) for w, o in zip(leaves["out_norm"], offs)]
    ys = _rms_norm_shards(rules, ys, norms, width, eps, split)
    outs = [y @ w for y, w in zip(ys, leaves["out_proj"])]
    return collectives.all_reduce_sum(outs, rules.mesh, rules.tp_axis) if split else outs


def _leaves(p: dict) -> dict:
    return {name: locals_of(leaf) for name, leaf in p.items()}


def mamba2_block_shards(rules, p: dict, hs: list, cfg: ModelConfig, *, sink=None) -> list:
    """:func:`mamba2_block` over the shards of ``rules.mesh``.

    ``in_proj``'s column blocks do not line up with ``z | x B C | dt`` (at tp
    4 of zamba2's 10448 columns a shard holds 2612), so the shards' products
    are all-gathered over "model" (one (B_loc, L, d_in) buffer a layer) and
    each shard takes the columns its heads need: its block of z, its heads'
    x and dt, and the B and C that every head shares.  The replicated
    ``conv_w``, ``conv_b``, ``dt_bias``, ``a_log`` and ``d_skip`` are sliced
    to the same heads.  A cache ``sink`` gets each shard's heads' final
    state (``ssm``, heads on "model") and its block of the conv window's
    tail (``conv``, channels on "model"), cut from the gathered products."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    n_heads = di // s.head_dim
    leaves = _leaves(p)
    proj = [h @ w for h, w in zip(hs, leaves["in_proj"])]
    if split_dim_of(p["in_proj"]) is not None:
        proj = collectives.all_gather(proj, rules.mesh, rules.tp_axis, dim=-1)
    offs, di_loc = offsets_of(p["out_proj"], 0), leaves["out_proj"][0].shape[0]
    ys, zs, states, convs = [], [], [], []
    for n, (pr, off) in enumerate(zip(proj, offs)):
        heads = _covering_heads(off, di_loc, s.head_dim)
        y, h_fin, xbc = _mamba2_mix({k: v[n] for k, v in leaves.items()}, pr, cfg, heads)
        ys.append(_cols(y, off - heads.start * s.head_dim, di_loc))
        zs.append(pr.narrow(-1, off, di_loc))
        states.append(h_fin)
        if sink is not None:  # the conv's whole input: xbc holds the heads' channels only
            whole = heads == slice(0, n_heads)
            convs.append((xbc if whole else _split_mamba_proj(pr, cfg)[1])[:, -(s.d_conv - 1):])
    if sink is not None:
        sink.put("ssm", states)
        sink.put_cut("conv", convs)
    return _out_shards(rules, p, leaves, ys, zs, di, cfg.norm_eps)


def _head_columns(rules, leaf, xs: list, p_dim: int) -> tuple[list, list]:
    """Each shard's product with a (D, di) leaf split over its columns,
    widened to whole heads of ``p_dim``: (the products, the first column each
    holds).  Where a shard's block holds part of a head (tp above the head
    count), the products are all-gathered over "model": the cell contracts
    P in every chunk product, so P is not split inside it."""
    offs = offsets_of(leaf, -1)
    if split_dim_of(leaf) is None or (leaf.shape[-1] // leaf.grid[-1]) % p_dim == 0:
        return xs, offs
    return collectives.all_gather(xs, rules.mesh, rules.tp_axis, dim=-1), [0] * len(xs)


def mlstm_block_shards(rules, p: dict, hs: list, cfg: ModelConfig, *, sink=None) -> list:
    """:func:`mlstm_block` over the shards of ``rules.mesh``: each shard runs
    the chunked cell on the heads that cover its block of ``di`` (its own
    columns of ``w_q``, ``w_k`` and ``w_v`` where they are whole heads, else
    the heads of the all-gathered products), with those heads' gates from
    the replicated ``w_i`` and ``w_f``.  A cache ``sink`` gets the final
    states in the cache's layout (:func:`_mlstm_cache_states`)."""
    s = cfg.ssm
    n_heads = cfg.n_heads
    di = s.expand * cfg.d_model
    p_dim = di // n_heads
    leaves = _leaves(p)
    qkv = [_head_columns(rules, p[name], [h @ w for h, w in zip(hs, leaves[name])], p_dim)
           for name in ("w_q", "w_k", "w_v")]
    offs, di_loc = offsets_of(p["out_proj"], 0), leaves["out_proj"][0].shape[0]
    ys, zs, states = [], [], []
    for n, (h, off) in enumerate(zip(hs, offs)):
        bsz, length, _ = h.shape
        heads = _covering_heads(off, di_loc, p_dim)
        width = (heads.stop - heads.start) * p_dim
        q, k, v = (_cols(xs[n], heads.start * p_dim - firsts[n], width)
                   .reshape(bsz, length, -1, p_dim) for xs, firsts in qkv)
        hf = h.to(f32)
        # xLSTM's exponential input gate: log i is the preactivation itself
        li = _cols(hf @ leaves["w_i"][n] + leaves["b_i"][n], heads.start, width // p_dim)
        lf = _cols(F.logsigmoid(hf @ leaves["w_f"][n] + leaves["b_f"][n]), heads.start,
                   width // p_dim)
        y, state = _mlstm_chunked(q, k, v, li, lf, s.chunk, compute_dtype=h.dtype)
        ys.append(_cols(y.reshape(bsz, length, width), off - heads.start * p_dim, di_loc))
        zs.append(h @ leaves["w_gate"][n])
        states.append(state)
    if sink is not None:
        _mlstm_cache_states(rules, sink, states, n_heads)
    return _out_shards(rules, p, leaves, ys, zs, di, cfg.norm_eps)


def _mlstm_cache_states(rules, sink, states: list, n_heads: int) -> None:
    """The mLSTM's final states, each shard's (C (B, h, P, P), n (B, h, P),
    m (B, h)) for its covering heads, handed to ``sink`` in the cache's
    layout: C and n split over their first P for every head, m whole.  Where
    every shard ran every head, each cuts its block; where each ran its own
    block of whole heads, one all-to-all over "model" a leaf turns heads into
    P blocks; where ``r`` shards shared a head (tp above the head count),
    the all-to-all brings each head ``r`` times and every ``r``-th is kept."""
    cs, ns, ms = (list(t) for t in zip(*states))
    if cs[0].shape[1] == n_heads:
        for name, xs in (("mC", cs), ("mn", ns), ("mm", ms)):
            sink.put_cut(name, xs)
        return
    mesh, tp_axis = rules.mesh, rules.tp_axis
    h_cov, tp = cs[0].shape[1], mesh.axis_size(tp_axis)
    if h_cov * tp == n_heads:
        r = 1
    elif h_cov == 1 and tp % n_heads == 0:
        r = tp // n_heads
    else:
        raise NotImplementedError(
            f"the mLSTM's cache layout: {n_heads} heads over {tp} shards, {h_cov} a shard")
    cs = collectives.all_to_all(cs, mesh, tp_axis, split_dim=2, concat_dim=1)
    ns = collectives.all_to_all(ns, mesh, tp_axis, split_dim=2, concat_dim=1)
    ms = collectives.all_gather(ms, mesh, tp_axis, dim=1)
    sink.put("mC", [c[:, ::r] for c in cs])
    sink.put("mn", [n[:, ::r] for n in ns])
    sink.put("mm", [m[:, ::r] for m in ms])


def slstm_block_shards(rules, p: dict, hs: list, cfg: ModelConfig, *, sink=None) -> list:
    """:func:`slstm_block` over the shards of ``rules.mesh``.

    The recurrence cannot be split over units: ``rec`` is computed per head
    and then cut into the four gates, so gate g of every unit comes from
    head g's whole state.  The input part ``x @ w + b`` (``w`` split over its
    columns) is all-gathered over "model" once a layer, the scan runs on
    every shard on the whole state, and the output MLP runs tensor-parallel:
    ``up`` by columns and ``down`` by rows, all-reduced where the guard
    splits them (at xlstm's 2730 hidden units: tp 2, not 4 or 16).  A cache
    ``sink`` gets each shard's block of the final state."""
    leaves = _leaves(p)
    wx = [h.to(f32) @ w for h, w in zip(hs, leaves["w"])]
    if split_dim_of(p["w"]) is not None:
        wx = collectives.all_gather(wx, rules.mesh, rules.tp_axis, dim=-1)
    outs, states = [], []
    for n, (h, w) in enumerate(zip(hs, wx)):
        loc = {k: v[n] for k, v in leaves.items()}
        seq, state = _slstm_scan(loc, w + loc["b"], cfg)
        outs.append(_slstm_out(loc, seq, h, cfg))
        states.append(state)
    if sink is not None:
        for name, xs in zip(("sc", "sn", "sm", "sh"), zip(*states)):
            sink.put_cut(name, list(xs))
    if split_dim_of(p["down"]) is None:
        return outs
    return collectives.all_reduce_sum(outs, rules.mesh, rules.tp_axis)


# ==========================================================================
# One-token decode over a mesh of shards, or one shard
# ==========================================================================
# The states are ``sharding.Sharded`` leaves of one layer (tensors on the
# one shard of no rules), laid out by the reference's ``cache_pspecs``, and
# updated in place: every shard computes its new blocks first and writes
# them after, since a block that several shards share (``mm``; every leaf
# where the batch is not split) is one tensor on their device.  Where the
# states' split does not line up with the blocks' products, the one-token
# operands are all-gathered over "model".
def _write(blocks: list, new: list) -> None:
    for blk, x in zip(blocks, new):
        blk.copy_(x)


def mamba2_decode_shards(rules, p: dict, hs: list, conv, ssm_state, cfg: ModelConfig) -> list:
    """:func:`mamba2_decode` over the shards of ``rules.mesh``: ``hs`` one
    (B_loc, 1, D) input a shard, ``conv`` (B, K−1, C) with its channels on
    "model" and ``ssm_state`` (B, H, N, P) with its heads on "model".

    As in the prefill, ``in_proj``'s products are all-gathered.  Each shard
    runs the causal conv on its block of channels and the conv outputs are
    all-gathered (one (B_loc, C) buffer), since a shard's heads need the x
    channels of their heads and the B and C channels of all of them, which
    its block of channels does not hold; its heads' SSM step then updates its
    block of the state, and the output is the prefill's (``_out_shards``).
    The conv over the ring of the last K inputs takes float32 products of
    the model's values summed in float32, as the reference's einsum."""
    s = cfg.ssm
    di, n, p_dim = s.expand * cfg.d_model, s.d_state, s.head_dim
    leaves = _leaves(p)
    proj = [h[:, 0] @ w for h, w in zip(hs, leaves["in_proj"])]
    if split_dim_of(p["in_proj"]) is not None:
        proj = collectives.all_gather(proj, rules.mesh, rules.tp_axis, dim=-1)
    conv_b, ssm_b = own_of(conv), own_of(ssm_state)
    c_offs, c_loc = offsets_of(conv, -1), conv_b[0].shape[-1]
    outs, wins, zdts = [], [], []
    for k, pr in enumerate(proj):
        z, xbc, dtr, _, _, _ = _split_mamba_proj(pr, cfg)
        win = torch.cat([conv_b[k], _cols(xbc, c_offs[k], c_loc)[:, None, :]], dim=1)
        w, b = (_cols(leaves[name][k], c_offs[k], c_loc) for name in ("conv_w", "conv_b"))
        out = (win.to(f32) * w.to(f32)).sum(dim=1).to(win.dtype) + b
        outs.append(F.silu(out.to(f32)).to(win.dtype))
        wins.append(win)
        zdts.append((z, dtr))
    if split_dim_of(conv) is not None:
        outs = collectives.all_gather(outs, rules.mesh, rules.tp_axis, dim=-1)
    h_offs, h_loc = offsets_of(ssm_state, 1), ssm_b[0].shape[1]
    o_offs, di_loc = offsets_of(p["out_proj"], 0), leaves["out_proj"][0].shape[0]
    ys, zs, states = [], [], []
    for k, (out, (z, dtr)) in enumerate(zip(outs, zdts)):
        if (h_offs[k] * p_dim, h_loc * p_dim) != (o_offs[k], di_loc):
            raise NotImplementedError(
                f"Mamba2 decode: the state's heads {h_offs[k]}..+{h_loc} are not the block of "
                f"out_proj's rows {o_offs[k]}..+{di_loc}")
        head = lambda t, k=k: _cols(t, h_offs[k], h_loc)  # noqa: E731  (this shard's heads)
        xs, b_, c_ = out.split([di, n, n], dim=-1)
        dt = softplus(head(dtr).to(f32) + head(leaves["dt_bias"][k]))               # (B,h)
        a = -torch.exp(head(leaves["a_log"][k]))
        decay = torch.exp(dt * a[None, :])
        xh = _cols(xs, o_offs[k], di_loc).reshape(-1, h_loc, p_dim).to(f32)
        xbar = xh * dt[..., None]
        st = decay[:, :, None, None] * ssm_b[k] + torch.einsum("bn,bhp->bhnp", b_.to(f32), xbar)
        y = torch.einsum("bn,bhnp->bhp", c_.to(f32), st)
        y = y + head(leaves["d_skip"][k])[None, :, None] * xh
        ys.append(y.reshape(-1, 1, di_loc))
        zs.append(_cols(z, o_offs[k], di_loc)[:, None, :])
        states.append(st)
    _write(conv_b, [w[:, 1:] for w in wins])
    _write(ssm_b, states)
    return _out_shards(rules, p, leaves, ys, zs, di, cfg.norm_eps)


def mlstm_decode_shards(rules, p: dict, hs: list, state: tuple, cfg: ModelConfig) -> list:
    """:func:`mlstm_decode` over the shards of ``rules.mesh``; ``state`` the
    (mC (B, H, P, P), mn (B, H, P), mm (B, H)) leaves.

    The cache splits C and n over their first P (the key's) for every head,
    which the column blocks of ``w_q``, ``w_k``, ``w_v`` (whole heads, or
    part of one) never line up with: the one-token q, k, v are all-gathered
    over "model".  Each shard updates its P-block of C and n for every head
    and forms its partials of ``q·C`` and ``q·n``, summed by one all-reduce
    where C is split; m, replicated, every shard computes whole."""
    s = cfg.ssm
    n_heads, di = cfg.n_heads, s.expand * cfg.d_model
    p_dim = di // n_heads
    leaves = _leaves(p)
    c_leaf, n_leaf, m_leaf = state
    cb, nb, mb = own_of(c_leaf), own_of(n_leaf), own_of(m_leaf)
    xts = [h[:, 0] for h in hs]
    qkv = [[xt @ leaves[w][k] for w in ("w_q", "w_k", "w_v")] for k, xt in enumerate(xts)]
    if split_dim_of(p["w_q"]) is not None:                              # (3, B, di_loc) a shard
        qkv = collectives.all_gather([torch.stack(x) for x in qkv], rules.mesh, rules.tp_axis,
                                     dim=-1)
    split = split_dim_of(c_leaf) is not None
    offs, p_loc = offsets_of(c_leaf, 2), cb[0].shape[2]
    new, parts = [], []
    for k, (xt, x) in enumerate(zip(xts, qkv)):
        bsz = xt.shape[0]
        q, kk, v = (t.reshape(bsz, n_heads, p_dim).to(f32) for t in x)
        q = q * p_dim ** -0.5
        xf = xt.to(f32)
        li = xf @ leaves["w_i"][k] + leaves["b_i"][k]                       # (B,H)
        lf = F.logsigmoid(xf @ leaves["w_f"][k] + leaves["b_f"][k])
        m_new = torch.maximum(lf + mb[k], li)
        keep, take = torch.exp(lf + mb[k] - m_new), torch.exp(li - m_new)
        kb, qb = _cols(kk, offs[k], p_loc), _cols(q, offs[k], p_loc)
        c_new = keep[:, :, None, None] * cb[k] + take[:, :, None, None] * (
            kb[..., :, None] * v[..., None, :])
        n_new = keep[:, :, None] * nb[k] + take[:, :, None] * kb
        num = (qb[:, :, None, :] @ c_new)[:, :, 0]                           # (B,H,P)
        qn = (qb * n_new).sum(dim=-1)
        parts.append(torch.cat([num, qn[..., None]], dim=-1) if split else (num, qn))
        new.append((c_new, n_new, m_new))
    if split:
        parts = [(t[..., :-1], t[..., -1])
                 for t in collectives.all_reduce_sum(parts, rules.mesh, rules.tp_axis)]
    o_offs, di_loc = offsets_of(p["out_proj"], 0), leaves["out_proj"][0].shape[0]
    ys, zs = [], []
    for k, (h, (num, qn), (_, _, m_new)) in enumerate(zip(hs, parts, new)):
        den = torch.maximum(qn.abs(), torch.exp(-m_new))
        y = (num / den[..., None]).reshape(h.shape[0], 1, di)
        ys.append(_cols(y, o_offs[k], di_loc))
        zs.append(h @ leaves["w_gate"][k])
    for blocks, i in ((cb, 0), (nb, 1), (mb, 2)):
        _write(blocks, [t[i] for t in new])
    return _out_shards(rules, p, leaves, ys, zs, di, cfg.norm_eps)


def slstm_decode_shards(rules, p: dict, hs: list, state: tuple, cfg: ModelConfig) -> list:
    """:func:`slstm_decode` over the shards of ``rules.mesh``; ``state`` the
    (sc, sn, sm, sh) leaves (B, D), D on "model".  The recurrence needs the
    whole state (gate g of every unit comes from head g's whole h), so the
    four blocks are all-gathered over "model" (one (4, B_loc, D) buffer), the
    step runs on every shard as in the prefill, and each keeps its block."""
    leaves = _leaves(p)
    wx = [h.to(f32) @ w for h, w in zip(hs, leaves["w"])]
    if split_dim_of(p["w"]) is not None:
        wx = collectives.all_gather(wx, rules.mesh, rules.tp_axis, dim=-1)
    blocks = [own_of(leaf) for leaf in state]
    olds = [tuple(b[k] for b in blocks) for k in range(len(hs))]
    if split_dim_of(state[0]) is not None:                             # (4, B_loc, D_loc) a shard
        olds = collectives.all_gather([torch.stack(old) for old in olds], rules.mesh,
                                      rules.tp_axis, dim=-1)
    offs, d_loc = offsets_of(state[0], -1), blocks[0][0].shape[-1]
    outs, new = [], []
    for k, (h, w, old) in enumerate(zip(hs, wx, olds)):
        loc = {name: v[k] for name, v in leaves.items()}
        seq, st = _slstm_scan(loc, w + loc["b"], cfg, tuple(old))
        outs.append(_slstm_out(loc, seq, h, cfg))
        new.append([_cols(t, offs[k], d_loc) for t in st])
    for i, b in enumerate(blocks):
        _write(b, [t[i] for t in new])
    if split_dim_of(p["down"]) is None:
        return outs
    return collectives.all_reduce_sum(outs, rules.mesh, rules.tp_axis)
