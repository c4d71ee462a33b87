"""The decompositions of the AFC kernels, in PyTorch.

:func:`chunked_prefix_power_sums` is the chunked ``prefix_power_sums``
kernel's arithmetic, :func:`clustered_sampled_moments` the cluster
``sampled_moments`` kernel's and :func:`radix_select_ranks` the radix
``masked_select_ranks`` kernel's sort, each described where it is defined.

``prefix_power_sums``' chunked path (``csrc/prefix_stats.cu``, ``chunked_kernel``)
cuts each row into chunks of ``4·threads`` columns and scans them as
unevaluated (hi, lo) pairs combined by two-sum, in this order, which
:func:`chunked_prefix_power_sums` repeats operation for operation:

- each thread scans its 4 columns in sequence;
- a warp scans its 32 thread totals (Hillis-Steele: at step s, lane i takes
  lane i − s's pair in front of its own), and each thread keeps the
  exclusive prefix from the lane before it (zero at lane 0);
- the warp totals are scanned the same way, zeros past the last warp;
- chunk c's carry folds the totals of chunks 0..c−1 of its row, 32 at a
  time: each group is scanned in a warp with zeros past its end, its lane
  31 is combined behind the carry, starting from zero;
- a column's sum is carry ⊕ (earlier warps ⊕ earlier lanes) ⊕ its own
  thread prefix, collapsed to hi + lo.

Pairs with a zero are combined exactly, so the zeros in the padding change
no bit.  Each operation below is its own PyTorch kernel, so nothing is
contracted or reassociated: the results are the kernels', bit for bit (the
card tests hold them equal); the CPU tests hold them to the plain versions.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.sampled_agg.compensated import two_sum
from repro_torch.kernels.sampled_agg.sampled_agg import chunk_cols

__all__ = ["COUNT_MAX", "chunked_prefix_power_sums", "clustered_sampled_moments",
           "radix_select_ranks", "sort_keys"]

COLS = 4   # columns a thread


def _combine(a, b):
    """``a`` (hi, lo) in front of ``b``: the kernel's ``comp_combine``."""
    s, e = two_sum(a[0], b[0])
    return s, (a[1] + b[1]) + e


def _lane_scan(p, dim: int):
    """Hillis-Steele inclusive scan of (hi, lo) pairs along ``dim`` (at most
    32 long: one warp's shuffles)."""
    hi, lo = (t.movedim(dim, -1) for t in p)
    s = 1
    while s < hi.shape[-1]:
        h, l = _combine((hi[..., :-s], lo[..., :-s]), (hi[..., s:], lo[..., s:]))
        hi = torch.cat([hi[..., :s], h], dim=-1)
        lo = torch.cat([lo[..., :s], l], dim=-1)
        s *= 2
    return hi.movedim(-1, dim), lo.movedim(-1, dim)


def _pad_to(t: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    pad = [0, 0] * (t.dim() - 1 - dim % t.dim()) + [0, n - t.shape[dim]]
    return torch.nn.functional.pad(t, pad)


def chunked_prefix_power_sums(vals: torch.Tensor, shift: torch.Tensor | None = None, *,
                              threads: int = 512) -> torch.Tensor:
    """(k, cap) f32 -> (k, cap, 4) tables, as the chunked kernel of
    ``threads`` threads a block (chunks of ``4·threads`` columns) gives them."""
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"threads must be a multiple of 32 up to 1024, got {threads}")
    v = vals.to(torch.float32)
    k, cap = v.shape
    if shift is None:
        shift = torch.zeros((k,), dtype=torch.float32, device=v.device)
    chunk, warps = COLS * threads, threads // 32
    n_ch = -(-cap // chunk)
    # columns past cap read the shift: exact zeros
    u = _pad_to(v - shift.to(torch.float32)[:, None], n_ch * chunk, 1)
    u2 = u * u
    p = torch.stack([u, u2, u2 * u, u2 * u2], dim=-1)              # (k, n_ch·chunk, 4)
    p = p.reshape(k, n_ch, warps, 32, COLS, 4)

    # a thread's columns in sequence
    hi, lo = [p[..., 0, :]], [torch.zeros_like(p[..., 0, :])]
    for j in range(1, COLS):
        h, l = _combine((hi[-1], lo[-1]), (p[..., j, :], torch.zeros_like(hi[-1])))
        hi.append(h)
        lo.append(l)
    local = (torch.stack(hi, dim=-2), torch.stack(lo, dim=-2))      # (k, n_ch, W, 32, COLS, 4)

    # thread totals over the warp; the exclusive prefix from the lane before
    t_hi, t_lo = _lane_scan((local[0][..., -1, :], local[1][..., -1, :]), dim=3)
    ex = tuple(torch.cat([torch.zeros_like(t[..., :1, :]), t[..., :-1, :]], dim=3)
               for t in (t_hi, t_lo))
    # warp totals over the block; the exclusive prefix from the warp before
    w_hi, w_lo = _lane_scan((t_hi[..., -1, :], t_lo[..., -1, :]), dim=2)   # (k, n_ch, W, 4)
    wex = tuple(torch.cat([torch.zeros_like(t[:, :, :1]), t[:, :, :-1]], dim=2)
                for t in (w_hi, w_lo))
    tot = (w_hi[:, :, -1], w_lo[:, :, -1])                          # (k, n_ch, 4)

    # chunk c's carry: its row's earlier totals, 32 at a time, in index order
    carry_hi = torch.zeros_like(tot[0])
    carry_lo = torch.zeros_like(tot[0])
    for c in range(1, n_ch):
        c_hi = c_lo = torch.zeros_like(tot[0][:, 0])
        for base in range(0, c, 32):
            g = tuple(_pad_to(t[:, base:min(base + 32, c)], 32, 1) for t in tot)
            g_hi, g_lo = _lane_scan(g, dim=1)
            c_hi, c_lo = _combine((c_hi, c_lo), (g_hi[:, 31], g_lo[:, 31]))
        carry_hi[:, c], carry_lo[:, c] = c_hi, c_lo

    # carry ⊕ (earlier warps ⊕ earlier lanes), then each column behind it
    front = _combine((wex[0][:, :, :, None], wex[1][:, :, :, None]), ex)
    front = _combine((carry_hi[:, :, None, None], carry_lo[:, :, None, None]), front)
    out_hi, out_lo = _combine((front[0][..., None, :], front[1][..., None, :]), local)
    out = (out_hi + out_lo).reshape(k, n_ch * chunk, 4)
    return out[:, :cap]


def _fold_lanes(hi: torch.Tensor, lo: torch.Tensor):
    """The halving tree of a warp's shuffles (``__shfl_down_sync`` at 16, 8,
    .., 1) over the last-but-one axis, 32 long: lane 0's pair."""
    s = hi.shape[-2] // 2
    while s:
        hi, lo = _combine((hi[..., :s, :], lo[..., :s, :]),
                          (hi[..., s:2 * s, :], lo[..., s:2 * s, :]))
        s //= 2
    return hi[..., 0, :], lo[..., 0, :]


def clustered_sampled_moments(vals: torch.Tensor, z: torch.Tensor,
                              shift: torch.Tensor | None = None, *, blocks: int,
                              threads: int = 256) -> torch.Tensor:
    """(k, cap), (k,) -> (k, 5) ``[count, Σu, Σu², Σu³, Σu⁴]`` as the cluster
    kernel of ``sampled_moments`` (``csrc/sampled_agg.cu``) sums them with
    ``blocks`` blocks a row of ``threads`` threads:

    - block b takes the row's b-th chunk of :func:`chunk_cols` columns,
      thread t its columns t, t + threads, ... below z, in order, one
      Kahan step a power each;
    - each warp folds its 32 threads' pairs by the halving tree of its
      shuffles, then warp 0 its warps' pairs the same way (zeros past the
      last warp);
    - block 0's pair is combined with blocks 1, 2, .. in rank order, and
      collapsed to hi + lo.

    A block with no column below z adds an exact zero pair, so the kernel's
    shortcut for prefixes inside block 0's chunk gives the same bits.
    """
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"threads must be a multiple of 32 up to 1024, got {threads}")
    v = vals.to(torch.float32)
    k, cap = v.shape
    if shift is None:
        shift = torch.zeros((k,), dtype=torch.float32, device=v.device)
    zc = torch.clamp(z.to(torch.int64), 0, cap)
    chunk = chunk_cols(cap, blocks)
    steps = -(-chunk // threads)
    # the column of (block B, step S, thread T), live where it is in the
    # chunk and below z
    ar = functools.partial(torch.arange, device=v.device)
    within = ar(steps)[:, None] * threads + ar(threads)[None, :]                 # (S, T)
    col = ar(blocks)[:, None, None] * chunk + within[None]                       # (B, S, T)
    live = (within < chunk)[None, None] & (col[None] < zc[:, None, None, None])  # (k, B, S, T)
    u = v[:, torch.clamp(col, max=cap - 1)] - shift.to(torch.float32)[:, None, None, None]
    u2 = u * u
    p = torch.stack([u, u2, u2 * u, u2 * u2], dim=-1)                            # (k, B, S, T, 4)
    hi = torch.zeros((k, blocks, threads, 4), dtype=torch.float32, device=v.device)
    lo = torch.zeros_like(hi)
    for s in range(steps):
        h, e = two_sum(hi, p[:, :, s])
        m = live[:, :, s, :, None]
        hi, lo = torch.where(m, h, hi), torch.where(m, lo + e, lo)
    warps = threads // 32
    hi, lo = _fold_lanes(hi.reshape(k, blocks, warps, 32, 4), lo.reshape(k, blocks, warps, 32, 4))
    pad = torch.zeros((k, blocks, 32 - warps, 4), dtype=torch.float32, device=v.device)
    hi, lo = _fold_lanes(torch.cat([hi, pad], dim=2), torch.cat([lo, pad], dim=2))  # (k, B, 4)
    acc = (hi[:, 0], lo[:, 0])
    for b in range(1, blocks):
        acc = _combine(acc, (hi[:, b], lo[:, b]))
    return torch.cat([zc.to(torch.float32)[:, None], acc[0] + acc[1]], dim=1)


NAN_KEY = 0xFFFFFFFF


def sort_keys(bits: torch.Tensor) -> torch.Tensor:
    """int32 float bits -> int64 holding the radix kernel's unsigned keys:
    the float order, −0.0 as +0.0, every NaN one key above +inf."""
    u = bits.to(torch.int64) & 0xFFFFFFFF
    mag = u & 0x7FFFFFFF
    u = torch.where(mag == 0, torch.zeros_like(u), u)
    key = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    return torch.where(mag > 0x7F800000, torch.full_like(key, NAN_KEY), key)


def _radix_pass(key: torch.Tensor, bits: torch.Tensor, shift: int, *, chunk: int, span: int,
                warps: int):
    """One 8-bit pass of the radix kernel over a row's live prefix (in its
    current order), position = digit base + earlier blocks + earlier warps
    of the block + earlier slots and lanes of the warp, as the kernel adds
    them; returns the pairs in their new order."""
    n = key.shape[0]
    d = (key >> shift) & 0xFF
    onehot = torch.nn.functional.one_hot(d, 256).to(torch.int64)           # (n, 256)
    n_blocks = -(-n // chunk)
    per_warp = torch.zeros((n_blocks * warps * span, 256), dtype=torch.int64)
    per_warp[:n] = onehot
    per_warp = per_warp.reshape(n_blocks, warps, span, 256)
    in_warp = (per_warp.cumsum(2) - per_warp).reshape(-1, 256)[:n]         # earlier in the warp
    whist = per_warp.sum(2)                                                # (blocks, warps, 256)
    in_block = (whist.cumsum(1) - whist).reshape(-1, 256)                  # earlier warps
    bhist = whist.sum(1)                                                   # (blocks, 256)
    earlier = bhist.cumsum(0) - bhist                                      # earlier blocks
    total = bhist.sum(0)
    base = (total.cumsum(0) - total)[None, :] + earlier                    # (blocks, 256)
    i = torch.arange(n)
    p = (base[i // chunk, d] + in_block[i // span, d]
         + in_warp.gather(1, d[:, None])[:, 0])
    out_key, out_bits = torch.empty_like(key), torch.empty_like(bits)
    out_key[p], out_bits[p] = key, bits
    return out_key, out_bits


COUNT_MAX = 352   # prefixes the radix kernel ranks by counting (``kCountMax``)


def _count_ranks(key: torch.Tensor, bits: torch.Tensor):
    """A short prefix's pairs in the order of their stable ranks, as the
    kernel counts them: rank(i) = #{j : k_j < k_i or (k_j == k_i, j < i)}."""
    i = torch.arange(key.shape[0])
    kj, ki = key[None, :], key[:, None]
    rank = ((kj < ki) | ((kj == ki) & (i[None, :] < i[:, None]))).sum(dim=1)
    out_key, out_bits = torch.empty_like(key), torch.empty_like(bits)
    out_key[rank], out_bits[rank] = key, bits
    return out_key, out_bits


def radix_select_ranks(vals: torch.Tensor, z: torch.Tensor, targets: torch.Tensor, *,
                       items: int, blocks: int, threads: int = 1024,
                       count_max: int = COUNT_MAX) -> torch.Tensor:
    """(h, cap), (h,), (h, R) -> (h, R) as the radix path of
    ``masked_select_ranks`` (``csrc/quantile_select.cu``) selects them, with
    clusters of ``blocks`` blocks of ``threads`` threads holding ``items``
    elements each (chunks of ``threads·items`` columns; slot j of lane l of
    warp w is chunk position w·32·items + j·32 + l):

    - the live prefix as (key, bits) pairs, keys from :func:`sort_keys`;
    - a prefix of at most ``count_max`` pairs ranked by counting
      (:func:`_count_ranks`), a longer one by four stable 8-bit passes, low
      digit first (:func:`_radix_pass`);
    - the gather: with ``nan`` NaN keys at the end of the sorted prefix, a
      target t clipped to ``[0, cap − 1]`` selects the prefix's t-th below
      z − nan, +inf below cap − nan, else the NaN at t − (cap − z), which
      is where the plain version's stable sort of the row, +inf past z,
      puts them.
    """
    h, cap = vals.shape
    chunk, span = threads * items, 32 * items
    if threads % 32 or blocks * chunk < cap:
        raise ValueError(f"{blocks} blocks of {chunk} columns do not cover rows of {cap}")
    bits_all = vals.to(torch.float32).contiguous().view(torch.int32)
    out = torch.empty(targets.shape, dtype=torch.int32)
    for f in range(h):
        zf = int(torch.clamp(z[f].to(torch.int64), 0, cap))
        bits = bits_all[f, :zf].clone()
        key = sort_keys(bits)
        if zf <= count_max:
            key, bits = _count_ranks(key, bits)
        else:
            for shift in (0, 8, 16, 24):
                key, bits = _radix_pass(key, bits, shift, chunk=chunk, span=span,
                                        warps=threads // 32)
        nan = int((key == NAN_KEY).sum())
        t = torch.clamp(targets[f].to(torch.int64), 0, cap - 1)
        inf = torch.tensor(float("inf"), dtype=torch.float32).view(torch.int32)
        pick = torch.where(t < zf - nan, t, t - (cap - zf)).clamp(0, max(zf - 1, 0))
        sel = bits[pick] if zf else torch.zeros_like(t, dtype=torch.int32)
        out[f] = torch.where((t < zf - nan) | (t >= cap - nan), sel, inf)
    return out.view(torch.float32)
