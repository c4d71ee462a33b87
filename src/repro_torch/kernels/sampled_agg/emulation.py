"""The chunked ``prefix_power_sums`` kernel's arithmetic, in PyTorch.

The kernel's chunked path (``csrc/prefix_stats.cu``, ``chunked_kernel``)
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
contracted or reassociated: the result is the kernel's, bit for bit (the
card tests hold them equal); the CPU tests hold it to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sampled_agg.compensated import two_sum

__all__ = ["chunked_prefix_power_sums"]

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
