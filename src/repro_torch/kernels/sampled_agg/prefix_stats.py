"""Per-request prefix statistics: the incremental-AFC precompute.

Port of the parametric half of ``repro/kernels/sampled_agg/prefix_stats.py``.
:func:`prefix_power_sums` wraps the CUDA kernel (``csrc/prefix_stats.cu``)
that builds the inclusive running power sums
``P_p[j, c] = Σ_{i ≤ c} (v_{j,i} − shift_j)^p`` for p = 1..4: each row cut
into chunks of 1024 or 2048 columns, a block each, whose totals are folded
in index order (:func:`chunk_threads` picks the launch; the emulation of
that decomposition is ``emulation.chunked_prefix_power_sums``);
:func:`prefix_power_sums_ref` is its plain version (a compensated scan).
The AFC (value, σ) at any plan z is then one gather of the table row at
``z − 1`` (:func:`prefix_moments_at`) fed through
``aggregates.estimates_from_power_sums``.

The holistic (MEDIAN/QUANTILE) twin is :func:`build_rank_index` /
:func:`select_ranks_indexed`: each column is stable-argsorted once per
request with its original positions attached (ties break on position,
exactly as ``masked_select_ranks`` breaks them), and because the planner
only visits ``z ∈ {min(z⁰ + i·γ, n)}``, prefix-membership counts are
precomputed per candidate z at block granularity.  An order statistic of
the live prefix is then an unrolled binary search over the block counts
plus one S-element scan.  The reference writes these in jnp, not Pallas,
so they are plain PyTorch here.

A streaming append (``data/store.Table.append``) inserts one value into a
cached request's buffers; :func:`append_power_sums` and
:func:`merge_sorted_prefix` apply it to the tables and the sorted runs as
delta updates (jnp in the reference too, so plain PyTorch here).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sampled_agg.compensated import comp_cumsum, two_sum

__all__ = [
    "BLOCK_S",
    "HolisticRankIndex",
    "N_POWERS",
    "append_power_sums",
    "build_rank_index",
    "chunk_threads",
    "empty_rank_index",
    "merge_sorted_prefix",
    "prefix_moments_at",
    "prefix_power_sums",
    "prefix_power_sums_ref",
    "rank_counts_from_sorted",
    "rank_index_from_sorted",
    "select_ranks_indexed",
]

N_POWERS = 4  # [Σu, Σu², Σu³, Σu⁴] — the count at z is z
NAME = "prefix_power_sums"


def _powers(v: torch.Tensor) -> torch.Tensor:
    """(..., c) -> (..., c, 4) stacked u, u², u³, u⁴."""
    v2 = v * v
    return torch.stack([v, v2, v2 * v, v2 * v2], dim=-1)


def prefix_power_sums_ref(
    vals: torch.Tensor, shift: torch.Tensor | None = None
) -> torch.Tensor:
    """(k, cap) f32 -> (k, cap, 4) inclusive prefix sums of (v − shift)^p."""
    v = vals.to(torch.float32)
    if shift is not None:
        v = v - shift.to(torch.float32)[:, None]
    return comp_cumsum(_powers(v), dim=1)


CHUNK_COLS = 4       # columns a thread of the chunked kernel
_HEADER_WORDS = 8    # a launch state's ticket/epoch word, padded; then a flag
                     # and 8 totals for each chunk slot
_states: dict[tuple[int, int, int], torch.Tensor] = {}


def bind(lib: ctypes.CDLL):
    """The typed entry point ``prefix_power_sums_launch`` of a loaded library."""
    fn = lib.prefix_power_sums_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fn():
    return bind(build.library("prefix_stats"))


@functools.cache
def _capture_id_fn():
    fn = build.library("prefix_stats").prefix_power_sums_capture_id
    fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
    fn.restype = ctypes.c_int
    return fn


def _capture_id(stream: int) -> int:
    """The id (plus one) of the graph capture under way on ``stream``, else 0."""
    out = ctypes.c_ulonglong(0)
    build.check(_capture_id_fn()(stream, ctypes.byref(out)), NAME)
    return out.value


def chunk_threads(k: int, cap: int) -> int:
    """The chunked kernel's threads a block for (k, cap): 256 (chunks of
    1024 columns) while a row has at most 32 of them, so that a chunk folds
    its predecessors' totals in one warp scan, else 512 (chunks of 2048;
    timed at the served shapes, PERF.md §6)."""
    return 256 if -(-cap // (256 * CHUNK_COLS)) <= 32 else 512


def _state(vals: torch.Tensor, device: int, stream: int, slots: int) -> torch.Tensor:
    """A launch state of the chunked kernel with at least ``slots`` chunk slots.

    Each launch leaves its state ready for the next (see
    ``csrc/prefix_stats.cu``), so a state is zeroed only when it is made;
    two launches that share one must never overlap.  Eager launches take
    the state of their (card, stream), as a stream runs them in turn.  A
    launch being captured into a CUDA graph takes the state of that capture
    (and stream), made at the capture's first launch there, its zeroing
    captured with it: the graph keeps it for its replays, which CUDA runs in
    turn on whatever stream they are replayed, and no eager launch or other
    graph ever uses it.  A state too small for the launch is replaced by a
    larger one.
    """
    key = (device, stream, _capture_id(stream) if torch.cuda.is_current_stream_capturing() else 0)
    st = _states.get(key)
    if st is None or st.numel() < _HEADER_WORDS + 9 * slots:
        st = torch.zeros((_HEADER_WORDS + 9 * slots,), dtype=torch.int32, device=vals.device)
        _states[key] = st
    return st


def prefix_power_sums(
    vals: torch.Tensor, shift: torch.Tensor | None = None, *, threads: int | None = None
) -> torch.Tensor:
    """The CUDA kernel: (k, cap) f32 on the card -> (k, cap, 4) f32 tables.

    ``threads`` overrides :func:`chunk_threads`; 0 takes the rows kernel
    (the earlier design), which the card tests and ``chip_smoke.py`` hold and
    time beside the chunked one.
    Each launch's path is counted in ``build.PATHS`` as
    ``prefix_power_sums.chunks`` or ``prefix_power_sums.rows``.
    """
    return launch_with(_fn, vals, shift, threads=threads)


def launch_with(entry, vals: torch.Tensor, shift: torch.Tensor | None = None, *,
                threads: int | None = None) -> torch.Tensor:
    """:func:`prefix_power_sums` through the entry point that ``entry()``
    gives (see :func:`bind`), asked for once the inputs have passed their
    checks."""
    build.check_tensor(vals, "prefix_power_sums vals", torch.float32, 2)
    k, cap = vals.shape
    if shift is None:
        shift = torch.zeros((k,), dtype=torch.float32, device=vals.device)
    shift = shift.to(torch.float32).contiguous()
    build.check_tensor(shift, "prefix_power_sums shift", torch.float32, 1)
    if shift.shape[0] != k:
        raise ValueError(f"prefix_power_sums: shift must have {k} rows")
    out = torch.empty((k, cap, N_POWERS), dtype=torch.float32, device=vals.device)
    if k == 0 or cap == 0:
        return out
    device, stream = build.stream_of(vals)
    if threads is None:
        threads = chunk_threads(k, cap)
    slots = k * -(-cap // (threads * CHUNK_COLS)) if threads else 0
    state = _state(vals, device, stream, slots) if threads else None
    err = entry()(vals.data_ptr(), shift.data_ptr(), out.data_ptr(), k, cap, threads,
                  None if state is None else state.data_ptr(),
                  0 if state is None else (state.numel() - _HEADER_WORDS) // 9, device, stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    build.PATHS[f"{NAME}.{'chunks' if threads else 'rows'}"] += 1
    return out


def prefix_moments_at(ptab: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Gather the (k, 5) ``[count, s1..s4]`` row at plan z (z == 0 -> zeros)."""
    cap = ptab.shape[1]
    idx = torch.clamp(z - 1, 0, cap - 1).to(torch.int64)
    row = torch.gather(ptab, 1, idx[:, None, None].expand(-1, 1, N_POWERS))[:, 0]
    row = torch.where(z[:, None] > 0, row, torch.zeros_like(row))
    return torch.cat([z.to(torch.float32)[:, None], row], dim=1)


class HolisticRankIndex(NamedTuple):
    """Argsort-with-original-index structure for holistic columns.

    sorted_vals: (h, capp) f32 ascending; positions ≥ n (and pad) are +inf.
    sorted_idx:  (h, capp) int32 original buffer position of each element
                 (stable: ties in column order).
    blk_cnt:     (h, n_z, n_blk + 1) int32; ``blk_cnt[f, i, b]`` counts the
                 sorted positions p < b·S whose original index is below
                 ``zcand[f, i]`` (exclusive block-start counts; entry n_blk
                 is the total).
    zcand:       (h, n_z) int32 plan ladder ``min(z⁰ + i·γ, n)``; every z
                 the planner reaches is one of these.
    """

    sorted_vals: torch.Tensor
    sorted_idx: torch.Tensor
    blk_cnt: torch.Tensor
    zcand: torch.Tensor


BLOCK_S = 128  # block-scan granularity S of the membership counts


def build_rank_index(
    vals: torch.Tensor, n: torch.Tensor, zcand: torch.Tensor, *, block: int = BLOCK_S
) -> HolisticRankIndex:
    """Once-per-request index of (h, cap) buffers with sizes n over a plan ladder."""
    h, cap = vals.shape
    block = min(block, cap)
    capp = -(-cap // block) * block
    pos = torch.arange(cap, dtype=torch.int32, device=vals.device)
    padded = torch.where(pos[None, :] < n[:, None], vals.to(torch.float32), torch.inf)
    if capp != cap:
        padded = torch.nn.functional.pad(padded, (0, capp - cap), value=torch.inf)
    order = torch.argsort(padded, dim=1, stable=True)
    svals = torch.take_along_dim(padded, order, dim=1)
    return rank_index_from_sorted(svals, order.to(torch.int32), zcand, block=block)


def rank_counts_from_sorted(
    sidx: torch.Tensor, zcand: torch.Tensor, *, block: int = BLOCK_S
) -> torch.Tensor:
    """Exclusive block-start prefix-membership counts ``(h, n_z, n_blk + 1)``."""
    h, capp = sidx.shape
    member = sidx[:, None, :] < zcand[:, :, None]                 # (h, n_z, capp)
    per_blk = member.reshape(h, zcand.shape[1], capp // block, block).sum(
        dim=-1, dtype=torch.int32
    )
    zeros = torch.zeros((h, zcand.shape[1], 1), dtype=torch.int32, device=sidx.device)
    return torch.cat([zeros, torch.cumsum(per_blk, dim=-1, dtype=torch.int32)], dim=-1)


def rank_index_from_sorted(
    svals: torch.Tensor, sidx: torch.Tensor, zcand: torch.Tensor, *, block: int = BLOCK_S
) -> HolisticRankIndex:
    """A :class:`HolisticRankIndex` from presorted value / position rows."""
    return HolisticRankIndex(
        sorted_vals=svals,
        sorted_idx=sidx.to(torch.int32),
        blk_cnt=rank_counts_from_sorted(sidx, zcand, block=block),
        zcand=zcand,
    )


def select_ranks_indexed(
    index: HolisticRankIndex, z: torch.Tensor, targets: torch.Tensor
) -> torch.Tensor:
    """(h, R) order statistics of each z-prefix (z on the ladder), from the index.

    Per query an unrolled ``bisect_right`` over the candidate's block
    counts finds the block that holds prefix rank r, then one S-element
    scan picks the element whose running membership count reaches r + 1.
    A rank at or past z (every rank when z = 0) gives +inf, as
    ``masked_select_ranks`` does.
    """
    svals, sidx, blk_cnt, zcand = index
    h, capp = svals.shape
    n_blk = blk_cnt.shape[-1] - 1
    block = capp // n_blk
    r = targets.to(torch.int32)

    iz = (zcand < z[:, None]).sum(dim=1)                          # ladder row of z
    cnt = torch.take_along_dim(blk_cnt, iz[:, None, None], dim=1)[:, 0]   # (h, n_blk+1)

    lo = torch.zeros_like(r)
    hi = torch.full_like(r, n_blk)
    for _ in range(max(1, (n_blk + 1).bit_length())):
        mid = torch.div(lo + hi + 1, 2, rounding_mode="floor")
        go = torch.take_along_dim(cnt, mid.to(torch.int64), dim=1) <= r
        lo = torch.where(go, mid, lo)
        hi = torch.where(go, hi, mid - 1)
    b = torch.clamp(lo, max=n_blk - 1).to(torch.int64)           # (h, R)

    base = torch.take_along_dim(cnt, b, dim=1)
    posn = (b[:, :, None] * block + torch.arange(block, device=svals.device)).reshape(h, -1)
    gi = torch.take_along_dim(sidx, posn, dim=1).reshape(h, -1, block)
    gv = torch.take_along_dim(svals, posn, dim=1).reshape(h, -1, block)
    member = gi < z[:, None, None]
    running = base[:, :, None] + torch.cumsum(member, dim=-1, dtype=torch.int32)
    hit = member & (running == (r + 1)[:, :, None])
    val = torch.where(hit, gv, torch.zeros_like(gv)).sum(dim=-1)
    return torch.where(hit.any(dim=-1), val, torch.full_like(val, torch.inf))


def empty_rank_index(lead: tuple[int, ...] = (), device=None) -> HolisticRankIndex:
    """A zero-size :class:`HolisticRankIndex` (no holistic feature), with
    leading dimensions ``lead``."""
    zi = torch.zeros(lead + (0, 0), dtype=torch.int32, device=device)
    return HolisticRankIndex(
        sorted_vals=torch.zeros(lead + (0, 0), dtype=torch.float32, device=device),
        sorted_idx=zi,
        blk_cnt=torch.zeros(lead + (0, 0, 0), dtype=torch.int32, device=device),
        zcand=zi,
    )


# --------------------------------------------------------------------------
# Streaming-append delta updates
# --------------------------------------------------------------------------
def append_power_sums(
    ptab: torch.Tensor,      # (k, cap, 4) prefix power-sum tables
    shift: torch.Tensor,     # (k,) their accumulation origin
    j: int,                  # insertion position, 1 <= j
    x: torch.Tensor,         # (k,) inserted value a feature row
    aff: torch.Tensor | None = None,  # (k,) bool: rows the event touches
) -> torch.Tensor:
    """The tables after inserting ``x`` at prefix position ``j``.

    ``P'[c] = P[c]`` for c < j and ``P'[c] = P[c−1] + (x − shift)^p`` for
    c ≥ j: a shift right plus one addition, as a Knuth two-sum (one float32
    rounding a delta).  On integer-valued data within 2²⁴ it is bitwise a
    rebuild.  Preconditions, as in the reference: ``j ≥ 1`` (j = 0 replaces
    the shift basis ``vals[:, 0]``: rebuild instead); ``j ≥ cap`` changes
    nothing; ``aff`` masks the rows.
    """
    k, cap, _ = ptab.shape
    pw = _powers(x.to(torch.float32) - shift.to(torch.float32))          # (k, 4)
    shifted = torch.cat([torch.zeros_like(ptab[:, :1]), ptab[:, :-1]], dim=1)
    s, e = two_sum(shifted, pw[:, None, :])
    upd = s + e
    c = torch.arange(cap, device=ptab.device)
    mask = (c[None, :] >= j) & (j < cap)
    if aff is not None:
        mask = mask & aff[:, None]
    return torch.where(mask[:, :, None], upd, ptab)


def merge_sorted_prefix(
    svals: torch.Tensor,     # (h, capp) sorted values, +inf past the prefix
    sidx: torch.Tensor,      # (h, capp) int32 original positions
    n: torch.Tensor,         # (h,) int32 live prefix lengths (<= cap)
    cap: int,                # buffer width the positions index into
    j: int,                  # insertion position
    x: torch.Tensor,         # (h,) inserted value a row
    aff: torch.Tensor | None = None,  # (h,) bool: rows the event touches
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge one appended element into sorted prefix runs: ``(svals, sidx, n)``.

    Ordered by (value, original position), the order of
    :func:`build_rank_index`'s stable argsort, so the result is bitwise a
    full re-sort (finite values).  A row renumbers its live positions ≥ j,
    drops the element pushed past ``cap`` (when the buffer was full),
    inserts (x, j) at its rank and resets the +inf tail to positions in
    order.  ``j ≥ cap`` changes nothing; ``aff`` masks the rows.
    """
    h, capp = svals.shape
    pos = torch.arange(capp, dtype=torch.int32, device=svals.device)
    nf = n.to(torch.int32)[:, None]
    xf = x.to(torch.float32)[:, None]
    live = sidx < nf
    si_r = torch.where(live & (sidx >= j), sidx + 1, sidx)
    drop = live & (si_r >= cap)
    order = torch.argsort(drop.to(torch.int32), dim=1, stable=True)
    sv2 = torch.take_along_dim(svals, order, dim=1)
    si2 = torch.take_along_dim(si_r, order, dim=1)
    nlive = nf - drop.sum(dim=1, keepdim=True, dtype=torch.int32)
    before = (pos < nlive) & ((sv2 < xf) | ((sv2 == xf) & (si2 < j)))
    ins = before.sum(dim=1, keepdim=True, dtype=torch.int32)
    sv_prev = torch.cat([sv2[:, :1], sv2[:, :-1]], dim=1)
    si_prev = torch.cat([si2[:, :1], si2[:, :-1]], dim=1)
    sv3 = torch.where(pos < ins, sv2, torch.where(pos == ins, xf, sv_prev))
    si3 = torch.where(pos < ins, si2, torch.where(pos == ins, torch.full_like(si2, j), si_prev))
    n2 = torch.clamp(nlive + 1, max=cap)
    sv4 = torch.where(pos < n2, sv3, torch.full_like(sv3, torch.inf))
    si4 = torch.where(pos < n2, si3, pos.expand(h, -1)).to(torch.int32)
    apply = torch.full((h,), j < cap, dtype=torch.bool, device=svals.device)
    if aff is not None:
        apply = apply & aff
    return (torch.where(apply[:, None], sv4, svals),
            torch.where(apply[:, None], si4, sidx.to(torch.int32)),
            torch.where(apply, n2[:, 0], n.to(torch.int32)))
