"""AFC entry points, routed by device: the CUDA kernels or their plain versions.

Port of ``repro/kernels/sampled_agg/ops.py``: the parametric power sums
and the holistic (MEDIAN/QUANTILE) bootstrap.  A CUDA tensor goes to the
hand-written kernel, a CPU tensor to the plain PyTorch version.
``use_kernel=False`` runs the plain version on the card too; it exists so
that tests and ``chip_smoke.py`` can compare the two.  Nothing
falls back silently: a kernel that fails to build or launch raises.

Buffers may carry leading lane dimensions, ``(L, k, cap)``: the fused
executor serves a batch of requests at once, and each entry point flattens
the lanes into rows so that the batch is ONE kernel launch over
``(L·k, cap)`` rows.  The bootstrap takes its keys as device tensors, one
row of derived keys a lane (:func:`boot_key_table`), so that a step
captured in a CUDA graph copies nothing from the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.data.aggregates import estimates_from_power_sums
from repro_torch.kernels.sampled_agg import prefix_stats
from repro_torch.kernels.sampled_agg.quantile_select import masked_select_ranks
from repro_torch.kernels.sampled_agg.ref import masked_select_ranks_ref, sampled_moments_ref
from repro_torch.kernels.sampled_agg.sampled_agg import sampled_moments
from repro_torch.numerics import fma, log, sqrt

__all__ = [
    "AFC_BACKENDS",
    "AFC_REF_MAX_CAP",
    "beta_order_stat",
    "boot_key_table",
    "bootstrap_rank_targets",
    "finish_quantile_estimates",
    "masked_estimates",
    "masked_quantile_estimates",
    "moments",
    "mt_keys",
    "prefix_power_sums",
    "resolve_afc_plan",
    "select_ranks",
]

f32 = torch.float32

#: Cap bucket at or below which "auto" takes the rescan path.  The
#: reference's threshold, kept for plan parity; it was calibrated on the
#: reference's hardware and has not been re-measured on the H100.
AFC_REF_MAX_CAP = 1024

AFC_BACKENDS = ("auto", "incremental", "ref")


def resolve_afc_plan(afc_backend: str, cap: int | None = None, *, cached: bool = False) -> bool:
    """Whether the executor takes the incremental AFC path.

    ``"incremental"``: the once-per-request prefix tables
    (``prefix_power_sums``) and an O(1) gather per evaluation.  ``"ref"``:
    the rescan, one ``sampled_moments`` pass per evaluation, as in the
    reference.  ``"auto"``: rescan for cap buckets at or below
    :data:`AFC_REF_MAX_CAP`, incremental above (``cap=None`` validates the
    string only and answers incremental).  ``cached=True`` declares an
    executor fed prebuilt tables by the feature cache
    (``serving/feature_cache.py``): a hit pays no set-up, so "auto" is
    incremental at every cap; ``"ref"`` and ``"incremental"`` still win.
    The backend picks the strategy only; which implementation runs follows
    the device.
    """
    if afc_backend not in AFC_BACKENDS:
        raise ValueError(f"unknown afc_backend {afc_backend!r}; choose from {AFC_BACKENDS}")
    if afc_backend == "auto":
        return cached or cap is None or cap > AFC_REF_MAX_CAP
    return afc_backend == "incremental"


def _rows(t: torch.Tensor, trailing: int) -> torch.Tensor:
    """``t`` with its leading dimensions flattened into one (rows first)."""
    return t.reshape((-1,) + tuple(t.shape[t.dim() - trailing:]))


def prefix_power_sums(
    vals: torch.Tensor, shift: torch.Tensor | None = None, *, use_kernel: bool = True
) -> torch.Tensor:
    """(..., cap) -> (..., cap, 4) running prefix power sums of ``vals - shift``,
    one launch over all rows."""
    rows = _rows(vals, 1).contiguous()
    shift = None if shift is None else shift.reshape(-1).contiguous()
    if use_kernel and vals.is_cuda:
        out = prefix_stats.prefix_power_sums(rows, shift)
    else:
        out = prefix_stats.prefix_power_sums_ref(rows, shift)
    return out.reshape(tuple(vals.shape) + (prefix_stats.N_POWERS,))


def moments(
    vals: torch.Tensor,
    z: torch.Tensor,
    shift: torch.Tensor | None = None,
    *,
    use_kernel: bool = True,
) -> torch.Tensor:
    """(..., cap), (...) -> (..., 5) ``[count, s1, s2, s3, s4]`` of ``vals - shift``,
    one launch over all rows."""
    rows, zr = _rows(vals, 1).contiguous(), z.reshape(-1)
    shift = None if shift is None else shift.reshape(-1).contiguous()
    if use_kernel and vals.is_cuda:
        out = sampled_moments(rows, zr, shift)
    else:
        out = sampled_moments_ref(rows, zr, shift)
    return out.reshape(tuple(z.shape) + (5,))


def masked_estimates(
    vals: torch.Tensor,
    z: torch.Tensor,
    n: torch.Tensor,
    agg_ids: torch.Tensor,
    *,
    use_kernel: bool = True,
):
    """Rescan AFC: one power-sum pass at plan z -> (value, sigma) per feature.

    ``vals (..., k, cap)``; ``z``, ``n``, ``agg_ids`` of shape ``(..., k)``.
    Sums are taken about each feature's first buffered sample, so the
    4th-moment cancellation stays at O(std⁴) when |mean| >> std.
    """
    shift = vals[..., 0].contiguous()
    mom = moments(vals, z, shift, use_kernel=use_kernel)
    value, sigma = estimates_from_power_sums(
        mom.reshape(-1, 5), z.reshape(-1), n.reshape(-1),
        torch.broadcast_to(agg_ids, z.shape).reshape(-1), shift.reshape(-1))
    return value.reshape(z.shape), sigma.reshape(z.shape)


def select_ranks(
    vals: torch.Tensor, z: torch.Tensor, targets: torch.Tensor, *, use_kernel: bool = True
) -> torch.Tensor:
    """(h, cap), (h,), (h, R) -> (h, R) order statistics of each z-prefix."""
    if use_kernel and vals.is_cuda:
        return masked_select_ranks(vals, z, targets)
    return masked_select_ranks_ref(vals, z, targets)


def _mt_keys(key, rounds: int) -> np.ndarray:
    """(2, rounds, 2): the normal keys, then the uniform keys, of each round.

    Round ``i`` of the reference draws from ``split(split(key, rounds)[i])``.
    """
    return np.stack([threefry.split(kk) for kk in threefry.split(key, rounds)], axis=1)


def mt_keys(key, rounds: int = 4) -> np.ndarray:
    """(2, rounds, 2, 2) keys of one Beta draw under ``key``, by
    [normal | uniform, round, gamma a | b, word]: the two gammas draw under
    ``split(key)``, each round as :func:`_mt_keys` says."""
    ka, kb = threefry.split(key)
    return np.stack([_mt_keys(ka, rounds), _mt_keys(kb, rounds)], axis=2)


def boot_key_table(base_key, max_iters: int, rounds: int = 4) -> np.ndarray:
    """(max_iters + 1, 2, rounds, 2, 2) uint32: :func:`mt_keys` of
    ``fold_in(base_key, it)`` for it = 0 .. max_iters.

    The planner's evaluation ``it`` keys its replicate ranks with
    ``fold_in(base_key, it)``, and ``it`` never passes ``max_iters``; so
    the fused executor derives every key once, with the host's own
    functions (bitwise by construction), keeps the table on the card and
    gathers each lane's row by its ``it`` there.
    """
    return np.stack([mt_keys(threefry.fold_in(base_key, it), rounds)
                     for it in range(max_iters + 1)])


def _mt_select(d: torch.Tensor, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Marsaglia-Tsang Gamma(d + 1/3) from proposals ``x, u`` of shape (rounds, *d).

    The first accepted round wins; none accepted gives the mean.  All
    rounds are evaluated at once, then the first acceptance is selected,
    which is what the reference's sequential rounds compute.  The
    multiply-adds round once and ``log`` is XLA's own, as in the
    reference's fused program.  ``c = 1/√(9d)`` is correctly rounded; XLA's
    CPU backend takes it from the processor's reciprocal-square-root
    estimate and two Newton steps, which can differ in the last bit, and
    then, rarely, ``d·v`` or an acceptance differs too.
    """
    c = 1.0 / sqrt(9.0 * d)
    b = fma(c, x, 1.0)
    v = b * (b * b)
    pos = v > 0.0
    safe_v = torch.where(pos, v, torch.ones_like(v))
    rhs = fma(-d, safe_v, fma(0.5 * x, x, d))
    rhs = fma(d, log(safe_v), rhs)
    ok = pos & (log(u) < rhs)
    first = torch.argmax(ok.to(torch.int8), dim=0, keepdim=True)  # first accepted round
    picked = torch.take_along_dim(d * safe_v, first, dim=0)[0]
    return torch.where(ok.any(dim=0), picked, d + float(np.float32(1.0 / 3.0)))


def _gamma_mt(keys: torch.Tensor, d: torch.Tensor, lanes: int = 0) -> torch.Tensor:
    """Gamma(a ≥ 1), ``d = a − 1/3``, in a fixed number of proposal rounds.

    Port of the reference's ``_gamma_mt``: round ``i`` draws its normal
    and its uniform (``minval=1e-38``) from ``split(split(key, rounds)[i])``.
    ``keys`` are those round keys as int64, ``(*L, 2, rounds, *G, 2)``: a
    lane axis ``L`` of ``lanes`` dims and a stack ``G`` of gammas
    (:func:`_mt_keys` of one key is ``(2, rounds, 2)``).  ``d`` is ``(*G,
    *L, *per_key)``; every key draws ``per_key`` proposals, all in one hash.
    """
    stack = keys.dim() - 3 - lanes
    per_key = tuple(d.shape[stack + lanes:])
    bits = threefry.random_bits(keys.reshape(-1, 2), per_key, device=d.device)
    bits = bits.reshape(tuple(keys.shape[:-1]) + per_key)
    # lanes after [normal | uniform, round, *G]: (2, rounds, *G, *L, *per_key)
    bits = bits.movedim(tuple(range(lanes)), tuple(range(2 + stack, 2 + stack + lanes)))
    x = threefry.bits_to_normal(bits[0])
    u = threefry.bits_to_uniform(bits[1], 1e-38)
    return _mt_select(d, x, u)


def beta_order_stat(key, a: torch.Tensor, b: torch.Tensor, shape, rounds: int = 4):
    """Beta(a, b) draws for a, b ≥ 1 as ``ga / (ga + gb)`` of two MT gammas.

    ``key`` is one threefry key (host), or derived keys as an int64 tensor
    on the draw's device: :func:`mt_keys` of one key ``(2, rounds, 2, 2)``,
    or of one key a lane ``(L, 2, rounds, 2, 2)``, where ``shape = (L,
    *per_lane)`` and lane ``l`` draws what its own key alone would.  Both
    gammas are one :func:`_gamma_mt` call (one hash, one acceptance pass);
    the bits are those of the reference's separate draws.
    """
    shape = tuple(shape)
    if not torch.is_tensor(key):
        key = torch.from_numpy(mt_keys(key, rounds).astype(np.int64))
    lanes = key.dim() - 4
    if key.shape[lanes:] != (2, rounds, 2, 2) or tuple(key.shape[:lanes]) != shape[:lanes]:
        raise ValueError(f"beta_order_stat: keys {tuple(key.shape)} do not fit draws {shape}")
    third = float(np.float32(1.0 / 3.0))
    d = torch.stack([torch.broadcast_to(a.to(f32), shape),
                     torch.broadcast_to(b.to(f32), shape)]) - third    # (2, *shape)
    g = _gamma_mt(key, d, lanes)
    return g[0] / (g[0] + g[1])


def bootstrap_rank_targets(z: torch.Tensor, qs: torch.Tensor, key, n_boot: int) -> torch.Tensor:
    """(..., h, 1 + B) int32 rank targets: [point-estimate rank | bootstrap ranks].

    The point rank is ``floor(q·(z − 1) + 0.5)``; replicate ``b`` is the
    order statistic ``floor(z·V)``, ``V ~ Beta(rank + 1, z − rank)``: the
    (rank+1)-th smallest of z uniform index draws, i.e. the rank-r quantile
    of a size-z resample with replacement (paper appendix D).  Shared by
    the rescan and the incremental path, so both draw the same ranks.
    ``z`` is ``(h,)`` under one key, or ``(L, h)`` under the lanes' derived
    keys (see :func:`beta_order_stat`).
    """
    z = z.to(torch.int32)
    zf = z.to(f32)
    zm1 = torch.clamp(z - 1, min=0)
    rank = torch.floor(fma(qs.to(f32), zf - 1.0, 0.5)).to(torch.int32)
    rank = torch.minimum(torch.clamp(rank, min=0), zm1)
    a = (rank + 1).to(f32)
    b = torch.clamp(z - rank, min=1).to(f32)
    v = beta_order_stat(key, a[..., None], b[..., None], tuple(z.shape) + (n_boot,))
    boot = torch.floor(zf[..., None] * v).to(torch.int32)
    boot = torch.minimum(torch.clamp(boot, min=0), zm1[..., None])
    return torch.cat([rank[..., None], boot], dim=-1)


def finish_quantile_estimates(sel: torch.Tensor, z: torch.Tensor, n: torch.Tensor):
    """(value (..., h), sorted replicates (..., h, B)) from selected
    (..., h, 1 + B) order stats.

    Empty prefix -> (0, zeros); exact (z ≥ n) -> a degenerate replicate
    table at the exact quantile; otherwise the point value and the sorted
    replicates.
    """
    empty = z <= 0
    value = torch.where(empty, torch.zeros_like(sel[..., 0]), sel[..., 0])
    reps = torch.sort(sel[..., 1:], dim=-1).values
    reps = torch.where((z >= n)[..., None], value[..., None], reps)
    reps = torch.where(empty[..., None], torch.zeros_like(reps), reps)
    return value, reps


def masked_quantile_estimates(
    vals: torch.Tensor,
    z: torch.Tensor,
    n: torch.Tensor,
    qs: torch.Tensor,
    key,
    n_boot: int,
    *,
    use_kernel: bool = True,
):
    """Holistic rescan AFC: (value (..., h), sorted replicates (..., h, B)).

    Draws the (..., h, 1 + B) rank targets and selects them all in one
    ``masked_select_ranks`` pass over the (..., h, cap) buffers as rows.
    """
    targets = bootstrap_rank_targets(z, qs, key, n_boot)
    sel = select_ranks(_rows(vals, 1).contiguous(), z.reshape(-1), _rows(targets, 1),
                       use_kernel=use_kernel)
    return finish_quantile_estimates(sel.reshape(targets.shape), z, n)
