"""The fused Biathlon feedback loop for one request, in PyTorch.

Port of the single-request path of ``repro/core/executor_fused.py``
(``_executor_core`` + ``build_fused_executor``).  PyTorch has no
``lax.while_loop``, so the loop is a Python loop over a fixed-shape,
device-resident planner step, and the Eq. 1 predicate is read back once per
iteration.  The order of operations is the reference's:

* buffers clamp ``n`` to the cap; exact-only features start at ``z = n``,
  the others at ``z⁰ = ceil(α·n)``;
* the incremental AFC path builds the ``prefix_power_sums`` tables once per
  request, and for holistic (MEDIAN/QUANTILE) features a rank index over
  the ladder of ``max_iters + 1`` plans the planner can reach; the rescan
  path runs ``sampled_moments`` and, for holistic features,
  ``masked_select_ranks`` at every evaluation;
* holistic features carry a sorted ``(h, B)`` bootstrap-replicate table
  instead of a σ: the replicate ranks come from JAX's threefry bits
  (``core/threefry.py``) under ``fold_in(PRNGKey(boot_seed), it)``, with
  ``it`` = 0 at z⁰ and the iteration index after that, so the rescan and
  the incremental path draw the same ranks, and both draw the reference's;
* the z⁰ evaluation is AMI-only (``m + 1`` model rows); its Saltelli block
  (``(k+2)·m_sobol`` rows) runs only when the loop will be entered — the
  reference's ``lax.cond`` becomes a plain ``if``;
* each iteration steps ``z`` along the previous evaluation's Sobol
  direction, then evaluates the new plan with ONE model call on a megabatch
  of ``m + 1 + (k+2)·m_sobol`` rows: AMI rows, the point estimate, the
  Saltelli A/B/AB rows.

The QMC grid is fixed per executor, so its normal quantiles and the
holistic replicate-table indices are computed once at build time: the AMI
(m, k) and Saltelli (m_sobol, 2k) grids are views of one grid, one
``sobol_points`` launch on the card.  Classification pipelines read the
AMI rows' class frequencies (a bincount over ``n_classes``) at ŷ's class as
the guarantee probability, and take the main-effect indices of the
indicator ``f == ŷ``, as the reference does.  The chunked executor and
CUDA-graph capture are later slices of the port.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.core import threefry
from repro_torch.core.planner import direction, gamma_abs, initial_plan, next_plan
from repro_torch.core.propagation import qmc_grid
from repro_torch.core.qmc import uniform_to_normal
from repro_torch.core.uncertainty import replicate_indices, sample_features_fused
from repro_torch.data.aggregates import AGG_IDS_FULL, HOLISTIC_AGGS, estimates_from_power_sums
from repro_torch.device import resolve_device
from repro_torch.kernels.sampled_agg.ops import (
    bootstrap_rank_targets,
    finish_quantile_estimates,
    masked_estimates,
    masked_quantile_estimates,
    prefix_power_sums,
    resolve_afc_plan,
)
from repro_torch.kernels.sampled_agg.prefix_stats import (
    build_rank_index,
    prefix_moments_at,
    select_ranks_indexed,
)

__all__ = [
    "FusedResult",
    "build_fused_executor",
    "fused_rows_per_iteration",
    "guarantee_prob",
    "pipeline_executor_kwargs",
]

f32 = torch.float32


class FusedResult(NamedTuple):
    y_hat: torch.Tensor         # () f32
    prob: torch.Tensor          # () f32 Eq. 1 guarantee probability
    iters: int                  # planner iterations run
    z: torch.Tensor             # (k,) int32 final plan
    samples_used: torch.Tensor  # () int64


def fused_rows_per_iteration(k: int, m: int, m_sobol: int) -> int:
    """Model rows evaluated per planner iteration (the single megabatch)."""
    return m + 1 + (k + 2) * m_sobol


def pipeline_executor_kwargs(agg_features, device) -> dict:
    """Executor kwargs from a pipeline's ``agg_features``.

    Returns the ``holistic`` / ``quantiles`` (0.5 for a median) /
    ``approximate`` build arguments and the runtime ``agg_ids`` row (int32
    on ``device``).  Raises on operators outside AGG_IDS_FULL.
    """
    unsupported = sorted({f.agg for f in agg_features if f.agg not in AGG_IDS_FULL})
    if unsupported:
        raise ValueError(f"unsupported aggregates {unsupported}")
    holistic = tuple(j for j, f in enumerate(agg_features) if f.agg in HOLISTIC_AGGS)
    return dict(
        holistic=holistic,
        quantiles=tuple(
            0.5 if agg_features[j].agg == "median" else agg_features[j].quantile
            for j in holistic
        ),
        approximate=tuple(f.approximate for f in agg_features),
        agg_ids=torch.tensor(
            [AGG_IDS_FULL[f.agg] for f in agg_features], dtype=torch.int32, device=device
        ),
    )


def guarantee_prob(y_hat, mean, sd, delta):
    """Eq. 1 probability ``Pr(|Y − ŷ| ≤ δ)`` for ``Y ~ N(mean, sd²)``.

    A degenerate ``sd <= 1e-12`` means Y is deterministic at ``mean``, and
    the probability is the indicator ``|mean − ŷ| ≤ δ``.

    Subnormal convention: the indicator is decided in float64 from the
    float32 operands, so it is the answer of exact arithmetic and does not
    depend on whether a float32 path flushes subnormals to zero.  A bias of
    ``1e-38`` (a float32 subnormal) is therefore NOT within ``δ = 0``: at
    ``ŷ = 0, mean = 1e-38, sd = 0, δ = 0`` the probability is 0.  (The
    reference computes the bias in float32 on XLA, which may flush it to
    zero and answer 1.)
    """
    bias = mean - y_hat
    safe = torch.clamp(sd, min=1e-12)
    prob = torch.special.ndtr((delta - bias) / safe) - torch.special.ndtr(
        (-delta - bias) / safe
    )
    exact_bias = mean.to(torch.float64) - y_hat.to(torch.float64)
    within = (exact_bias.abs() <= delta.to(torch.float64)).to(f32)
    return torch.where(sd <= 1e-12, within, prob)


def build_fused_executor(
    model_fn,
    *,
    k: int,
    task: str,
    n_classes: int = 2,
    m: int = 512,
    m_sobol: int = 128,
    alpha: float = 0.05,
    gamma: float = 0.01,
    tau: float = 0.95,
    max_iters: int = 32,
    afc_backend: str = "auto",
    holistic: Sequence[int] = (),
    quantiles: Sequence[float] | None = None,
    n_boot: int = 256,
    boot_seed: int = 0,
    approximate: Sequence[bool] | None = None,
    device=None,
    use_kernel: bool = True,
):
    """Returns ``run(vals (k, cap), n (k,), agg_ids (k,), delta (), exact (e,)) -> FusedResult``.

    ``model_fn``: ``(rows (r, k), exact (e,)) -> (r,)`` predictions
    (regression values, or class ids ``0 .. n_classes − 1`` for
    ``task="classification"``), called exactly once per planner iteration
    on the megabatch.
    ``afc_backend`` picks the AFC strategy per cap bucket
    (``ops.resolve_afc_plan``); the implementation follows the device.
    ``holistic`` lists the MEDIAN/QUANTILE feature indices, ``quantiles``
    their q's (median = 0.5), ``n_boot`` the replicate count B and
    ``boot_seed`` the seed of the replicate ranks' key.
    ``use_kernel=False`` runs the plain versions on the card (for
    comparison only).  All tensors passed to ``run`` live on ``device``.
    """
    resolve_afc_plan(afc_backend)  # validate the string at build time
    if task not in ("regression", "classification"):
        raise ValueError(f"task must be 'regression' or 'classification', got {task!r}")
    classify = task == "classification"
    dev = resolve_device(device)
    approx = torch.tensor(
        [True] * k if approximate is None else list(approximate), dtype=torch.bool, device=dev
    )
    hol = tuple(int(j) for j in holistic)
    n_hol = len(hol)
    qs_list = [0.5] * n_hol if quantiles is None else [float(q) for q in quantiles]
    if len(qs_list) != n_hol:
        raise ValueError("quantiles must align with holistic indices")
    hol_idx = torch.tensor(hol, dtype=torch.int64, device=dev)
    qs = torch.tensor(qs_list, dtype=f32, device=dev)
    base_key = threefry.PRNGKey(boot_seed)
    # the fixed QMC grid, its normal quantiles and replicate indices, once per executor
    u_ami, u_sob = qmc_grid(m, m_sobol, k, device=dev, use_kernel=use_kernel)
    g_ami, g_sob = uniform_to_normal(u_ami), uniform_to_normal(u_sob)
    grids = {
        "ami": (g_ami, replicate_indices(u_ami, hol_idx, n_boot)),
        "a": (g_sob[:, :k], replicate_indices(u_sob[:, :k], hol_idx, n_boot)),
        "b": (g_sob[:, k:], replicate_indices(u_sob[:, k:], hol_idx, n_boot)),
    }
    eye = torch.eye(k, dtype=torch.bool, device=dev)
    classes = torch.arange(n_classes, device=dev)

    def sample(grid, value, sigma, reps):
        normals, rep_idx = grids[grid]
        return sample_features_fused(value, sigma, normals, reps, rep_idx, hol_idx)

    def ami_prob(y, y_hat, delta):
        """Eq. 1 guarantee probability from the AMI output slice; for
        classification the AMI rows' frequency of ŷ's class."""
        if classify:
            # bincount by comparison: torch.bincount reads its max back to the host
            counts = (y.to(torch.int64)[:, None] == classes[None, :]).sum(0)
            return (counts.to(f32) / m).gather(0, y_hat.to(torch.int64).reshape(1))[0]
        y_bar = y.mean()
        return guarantee_prob(y_hat, y_bar, torch.sqrt(((y - y_bar) ** 2).mean()), delta)

    def sobol_from_outputs(f_all, y_hat):
        """Main-effect indices from the pre-evaluated Saltelli block (of the
        indicator ``f == ŷ`` for classification)."""
        if classify:
            f_all = (f_all.to(torch.int32) == y_hat.to(torch.int32)).to(f32)
        f_all = f_all - f_all.mean()
        fa, fb = f_all[:m_sobol], f_all[m_sobol : 2 * m_sobol]
        fab = f_all[2 * m_sobol :].reshape(k, m_sobol)
        var_y = f_all.var(correction=0)
        v_j = (fb[None] * (fab - fa[None])).mean(dim=1)
        ratio = torch.clamp(v_j / torch.clamp(var_y, min=1e-12), 0.0, 1.0)
        return torch.where(var_y > 1e-12, ratio, torch.zeros_like(ratio))

    def sobol_rows(value, sigma, reps):
        """Saltelli A/B/AB block: ((k+2)·m_sobol, k)."""
        xa = sample("a", value, sigma, reps)
        xb = sample("b", value, sigma, reps)
        xab = torch.where(eye[:, None, :], xb[None], xa[None]).reshape(k * m_sobol, k)
        return torch.cat([xa, xb, xab], dim=0)

    def run(vals, n, agg_ids, delta, exact) -> FusedResult:
        cap = vals.shape[1]
        n = torch.clamp(n.to(torch.int32), max=cap)
        z0 = torch.where(approx, initial_plan(n, alpha), n)
        step = gamma_abs(n, gamma)
        delta = torch.as_tensor(delta, dtype=f32, device=dev)
        incremental = resolve_afc_plan(afc_backend, cap)
        if n_hol:
            vals_h, n_h = vals[hol_idx], n[hol_idx]
        if incremental:
            shift = vals[:, 0].contiguous()
            ptab = prefix_power_sums(vals, shift, use_kernel=use_kernel)
            if n_hol:
                # every plan the planner can reach: min(z⁰ + i·γ, n), i = 0..max_iters
                ladder = torch.arange(max_iters + 1, dtype=torch.int32, device=dev)
                zcand = torch.minimum(z0[:, None] + ladder[None, :] * step, n[:, None])
                rindex = build_rank_index(vals_h, n_h, zcand[hol_idx])

        def afc(z, it):
            """(value, sigma, replicates) at plan z; ``it`` keys the replicate ranks."""
            if incremental:
                value, sigma = estimates_from_power_sums(
                    prefix_moments_at(ptab, z), z, n, agg_ids, shift
                )
            else:
                value, sigma = masked_estimates(vals, z, n, agg_ids, use_kernel=use_kernel)
            if not n_hol:
                return value, sigma, None
            key = threefry.fold_in(base_key, it)
            z_h = z[hol_idx]
            if incremental:
                targets = bootstrap_rank_targets(z_h, qs, key, n_boot)
                q_val, reps = finish_quantile_estimates(
                    select_ranks_indexed(rindex, z_h, targets), z_h, n_h
                )
            else:
                q_val, reps = masked_quantile_estimates(
                    vals_h, z_h, n_h, qs, key, n_boot, use_kernel=use_kernel
                )
            value = value.index_copy(0, hol_idx, q_val)
            sigma = sigma.index_fill(0, hol_idx, 0.0)
            return value, sigma, reps

        def evaluate(z, it):
            value, sigma, reps = afc(z, it)
            batch = torch.cat(
                [sample("ami", value, sigma, reps), value[None, :],
                 sobol_rows(value, sigma, reps)], dim=0,
            )
            y_all = model_fn(batch, exact).to(f32)
            y_hat = y_all[m]
            return (y_hat, ami_prob(y_all[:m], y_hat, delta),
                    sobol_from_outputs(y_all[m + 1 :], y_hat))

        # z⁰: AMI-only dispatch; the Saltelli block only if the loop is entered
        value0, sigma0, reps0 = afc(z0, 0)
        y0_all = model_fn(
            torch.cat([sample("ami", value0, sigma0, reps0), value0[None, :]], 0), exact
        ).to(f32)
        z, y_hat = z0, y0_all[m]
        prob = ami_prob(y0_all[:m], y_hat, delta)

        def want_more():
            """The Eq. 1 loop predicate, read back once per iteration."""
            return bool(((prob < tau) & (z < n).any()).item())

        it = 0
        if max_iters > 0 and want_more():
            idx = sobol_from_outputs(
                model_fn(sobol_rows(value0, sigma0, reps0), exact).to(f32), y_hat
            )
            while True:
                z = next_plan(z, direction(idx, z, n), step, n)
                y_hat, prob, idx = evaluate(z, it + 1)
                it += 1
                if it >= max_iters or not want_more():
                    break
        return FusedResult(
            y_hat=y_hat, prob=prob, iters=it, z=z,
            samples_used=torch.minimum(z, n).sum(),
        )

    return run
