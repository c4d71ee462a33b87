"""Biathlon's paper-faithful executor: the Planner ⇄ Executor loop (paper §3.1).

Port of ``repro/core/executor.py``.  :class:`HostLoopExecutor` is a Python
feedback loop over the AFC, AMI and planner stages with *bucketed* sample
buffers (power-of-two caps that grow with the live sample size, like an
online-aggregation scan); it is the reference server's default mode.  The
fused executor (``executor_fused.py``) runs the same algorithm over a fixed
``(k, cap)`` buffer.  Per request (paper Fig. 3):

    z ← ceil(α·N)
    loop:
        AFC:  x̂, U_x  ← online-aggregation estimates at plan z
        AMI:  ŷ, U_y  ← QMC uncertainty propagation (m samples)
        if Pr(|Y−ŷ| ≤ δ) ≥ τ:  return ŷ
        I  ← Sobol main-effect indices (Saltelli, QMC)
        z  ← min(z + γ·onehot(argmax_j I_j/(N_j−z_j)), N)

Plans and keys live on the host (numpy, threefry keys); buffers, estimates
and model calls on ``device``.  On the card the stages run the
``masked_select_ranks`` (holistic estimates), ``sobol_points`` (each QMC
grid) and ``ensemble_sum`` (tree models) kernels.  The stage timers read
the host clock after a device synchronize.  :func:`run_exact` is the
unoptimized baseline, the denominator of every speedup.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import guarantee, threefry
from repro_torch.core.pipeline import Pipeline, make_model_fn
from repro_torch.core.planner import direction, gamma_abs, initial_plan, next_plan
from repro_torch.core.propagation import propagate_classification, propagate_regression
from repro_torch.core.sobol_indices import main_effect_indices
from repro_torch.core.uncertainty import FeatureUncertainty
from repro_torch.data import aggregates
from repro_torch.data.store import ColumnStore, bucket_size
from repro_torch.device import resolve_device

__all__ = ["BiathlonConfig", "HostLoopExecutor", "RequestResult", "run_exact"]

f32 = torch.float32


@dataclass(frozen=True)
class BiathlonConfig:
    """Default configuration = the paper's §4 defaults.

    ``batch_afc``, ``adaptive_ami`` and ``ami_margin`` are the reference's
    host-loop knobs, kept for parity with its API: no caller in the port
    (server defaults, examples, ``chip_smoke.py``) changes them from these
    defaults; only the parity tests do.
    """

    alpha: float = 0.05        # initial sampling ratio
    gamma: float = 0.01        # step size as fraction of Σ N_j
    tau: float = 0.95          # confidence level
    delta: float | None = None  # error bound; None -> pipeline.delta_default
    m: int = 1000              # QMC samples for AMI
    m_sobol: int = 256         # QMC base samples for Saltelli indices
    n_bootstrap: int = 256     # bootstrap replicates B for MEDIAN/QUANTILE features
    max_iters: int = 64        # safety cap (the loop terminates at z = N anyway)
    batch_afc: bool = True     # host loop: one AFC pass for the parametric
                               # features over buffers kept per request
                               # (False: per-feature dispatch, the original)
    adaptive_ami: bool = False  # host loop: screen with max(m/8, 64) QMC rows,
                                # pay the full m only when the coarse prob
                                # lies within ami_margin of tau
    ami_margin: float = 0.04


@dataclass
class RequestResult:
    y_hat: float
    prob: float
    satisfied: bool
    iters: int
    samples_used: int
    samples_total: int
    z: np.ndarray
    n: np.ndarray
    t_afc: float = 0.0
    t_ami: float = 0.0
    t_planner: float = 0.0
    t_total: float = 0.0

    @property
    def sample_fraction(self) -> float:
        return self.samples_used / max(self.samples_total, 1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class HostLoopExecutor:
    """Paper-faithful iterative executor (dynamic plans, bucketed buffers).

    ``device`` defaults to CUDA and raises without a card;
    ``use_kernel=False`` runs the kernels' plain versions on the card (for
    comparison only).
    """

    def __init__(self, store: ColumnStore, config: BiathlonConfig | None = None, *,
                 device=None, use_kernel: bool = True):
        self.store = store
        self.config = config or BiathlonConfig()
        self.device = resolve_device(device)
        self.use_kernel = use_kernel

    # --- AFC ---------------------------------------------------------------
    def _estimate(self, f, buf: torch.Tensor, z: int, n: int, key) -> aggregates.AggResult:
        return aggregates.estimate(f.agg, buf, z, n, key, n_boot=self.config.n_bootstrap,
                                   quantile=f.quantile, use_kernel=self.use_kernel)

    def _afc(self, pipeline: Pipeline, request: dict, z: np.ndarray, n: np.ndarray, key,
             buffers: dict | None = None) -> FeatureUncertainty:
        """Approximate Feature Computation at plan ``z``.

        ``buffers`` caches the request's ``(k, cap)`` stack on the device:
        a wider plan reads a wider prefix of the SAME buffer, so the stack
        is gathered again only when the cap bucket of ``max(z)`` grows (paper
        §3.2's no-repeated-access property).
        """
        cfg = self.config
        if not cfg.batch_afc:
            return self._afc_naive(pipeline, request, z, n, key)
        feats = pipeline.agg_features
        k, dev = pipeline.k, self.device
        zs = np.where([f.approximate for f in feats], np.minimum(z, n), n).astype(np.int64)
        cap = bucket_size(int(max(zs.max(), 1)))
        buffers = buffers if buffers is not None else {}
        if buffers.get("cap", 0) < cap:
            stack = np.stack([self.store[f.table].sample_prefix(
                f.column, int(request[f.group_field]), cap) for f in feats])
            buffers["cap"], buffers["stack"] = cap, torch.from_numpy(stack).to(dev)
        stack = buffers["stack"]

        param_idx = [j for j, f in enumerate(feats) if f.agg in aggregates.PARAMETRIC_AGGS]
        hol_idx = [j for j in range(k) if j not in param_idx]
        value = torch.zeros((k,), dtype=f32, device=dev)
        sigma = torch.zeros((k,), dtype=f32, device=dev)
        reps = torch.zeros((k, cfg.n_bootstrap), dtype=f32, device=dev)
        emp = torch.zeros((k,), dtype=torch.bool, device=dev)
        if param_idx:
            p = torch.tensor(param_idx, device=dev)
            v, s = aggregates.masked_estimates_batch(
                stack[p],
                torch.from_numpy(zs[param_idx].astype(np.int32)).to(dev),
                torch.from_numpy(n[param_idx].astype(np.int32)).to(dev),
                torch.tensor([aggregates.AGG_IDS[feats[j].agg] for j in param_idx],
                             dtype=torch.int32, device=dev),
            )
            value[p], sigma[p] = v, s
            reps[p] = v[:, None]
        keys = threefry.split(key, max(len(hol_idx), 1))
        for i, j in enumerate(hol_idx):
            res = self._estimate(feats[j], stack[j], int(zs[j]), int(n[j]), keys[i])
            value[j], sigma[j], reps[j] = res.value, res.sigma, res.replicates
            emp[j] = res.is_empirical
        return FeatureUncertainty(value=value, sigma=sigma, replicates=reps, is_empirical=emp)

    def _afc_naive(self, pipeline: Pipeline, request: dict, z: np.ndarray, n: np.ndarray,
                   key) -> FeatureUncertainty:
        """Per-feature dispatch, each feature gathered at its own bucket."""
        results = []
        keys = threefry.split(key, pipeline.k)
        for j, f in enumerate(pipeline.agg_features):
            # non-approximated operators (the Fig. 10 ablation) are always exact
            zj = int(min(z[j], n[j])) if f.approximate else int(n[j])
            cap = bucket_size(max(zj, 1))
            buf = self.store[f.table].sample_prefix(f.column, int(request[f.group_field]), cap)
            results.append(self._estimate(f, torch.from_numpy(buf).to(self.device), zj,
                                          int(n[j]), keys[j]))
        return FeatureUncertainty(
            value=torch.stack([r.value for r in results]),
            sigma=torch.stack([r.sigma for r in results]),
            replicates=torch.stack([r.replicates for r in results]),
            is_empirical=torch.tensor([r.is_empirical for r in results], device=self.device),
        )

    # --- full request ---------------------------------------------------
    def run(self, pipeline: Pipeline, request: dict, key=None) -> RequestResult:
        """Serve one request; ``key`` is a threefry key (default ``PRNGKey(0)``)."""
        cfg, dev = self.config, self.device
        key = key if key is not None else threefry.PRNGKey(0)
        delta = cfg.delta if cfg.delta is not None else pipeline.delta_default
        if pipeline.task == "classification" and delta != 0.0:
            raise ValueError("classification pipelines require delta == 0 (paper §3)")

        t0 = time.perf_counter()
        n = pipeline.group_sizes(self.store, request)
        model_fn = make_model_fn(pipeline, pipeline.exact_feature_values(self.store, request),
                                 dev, use_kernel=self.use_kernel)
        n_t = torch.from_numpy(n.astype(np.int32))
        z = initial_plan(n_t, cfg.alpha).numpy()
        approx = np.array([f.approximate for f in pipeline.agg_features])
        z = np.where(approx, z, n)  # exact-only operators consume full groups
        step = gamma_abs(n_t, cfg.gamma)

        def propagate(unc, m_samples, k_ami):
            if pipeline.task == "regression":
                return propagate_regression(model_fn, unc, m_samples, k_ami,
                                            use_kernel=self.use_kernel)
            return propagate_classification(model_fn, unc, m_samples, pipeline.n_classes,
                                            k_ami, use_kernel=self.use_kernel)

        t_afc = t_ami = t_plan = 0.0
        it = 0
        buffers: dict = {}
        while True:
            it += 1
            key, k_afc, k_ami, k_sob = threefry.split(key, 4)

            t = time.perf_counter()
            unc = self._afc(pipeline, request, z, n, k_afc, buffers)
            _sync(dev)
            t_afc += time.perf_counter() - t

            t = time.perf_counter()
            if cfg.adaptive_ami:
                infu = propagate(unc, max(cfg.m // 8, 64), k_ami)
                prob_t, _ = guarantee.satisfied(infu, delta, cfg.tau, pipeline.task)
                if abs(float(prob_t) - cfg.tau) <= cfg.ami_margin:
                    infu = propagate(unc, cfg.m, k_ami)   # the uncertain band: full m
                    prob_t, _ = guarantee.satisfied(infu, delta, cfg.tau, pipeline.task)
                prob = float(prob_t)
                ok = prob >= cfg.tau
            else:
                infu = propagate(unc, cfg.m, k_ami)
                prob_t, ok_t = guarantee.satisfied(infu, delta, cfg.tau, pipeline.task)
                prob, ok = float(prob_t), bool(ok_t)
            y_hat = float(infu.y_hat)
            _sync(dev)
            t_ami += time.perf_counter() - t

            if ok or bool(np.all(z >= n)) or it >= cfg.max_iters:
                break

            t = time.perf_counter()
            est = main_effect_indices(
                model_fn, unc, cfg.m_sobol, k_sob, task=pipeline.task,
                y_hat=torch.tensor(y_hat, dtype=f32, device=dev), use_kernel=self.use_kernel,
            )
            z_t = torch.from_numpy(z.astype(np.int32))
            z = next_plan(z_t, direction(est.indices.cpu(), z_t, n_t), step, n_t).numpy()
            t_plan += time.perf_counter() - t

        t_total = time.perf_counter() - t0
        z = np.minimum(z, n)
        return RequestResult(
            y_hat=y_hat,
            prob=prob,
            satisfied=bool(prob >= cfg.tau) or bool(np.all(z >= n)),
            iters=it,
            samples_used=int(z.sum()),
            samples_total=int(n.sum()),
            z=z,
            n=n,
            t_afc=t_afc,
            t_ami=t_ami,
            t_planner=t_plan,
            t_total=t_total,
        )


def run_exact(store: ColumnStore, pipeline: Pipeline, request: dict, *, device=None,
              use_kernel: bool = True) -> tuple[float, float]:
    """The unoptimized baseline: every aggregate over ALL rows.

    Returns ``(prediction, wall seconds)``: ``Y`` in Eq. 1 and the
    denominator of every speedup.  Each feature's whole group is gathered
    at its power-of-two bucket, moved to ``device`` and estimated at
    ``z = n`` (``masked_select_ranks`` on the card for MEDIAN/QUANTILE);
    then one model call on one row.
    """
    dev = resolve_device(device)
    t0 = time.perf_counter()
    feats = []
    for f in pipeline.agg_features:
        gid = int(request[f.group_field])
        n = store[f.table].group_size(gid)
        buf = torch.from_numpy(store[f.table].sample_prefix(f.column, gid, bucket_size(n)))
        feats.append(float(aggregates.exact_value(f.agg, buf.to(dev), n, quantile=f.quantile,
                                                  use_kernel=use_kernel)))
    model_fn = make_model_fn(pipeline, pipeline.exact_feature_values(store, request), dev,
                             use_kernel=use_kernel)
    y = float(model_fn(torch.tensor([feats], dtype=f32, device=dev)).reshape(()))
    return y, time.perf_counter() - t0
