"""Serving front end: one request at a time, by the host loop or the fused executor.

Port of ``repro/serving/server.py``.  Two execution modes per pipeline:

* ``host`` — the paper-faithful ``HostLoopExecutor`` (dynamic plans,
  bucketed buffers);
* ``fused`` — a request's ``(k, cap)`` sample buffers are gathered once
  (its power-of-two cap bucket, at most ``max_cap``'s) into a pinned host
  buffer, copied to the device asynchronously, and the whole
  iterate-until-guaranteed loop runs there: the one-lane case of the fused
  executor, on the card as CUDA graphs captured once per cap bucket.  With
  ``cache_size`` the buffers and AFC tables come from the hot-group
  feature cache (``serving/feature_cache.py``) instead.

:class:`ServerStats` holds the paper's §4 metrics: latency, speedup over the
exact baseline (``run_exact``), sample fraction and the guarantee rate.
Batches of requests are served by ``serving/batched.BatchedFusedServer``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.analysis.contracts import assert_compile_contract
from repro_torch.core import threefry
from repro_torch.core.executor import BiathlonConfig, HostLoopExecutor, run_exact
from repro_torch.core.executor_fused import build_fused_executor, pipeline_executor_kwargs
from repro_torch.core.pipeline import make_fused_model_fn
from repro_torch.data.store import HostStaging, bucket_size
from repro_torch.device import resolve_device
from repro_torch.serving.feature_cache import pipeline_feature_cache

__all__ = ["BiathlonServer", "ServerStats"]


@dataclass
class ServerStats:
    latencies: list = field(default_factory=list)
    exact_latencies: list = field(default_factory=list)
    errors_vs_exact: list = field(default_factory=list)
    sample_fracs: list = field(default_factory=list)
    iters: list = field(default_factory=list)
    satisfied: list = field(default_factory=list)
    y_hats: list = field(default_factory=list)
    y_exacts: list = field(default_factory=list)

    def summary(self, delta: float, task: str) -> dict:
        """Mean and p95 latency, mean exact latency, speedup (mean exact
        latency over mean latency), mean sample fraction and iterations, the
        guarantee rate (share of requests within δ of the exact answer, or
        of the same class) and the mean error against exact."""
        lat = np.array(self.latencies)
        if len(lat) == 0:
            # zero served requests: well-defined zeros and NaNs, never a crash
            return {
                "n": 0,
                "mean_latency_s": float("nan"),
                "p95_latency_s": float("nan"),
                "mean_exact_latency_s": float("nan"),
                "speedup": 0.0,
                "mean_sample_frac": float("nan"),
                "mean_iters": 0.0,
                "guarantee_rate": 0.0,
                "mean_abs_err_vs_exact": float("nan"),
            }
        ex = np.array(self.exact_latencies) if self.exact_latencies else np.array([np.nan])
        err = np.array(self.errors_vs_exact)
        within = (err <= max(delta, 1e-12) + 1e-9) if task == "regression" else (err == 0)
        return {
            "n": len(lat),
            "mean_latency_s": float(lat.mean()),
            "p95_latency_s": float(np.percentile(lat, 95)),
            "mean_exact_latency_s": float(np.nanmean(ex)),
            "speedup": float(np.nanmean(ex) / lat.mean()),
            "mean_sample_frac": float(np.mean(self.sample_fracs)),
            "mean_iters": float(np.mean(self.iters)),
            "guarantee_rate": float(np.mean(within)) if len(err) else 0.0,
            "mean_abs_err_vs_exact": float(err.mean()) if len(err) else float("nan"),
        }


class BiathlonServer:
    """Serves requests of one pipeline bundle on ``device`` (default CUDA).

    ``mode`` is ``"fused"`` (the port's default; callers that name no mode
    rely on it) or ``"host"`` (the reference's default).  ``afc_backend``
    picks the fused executor's AFC strategy (``"auto" | "incremental" |
    "ref"``); ``max_cap`` caps the fused per-request bucket (the
    reference's option, kept for parity: only a parity test sets it);
    ``use_kernel=False`` runs the plain PyTorch versions of the kernels on
    the card, and ``capture=False`` the fused executor's programs eagerly
    instead of as CUDA graphs, both for comparison only.

    ``cache_size`` (fused mode) turns on the hot-group feature cache
    (:attr:`cache`, an LRU of that many request shapes): the executor is
    built ``prebuilt=True`` and fed each request's device-resident buffers
    and AFC tables.  :attr:`compile_count` counts the executor's slots (on
    the card, captures of its three graphs), one per cap bucket in
    :attr:`compiled_buckets`; a cache hit builds none.
    """

    def __init__(
        self,
        bundle,
        config: BiathlonConfig | None = None,
        mode: str = "fused",
        afc_backend: str = "auto",
        *,
        max_cap: int | None = None,
        cache_size: int | None = None,
        device=None,
        use_kernel: bool = True,
        capture: bool | None = None,
    ):
        if mode not in ("host", "fused"):
            raise ValueError(f"mode must be 'host' or 'fused', got {mode!r}")
        self.device = resolve_device(device)
        self.bundle = bundle
        self.config = cfg = config or BiathlonConfig()
        self.mode = mode
        self.pipeline = p = bundle.pipeline
        self.store = bundle.store
        self.use_kernel = use_kernel
        self._max_cap = None if max_cap is None else bucket_size(max_cap)
        self._caps_seen: set[int] = set()
        self._fused = self.cache = None
        #: the registered contract(s) of the fused mode's slots
        self.contract = ("fused_prebuilt", "afc_precompute") if cache_size is not None \
            else ("fused",)
        p.model.to(self.device)
        if mode == "host":
            self._host = HostLoopExecutor(self.store, cfg, device=self.device,
                                          use_kernel=use_kernel)
            return
        feat_kwargs = pipeline_executor_kwargs(p.agg_features, self.device)
        self._agg_ids = feat_kwargs.pop("agg_ids")
        self._fused = build_fused_executor(
            make_fused_model_fn(p, self.device, use_kernel=use_kernel),
            k=p.k,
            task=p.task,
            n_classes=max(p.n_classes, 2),
            m=cfg.m,
            m_sobol=cfg.m_sobol,
            alpha=cfg.alpha,
            gamma=cfg.gamma,
            tau=cfg.tau,
            max_iters=cfg.max_iters,
            n_boot=cfg.n_bootstrap,
            afc_backend=afc_backend,
            device=self.device,
            use_kernel=use_kernel,
            capture=capture,
            prebuilt=cache_size is not None,
            **feat_kwargs,
        )
        self._staging = HostStaging(self.device)
        if cache_size is not None:
            self.cache = pipeline_feature_cache(
                self.store, p.k, cfg, feat_kwargs, maxsize=cache_size, device=self.device,
                use_kernel=use_kernel, staging=self._staging)

    @property
    def compile_count(self) -> int:
        """Slots the fused executor built (0 in host mode)."""
        return 0 if self._fused is None else self._fused.slots_built

    @property
    def compiled_buckets(self) -> list[int]:
        """Cap buckets the fused mode served."""
        return sorted(self._caps_seen)

    def check_compile_contract(self, *, buckets=None) -> None:
        """Assert the fused mode's slot count against :attr:`contract` (one
        slot a cap bucket; a cache hit builds none)."""
        assert_compile_contract(self, self.contract, buckets=buckets)

    def serve(self, request: dict, key=None) -> dict:
        """Serve one request.  ``key`` (a threefry key) seeds the host loop's
        QMC shifts and bootstrap; the fused mode draws from its fixed grid
        and ignores it."""
        p = self.pipeline
        if self.mode == "host":
            r = self._host.run(p, request, key)
            return {
                "y_hat": r.y_hat,
                "latency": r.t_total,
                "iters": r.iters,
                "sample_frac": r.sample_fraction,
                "prob": r.prob,
                "z": np.asarray(r.z),
                "n": np.asarray(r.n),
            }
        delta = self.config.delta if self.config.delta is not None else p.delta_default
        t0 = time.perf_counter()
        specs = p.agg_specs(request)
        n_np = p.group_sizes(self.store, request)
        cap = bucket_size(int(max(n_np.max(), 1)))  # the request's power-of-two bucket
        if self._max_cap is not None:
            cap = min(cap, self._max_cap)
        exact = torch.from_numpy(p.exact_feature_values(self.store, request)).to(self.device)
        self._caps_seen.add(cap)
        if self.cache is not None:
            entry = self.cache.get(specs, cap)
            res = self._fused(entry.vals, entry.n, self._agg_ids, delta, exact, entry.tables)
        else:
            buf = self._staging.gather(self.store, [specs], cap)
            sizes = torch.from_numpy(self.store.request_sizes(specs, cap))
            res = self._fused(buf[0], sizes, self._agg_ids, delta, exact)
            self._staging.release(buf)
        y = float(res.y_hat)
        dt = time.perf_counter() - t0
        return {
            "y_hat": y,
            "latency": dt,
            "iters": res.iters,
            "sample_frac": float(res.samples_used) / max(int(n_np.sum()), 1),
            "prob": float(res.prob),
            "z": res.z.cpu().numpy(),
            "n": np.minimum(n_np, cap).astype(np.int32),
            "cap": cap,
        }

    def serve_all(self, requests=None, compare_exact: bool = True, seed: int = 0) -> ServerStats:
        """Drain a request log (the bundle's by default) with keys
        ``PRNGKey(seed + i)``; with ``compare_exact`` also run the exact
        baseline of each request on the same device and path."""
        requests = requests if requests is not None else self.bundle.requests
        stats = ServerStats()
        for i, req in enumerate(requests):
            out = self.serve(req, threefry.PRNGKey(seed + i))
            stats.latencies.append(out["latency"])
            stats.iters.append(out["iters"])
            stats.sample_fracs.append(out["sample_frac"])
            stats.y_hats.append(out["y_hat"])
            if compare_exact:
                y_ex, t_ex = run_exact(self.store, self.pipeline, req, device=self.device,
                                       use_kernel=self.use_kernel)
                stats.exact_latencies.append(t_ex)
                stats.errors_vs_exact.append(abs(out["y_hat"] - y_ex))
                stats.y_exacts.append(y_ex)
        return stats
