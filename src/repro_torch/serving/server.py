"""Serving front end: one request at a time through the fused executor.

Port of ``repro/serving/server.py::BiathlonServer`` in ``mode="fused"``: a
request's ``(k, cap)`` sample buffers are gathered once (power-of-two cap
buckets up to the store-wide ceiling), moved to the device, and the whole
iterate-until-guaranteed loop runs there.  The host-loop mode, the
hot-group feature cache and the batched servers are later slices.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.executor import BiathlonConfig
from repro_torch.core.executor_fused import build_fused_executor, pipeline_executor_kwargs
from repro_torch.core.pipeline import make_fused_model_fn
from repro_torch.data.store import bucket_size
from repro_torch.device import resolve_device

__all__ = ["BiathlonServer"]


class BiathlonServer:
    """Serves requests of one pipeline bundle on ``device`` (default CUDA).

    ``afc_backend`` picks the AFC strategy (``"auto" | "incremental" |
    "ref"``); ``use_kernel=False`` runs the plain PyTorch versions of the
    kernels on the card, for comparison only.
    """

    def __init__(
        self,
        bundle,
        config: BiathlonConfig | None = None,
        mode: str = "fused",
        afc_backend: str = "auto",
        *,
        device=None,
        use_kernel: bool = True,
    ):
        if mode != "fused":
            raise NotImplementedError(
                f"mode={mode!r}: the PyTorch port serves mode='fused' only; the "
                "host-loop executor is a later slice"
            )
        self.device = resolve_device(device)
        self.bundle = bundle
        self.config = config or BiathlonConfig()
        self.mode = mode
        self.pipeline = p = bundle.pipeline
        self.store = bundle.store
        cfg = self.config
        p.model.to(self.device)
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
            **feat_kwargs,
        )

    def serve(self, request: dict) -> dict:
        p = self.pipeline
        delta = self.config.delta if self.config.delta is not None else p.delta_default
        t0 = time.perf_counter()
        specs = p.agg_specs(request)
        n_np = p.group_sizes(self.store, request)
        cap = bucket_size(int(max(n_np.max(), 1)))  # the request's power-of-two bucket
        vals, sizes = self.store.request_buffers(specs, cap, self.device)
        exact = torch.from_numpy(p.exact_feature_values(self.store, request)).to(self.device)
        res = self._fused(vals, sizes, self._agg_ids, delta, exact)
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
