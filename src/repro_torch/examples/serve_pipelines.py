"""Serving across the paper pipelines, host loop and fused executor, in PyTorch.

Port of ``examples/serve_pipelines.py``.  Drains each pipeline's request log
through ``BiathlonServer`` and prints the paper's §4 metrics (latency,
exact-baseline latency, speedup, sample fraction, guarantee rate), for the
paper-faithful host loop and for the fused executor.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_pipelines [--device cpu] [--small]
"""
from __future__ import annotations

import argparse

from repro_torch.core.executor import BiathlonConfig
from repro_torch.data.synthetic import PIPELINE_NAMES, make_pipeline
from repro_torch.device import resolve_device
from repro_torch.serving import BiathlonServer

__all__ = ["FULL", "SMALL", "run"]

FULL = dict(rows_per_group=40000, n_train_groups=200, n_serve_groups=6, n_requests=8)
SMALL = dict(rows_per_group=4000, n_train_groups=120, n_serve_groups=4, n_requests=5)


def run(device=None, scale: dict = FULL, config: BiathlonConfig | None = None,
        names=PIPELINE_NAMES) -> dict:
    """Serve every request of each pipeline in both modes after one warm-up
    request; prints a row per pipeline and mode and returns the summaries,
    ``{name: {mode: ServerStats.summary}}``."""
    dev = resolve_device(device)
    cfg = config or BiathlonConfig(m=400, m_sobol=96)
    print(f"{'pipeline':20s} {'mode':6s} {'lat_ms':>8} {'exact_ms':>9} "
          f"{'speedup':>8} {'frac':>6} {'guar':>5}   [{dev}]")
    out = {}
    for name in names:
        bundle = make_pipeline(name, device=dev, **scale)
        task, delta = bundle.pipeline.task, bundle.pipeline.delta_default
        out[name] = {}
        for mode in ("host", "fused"):
            srv = BiathlonServer(bundle, cfg, mode=mode, device=dev)
            srv.serve(bundle.requests[0])  # warm
            s = out[name][mode] = srv.serve_all(bundle.requests).summary(delta, task)
            print(f"{name if mode == 'host' else '':20s} {mode:6s} "
                  f"{s['mean_latency_s'] * 1e3:>8.1f} {s['mean_exact_latency_s'] * 1e3:>9.1f} "
                  f"{s['speedup']:>8.2f} {s['mean_sample_frac']:>6.3f} "
                  f"{s['guarantee_rate']:>5.2f}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--small", action="store_true", help="4000-row groups instead of 40000")
    args = ap.parse_args(argv)
    run(args.device, SMALL if args.small else FULL)


if __name__ == "__main__":
    main()
