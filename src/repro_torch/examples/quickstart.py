"""Quickstart: serve one inference pipeline with Biathlon, in PyTorch.

Port of ``examples/quickstart.py``.  Builds the Trip-Fare pipeline
(synthetic NYC-taxi-like data, gradient-boosted trees trained in-repo),
then serves its request log two ways:

  * exact baseline: every aggregate over all rows (the paper's ``Y``),
  * Biathlon: adaptive approximate aggregation with the Eq. 1 guarantee
    ``Pr(|Y - y| <= delta) >= tau``, by the paper-faithful host loop.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu] [--small]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import threefry
from repro_torch.core.executor import BiathlonConfig, HostLoopExecutor, run_exact
from repro_torch.data.synthetic import make_pipeline
from repro_torch.device import resolve_device

__all__ = ["FULL", "SMALL", "run"]

FULL = dict(rows_per_group=40000, n_train_groups=200, n_serve_groups=6, n_requests=8)
SMALL = dict(rows_per_group=4000, n_train_groups=120, n_serve_groups=4, n_requests=5)


def run(device=None, scale: dict = FULL, config: BiathlonConfig | None = None) -> list[dict]:
    """Build the pipeline at ``scale``, warm both paths on request 0, then
    serve every request exactly and by Biathlon; prints a table and returns
    one dict per request."""
    dev = resolve_device(device)
    bundle = make_pipeline("trip_fare", device=dev, **scale)
    pipe, store = bundle.pipeline, bundle.store
    delta, tau = pipe.delta_default, 0.95
    print(f"trip_fare: {bundle.table_rows} rows; model=GBDT  k={pipe.k} aggregate features  "
          f"delta=MAE={delta:.3f}  tau={tau}  device={dev}")
    executor = HostLoopExecutor(store, config or BiathlonConfig(m=500, m_sobol=128), device=dev)
    executor.run(pipe, bundle.requests[0], threefry.PRNGKey(99))
    run_exact(store, pipe, bundle.requests[0], device=dev)

    print(f"\n{'req':>4} {'exact':>10} {'biathlon':>10} {'err':>8} "
          f"{'frac':>6} {'iters':>5} {'t_exact':>8} {'t_bia':>8}")
    rows = []
    for i, req in enumerate(bundle.requests):
        y_exact, t_exact = run_exact(store, pipe, req, device=dev)
        r = executor.run(pipe, req, threefry.PRNGKey(i))
        rows.append(dict(y_exact=y_exact, y_hat=r.y_hat, err=abs(r.y_hat - y_exact),
                         frac=r.sample_fraction, iters=r.iters, t_exact=t_exact,
                         t_biathlon=r.t_total))
        print(f"{i:>4} {y_exact:>10.3f} {r.y_hat:>10.3f} {rows[-1]['err']:>8.3f} "
              f"{r.sample_fraction:>6.3f} {r.iters:>5} "
              f"{t_exact * 1e3:>7.1f}ms {r.t_total * 1e3:>7.1f}ms")
    fracs = [r["frac"] for r in rows]
    within = np.mean([r["err"] <= delta for r in rows])
    print(f"\nguarantee satisfied: {within:.0%} of requests (target >= {tau:.0%})")
    print(f"mean data touched:   {np.mean(fracs):.1%} of rows "
          f"(I/O-bound speedup bound: {1 / np.mean(fracs):.1f}x)")
    print(f"mean wall speedup:   {np.mean([r['t_exact'] / r['t_biathlon'] for r in rows]):.2f}x "
          f"on {dev}")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--small", action="store_true", help="4000-row groups instead of 40000")
    args = ap.parse_args(argv)
    run(args.device, SMALL if args.small else FULL)


if __name__ == "__main__":
    main()
