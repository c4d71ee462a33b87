"""Serving launcher: ``python -m repro_torch.launch.serve --pipeline <name>``.

Port of ``repro/launch/serve.py``.  Builds one of the paper pipelines and
serves it through the chosen mode on ``--device`` (default ``cuda``;
``--device cpu`` runs the plain PyTorch versions on the CPU), printing the
paper's §4 metrics.

Modes:
  host              paper-faithful host loop, one request at a time
  fused             the fused executor, one request at a time (on the card,
                    CUDA graphs captured once per cap bucket)
  fused-batched     arrival-driven runtime: Poisson arrivals -> request
                    queue -> max-wait/max-size admission -> fixed-lane
                    batches (serving/runtime.py)
  fused-sharded     fused-batched with the lanes sharded over a 1-D mesh of
                    ``--devices`` shards (launch/mesh.py; default: every
                    visible card).  With ``--device cpu`` the shards are
                    simulated on the CPU (``simulated_devices``), as they
                    may be on one card by building the mesh in code
  fused-continuous  continuous batching: a persistent lane table advanced
                    ``--chunk-iters`` planner iterations per chunk, lanes
                    whose request is done refilled from the queue at chunk
                    boundaries (serving/continuous.py); --max-wait-ms does
                    not apply; ``--devices N`` shards the table

``--median`` serves the appendix-D AVG→MEDIAN variant; ``sensor_health``
has MEDIAN/QUANTILE features of its own.  On the batched and continuous
modes ``--slo-ms`` gives every arrival a latency budget, ``--degrade``
installs the knob-tier admission controller (serving/degrade.py), and
``--fault-profile`` wraps the server in a seeded fault schedule
(serving/faults.py): spikes, transient failures, an arrival burst, and on
``fused-continuous`` chunk and refill failures (rolled back and retried)
and ``poison`` (a lane's carry wrecked, the lane quarantined).
``--cache-size N`` serves the fused modes from the hot-group feature cache.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --pipeline turbofan --mode fused
  PYTHONPATH=src python -m repro_torch.launch.serve --pipeline turbofan \\
      --mode fused-batched --arrival-rate 80 --slo-ms 250 --degrade --fault-profile spikes
  PYTHONPATH=src python -m repro_torch.launch.serve --pipeline sensor_health \\
      --mode fused-continuous --arrival-rate 80 --batch-size 8 --chunk-iters 4
  PYTHONPATH=src python -m repro_torch.launch.serve --pipeline turbofan \\
      --mode fused-sharded --device cpu --devices 2 --rows-per-group 2000
  PYTHONPATH=src python -m repro_torch.launch.serve --pipeline turbofan --mode host \\
      --device cpu --rows-per-group 2000
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core.executor import BiathlonConfig
from repro_torch.data.synthetic import (
    PIPELINE_NAMES,
    make_pipeline,
    make_pipeline_median,
    poisson_arrivals,
)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_serving_mesh, simulated_devices
from repro_torch.serving import (
    BatchedFusedServer,
    BiathlonServer,
    ContinuousBatchedServer,
    ContinuousServingRuntime,
    DegradationController,
    FaultProfile,
    FaultyContinuousServer,
    FaultyServer,
    ServingRuntime,
    default_tiers,
    inject_burst,
)

__all__ = ["main"]

MODES = ("host", "fused", "fused-batched", "fused-continuous", "fused-sharded")


def _print_table(d: dict) -> None:
    for k, v in d.items():
        print(f"  {k:24s} {v:.4f}" if isinstance(v, float) else f"  {k:24s} {v}")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pipeline", choices=PIPELINE_NAMES, required=True)
    ap.add_argument("--mode", choices=MODES, default="host")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--devices", type=int, default=None,
                    help="shards of the serving mesh for fused-sharded (default: every "
                    "visible card) and fused-continuous (default: unsharded); simulated "
                    "on the CPU with --device cpu; --batch-size must be divisible by it")
    ap.add_argument("--chunk-iters", type=int, default=4,
                    help="planner iterations per chunk (fused-continuous)")
    ap.add_argument("--median", action="store_true",
                    help="appendix-D variant: AVG→MEDIAN substitution, retrained")
    ap.add_argument("--rows-per-group", type=int, default=20000)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--tau", type=float, default=0.95)
    ap.add_argument("--delta", type=float, default=None)
    ap.add_argument("--alpha", type=float, default=0.05)
    ap.add_argument("--gamma", type=float, default=0.01)
    ap.add_argument("--m", type=int, default=500)
    ap.add_argument("--arrival-rate", type=float, default=20.0,
                    help="Poisson arrival rate in requests/s")
    ap.add_argument("--batch-size", type=int, default=8, help="lanes of a batch or the table")
    ap.add_argument("--max-wait-ms", type=float, default=20.0,
                    help="admission max-wait in milliseconds (fused-batched)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-request latency budget in ms (deadline t + slo)")
    ap.add_argument("--degrade", action="store_true",
                    help="knob-tier admission controller and load shedding")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="shed when the queue exceeds this bound (--degrade)")
    ap.add_argument("--fault-profile", choices=("none", "spikes", "failures", "burst", "poison"),
                    default="none",
                    help="seeded fault schedule around the server; 'poison' is "
                    "fused-continuous only")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--cache-size", type=int, default=None,
                    help="hot-group feature cache entries (fused modes)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _arrivals(bundle, args):
    arrivals = poisson_arrivals(bundle.requests, args.arrival_rate, n=args.requests,
                                seed=args.seed)
    if args.fault_profile == "burst":
        arrivals = inject_burst(arrivals, at_t=arrivals[len(arrivals) // 2][0],
                                n=max(args.requests, 8), width_s=0.05, seed=args.fault_seed)
    return arrivals


def _continuous(srv, bundle, cfg, args, delta):
    arrivals = _arrivals(bundle, args)
    controller = None
    if args.degrade:
        # the controller's per-request service estimate from one measured
        # chunk of a full table: a request needs at most
        # ceil(max_iters / chunk_iters) chunks
        cap = srv.trace_cap([a[1] for a in arrivals])
        table, _ = srv.admit(srv.new_table(cap), cap,
                             [(lane, bundle.requests[lane % len(bundle.requests)], None)
                              for lane in range(args.batch_size)])
        srv.readback(srv.run_chunk(table))
        t0 = time.perf_counter()
        srv.readback(srv.run_chunk(table))
        chunk_s = time.perf_counter() - t0
        controller = DegradationController(
            default_tiers(cfg.tau, cfg.max_iters),
            service_est_s=chunk_s * -(-cfg.max_iters // args.chunk_iters),
            lanes=args.batch_size, max_queue=args.max_queue)
    # warm the inner server first: faults hit measured traffic only, with
    # call indices from 0
    ContinuousServingRuntime(srv).warmup([a[1] for a in arrivals])
    server = srv
    if args.fault_profile == "spikes":
        server = FaultyContinuousServer(
            srv, FaultProfile(seed=args.fault_seed, spike_prob=0.2, spike_s=0.25))
    elif args.fault_profile == "failures":
        server = FaultyContinuousServer(
            srv, FaultProfile(seed=args.fault_seed, chunk_fail_prob=0.1, refill_fail_prob=0.05))
    elif args.fault_profile == "poison":
        server = FaultyContinuousServer(srv, FaultProfile(seed=args.fault_seed, poison_prob=0.05))
    runtime = ContinuousServingRuntime(
        server, slo_s=None if args.slo_ms is None else args.slo_ms / 1e3, controller=controller)
    stats = runtime.run(arrivals, warmup=False)
    print(f"[serve] {args.pipeline} mode={args.mode} rate={args.arrival_rate:.1f}rps "
          f"lanes={args.batch_size} device={srv.device} devices={srv.n_devices} "
          f"chunk_iters={args.chunk_iters} "
          f"delta={delta:.4f} slo={args.slo_ms}ms degrade={args.degrade} "
          f"faults={args.fault_profile}")
    return stats.summary()


def _batched(srv, bundle, cfg, args, delta):
    controller = None
    if args.degrade:
        # the controller's service estimate from one measured full batch
        batch = [bundle.requests[i % len(bundle.requests)] for i in range(args.batch_size)]
        srv.serve_batch(batch)
        t0 = time.perf_counter()
        srv.serve_batch(batch)
        controller = DegradationController(
            default_tiers(cfg.tau, cfg.max_iters), service_est_s=time.perf_counter() - t0,
            lanes=args.batch_size, max_queue=args.max_queue)
    arrivals = _arrivals(bundle, args)
    ServingRuntime(srv).warmup([a[1] for a in arrivals])
    server = srv
    if args.fault_profile == "spikes":
        server = FaultyServer(srv, FaultProfile(seed=args.fault_seed, spike_prob=0.2,
                                                spike_s=0.25))
    elif args.fault_profile == "failures":
        server = FaultyServer(srv, FaultProfile(seed=args.fault_seed, fail_prob=0.15))
    runtime = ServingRuntime(
        server, max_wait_s=args.max_wait_ms / 1e3,
        slo_s=None if args.slo_ms is None else args.slo_ms / 1e3, controller=controller)
    stats = runtime.run(arrivals)
    print(f"[serve] {args.pipeline} mode={args.mode} rate={args.arrival_rate:.1f}rps "
          f"lanes={args.batch_size} device={srv.device} devices={srv.n_devices} "
          f"max_wait={args.max_wait_ms:.0f}ms "
          f"delta={delta:.4f} slo={args.slo_ms}ms degrade={args.degrade} "
          f"faults={args.fault_profile}")
    return stats.summary()


def main(argv=None) -> dict:
    """Parse ``argv``, serve, print the §4 table; returns the summary printed."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.devices is not None and args.mode not in ("fused-sharded", "fused-continuous"):
        ap.error("--devices shards the lanes of --mode fused-sharded or fused-continuous")
    if args.fault_profile == "poison" and args.mode != "fused-continuous":
        ap.error("--fault-profile poison wrecks a lane's carry at a chunk boundary; "
                 "use --mode fused-continuous")
    if args.cache_size is not None and args.mode == "host":
        ap.error("--cache-size requires a fused mode")
    dev = resolve_device(args.device)
    make = make_pipeline_median if args.median else make_pipeline
    bundle = make(args.pipeline, rows_per_group=args.rows_per_group, n_serve_groups=6,
                  n_requests=args.requests, device=dev)
    cfg = BiathlonConfig(tau=args.tau, delta=args.delta, alpha=args.alpha, gamma=args.gamma,
                         m=args.m, m_sobol=max(args.m // 4, 64))
    delta = cfg.delta if cfg.delta is not None else bundle.pipeline.delta_default

    mesh = None
    if args.mode == "fused-sharded" or args.devices is not None:
        if dev.type == "cpu":
            mesh = make_serving_mesh(devices=simulated_devices(args.devices or 1, dev))
        else:
            mesh = make_serving_mesh(args.devices)
    # with a mesh the shards' devices are the mesh's
    on = dict(device=dev) if mesh is None else dict(mesh=mesh)
    if args.mode == "fused-continuous":
        srv = ContinuousBatchedServer(bundle, cfg, batch_size=args.batch_size,
                                      chunk_iters=args.chunk_iters, cache_size=args.cache_size,
                                      **on)
        summary = _continuous(srv, bundle, cfg, args, delta)
    elif args.mode in ("fused-batched", "fused-sharded"):
        srv = BatchedFusedServer(bundle, cfg, batch_size=args.batch_size,
                                 cache_size=args.cache_size, **on)
        summary = _batched(srv, bundle, cfg, args, delta)
    else:
        srv = BiathlonServer(bundle, cfg, mode=args.mode, cache_size=args.cache_size, device=dev)
        srv.serve(bundle.requests[0])  # warm: every cap bucket of the first request
        summary = srv.serve_all(bundle.requests).summary(bundle.pipeline.delta_default,
                                                         bundle.pipeline.task)
        print(f"[serve] {args.pipeline} mode={args.mode} device={dev} delta={delta:.4f}"
              + (f" cache={args.cache_size}" if args.cache_size is not None else ""))
    _print_table(summary)
    cache = getattr(srv, "cache", None)
    if cache is not None:
        _print_table({f"cache_{k}": v for k, v in cache.stats.items()})
    if args.mode != "host":
        print(f"  {'slots_built':24s} {srv.compile_count} for buckets {srv.compiled_buckets}")
        srv.check_compile_contract()
    return summary


if __name__ == "__main__":
    main()
