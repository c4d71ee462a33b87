"""Run one cell of the port's benchmark on the card and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the card's name, power limit and
clocks first, each compared number beside its limit as the last lines on
standard error, and the result as one JSON object on the last line of
standard output: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the traced slice's device time and
breakdown.  Exits non-zero and prints no result without a CUDA card (or
with fewer than the cell asks for), without the port's sources beside the
benchmark, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a non-negative integer")
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: the port's sources (src/repro_torch) are not in this checkout",
              file=sys.stderr)
        return 3
    # one process with few threads: the host's work is one Python thread
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    # the program's kernel caches stay inside the checkout, at fixed paths
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(ROOT / "build" / "inductor"))
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from portbench import bench, catalog

    bm = catalog.benchmark()
    cells = {w["name"]: w for w in bm["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    print(f"card: {bench.card_line()}", flush=True)
    ctx = bench.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                         device="cuda", t_start=T_START)
    section = "per_layer" if args.trace else "end_to_end"
    metrics = bench.read_metrics(ctx, catalog.reported(bm, section, args.workload))
    print(f"card after: {bench.card_line()}", flush=True)
    bad = bench.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": ctx.memory_peak}
    result = {"correct": bool(ctx.correct), "attempted": ctx.attempted, "failed": ctx.failed,
              "metrics": metrics, "device": device}
    if args.trace:
        if ctx.trace is None:
            print("portbench: the profiler traced no device operation", file=sys.stderr)
            return 5
        device["busy_s"] = ctx.trace["busy_s"]
        device["window_s"] = ctx.trace["window_s"]
        result["breakdown"] = {"device_ops": ctx.trace["device_ops"],
                               "idle_gaps": ctx.trace["idle_gaps"]}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim, _ok in ctx.checks}
    if ctx.overrun:
        print(f"portbench: {ctx.overrun}", file=sys.stderr)
    print(f"window: {ctx.window_s:.3f} s, {ctx.attempted} requests offered, "
          f"{ctx.failed} not served; segments end at "
          f"{[round(t, 3) for t in ctx.segment_ends_s]} s", file=sys.stderr)
    for name, value, limit, ok in ctx.checks:
        print(f"check {name} {value!r} limit {limit!r} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
