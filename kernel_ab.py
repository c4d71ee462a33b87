#!/usr/bin/env python3
"""Time one of this checkout's CUDA kernels against another build of its source.

    PYTHONPATH=src python3 kernel_ab.py KERNEL OTHER.cu

KERNEL is ``flash_attention``, ``ensemble_sum`` or ``prefix_power_sums``;
``OTHER.cu`` another version of its source under ``src/repro_torch/kernels/
csrc/`` (``flash_attention.cu``, ``tree_qmc.cu``, ``prefix_stats.cu``), for
example the file at a parent commit (``git show HEAD~:src/...``).  It is
built with the port's nvcc command into ``build/repro_torch/ab-other.so``;
its C entry point must take this tree's arguments, as both libraries are
called through the wrapper's own launch code (``launch_with``), so only
the loaded library differs.  On one card both run in turns (other, this,
this, other) at the
shapes the served paths give the kernel, each output held to the plain
version (bitwise for ``ensemble_sum``; the tables' tolerance for
``prefix_power_sums``; the card tests' bf16 tolerance for
``flash_attention``).  Device times per call come from CUDA-graph replay,
beside the eager time of back-to-back launches (``chip_smoke.time_ms``);
whether the two give the same bits is reported; ``ensemble_sum`` and
``prefix_power_sums`` also time each other launch plan of this tree once,
the earlier designs among them (the global and rows paths).  Prints the card,
one line a shape, and a JSON object of every time as the last line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke

ROOT = Path(__file__).resolve().parent
TURNS = ("other", "this", "this", "other")


def turns(runs: dict, check, reps: int) -> dict:
    """Device and eager ms of each run in turns, every output checked, and
    whether the two builds give the same bits."""
    times, outs = {}, {}
    for turn, name in enumerate(TURNS):
        dev_ms, eager_ms = chip_smoke.time_ms(runs[name], reps)
        times[f"{name}_{turn}"] = dev_ms
        times[f"{name}_{turn}_eager"] = eager_ms
        outs[name] = runs[name]()
        check(name, outs[name])
    times["bitwise_equal"] = torch.equal(outs["other"], outs["this"])
    return times


def ab_flash(other_lib):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    other_fn = fa.bind(other_lib)
    entries = {"other": lambda: other_fn, "this": fa._fn}
    gen = torch.Generator().manual_seed(0)
    results = {}
    for shape in [(1, 16, 4096, 64), (1, 16, 4096, 128), (1, 16, 48, 64), (1, 16, 512, 256)]:
        q, k, v = (torch.randn(shape, generator=gen).to("cuda", torch.bfloat16) for _ in range(3))
        want = flash_attention_ref(q, k, v, causal=True).float()

        def check(name, got, shape=shape, want=want):
            chip_smoke.require(torch.allclose(got.float(), want, **chip_smoke.ATTN_TOL[q.dtype]),
                               f"{name} kernel differs from the plain version at {shape}")

        runs = {n: (lambda n=n: fa.launch_with(entries[n], q, k, v, causal=True))
                for n in entries}
        times = turns(runs, check, 20 if shape[2] < 1024 else 5)
        times["sdpa"] = chip_smoke.time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 5)[0]
        results["x".join(map(str, shape))] = times
    return results


def ab_ensemble(other_lib):
    from repro_torch.kernels.tree_qmc import tree_qmc
    from repro_torch.kernels.tree_qmc.ops import predict_sum
    from repro_torch.models.tabular.trees import GradientBoosting, RandomForest

    rng = np.random.default_rng(0)
    X = rng.normal(0, 1, (2000, 9)).astype(np.float32)
    y = X[:, 0] * 2 + np.sin(3 * X[:, 1])
    forests = {"rf_40x511": RandomForest(n_trees=40, max_depth=8).fit(X, y),
               "gbm_60x63": GradientBoosting(n_trees=60, max_depth=5).fit(X, y)}
    fn = tree_qmc.bind(other_lib)
    other = lambda ens, x: tree_qmc.launch_with(  # noqa: E731
        lambda: fn, *chip_smoke.tree_tables(ens), x, depth=ens.depth)
    results = {}
    # the megabatches the served paths give it (z⁰, the Saltelli block, an
    # iteration: turbofan 1001 / 2816 / 3817, sensor_health 1001 / 1792 /
    # 2793) and larger batches
    shapes = [("rf_40x511", m) for m in (1001, 2816, 3817, 16384, 65536)]
    shapes += [("gbm_60x63", m) for m in (1001, 1792, 2793, 65536)]
    for name, m in shapes:
        ens = forests[name].to("cuda").ensemble
        x = torch.from_numpy(rng.normal(0, 1, (m, 9)).astype(np.float32)).to("cuda")
        want = predict_sum(ens, x, use_kernel=False)

        def check(who, got, m=m, want=want):
            chip_smoke.require(torch.equal(got, want), f"{who} ensemble_sum differs at m={m}")

        runs = {"other": lambda: other(ens, x), "this": lambda: predict_sum(ens, x)}
        times = turns(runs, check, 20)
        T, M = ens.feature.shape
        p = tree_qmc.plan(T, M, 9, m)
        times["plan"] = list(p)
        plans = {}
        for alt in tree_qmc.candidates(T, M, 9, m) + [tree_qmc.Plan(0, 0, 0, 0)]:
            run = lambda alt=alt: tree_qmc.ensemble_sum(  # noqa: E731
                *chip_smoke.tree_tables(ens), x, depth=ens.depth, launch=alt)
            check(f"plan {tuple(alt)}", run())
            plans[",".join(map(str, alt))] = chip_smoke.time_ms(run, 20)[0]
        times["plans"] = plans
        results[f"{name}_m{m}"] = times
    return results


def ab_prefix(other_lib):
    from repro_torch.kernels.sampled_agg import prefix_stats

    fn = prefix_stats.bind(other_lib)
    other = lambda v, s: prefix_stats.launch_with(lambda: fn, v, s)  # noqa: E731
    rng = np.random.default_rng(0)
    results = {}
    for k, cap in ((9, 32768), (3, 65536), (5, 32768), (1, 60000)):
        v = torch.from_numpy(rng.normal(1.0, 3.0, (k, cap)).astype(np.float32)).to("cuda")
        s = v[:, 0].contiguous()
        want = prefix_stats.prefix_power_sums_ref(v, s)

        def check(who, got, k=k, cap=cap, want=want):
            chip_smoke.require(torch.allclose(got, want, **chip_smoke.TABLE_TOL),
                               f"{who} prefix_power_sums differs at ({k}, {cap})")

        runs = {"other": lambda: other(v, s), "this": lambda: prefix_stats.prefix_power_sums(v, s)}
        times = turns(runs, check, 20)
        times["threads"] = prefix_stats.chunk_threads(k, cap)
        plans = {}
        for threads in (512, 256, 0):
            run = lambda t=threads: prefix_stats.prefix_power_sums(v, s, threads=t)  # noqa: E731
            check(f"threads {threads}", run())
            plans[str(threads)] = chip_smoke.time_ms(run, 20)[0]
        times["plans"] = plans
        results[f"{k}x{cap}"] = times
    return results


AB = {"flash_attention": ("flash_attention", ab_flash), "ensemble_sum": ("tree_qmc", ab_ensemble),
      "prefix_power_sums": ("prefix_stats", ab_prefix)}


def main(kernel: str, other: Path) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    print(chip_smoke.card_line(), flush=True)
    source, run = AB[kernel]
    build.build_all()
    so = build.BUILD_DIR / "ab-other.so"
    subprocess.run(build.compile_command(other, so), check=True, capture_output=True)
    results = run(ctypes.CDLL(str(so)))
    for shape, times in results.items():
        print(f"{kernel} {shape}: " + " ".join(
            f"{n}={t:.5f}" for n, t in times.items() if isinstance(t, float)), flush=True)
    print(json.dumps({"kernel": kernel, "source": source,
                      "card": chip_smoke.card_line(),
                      "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(AB))
    ap.add_argument("other", type=Path)
    a = ap.parse_args()
    sys.exit(main(a.kernel, a.other.resolve()))
