#!/usr/bin/env python3
"""Time one of this checkout's CUDA kernels against another build of its source.

    PYTHONPATH=src python3 kernel_ab.py KERNEL [OTHER.cu]

KERNEL is ``flash_attention``, ``flash_attention_bwd`` (its two backward
kernels), ``ensemble_sum``, ``prefix_power_sums``, ``sampled_moments``,
``masked_select_ranks`` or ``sobol_points``; ``OTHER.cu`` another version
of its source under ``src/repro_torch/kernels/csrc/``
(``flash_attention.cu``, ``flash_attention_bwd.cu``, ``tree_qmc.cu``,
``prefix_stats.cu``, ``sampled_agg.cu``, ``quantile_select.cu``,
``sobol.cu``), for example the file at a parent commit (``git show
HEAD~:src/...``).  It is built with the port's nvcc command into
``build/repro_torch/ab-other.so``; its C entry point must take this tree's
arguments, as both libraries are called through the wrapper's own launch
code (``launch_with``), so only the loaded library differs (a
``flash_attention.cu`` from before the row log-sum-exp output needs a last
``float* lse`` parameter added, unused: the A/B launches pass null; a
``flash_attention_bwd.cu`` from before its entry points reported their path
gets an ``int *path`` argument written here, see :func:`bwd_source`).  For
``sampled_moments``, ``masked_select_ranks`` and ``sobol_points`` OTHER.cu
may be left out: the other side is then this build's earlier design (the
rows, rank and direct paths); a copy of ``quantile_select.cu`` with another
``kCountMax`` (0: no counting) times the radix kernel's counting threshold.
On one card both run in turns (other, this, this, other) at the shapes the
served paths give the kernel, each output held to the plain version
(bitwise for ``ensemble_sum``, ``masked_select_ranks`` and
``sobol_points``; the tables' tolerance for ``prefix_power_sums`` and
``sampled_moments``; the card tests' bf16 tolerance for
``flash_attention``; the plain backward's ``BWD_TOL`` for
``flash_attention_bwd``, at ``chip_smoke.BWD_SHAPES``' bf16 shapes, beside
SDPA's autograd backward).  Device times per call come from CUDA-graph replay,
beside the eager time of back-to-back launches (``chip_smoke.time_ms``);
whether the two give the same bits is reported; every kernel but
``flash_attention`` also times each other launch plan of this tree once,
the earlier designs among them (the global, rows and rank paths),
``masked_select_ranks`` a sort + gather, the two-call yardstick the port
never calls, and ``sobol_points`` its uniforms and run lengths of 1 to 32
at the served grids.  Prints the card, one line a shape, and a JSON object
of every time as the last line.
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


def turns(runs: dict, check, reps: int, canon=None) -> dict:
    """Device and eager ms of each run in turns, every output checked, and
    whether the two builds give the same bits (of ``canon(output)`` where
    the two sides hold their results in different types)."""
    canon = canon or _bits
    times, outs = {}, {}
    for turn, name in enumerate(TURNS):
        dev_ms, eager_ms = chip_smoke.time_ms(runs[name], reps)
        times[f"{name}_{turn}"] = dev_ms
        times[f"{name}_{turn}_eager"] = eager_ms
        outs[name] = runs[name]()
        check(name, outs[name])
    times["bitwise_equal"] = torch.equal(canon(outs["other"]), canon(outs["this"]))
    return times


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits as integers of its element size (so that -0.0 and
    +0.0, or two NaNs, are told apart)."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


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


def bwd_source(other: Path) -> Path:
    """A ``flash_attention_bwd.cu`` from before its entry points reported
    their path (the SIMT kernels' source) with an ``int *path`` argument
    added, set to the scalar path; any other source as it is."""
    text = other.read_text()
    if "int *path" in text:
        return other
    text = text.replace("int window, float scale, int dtype, int device, void *stream\n",
                        "int window, float scale, int dtype, int device, void *stream, int *path\n")
    text = text.replace("const Problem a = FLASH_BWD_PROBLEM;",
                        "const Problem a = FLASH_BWD_PROBLEM;\n  *path = 0;")
    chip_smoke.require(text.count("*path = 0;") == 2 and "void *stream, int *path" in text,
                       f"{other}: no flash_attention_bwd entry points to give a path argument")
    patched = ROOT / "build" / "ab-other-flash_attention_bwd.cu"
    patched.parent.mkdir(parents=True, exist_ok=True)
    patched.write_text(text)
    return patched


def ab_flash_bwd(other_lib):
    """The two backward kernels of this tree against another build, at the
    bf16 shapes of ``chip_smoke.BWD_SHAPES``: each kernel's device ms (graph
    replay) and eager ms in turns, every output of both builds held to the
    plain backward within ``BWD_TOL``, the launches' paths, and SDPA's
    autograd backward timed in the same call."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import backward as bwd
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention

    fns = {"other": bwd.bind(other_lib), "this": None}
    results = {}
    for i, (name, (shape, causal, window, dtype)) in enumerate(chip_smoke.BWD_SHAPES.items()):
        if dtype != torch.bfloat16:
            continue
        b, h, hkv, sq, sk, d, dv = shape
        rng = np.random.default_rng(300 + i)
        q, k, v, do = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to("cuda", dtype)
                       for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv),
                                 (b, h, sq, dv)))
        out, lse = flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
        want = chip_smoke.plain_backward(q, k, v, out, do, causal, window)
        prep = {n: bwd.prepare(q, k, v, out, lse, do, causal=causal, window=window)
                for n in fns}
        reps = 3 if sq * sk > 1 << 24 else 10
        times, outs = {}, {}
        for turn, side in enumerate(TURNS):
            build.reset_launch_counts()
            for kname in (bwd.DQ, bwd.DKV):
                bwd.launch(kname, prep[side], fns[side])
            torch.cuda.synchronize()
            times[f"{side}_{turn}_paths"] = dict(build.PATHS)
            outs[side] = [t.clone() for t in (prep[side].dq, prep[side].dk, prep[side].dv)]
            for g, w, what in zip(outs[side], want, ("dq", "dk", "dv")):
                err = float((g.float() - w.float()).abs().max() / w.float().abs().max())
                chip_smoke.require(err < chip_smoke.BWD_TOL[dtype],
                                   f"{side} {what} at {name}: {err} beyond the plain backward's "
                                   f"tolerance")
                times[f"{side}_{turn}_{what}_rel_err"] = err
            for kname in (bwd.DQ, bwd.DKV):
                dev_ms, eager_ms = chip_smoke.time_ms(
                    lambda kname=kname: bwd.launch(kname, prep[side], fns[side]), reps)
                times[f"{side}_{turn}_{kname}"] = dev_ms
                times[f"{side}_{turn}_{kname}_eager"] = eager_ms
        build.reset_launch_counts()
        times["bitwise_equal"] = all(torch.equal(a, b) for a, b in zip(outs["other"],
                                                                        outs["this"]))
        times["sdpa_autograd"] = chip_smoke.sdpa_backward_ms(q, k, v, do, causal, window, 3)
        work = chip_smoke.bwd_work(shape, causal, window, q.element_size())
        times["bound"] = chip_smoke.bound(*work["backward"],
                                          ops_per_s=chip_smoke.BF16_OPS_PER_S)[0]
        for side in fns:
            times[f"{side}_pair"] = min(
                times[f"{side}_{t}_{bwd.DQ}"] + times[f"{side}_{t}_{bwd.DKV}"]
                for t, s in enumerate(TURNS) if s == side)
        results[name] = times
        del want, prep, outs
        torch.cuda.empty_cache()
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


def ab_moments(other_lib):
    from repro_torch.kernels.sampled_agg import sampled_agg
    from repro_torch.kernels.sampled_agg.ref import sampled_moments_ref

    if other_lib is None:
        other = lambda v, z, s: sampled_agg.sampled_moments(v, z, s, blocks=0)  # noqa: E731
    else:
        fn = sampled_agg.bind(other_lib)
        other = lambda v, z, s: sampled_agg.launch_with(lambda: fn, v, z, s)  # noqa: E731
    rng = np.random.default_rng(0)
    results = {}
    # turbofan's z⁰ at full width, its full prefix, the LM head's full prefix
    for k, cap, zr in ((9, 32768, 1051), (9, 32768, 32768), (3, 65536, 65536)):
        v = torch.from_numpy(rng.normal(1.0, 3.0, (k, cap)).astype(np.float32)).to("cuda")
        s = v[:, 0].contiguous()
        z = torch.full((k,), zr, dtype=torch.int32, device="cuda")
        want = sampled_moments_ref(v, z, s)

        def check(who, got, k=k, cap=cap, want=want):
            chip_smoke.require(torch.allclose(got, want, **chip_smoke.TABLE_TOL),
                               f"{who} sampled_moments differs at ({k}, {cap})")

        runs = {"other": lambda: other(v, z, s),
                "this": lambda: sampled_agg.sampled_moments(v, z, s)}
        times = turns(runs, check, 20)
        times["blocks"] = sampled_agg.moment_blocks(cap)
        times["bound"] = chip_smoke.bound(k * zr * 4 + k * 8 + k * 20, k * zr * 8)[0]
        plans = {}
        for blocks in range(sampled_agg.MAX_BLOCKS + 1):
            run = lambda b=blocks: sampled_agg.sampled_moments(v, z, s, blocks=b)  # noqa: E731
            check(f"blocks {blocks}", run())
            plans[str(blocks)] = chip_smoke.time_ms(run, 20)[0]
        times["plans"] = plans
        results[f"{k}x{cap}_z{zr}"] = times
    return results


def ab_select(other_lib):
    from repro_torch.kernels.sampled_agg import quantile_select as qs
    from repro_torch.kernels.sampled_agg.ref import masked_select_ranks_ref

    if other_lib is None:
        other = lambda v, z, t: qs.masked_select_ranks(v, z, t, launch=qs.Plan(0, 0))  # noqa: E731
    else:
        fn = qs.bind(other_lib)
        other = lambda v, z, t: qs.launch_with(lambda: fn, v, z, t)  # noqa: E731
    results = {}
    h, r = 3, 257
    # the reduced-depth rescan's short prefixes at cap 512, prefixes around
    # the kernel's counting threshold, sensor_health's z⁰ at cap 16384, then
    # longer prefixes up to the LM head's bucket, full at 32768 and 65536
    for cap, zr in ((512, 23), (512, 256), (16384, 128), (16384, 384), (16384, 512),
                    (16384, 760), (16384, 4096), (16384, 16384), (32768, 32768),
                    (65536, 65536)):
        rng = np.random.default_rng(cap + zr)
        v = torch.from_numpy(np.round(rng.normal(0, 2, (h, cap)), 2).astype(np.float32)).to("cuda")
        z = torch.full((h,), zr, dtype=torch.int32, device="cuda")
        t = torch.from_numpy(rng.integers(0, zr, (h, r)).astype(np.int32)).to("cuda")
        want = _bits(masked_select_ranks_ref(v, z, t))

        def check(who, got, cap=cap, zr=zr, want=want):
            chip_smoke.require(torch.equal(_bits(got), want),
                               f"{who} masked_select_ranks differs at cap {cap}, z {zr}")

        runs = {"other": lambda: other(v, z, t), "this": lambda: qs.masked_select_ranks(v, z, t)}
        reps = 5 if zr > 16384 else 20
        times = turns(runs, check, reps)
        times["plan"] = list(qs.plan(cap))
        cols = torch.arange(cap, device="cuda")
        padded = torch.where(cols[None, :] < z[:, None], v, torch.inf)
        sort_gather = lambda: torch.take_along_dim(  # noqa: E731
            torch.sort(padded, dim=1, stable=True).values, t.to(torch.int64), dim=1)
        check("sort + gather", sort_gather())
        times["sort_gather"] = chip_smoke.time_ms(sort_gather, reps)[0]
        times["bound"] = chip_smoke.bound(h * zr * 4 + h * 4 + 2 * h * r * 4, 0)[0]
        plans = {}
        for p in qs.candidates(cap) + [qs.Plan(0, 0)]:
            run = lambda p=p: qs.masked_select_ranks(v, z, t, launch=p)  # noqa: E731
            check(f"plan {tuple(p)}", run())
            plans[",".join(map(str, p))] = chip_smoke.time_ms(run, reps)[0]
        times["plans"] = plans
        results[f"cap{cap}_z{zr}"] = times
    return results


def ab_sobol(other_lib):
    from repro_torch.kernels.sobol import sobol
    from repro_torch.kernels.sobol.ops import points, to_uniforms, uniforms

    if other_lib is None:
        other = lambda m, d: sobol.sobol_points(m, d, device="cuda", run=0)  # noqa: E731
    else:
        fns = sobol.bind(other_lib)
        other = lambda m, d: sobol.launch_with(lambda: fns, m, d, device="cuda")  # noqa: E731
    widen = lambda t: t.to(torch.int64) & 0xFFFFFFFF  # noqa: E731
    results = {}
    for m, d in chip_smoke.SOBOL_GRIDS:
        want = points(m, d, device="cuda", use_kernel=False)

        def check(who, got, m=m, d=d, want=want):
            chip_smoke.require(torch.equal(widen(got), want),
                               f"{who} sobol_points differs at ({m}, {d})")

        runs = {"other": lambda: other(m, d), "this": lambda: sobol.sobol_points(m, d, device="cuda")}
        times = turns(runs, check, 20, canon=widen)
        u = lambda: uniforms(m, d, device="cuda")  # noqa: E731
        chip_smoke.require(torch.equal(_bits(u()), _bits(to_uniforms(want))),
                           f"sobol_points uniforms differ at ({m}, {d})")
        times["uniforms"] = chip_smoke.time_ms(u, 20)[0]
        times["run"] = sobol.plan(m, d)
        times["bound"] = chip_smoke.bound(m * d * 4 + d * 32 * 4, m * d * 2)[0]
        plans = {}
        for run in (1, 2, 4, 8, 16, 32):
            fn = lambda r=run: sobol.sobol_points(m, d, device="cuda", run=r)  # noqa: E731
            check(f"run {run}", fn())
            plans[str(run)] = chip_smoke.time_ms(fn, 20)[0]
        times["plans"] = plans
        results[f"{m}x{d}"] = times
    return results


AB = {"flash_attention": ("flash_attention", ab_flash),
      "flash_attention_bwd": ("flash_attention_bwd", ab_flash_bwd),
      "ensemble_sum": ("tree_qmc", ab_ensemble),
      "prefix_power_sums": ("prefix_stats", ab_prefix),
      "sampled_moments": ("sampled_agg", ab_moments),
      "masked_select_ranks": ("quantile_select", ab_select),
      "sobol_points": ("sobol", ab_sobol)}
#: kernels whose other side may be this build's earlier design
EARLIER = ("sampled_moments", "masked_select_ranks", "sobol_points")


def main(kernel: str, other: Path | None) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    print(chip_smoke.card_line(), flush=True)
    source, run = AB[kernel]
    build.build_all()
    other_lib = None
    if other is not None:
        if kernel == "flash_attention_bwd":
            other = bwd_source(other)
        so = build.BUILD_DIR / "ab-other.so"
        subprocess.run(build.compile_command(other, so), check=True, capture_output=True)
        other_lib = ctypes.CDLL(str(so))
    results = run(other_lib)
    for shape, times in results.items():
        print(f"{kernel} {shape}: " + " ".join(
            f"{n}={t:.5f}" for n, t in times.items() if isinstance(t, float)
            and not n.endswith("rel_err")), flush=True)
    print(json.dumps({"kernel": kernel, "source": source,
                      "other": "earlier path" if other is None else str(other),
                      "card": chip_smoke.card_line(),
                      "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(AB))
    ap.add_argument("other", type=Path, nargs="?")
    a = ap.parse_args()
    if a.other is None and a.kernel not in EARLIER:
        ap.error(f"{a.kernel} needs OTHER.cu")
    sys.exit(main(a.kernel, None if a.other is None else a.other.resolve()))
