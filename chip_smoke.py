#!/usr/bin/env python3
"""Drive the PyTorch port of Biathlon on one CUDA card and check what it does.

Run from the root of a checkout, with no arguments:

    PYTHONPATH=src python3 chip_smoke.py

Phases (any failure exits non-zero before the result line is printed):

1. print the card (``nvidia-smi`` name and power limit) and build the six
   CUDA kernels from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` each,
   in parallel), with their build time;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it, and time both with CUDA events;
   ``sobol_points`` at the executors' one-launch grids of all eight
   pipelines and the LM head, and at (65536, 64), each at skip 0, 12345 and
   2^32 - 50 (the index wraps): points, uniforms and its direct path (the
   earlier design, ``earlier_ms``) bitwise the plain version's, and
   ``SobolEngine``'s points (timed with the copy to the card as
   ``library_ms``), every run length on one grid;
   ``prefix_power_sums`` at (9, 32768) and the LM head's (3, 65536) also
   launched twice (bitwise equal), against its emulation in PyTorch
   (bitwise) and through its rows path (the earlier design, timed as
   ``earlier_ms``); ``ensemble_sum`` on the turbofan forest (40 × 511) and a
   60 × 63 boosted model at every served megabatch, bitwise equal to the
   plain version on both of its paths, its global path (the earlier
   design) timed as ``earlier_ms``;
   ``sampled_moments`` on (9, 32768) at random z, on request 0's z⁰ and
   over z = 1051 and full prefixes at (9, 32768) and (3, 65536): launched
   twice (bitwise equal), bitwise equal to its emulation in PyTorch, its
   rows path (the earlier design, ``earlier_ms``) and it within the tables'
   tolerance of the plain version; all five must take their redesigned
   path (``build.PATHS``) there and on every served run below;
3. build the full-width ``turbofan`` bundle (20000 rows per group, 400
   train groups, 24 serve groups; random forest of 40 trees, depth 8) and
   serve 8 requests with ``BiathlonConfig()`` under ``afc_backend="auto"``
   (incremental AFC), under ``"ref"`` (the rescan) and through the plain
   versions on the card; launch counts are reset just before each run and
   read just after, and every kernel of a run's path must have launched;
4. the same at ``rows_per_group=500``, where "auto" takes the rescan path;
5. the holistic pipeline ``sensor_health`` (five aggregates, three of them
   MEDIAN/QUANTILE; gradient boosting, 60 trees of depth 5) at full width:
   ``masked_select_ranks`` against its plain version on request 0's own
   holistic buffers, its plan z⁰ and the 1 + 256 rank targets of its z⁰
   evaluation, and over z = 4096, 16384, 32768 and 65536 (int32 bits, two
   launches, the radix path; the rank path, the earlier design, too),
   timed beside the rank path (``earlier_ms``) and ``torch.sort`` plus a
   gather; then 8 requests under "auto" (incremental: the
   rank index, no ``masked_select_ranks``), "ref" (the rescan through
   ``masked_select_ranks``) and the plain versions, and under "auto" and
   plain at 0.3 × δ so that the loop is entered; then the same kernel
   check and 4 requests at ``rows_per_group=500``, where "auto" rescans;
   then the rescan against the incremental AFC per cap bucket, 512 to
   65536, on synthetic buffers of both pipelines' shapes (host wall time
   of the incremental set-up and of an evaluation on each path);
6. the six other paper pipelines at full width (``make_pipeline``
   defaults): ``trip_fare``, ``tick_price`` (linear), ``battery``,
   ``bearing_imbalance`` (MLP classifier), ``fraud_detection`` and
   ``student_qa`` (classifiers), 4 requests each under "auto" and through
   the plain versions, at δ and at 0.3·δ (regression) or τ = 0.99
   (classification): equal plans, iterations and classes, every kernel of
   the path launched (``ensemble_sum`` on the four tree pipelines), one
   ``sobol_points`` launch an executor build; ``student_qa``'s forest held
   bitwise and timed at its 6889-row megabatch, ``fraud_detection``'s at
   2281; the busiest tight classification request profiled; then
   ``make_pipeline_median("trip_fare")`` under "ref" (``masked_select_ranks``);
7. ``flash_attention`` against its plain version: the LM-head prompt
   (1, 16, 48, 64) and (1, 16, 4096, 64) and (1, 16, 4096, 128) prefills
   in bf16, causal (the tensor-core kernel); a float32 non-causal case (the
   scalar kernel); Sq ≠ Sk; 4096 × 16 = 65536 batch·heads on three
   inputs; GQA through ``ops.attention``; every bf16 output also within one
   bf16 ulp of its emulated roundings plus its tie slack; the three bf16
   shapes timed beside ``F.scaled_dot_product_attention`` (a yardstick the
   port never calls), with the ratio to it, the share of the bound and
   each bf16 instance's registers and spills from the build log;
8. the LM-head pipeline (``repro_torch.examples.serve_lm_head``) with a
   full-width ``qwen1.5-0.5b`` backbone (24 layers, d 1024, random weights
   from a seed): 6 requests through the kernels, exactly 24
   ``flash_attention`` launches and one ``prefix_power_sums`` per request;
   the same requests under ``use_kernel=False`` (no launch), pooled states
   within bf16 tolerance of the kernel path's, and equal plans when both
   executors are fed the same pooled state; a profile of one request;
9. one 1 × 4096-token backbone forward, profiled: its latency,
   ``flash_attention``'s share of device time and the device's idle share;
10. print the run's total seconds, one ``{"kernels": [...]}`` line, then the
    result line ``{"ok": true, "device": {...}}``.

It refuses to run without a CUDA device, and imports nothing of JAX or of
the JAX package.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16, dense tensor cores
N_SERVE = 8
N_LM_REQ = 6
TABLE_TOL = dict(rtol=3e-5, atol=1e-3)
# flash_attention vs its plain version: float32 differs in summation order
# only; bf16 outputs are the float32 results rounded once (one bf16 ulp)
ATTN_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
# pooled states of the kernel and plain LM paths, max |diff| over max |state|:
# one bf16 ulp in an attention output moves later layers' bf16 roundings
STATE_REL_TOL = 3e-2
# the bf16 flash_attention kernel against its roundings emulated in PyTorch
# (kernels/flash_attention/emulation.py): both outputs are bf16, so one ulp
# (2^-7 relative) of the rounding apart at most, plus each output's slack
# from p's that the kernel may round to the other side of a bf16 tie
EMULATION_TOL = dict(rtol=2 ** -7, atol=2 ** -8)


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _events_ms(run, reps: int) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_ms(fn, reps: int = 20) -> tuple[float, float]:
    """``(device ms, eager ms)`` per call of ``fn`` (L2 warm).

    Device time: ``reps`` calls captured in one CUDA graph and replayed, so
    host launch overhead is out of the measurement.  Eager time: the same
    calls launched back to back from Python, as the serving loop launches
    them (for a tiny kernel this is the launch rate, not the kernel).
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    device = _events_ms(graph.replay, 5) / reps
    return device, _events_ms(fn, reps)


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """Least time (ms) for the work: bytes over HBM rate vs ops over the type's peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def heavy_tailed(n=60000, seed=7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.normal(1.25, 0.12, n).astype(np.float32)
    v[0] = 100.0
    return v


def timings(kernel, plain) -> dict:
    (ms, eager_ms), (plain_ms, _) = time_ms(kernel), time_ms(plain)
    return dict(ms=ms, eager_ms=eager_ms, plain_ms=plain_ms)


# ------------------------------------------------------------------ phase 2
def moments_work(z: torch.Tensor) -> tuple[float, str]:
    """Bound of one ``sampled_moments`` call: the live values read once, z
    and the shift read, (k, 5) written; 8 operations a live value."""
    k, live = z.shape[0], int(z.sum())
    return bound(live * 4 + k * 8 + k * 20, live * 8)


def moments_check(vals, z, shift, name: str) -> tuple[torch.Tensor, float]:
    """``sampled_moments`` through the executor's entry point: on the cluster
    path, bitwise equal to the launch before and to its emulation in PyTorch,
    its rows path (the earlier design) and it within the tables' tolerance of
    the plain version.  Returns the output and max |kernel - plain|."""
    from repro_torch.kernels import build
    from repro_torch.kernels.sampled_agg import ops
    from repro_torch.kernels.sampled_agg.emulation import clustered_sampled_moments
    from repro_torch.kernels.sampled_agg.sampled_agg import moment_blocks, sampled_moments

    build.reset_launch_counts()
    got, again = ops.moments(vals, z, shift), ops.moments(vals, z, shift)
    require(build.PATHS == {"sampled_moments.cluster": 2},
            f"sampled_moments {name} took {dict(build.PATHS)}, expected the cluster path")
    require(torch.equal(got, again), f"sampled_moments {name}: two launches differ")
    emulated = clustered_sampled_moments(vals, z, shift, blocks=moment_blocks(vals.shape[1]))
    require(torch.equal(got, emulated), f"sampled_moments {name} differs from its emulation")
    want = ops.moments(vals, z, shift, use_kernel=False)
    torch.testing.assert_close(got, want, **TABLE_TOL)
    torch.testing.assert_close(sampled_moments(vals, z, shift, blocks=0), want, **TABLE_TOL)
    return got, float((got - want).abs().max())


def moments_timed(vals, z, shift) -> dict:
    """The cluster path, its rows path (``earlier_ms``) and the plain
    version timed on one input, with the bound."""
    from repro_torch.kernels.sampled_agg import ops
    from repro_torch.kernels.sampled_agg.sampled_agg import moment_blocks, sampled_moments

    b = moments_work(z)
    return dict(
        **timings(lambda: ops.moments(vals, z, shift),
                  lambda: ops.moments(vals, z, shift, use_kernel=False)),
        earlier_ms=time_ms(lambda: sampled_moments(vals, z, shift, blocks=0))[0],
        blocks=vals.shape[0] * moment_blocks(vals.shape[1]), bound_ms=b[0], bound_by=b[1],
    )


def moments_record(bundle, dev, alpha: float) -> dict:
    """``sampled_moments`` on the inputs of the rescan's first evaluation.

    Request 0 of ``bundle`` is gathered as the server gathers it (its
    power-of-two cap bucket) with the plan z⁰ = ceil(α·n): the shape and data
    each rescan evaluation of that path gives the kernel.  Checked
    (:func:`moments_check`), timed beside the rows path and bounded by the
    live columns it must read.
    """
    from repro_torch.core.planner import initial_plan
    from repro_torch.data.store import bucket_size

    p, req = bundle.pipeline, bundle.requests[0]
    cap = bucket_size(int(max(p.group_sizes(bundle.store, req).max(), 1)))
    vals, sizes = bundle.store.request_buffers(p.agg_specs(req), cap, dev)
    z = initial_plan(sizes, alpha)
    shift = vals[:, 0].contiguous()
    _, err = moments_check(vals, z, shift, f"request 0 ({vals.shape[0]}, {cap})")
    return dict(shape=[vals.shape[0], cap], z=z.cpu().tolist(), max_abs_err=err,
                **moments_timed(vals, z, shift))


def moments_sweep(dev, rng) -> list:
    """The cluster kernel over the prefixes the paths give it: turbofan's
    z⁰ = 1051 and full prefix at (9, 32768), the LM head's full (3, 65536)."""
    out = []
    for k, cap, zr in ((9, 32768, 1051), (9, 32768, 32768), (3, 65536, 65536)):
        vals = torch.from_numpy(rng.normal(1.0, 3.0, (k, cap)).astype(np.float32)).to(dev)
        z = torch.full((k,), zr, dtype=torch.int32, device=dev)
        shift = vals[:, 0].contiguous()
        _, err = moments_check(vals, z, shift, f"({k}, {cap}) at z = {zr}")
        out.append(dict(shape=[k, cap], z=zr, max_abs_err=err, **moments_timed(vals, z, shift)))
    return out


def prefix_work(k: int, cap: int) -> tuple[float, str]:
    """Bound of one (k, cap) table: values read once, the shift read, (k, cap,
    4) written; 8 operations a value (four powers, four compensated sums)."""
    return bound(k * cap * 4 + k * 4 + k * cap * 16, k * cap * 8)


def prefix_record(vals, shift, *, full: bool = True) -> dict:
    """``prefix_power_sums`` on one (k, cap) input, held to its plain version,
    timed beside the rows path (the earlier design, ``earlier_ms``).  ``full``
    also holds two launches bitwise equal, the chunked kernel bitwise equal
    to its emulation, and the rows path to the plain version."""
    from repro_torch.kernels import build
    from repro_torch.kernels.sampled_agg import ops
    from repro_torch.kernels.sampled_agg.emulation import chunked_prefix_power_sums
    from repro_torch.kernels.sampled_agg.prefix_stats import chunk_threads, prefix_power_sums

    k, cap = vals.shape
    threads = chunk_threads(k, cap)
    build.reset_launch_counts()
    got = ops.prefix_power_sums(vals, shift)
    require(build.PATHS == {"prefix_power_sums.chunks": 1},
            f"prefix_power_sums ({k}, {cap}) took {dict(build.PATHS)}, expected chunks")
    want = ops.prefix_power_sums(vals, shift, use_kernel=False)
    torch.testing.assert_close(got, want, **TABLE_TOL)
    if full:
        require(torch.equal(got, ops.prefix_power_sums(vals, shift)),
                f"prefix_power_sums ({k}, {cap}): two launches differ")
        require(torch.equal(got, chunked_prefix_power_sums(vals, shift, threads=threads)),
                f"prefix_power_sums ({k}, {cap}) differs from its emulation")
        torch.testing.assert_close(prefix_power_sums(vals, shift, threads=0), want, **TABLE_TOL)
    b = prefix_work(k, cap)
    return dict(
        shape=[k, cap], chunk=4 * threads, blocks=k * -(-cap // (4 * threads)),
        max_abs_err=float((got - want).abs().max()),
        **timings(lambda: ops.prefix_power_sums(vals, shift),
                  lambda: ops.prefix_power_sums(vals, shift, use_kernel=False)),
        earlier_ms=time_ms(lambda: prefix_power_sums(vals, shift, threads=0))[0],
        bound_ms=b[0], bound_by=b[1],
    )


def request_tables_record(bundle, dev) -> dict:
    """``prefix_power_sums`` on request 0's buffers at its cap bucket, with
    the shift the executor takes: the shape the incremental path gives it."""
    from repro_torch.data.store import bucket_size

    p, req = bundle.pipeline, bundle.requests[0]
    cap = bucket_size(int(max(p.group_sizes(bundle.store, req).max(), 1)))
    vals, _ = bundle.store.request_buffers(p.agg_specs(req), cap, dev)
    return prefix_record(vals, vals[:, 0].contiguous(), full=False)


def tree_tables(ens) -> tuple:
    return ens.feature, ens.threshold, ens.left, ens.right, ens.value


def tree_check(ens, ms, dev, rng, n_feat: int = 9) -> float:
    """``ensemble_sum`` on random (m, n_feat) rows for each m of ``ms``: the
    smem path twice (bitwise equal), the global path (the earlier design),
    both bitwise the plain version's.  Returns max |kernel - plain|."""
    from repro_torch.kernels import build
    from repro_torch.kernels.tree_qmc.ops import predict_sum
    from repro_torch.kernels.tree_qmc.tree_qmc import Plan, ensemble_sum

    err = 0.0
    for m in ms:
        x = torch.from_numpy(rng.normal(0, 1, (m, n_feat)).astype(np.float32)).to(dev)
        build.reset_launch_counts()
        a, a2 = predict_sum(ens, x), predict_sum(ens, x)
        g = ensemble_sum(*tree_tables(ens), x, depth=ens.depth, launch=Plan(0, 0, 0, 0))
        want = predict_sum(ens, x, use_kernel=False)
        require(build.PATHS == {"ensemble_sum.smem": 2, "ensemble_sum.global": 1},
                f"ensemble_sum at m={m}: took {dict(build.PATHS)}, expected the smem path")
        require(torch.equal(a, a2), f"ensemble_sum not bitwise stable at m={m}")
        require(torch.equal(a, want), f"ensemble_sum differs from plain at m={m}")
        require(torch.equal(g, want), f"ensemble_sum global path differs from plain at m={m}")
        err = max(err, float((a - want).abs().max()), float((g - want).abs().max()))
    build.reset_launch_counts()
    return err


def tree_record(ens, m: int, dev, rng, n_feat: int = 9) -> dict:
    """``ensemble_sum`` on m rows: the smem path timed beside the global path
    (the earlier design, ``earlier_ms``) and the plain version; bounded by the
    bytes it must move (x and the five tables read, the sums written) and by
    m·T·(2·depth + 1) operations, beside its m·T·depth node visits."""
    from repro_torch.kernels.tree_qmc.ops import predict_sum
    from repro_torch.kernels.tree_qmc.tree_qmc import Plan, ensemble_sum, plan

    (T, M), F = ens.feature.shape, n_feat
    x = torch.from_numpy(rng.normal(0, 1, (m, F)).astype(np.float32)).to(dev)
    p = plan(T, M, F, m, torch.cuda.get_device_properties(dev).multi_processor_count)
    require(p.path == "smem", f"ensemble_sum {T}x{M} at m={m} is not planned on the smem path")
    b = bound(m * F * 4 + 5 * T * M * 4 + m * 4, m * T * (2 * ens.depth + 1))
    return dict(
        shape=[m, F, T, M], depth=ens.depth, node_visits=m * T * ens.depth,
        plan=dict(p._asdict(), blocks=p.cluster * p.clusters),
        **timings(lambda: predict_sum(ens, x), lambda: predict_sum(ens, x, use_kernel=False)),
        earlier_ms=time_ms(lambda: ensemble_sum(*tree_tables(ens), x, depth=ens.depth,
                                                launch=Plan(0, 0, 0, 0)))[0],
        bound_ms=b[0], bound_by=b[1],
    )


# the executors' one-launch QMC grids (max(m, m_sobol), 2k) at BiathlonConfig()'s
# m = 1000, m_sobol = 256 (k = 3 trip_fare, fraud_detection; 1 tick_price; 10
# battery; 9 turbofan; 8 bearing_imbalance; 21 student_qa; 5 sensor_health)
# and the LM head's (m = 400, m_sobol = 96, k = 3); then a grid where the
# arithmetic shows
SOBOL_GRIDS = [(1000, 18), (1000, 6), (1000, 2), (1000, 20), (1000, 16), (1000, 42),
               (1000, 10), (400, 6), (65536, 64)]
SOBOL_SKIPS = (0, 12345, 2**32 - 50)   # the last wraps the index past 2^32


def sobol_engine_points(m: int, d: int) -> torch.Tensor:
    """(m, d) uint32 points (int64) from ``torch.quasirandom.SobolEngine``, a
    yardstick the port never calls: ``draw`` gives x·2^-32 exactly in float64."""
    draw = torch.quasirandom.SobolEngine(d, scramble=False).draw(m, dtype=torch.float64)
    return (draw * 2.0**32).to(torch.int64)


def sobol_record(dev) -> dict:
    """``sobol_points`` at every served grid and at (65536, 64).

    Each grid at each of :data:`SOBOL_SKIPS`: the points (the runs path at
    its planned run length), the uniforms written in the same pass and the
    direct path (the earlier design) bitwise the plain version's; at 0 also
    ``SobolEngine``'s points; on (1000, 42) near 2^32 every run length.
    Timed at skip 0 as the executor calls it (uniforms): graph replay,
    eager, the direct path (``earlier_ms``), the plain version, and
    ``SobolEngine(d).draw(m)`` plus the copy to the card (``library_ms``,
    host wall time of the two, as a caller pays them); bounded by 4 bytes a
    value written and the direction numbers read once, two operations (an
    XOR, a ctz) a value.
    """
    from repro_torch.kernels import build
    from repro_torch.kernels.sobol.ops import points, to_uniforms, uniforms
    from repro_torch.kernels.sobol.sobol import MAX_RUN, plan, sobol_points

    grids, err = [], 0
    for m, d in SOBOL_GRIDS:
        for skip in SOBOL_SKIPS:
            build.reset_launch_counts()
            got, u = points(m, d, skip, device=dev), uniforms(m, d, skip, device=dev)
            direct = sobol_points(m, d, skip, device=dev, run=0)
            require(build.PATHS == {"sobol_points.runs": 2, "sobol_points.direct": 1},
                    f"sobol_points {(m, d, skip)} took {dict(build.PATHS)}")
            want = points(m, d, skip, device=dev, use_kernel=False)
            err = max(err, int((got - want).abs().max()))
            require(torch.equal(got, want), f"sobol_points differs from plain at {(m, d, skip)}")
            require(torch.equal(direct, want), f"sobol_points direct path differs at {(m, d, skip)}")
            require(torch.equal(bits(u), bits(to_uniforms(want))),
                    f"sobol_points uniforms differ from plain at {(m, d, skip)}")
        require(torch.equal(sobol_engine_points(m, d),
                            points(m, d, 0, device=dev, use_kernel=False).cpu()),
                f"SobolEngine's points differ from the plain version's at {(m, d)}")
        b = bound(m * d * 4 + d * 32 * 4, m * d * 2)
        library = lambda: sobol_engine_points(m, d).to(dev)  # noqa: E731
        library()
        grids.append(dict(
            shape=[m, d], run=plan(m, d),
            **timings(lambda: uniforms(m, d, device=dev),
                      lambda: uniforms(m, d, device=dev, use_kernel=False)),
            earlier_ms=time_ms(lambda: sobol_points(m, d, device=dev, run=0))[0],
            library_ms=wall_ms({"library": library})["library"],
            bound_ms=b[0], bound_by=b[1]))
    m, d, skip = 1000, 42, 2**32 - 50
    want = points(m, d, skip, device=dev, use_kernel=False)
    for run in range(1, MAX_RUN + 1):
        got = sobol_points(m, d, skip, device=dev, run=run).to(torch.int64) & 0xFFFFFFFF
        require(torch.equal(got, want), f"sobol_points run {run} differs at {(m, d, skip)}")
    build.reset_launch_counts()
    return dict(grids[0], grids=grids[1:], max_abs_err=float(err),
                phases=["bitwise_points_uniforms_direct_9_grids_3_skips", "skip_wraps_2^32",
                        "sobol_engine_bitwise", "every_run_length_1000x42"])


def check_kernels(dev, bundle, alpha: float) -> dict:
    """Each kernel against its plain version; returns per-kernel records."""
    from repro_torch.kernels import build
    from repro_torch.kernels.sampled_agg import ops
    from repro_torch.models.tabular.trees import GradientBoosting

    rf_ensemble = bundle.pipeline.model.ensemble
    rec = {}
    rng = np.random.default_rng(0)

    rec["sobol_points"] = sobol_record(dev)

    # prefix_power_sums / sampled_moments at 60k heavy-tailed rows vs float64
    v = heavy_tailed()
    t = torch.from_numpy(v[None]).to(dev)
    want64 = np.stack([(v.astype(np.float64) ** p).cumsum() for p in range(1, 5)], axis=-1)
    build.reset_launch_counts()
    tab = ops.prefix_power_sums(t)[0].cpu().numpy()
    require(build.PATHS == {"prefix_power_sums.chunks": 1},
            f"prefix_power_sums at 60k rows took {dict(build.PATHS)}, expected chunks")
    require((np.abs(tab - want64) / np.abs(want64)).max() < 1e-6,
            "prefix_power_sums: 60k heavy-tailed row not within 1e-6 of float64")
    build.reset_launch_counts()
    mom = ops.moments(t, torch.tensor([v.size], device=dev))[0].cpu().numpy()
    require(build.PATHS == {"sampled_moments.cluster": 1},
            f"sampled_moments at 60k rows took {dict(build.PATHS)}, expected the cluster path")
    require((np.abs(mom[1:] - want64[-1]) / np.abs(want64[-1])).max() < 1e-6
            and mom[0] == v.size,
            "sampled_moments: 60k heavy-tailed row not within 1e-6 of float64")

    # the serving shapes: k = 9, cap 32768 (incremental) and random z (rescan)
    k, cap = 9, 32768
    vals = torch.from_numpy(rng.normal(1.0, 3.0, (k, cap)).astype(np.float32)).to(dev)
    shift = vals[:, 0].contiguous()
    rec["prefix_power_sums"] = dict(prefix_record(vals, shift), phases=[
        "f64_60k", "plain_9x32768", "bitwise_stable", "emulation_bitwise", "rows_path_plain",
        "plain_3x65536_lm_head", "plain_sensor_health_request_0"])
    # the LM head's (3, 65536) tables
    lm = torch.from_numpy(rng.normal(1.0, 3.0, (3, 65536)).astype(np.float32)).to(dev)
    rec["prefix_power_sums"]["lm_head"] = prefix_record(lm, lm[:, 0].contiguous())
    z = torch.from_numpy(rng.integers(0, cap + 1, k).astype(np.int32)).to(dev)
    z[0] = 0
    got, err = moments_check(vals, z, shift, "(9, 32768) at random z")
    require(bool((got[0] == 0).all()), "sampled_moments: a z = 0 row is not all-zero")
    rec["sampled_moments"] = dict(
        moments_record(bundle, dev, alpha), sweep=moments_sweep(dev, rng),
        phases=["f64_60k", "plain_9x32768_random_z", "zero_rows", "request_0_z0",
                "bitwise_stable", "emulation_bitwise", "rows_path_plain",
                "sweep_z1051_full_9x32768_full_3x65536"],
    )
    rec["sampled_moments"]["max_abs_err"] = max(
        [err, rec["sampled_moments"]["max_abs_err"]]
        + [r["max_abs_err"] for r in rec["sampled_moments"]["sweep"]])

    # ensemble_sum: the turbofan forest and a 60 x 63 (depth 5) boosted model
    X = rng.normal(0, 1, (2000, 9)).astype(np.float32)
    gbm = GradientBoosting(n_trees=60, max_depth=5, learning_rate=0.15).fit(
        X, X[:, 0] * 2 + np.sin(3 * X[:, 1])).to(dev)
    require(tuple(gbm.ensemble.feature.shape) == (60, 63), "GBM shape is not 60 x 63")
    require(tuple(rf_ensemble.feature.shape) == (40, 511) and rf_ensemble.depth == 8,
            "turbofan forest is not 40 x 511, depth 8")
    # every served megabatch (z⁰, the Saltelli block, an iteration: turbofan
    # 1001 / 2816 / 3817, sensor_health 1001 / 1792 / 2793, trip_fare and
    # fraud_detection 1280 / 2281, battery 3072 / 4073) and more; student_qa's
    # own forest (21 features, up to 6889 rows) is checked in its phase
    err = max(tree_check(ens, (4073, 3817, 3072, 2816, 2793, 2281, 1792, 1280, 1001, 881, 1),
                         dev, rng)
              for ens in (rf_ensemble, gbm.ensemble))
    rec["ensemble_sum"] = dict(
        tree_record(rf_ensemble, 3817, dev, rng),
        gbm=tree_record(gbm.ensemble, 2793, dev, rng),
        max_abs_err=err,
        phases=["rf_40x511", "gbm_60x63",
                "m_4073_3817_3072_2816_2793_2281_1792_1280_1001_881_1", "bitwise_stable",
                "bitwise_plain", "global_path_bitwise_plain"],
    )
    return rec


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bits, so that −0.0 and +0.0 (or two NaNs) differ."""
    return t.view(torch.int32)


def select_check(vh, z, targets, name: str) -> tuple[torch.Tensor, float]:
    """``masked_select_ranks`` through the executor's entry point: on the
    radix path, its int32 bits equal to the launch before's and to the plain
    version's, and the rank path's (the earlier design) too.  Returns the
    output and max |kernel - plain| over the outputs whose bits differ."""
    from repro_torch.kernels import build
    from repro_torch.kernels.sampled_agg import ops
    from repro_torch.kernels.sampled_agg.quantile_select import Plan, masked_select_ranks

    build.reset_launch_counts()
    got, again = ops.select_ranks(vh, z, targets), ops.select_ranks(vh, z, targets)
    require(build.PATHS == {"masked_select_ranks.radix": 2},
            f"masked_select_ranks {name} took {dict(build.PATHS)}, expected the radix path")
    plain = ops.select_ranks(vh, z, targets, use_kernel=False)
    same = bits(got) == bits(plain)
    err = float(torch.where(same, 0.0, (got - plain).abs()).max())
    require(bool(same.all()), f"masked_select_ranks {name} differs from plain (max |err| {err})")
    require(torch.equal(bits(again), bits(got)), f"masked_select_ranks {name}: two launches differ")
    earlier = masked_select_ranks(vh, z, targets, launch=Plan(0, 0))
    require(torch.equal(bits(earlier), bits(plain)),
            f"masked_select_ranks {name}: rank path differs")
    return got, err


def select_timed(vh, z, targets, reps: int = 20) -> dict:
    """The radix path, the rank path (``earlier_ms``), the plain version and
    ``torch.sort`` + ``take_along_dim`` (a yardstick of two calls that the
    port never makes, checked bitwise) timed on one input, with the bound."""
    from repro_torch.kernels.sampled_agg import ops
    from repro_torch.kernels.sampled_agg.quantile_select import Plan, masked_select_ranks, plan

    h, cap = vh.shape
    r = targets.shape[1]
    cols = torch.arange(cap, device=vh.device)
    padded = torch.where(cols[None, :] < z[:, None], vh, torch.inf)
    clipped = torch.clamp(targets.to(torch.int64), 0, cap - 1)
    sort_gather = lambda: torch.take_along_dim(  # noqa: E731
        torch.sort(padded, dim=1, stable=True).values, clipped, dim=1)
    require(torch.equal(bits(sort_gather()), bits(ops.select_ranks(vh, z, targets))),
            "sort + gather disagrees with the kernel")
    # live prefix, z and targets read once, (h, R) written; a selection does no arithmetic
    b = bound(int(z.sum()) * 4 + h * 4 + h * r * 4 + h * r * 4, 0)
    return dict(
        **timings(lambda: ops.select_ranks(vh, z, targets),
                  lambda: ops.select_ranks(vh, z, targets, use_kernel=False)),
        earlier_ms=time_ms(lambda: masked_select_ranks(vh, z, targets, launch=Plan(0, 0)),
                           reps)[0],
        sort_gather_ms=time_ms(sort_gather, reps)[0], plan=list(plan(cap)),
        bound_ms=b[0], bound_by=b[1],
    )


def select_record(bundle, dev, cfg) -> dict:
    """``masked_select_ranks`` on the inputs of the rescan's z⁰ evaluation.

    Request 0's holistic buffers at its cap bucket, the plan z⁰ and the
    (h, 1 + B) rank targets that evaluation draws (key ``fold_in(PRNGKey(0),
    0)``).  Checked bitwise (:func:`select_check`) and timed
    (:func:`select_timed`).
    """
    from repro_torch.core import threefry
    from repro_torch.core.executor_fused import pipeline_executor_kwargs
    from repro_torch.core.planner import initial_plan
    from repro_torch.data.store import bucket_size
    from repro_torch.kernels.sampled_agg import ops

    p, req = bundle.pipeline, bundle.requests[0]
    cap = bucket_size(int(max(p.group_sizes(bundle.store, req).max(), 1)))
    vals, sizes = bundle.store.request_buffers(p.agg_specs(req), cap, dev)
    kw = pipeline_executor_kwargs(p.agg_features, dev)
    hol = torch.tensor(kw["holistic"], device=dev)
    qs = torch.tensor(kw["quantiles"], dtype=torch.float32, device=dev)
    vh = vals[hol]
    z = initial_plan(sizes, cfg.alpha)[hol]
    key = threefry.fold_in(threefry.PRNGKey(0), 0)
    targets = ops.bootstrap_rank_targets(z, qs, key, cfg.n_bootstrap)
    got, err = select_check(vh, z, targets, f"request 0 at cap {cap}")
    require(bool(torch.isfinite(got).all()), "masked_select_ranks: a z⁰ target selected +inf")
    h, r = targets.shape
    return dict(shape=[h, cap, r], z=z.cpu().tolist(), max_abs_err=err,
                **select_timed(vh, z, targets))


def select_sweep(dev, h: int = 3, r: int = 257) -> list:
    """The kernel over longer prefixes than z⁰: 4096 and 16384 at
    sensor_health's cap 16384, full 32768 and full 65536 (the LM head's
    bucket), values with ties and targets inside the prefix."""
    out = []
    for cap, zr in ((16384, 4096), (16384, 16384), (32768, 32768), (65536, 65536)):
        rng = np.random.default_rng(cap + zr)
        v = torch.from_numpy(np.round(rng.normal(0, 2, (h, cap)), 2).astype(np.float32)).to(dev)
        z = torch.full((h,), zr, dtype=torch.int32, device=dev)
        t = torch.from_numpy(rng.integers(0, zr, (h, r)).astype(np.int32)).to(dev)
        _, err = select_check(v, z, t, f"at cap {cap}, z {zr}")
        out.append(dict(shape=[h, cap, r], z=zr, max_abs_err=err,
                        **select_timed(v, z, t, 5 if zr > 16384 else 20)))
    return out


def wall_ms(fns: dict, reps: int = 10) -> dict:
    """Median host wall time (ms) of one call of each of ``fns`` followed by
    a synchronize, as a planner evaluation pays it before its predicate is
    read back (the operators' dispatch and their device time); the calls
    run in turns (each name, then the names in reverse), ``reps`` a turn,
    after one warm-up call each."""
    times = {name: [] for name in fns}
    for name, fn in fns.items():
        fn()
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fns[name]()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def afc_crossover(dev, cfg) -> list:
    """The rescan against the incremental AFC, per cap bucket, on synthetic
    buffers of the two pipelines' shapes (k = 9 parametric features;
    k = 5 of which 3 holistic, a median, a median and a p90), group sizes
    drawn in (cap/2, cap], at the plan z⁰: the incremental path's set-up
    once a request (``prefix_power_sums`` and, for holistic features, the
    rank index over the plan ladder) and its cost an evaluation, against the
    rescan's cost an evaluation (``sampled_moments``, ``masked_select_ranks``
    and the bootstrap), host wall times (:func:`wall_ms`).
    ``crossover_evals``: the evaluations a request above which the
    incremental path costs less (None: never)."""
    from repro_torch.core import threefry
    from repro_torch.core.planner import gamma_abs, initial_plan
    from repro_torch.data.aggregates import estimates_from_power_sums
    from repro_torch.kernels.sampled_agg import ops
    from repro_torch.kernels.sampled_agg.prefix_stats import (
        build_rank_index,
        prefix_moments_at,
        select_ranks_indexed,
    )

    rng = np.random.default_rng(17)
    key = threefry.fold_in(threefry.PRNGKey(0), 1)
    out = []
    for name, k, h in (("parametric", 9, 0), ("holistic", 5, 3)):
        for cap in (512, 1024, 2048, 4096, 8192, 16384, 32768, 65536):
            vals = torch.from_numpy(rng.normal(1.0, 3.0, (k, cap)).astype(np.float32)).to(dev)
            n = torch.from_numpy(rng.integers(cap // 2 + 1, cap + 1, k).astype(np.int32)).to(dev)
            agg = torch.zeros((k,), dtype=torch.int32, device=dev)    # AVG; the sums are the same
            z = initial_plan(n, cfg.alpha)
            shift = vals[:, 0].contiguous()
            vh, nh, zh = vals[:h].contiguous(), n[:h], z[:h]
            qs = torch.tensor([0.5, 0.5, 0.9][:h], dtype=torch.float32, device=dev)
            ladder = torch.arange(cfg.max_iters + 1, dtype=torch.int32, device=dev)
            zcand = torch.minimum(z[:h, None] + ladder[None, :] * gamma_abs(n, cfg.gamma),
                                  nh[:, None])

            def setup():
                ptab = ops.prefix_power_sums(vals, shift)
                return ptab, build_rank_index(vh, nh, zcand) if h else None

            ptab, rindex = setup()

            def incremental():
                estimates_from_power_sums(prefix_moments_at(ptab, z), z, n, agg, shift)
                if h:
                    t = ops.bootstrap_rank_targets(zh, qs, key, cfg.n_bootstrap)
                    ops.finish_quantile_estimates(select_ranks_indexed(rindex, zh, t), zh, nh)

            def rescan():
                ops.masked_estimates(vals, z, n, agg)
                if h:
                    ops.masked_quantile_estimates(vh, zh, nh, qs, key, cfg.n_bootstrap)

            t = wall_ms({"setup": setup, "incremental": incremental, "rescan": rescan})
            r = dict(pipeline=name, k=k, holistic=h, cap=cap, z0_max=int(z.max()),
                     setup_ms=t["setup"], incremental_eval_ms=t["incremental"],
                     rescan_eval_ms=t["rescan"])
            gain = r["rescan_eval_ms"] - r["incremental_eval_ms"]
            r["crossover_evals"] = r["setup_ms"] / gain if gain > 0 else None
            out.append(r)
    return out


# ---------------------------------------------------------------- phase 3/4
def serve_run(bundle, cfg, dev, *, afc_backend, use_kernel, n_req):
    """Build a server and serve ``n_req`` requests after one warm-up request.

    Returns (outputs, p50 latency seconds, launch counts of the whole run,
    launch counts of the server's construction alone).  The counts are
    reset once, before the server is built; the construction's are read
    when it returns, the whole run's after the last request.  The run's
    counts hold each kernel path's launches too (``build.PATHS``).
    """
    from repro_torch.kernels import build
    from repro_torch.serving import BiathlonServer

    torch.cuda.synchronize()
    build.reset_launch_counts()
    srv = BiathlonServer(bundle, cfg, afc_backend=afc_backend, device=dev,
                         use_kernel=use_kernel)
    at_build = dict(build.LAUNCHES)
    reqs = bundle.requests[:n_req]
    srv.serve(reqs[0])  # warm-up
    outs = [srv.serve(r) for r in reqs]
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES) | dict(build.PATHS)
    return outs, statistics.median(o["latency"] for o in outs), launches, at_build


def profile_rows(prof, path: Path) -> tuple[list, list]:
    """``(all rows, device rows)`` of a profile, each ``(device us, name, count,
    host us)`` sorted by device time; the table is written to ``path``."""
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append((float(dev_us), e.key, int(e.count), float(e.self_cpu_time_total)))
    rows.sort(reverse=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("self_device_us  count  self_cpu_us  name\n" + "\n".join(
        f"{d:14.1f} {c:6d} {h:12.1f}  {k}" for d, k, c, h in rows))
    # device activity (kernels, copies) has no host time of its own; host
    # operators carry their kernels' time too, so only the former is summed
    return rows, [r for r in rows if r[3] == 0.0 and r[0] > 0.0]


def profile_served(serve_once, path: Path) -> dict:
    """Device time of one served request by kernel, from ``torch.profiler``.

    ``serve_once()`` serves the request and returns its output dict; it is
    called once to warm up, then once under the profiler.  Writes the table
    to ``path``; returns the device-busy total, the device time of the
    flash_attention kernel and the top entries.  The profiled latency
    carries the profiler's own overhead.
    """
    from torch.profiler import ProfilerActivity, profile

    serve_once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = serve_once()
        torch.cuda.synchronize()
    rows, device = profile_rows(prof, path)
    return dict(device_busy_ms=sum(r[0] for r in device) / 1e3,
                device_launches=sum(r[2] for r in device),
                host_ops=sum(r[2] for r in rows if r[3] > 0.0), iters=out["iters"],
                flash_attention_device_ms=sum(r[0] for r in device
                                              if "flash_attention" in r[1]) / 1e3,
                profiled_latency_ms=out["latency"] * 1e3,
                top_device=[[k[:60], d / 1e3, c] for d, k, c, _ in device[:6]])


def profile_request(bundle, cfg, dev, request, path: Path) -> dict:
    """:func:`profile_served` of one request of a fresh server."""
    from repro_torch.serving import BiathlonServer

    srv = BiathlonServer(bundle, cfg, device=dev)
    return profile_served(lambda: srv.serve(request), path)


def compare_runs(name, base, other, cfg):
    for i, (a, b) in enumerate(zip(base, other)):
        require(a["iters"] == b["iters"] and (a["z"] == b["z"]).all(),
                f"{name}: request {i} plan differs: {a['z']} x{a['iters']} vs "
                f"{b['z']} x{b['iters']}")
        require(abs(a["y_hat"] - b["y_hat"]) <= 1e-4 * max(1.0, abs(a["y_hat"])),
                f"{name}: request {i} y_hat {a['y_hat']} vs {b['y_hat']}")
    for i, o in enumerate(other):
        require(np.isfinite(o["y_hat"]), f"{name}: request {i} y_hat not finite")
        done = o["prob"] >= cfg.tau or (o["z"] == o["n"]).all() or o["iters"] == cfg.max_iters
        require(done, f"{name}: request {i} stopped with prob {o['prob']} < tau, plan left")


# the path every launch of a redesigned kernel must take on the served shapes
SERVED_PATHS = {"ensemble_sum": "smem", "prefix_power_sums": "chunks",
                "sampled_moments": "cluster", "masked_select_ranks": "radix",
                "sobol_points": "runs"}


def expect_launched(name, launches, kernels, absent=()):
    for kname in kernels:
        require(launches.get(kname, 0) > 0, f"{name}: kernel {kname} never launched")
    for kname in absent:
        require(launches.get(kname, 0) == 0, f"{name}: kernel {kname} launched off its path")
    for kname, path in SERVED_PATHS.items():
        require(launches.get(f"{kname}.{path}", 0) == launches.get(kname, 0),
                f"{name}: {kname} took {launches}, expected the {path} path on every launch")


# ------------------------------------------------------------------ phase 6
# the six other paper pipelines: model kind, task, and whether a tree
# ensemble (ensemble_sum) serves it
PAPER_PIPELINES = {
    "trip_fare": ("gradient boosting", "regression", True),
    "tick_price": ("linear", "regression", False),
    "battery": ("gradient boosting", "regression", True),
    "bearing_imbalance": ("MLP", "classification", False),
    "fraud_detection": ("gradient boosting", "classification", True),
    "student_qa": ("random forest", "classification", True),
}
N_PAPER = 4


def tight_config(pipeline):
    """The setting at which requests enter the planner loop: 0.3·δ for
    regression, τ = 0.99 for classification."""
    from repro_torch.core.executor import BiathlonConfig

    if pipeline.task == "classification":
        return BiathlonConfig(tau=0.99)
    return BiathlonConfig(delta=pipeline.delta_default * 0.3)


def paper_pipelines_phase(dev, cfg, card: str, rng) -> dict:
    """Each of the six other paper pipelines at full width (``make_pipeline``
    defaults), 4 requests through the kernels ("auto": incremental at these
    caps) and through the plain versions, at δ and at the tight setting:
    equal plans, iteration counts and classes; every kernel of the path
    launched on its redesigned path, none on the plain runs.  Then
    ``make_pipeline_median("trip_fare")`` under "ref" (the holistic rescan
    through ``masked_select_ranks``) against the plain versions.
    ``student_qa``'s forest (21 features) is held bitwise at its served
    megabatches and timed at 6889 rows, ``fraud_detection``'s boosted model
    at 2281; the tight classification request that iterated most is
    profiled."""
    from repro_torch.data.synthetic import make_pipeline, make_pipeline_median

    runs = {"auto": dict(afc_backend="auto", use_kernel=True),
            "plain": dict(afc_backend="auto", use_kernel=False)}
    out = {"serve": {}, "trees": {}}
    bundles = {}
    for name, (kind, task, trees) in PAPER_PIPELINES.items():
        t0 = time.perf_counter()
        bundle = bundles[name] = make_pipeline(name, device=dev)
        p = bundle.pipeline
        require(p.task == task, f"{name}: task {p.task}, expected {task}")
        build_s = time.perf_counter() - t0
        tight = tight_config(p)
        res = {key: serve_run(bundle, cfg, dev, n_req=N_PAPER, **kw) for key, kw in runs.items()}
        res.update({f"{key}_tight": serve_run(bundle, tight, dev, n_req=N_PAPER, **kw)
                    for key, kw in runs.items()})
        caps = sorted({o["cap"] for o in res["auto"][0]})
        require(min(caps) > 1024, f"{name}: caps {caps} do not take the incremental path")
        kernels = ["prefix_power_sums", "sobol_points"] + (["ensemble_sum"] if trees else [])
        absent = ["sampled_moments", "masked_select_ranks"] + ([] if trees else ["ensemble_sum"])
        for key in ("auto", "auto_tight"):
            expect_launched(f"{name} {key}", res[key][2], kernels, absent)
            require(res[key][3].get("sobol_points", 0) == 1,
                    f"{name} {key}: {res[key][3]} at the executor build, expected one "
                    "sobol_points launch")
        for key in ("plain", "plain_tight"):
            require(not res[key][2], f"{name} {key} launched kernels {res[key][2]}")
        compare_runs(f"{name} auto vs plain", res["plain"][0], res["auto"][0], cfg)
        compare_runs(f"{name} tight auto vs plain", res["plain_tight"][0],
                     res["auto_tight"][0], tight)
        if task == "classification":
            for o in res["auto"][0] + res["auto_tight"][0]:
                require(o["y_hat"] in (0.0, 1.0), f"{name}: y_hat {o['y_hat']} is not a class")
        for key, (outs, p50, launches, _) in res.items():
            print(f"serve {name} {key}: p50 {p50 * 1e3:.3f} ms over {len(outs)} requests, "
                  f"iters {[o['iters'] for o in outs]}, caps {sorted({o['cap'] for o in outs})}, "
                  f"launches {launches} [{card}]", flush=True)
        out["serve"][name] = dict(
            model=kind, task=task, k=p.k, rows=bundle.table_rows, build_s=build_s,
            megabatch=cfg.m + 1 + (p.k + 2) * cfg.m_sobol,
            **{key: dict(p50_ms=p50 * 1e3, iters=[o["iters"] for o in outs], launches=launches)
               for key, (outs, p50, launches, _) in res.items()})

    student = bundles["student_qa"].pipeline.model.ensemble
    require(tuple(student.feature.shape) == (40, 511), "student_qa forest is not 40 x 511")
    out["trees"]["student_qa"] = dict(
        tree_record(student, 6889, dev, rng, n_feat=21),
        max_abs_err=tree_check(student, (6889, 5888, 1001, 1), dev, rng, n_feat=21))
    fraud = bundles["fraud_detection"].pipeline.model.ensemble
    out["trees"]["fraud_detection"] = dict(
        tree_record(fraud, 2281, dev, rng, n_feat=9),
        max_abs_err=tree_check(fraud, (2281, 1280, 1001), dev, rng, n_feat=9))

    # the tight classification request that iterated most
    name, busiest = max(
        ((n, i) for n, (_, task, _) in PAPER_PIPELINES.items() if task == "classification"
         for i in range(N_PAPER)),
        key=lambda ni: out["serve"][ni[0]]["auto_tight"]["iters"][ni[1]])
    tight = tight_config(bundles[name].pipeline)
    out["profile_classification"] = dict(
        profile_request(bundles[name], tight, dev, bundles[name].requests[busiest],
                        ROOT / "build" / "chip_smoke_profile_classification.txt"),
        pipeline=name, request=busiest, tau=tight.tau)
    print(f"profile of {name} tight request {busiest}: "
          f"{json.dumps(out['profile_classification'])} [{card}]", flush=True)

    median = make_pipeline_median("trip_fare", device=dev)
    res = {"ref": serve_run(median, cfg, dev, afc_backend="ref", use_kernel=True, n_req=N_PAPER),
           "plain": serve_run(median, cfg, dev, afc_backend="ref", use_kernel=False,
                              n_req=N_PAPER)}
    expect_launched("trip_fare_median ref", res["ref"][2],
                    ["masked_select_ranks", "sampled_moments", "ensemble_sum", "sobol_points"],
                    ["prefix_power_sums"])
    require(not res["plain"][2], f"trip_fare_median plain launched kernels {res['plain'][2]}")
    compare_runs("trip_fare_median ref vs plain", res["plain"][0], res["ref"][0], cfg)
    for key, (outs, p50, launches, _) in res.items():
        print(f"serve trip_fare_median {key}: p50 {p50 * 1e3:.3f} ms over {len(outs)} requests, "
              f"iters {[o['iters'] for o in outs]}, caps {sorted({o['cap'] for o in outs})}, "
              f"launches {launches} [{card}]", flush=True)
    out["serve"]["trip_fare_median"] = {
        key: dict(p50_ms=p50 * 1e3, iters=[o["iters"] for o in outs], launches=launches)
        for key, (outs, p50, launches, _) in res.items()}
    return out


# ---------------------------------------------------------------- phase 7-9
def attention_work(b, h, hkv, sq, sk, d, dv, causal: bool, itemsize: int) -> tuple[int, int]:
    """(bytes, FLOPs) of one attention call: q, k, v read once and o written
    once; 2·D + 2·Dv FLOPs per live (q, k) pair (top-left causal mask)."""
    if not causal:
        pairs = sq * sk
    elif sq <= sk:
        pairs = sq * (sq + 1) // 2
    else:
        pairs = sk * (sk + 1) // 2 + (sq - sk) * sk
    nbytes = itemsize * (b * h * sq * d + b * hkv * sk * (d + dv) + b * h * sq * dv)
    return nbytes, b * h * pairs * (2 * d + 2 * dv)


def attention_check(dev, name, shape, dtype, causal, seed):
    """The kernel against its plain version on seeded inputs; returns
    (inputs, max |err|), failing beyond ``ATTN_TOL``.  A bf16 call must have
    taken the TMA path and be within ``EMULATION_TOL`` of its emulated
    roundings plus, for each output, the slack of the p's that the kernel
    may round to the other side of a bf16 tie (``emulation.bf16_path``)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.emulation import beyond, bf16_path, key_tile
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    b, h, hkv, sq, sk, d, dv = shape
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(dev, dtype)
               for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv)))
    build.reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    path = "tma" if dtype == torch.bfloat16 else "simt"
    require(build.PATHS == {f"flash_attention.{path}": 1},
            f"flash_attention {name}: took {dict(build.PATHS)}, expected the {path} path")
    rep = h // hkv
    kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    want = flash_attention_ref(q, kr, vr, causal=causal)
    err = float((got.float() - want.float()).abs().max())
    require(torch.allclose(got.float(), want.float(), **ATTN_TOL[dtype]),
            f"flash_attention {name}: max |err| {err} beyond {ATTN_TOL[dtype]}")
    line = f"flash_attention {name} ({path}): max |err| {err:.3g} (tolerance {ATTN_TOL[dtype]})"
    if dtype == torch.bfloat16:
        emulated, slack = bf16_path(q, kr, vr, causal=causal, block_k=key_tile(d, dv), slack=True)
        em_err = float((got.float() - emulated.float()).abs().max())
        n_beyond = int(beyond(got, emulated, slack, **EMULATION_TOL).sum())
        past_ulp = int(beyond(got, emulated, torch.zeros_like(slack), **EMULATION_TOL).sum())
        require(n_beyond == 0,
                f"flash_attention {name}: {n_beyond} outputs beyond {EMULATION_TOL} plus their "
                f"tie slack from the emulated roundings (max |err| {em_err})")
        line += (f"; from the emulated roundings {em_err:.3g} ({past_ulp} of {got.numel()} "
                 f"past {EMULATION_TOL}, none past it plus their tie slack, at most "
                 f"{float(slack.max()):.3g}; {int((slack > 0).sum())} outputs with slack)")
        del emulated, slack
    print(line, flush=True)
    return (q, k, v), err


def attention_timings(dev, qkv, causal: bool, reps: int) -> dict:
    """Kernel, plain version and ``F.scaled_dot_product_attention`` on one input."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    q, k, v = qkv
    b, h, sq, d = q.shape
    _, hkv, sk, dv = v.shape
    ms, eager_ms = time_ms(lambda: flash_attention(q, k, v, causal=causal), reps)
    plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, causal=causal), reps)[0]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
                         reps)[0]
    lib_err = float((F.scaled_dot_product_attention(q, k, v, is_causal=causal).float()
                     - flash_attention_ref(q, k, v, causal=causal).float()).abs().max())
    peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    b_ms, b_by = bound(*attention_work(b, h, hkv, sq, sk, d, dv, causal, q.element_size()),
                       ops_per_s=peak)
    return dict(shape=[b, h, sq, d], dtype=str(q.dtype).removeprefix("torch."), causal=causal,
                ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, library_ms=library_ms,
                library_max_abs_err=lib_err, bound_ms=b_ms, bound_by=b_by)


def ptxas_report(name: str) -> dict:
    """Registers and spill bytes of each bf16 ``flash_attention`` instance
    (``sm90::flash_attention_kernel<DP>``), from the ``-Xptxas -v`` log of
    the library that was loaded, with any ``setmaxnreg`` warning of the
    compiler."""
    from repro_torch.kernels import build

    out, entry = {}, None
    for line in build.log_path(name).read_text().splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"4sm90\w*flash_attention_kernelILi(\d+)E", line)
            entry = f"dp{m.group(1)}" if m else None
            if entry:
                out[entry] = {}
        elif entry and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            out[entry].update(spill_store_bytes=int(m.group(1)), spill_load_bytes=int(m.group(2)))
        elif entry and "Used" in line and "registers" in line:
            out[entry]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
        if "setmaxnreg" in line:
            out.setdefault("warnings", []).append(line.strip())
    require(out, f"{build.log_path(name)} lists no bf16 flash_attention instance")
    return out


def flash_record(dev) -> dict:
    """``flash_attention`` against its plain version at every listed shape, timed."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as attn_ops

    bf16, f32 = torch.bfloat16, torch.float32
    errors = {}
    inputs = {}
    for i, (name, shape, dtype, causal) in enumerate([
        ("lm_head_1x16x48x64_bf16_causal", (1, 16, 16, 48, 48, 64, 64), bf16, True),
        ("prefill_1x16x4096x64_bf16_causal", (1, 16, 16, 4096, 4096, 64, 64), bf16, True),
        ("f32_1x16x512x64_noncausal", (1, 16, 16, 512, 512, 64, 64), f32, False),
        ("sq100_sk260_bf16_causal", (1, 16, 16, 100, 260, 64, 64), bf16, True),
        ("prefill_1x16x4096x128_bf16_causal", (1, 16, 16, 4096, 4096, 128, 128), bf16, True),
    ] + [
        # 65536 batch·heads (past a grid's y axis) on three inputs
        (f"batch_heads_65536_4096x16x16x64_bf16_causal_seed{seed}",
         (4096, 16, 16, 16, 16, 64, 64), bf16, True) for seed in (5, 6, 7)
    ]):
        inputs[name], errors[name] = attention_check(dev, name, shape, dtype, causal, seed=i)
    # GQA through the model-layout entry point: 16 query heads on 4 KV heads
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(dev, bf16)
               for s in ((1, 256, 16, 64), (1, 256, 4, 64), (1, 256, 4, 64)))
    got, want = attn_ops.attention(q, k, v), attn_ops.attention(q, k, v, use_kernel=False)
    errors["gqa_ops_1x256x16on4x64_bf16_causal"] = err = float((got - want).float().abs().max())
    require(torch.allclose(got.float(), want.float(), **ATTN_TOL[bf16]),
            f"flash_attention GQA through ops.attention: max |err| {err}")
    print(f"flash_attention gqa_ops: max |err| {err:.3g} (tolerance {ATTN_TOL[bf16]})",
          flush=True)
    rec = attention_timings(dev, inputs["prefill_1x16x4096x64_bf16_causal"], True, reps=5)
    rec["lm_head_shape"] = attention_timings(dev, inputs["lm_head_1x16x48x64_bf16_causal"],
                                             True, reps=20)
    rec["prefill_d128"] = attention_timings(dev, inputs["prefill_1x16x4096x128_bf16_causal"],
                                            True, reps=5)
    for r in (rec, rec["lm_head_shape"], rec["prefill_d128"]):
        r.update(ratio_to_library=r["ms"] / r["library_ms"], bound_share=r["bound_ms"] / r["ms"])
    rec.update(max_abs_err=max(errors.values()), errors=errors, phases=list(errors),
               instances=ptxas_report("flash_attention"))
    build.reset_launch_counts()
    return rec


def lm_head_phase(dev, card: str) -> dict:
    """The LM-head pipeline at full qwen1.5-0.5b width, kernel path and plain path."""
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_lm_head as ex
    from repro_torch.kernels import build
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_config("qwen1.5-0.5b")
    t0 = time.perf_counter()
    sc = ex.build(cfg, dev)
    leaves = tree_leaves(sc.params)
    n_params = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"lm_head: {cfg.arch_id} backbone {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{n_params} parameters, {n_bytes} bytes ({leaves[0].dtype}); event store "
          f"{sc.store['events'].n_rows} rows; built with the head in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    requests = ex.draw_requests(sc, N_LM_REQ)
    runs = {}
    for use_kernel in (True, False):
        torch.cuda.synchronize()
        build.reset_launch_counts()
        executor = ex.make_executor(sc, use_kernel=use_kernel)
        at_build = dict(build.LAUNCHES)
        paths_at_build = dict(build.PATHS)
        outs = ex.serve(sc, executor, requests, use_kernel=use_kernel)
        torch.cuda.synchronize()
        paths = {n: c - paths_at_build.get(n, 0) for n, c in build.PATHS.items()
                 if c > paths_at_build.get(n, 0)}
        runs[use_kernel] = (outs, dict(build.LAUNCHES) | dict(build.PATHS), at_build, executor,
                            paths)
    outs, launches, at_build, _, paths = runs[True]
    served = {n: launches.get(n, 0) - at_build.get(n, 0) for n in launches}
    require(served.get("flash_attention", 0) == cfg.n_layers * N_LM_REQ,
            f"lm_head: {served.get('flash_attention', 0)} flash_attention launches for "
            f"{N_LM_REQ} requests, expected {cfg.n_layers} per request")
    require(paths == {"flash_attention.tma": cfg.n_layers * N_LM_REQ,
                      "prefix_power_sums.chunks": N_LM_REQ},
            f"lm_head: took {paths}, expected the TMA path on every flash_attention launch "
            "and the chunked prefix_power_sums")
    require(served.get("prefix_power_sums", 0) == N_LM_REQ,
            f"lm_head: prefix_power_sums launched {served.get('prefix_power_sums', 0)} times "
            f"for {N_LM_REQ} requests, expected once per request")
    expect_launched("lm_head", launches, ["sobol_points"], ["sampled_moments"])
    plain_outs, plain_launches = runs[False][0], runs[False][1]
    require(not plain_launches, f"lm_head plain run launched kernels {plain_launches}")
    state_err = 0.0
    for i, (a, b) in enumerate(zip(outs, plain_outs)):
        require(bool(torch.isfinite(a["state"]).all()) and a["state"].shape == (cfg.d_model,),
                f"lm_head: request {i} pooled state not finite of shape ({cfg.d_model},)")
        err = float((a["state"] - b["state"]).abs().max() / b["state"].abs().max())
        require(err < STATE_REL_TOL, f"lm_head: request {i} pooled states differ by {err}")
        state_err = max(state_err, err)
    # both executors fed the kernel path's pooled states
    fed = ex.serve(sc, runs[False][3], requests, use_kernel=False,
                   states=[o["state"] for o in outs])
    for i, (a, b) in enumerate(zip(outs, fed)):
        require(np.isfinite(a["y_hat"]) and 0.0 <= a["prob"] <= 1.0,
                f"lm_head: request {i} y_hat {a['y_hat']} prob {a['prob']}")
        require(a["iters"] == b["iters"] and (a["z"] == b["z"]).all(),
                f"lm_head: request {i} plan {a['z']} x{a['iters']} vs plain {b['z']} "
                f"x{b['iters']}")
        require(abs(a["y_hat"] - b["y_hat"]) <= 1e-4 * max(1.0, abs(a["y_hat"])),
                f"lm_head: request {i} y_hat {a['y_hat']} vs plain {b['y_hat']}")
        done = a["prob"] >= 0.95 or a["iters"] == 32 or (a["frac"] == 1.0)
        require(done, f"lm_head: request {i} stopped at prob {a['prob']} with plan left")
    result = {}
    for name, group in (("kernel", outs), ("plain", plain_outs)):
        for o in group:
            print(f"lm_head {name} user {o['user']:>3}: latency {o['latency'] * 1e3:.3f} ms, "
                  f"iters {o['iters']}, frac {o['frac']:.4f}, y_hat {o['y_hat']:.5f}, "
                  f"prob {o['prob']:.4f}", flush=True)
        p50 = statistics.median(o["latency"] for o in group) * 1e3
        print(f"lm_head {name}: p50 {p50:.3f} ms over {len(group)} requests [{card}]",
              flush=True)
        result[name] = dict(p50_ms=p50, latency_ms=[o["latency"] * 1e3 for o in group],
                            iters=[o["iters"] for o in group],
                            frac=[o["frac"] for o in group],
                            y_hat=[o["y_hat"] for o in group], prob=[o["prob"] for o in group])
    result.update(params=n_params, param_bytes=n_bytes, launches=launches,
                  launches_at_build=at_build,
                  flash_attention_paths={n: c for n, c in paths.items()
                                         if n.startswith("flash_attention.")},
                  state_max_rel_err=state_err)
    prof = profile_served(lambda: ex.serve(sc, runs[True][3], requests[:1])[0],
                          ROOT / "build" / "chip_smoke_profile_lm_head.txt")
    prof["device_idle_share"] = max(0.0, 1.0 - prof["device_busy_ms"] / result["kernel"]["p50_ms"])
    print(f"profile of lm_head request 0: {json.dumps(prof)} [{card}]", flush=True)
    result["profile"] = prof
    return result, sc


def backbone_profile(sc, dev, path: Path) -> dict:
    """One 1 × 4096-token backbone forward: latency and a device-time profile."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build
    from repro_torch.models.lm import LM

    cfg = sc.cfg
    tokens = torch.from_numpy(np.random.default_rng(4096).integers(0, cfg.vocab, (1, 4096)))
    tokens = tokens.to(dev)
    lat = {}
    with torch.no_grad():
        for use_kernel in (True, False):
            lm = LM(cfg, use_kernel=use_kernel)
            fwd = lambda: lm._backbone(sc.params, lm.embed(sc.params, tokens))  # noqa: E731
            h = fwd()
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                h = fwd()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            require(bool(torch.isfinite(h).all()), "4096-token forward is not finite")
            lat[use_kernel] = statistics.median(times)
        lm = LM(cfg)
        build.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            lm._backbone(sc.params, lm.embed(sc.params, tokens))
            torch.cuda.synchronize()
        launches = build.LAUNCHES["flash_attention"]
        tma = build.PATHS["flash_attention.tma"]
    require(launches == cfg.n_layers,
            f"4096-token forward: {launches} flash_attention launches, expected {cfg.n_layers}")
    require(tma == launches, f"4096-token forward: {tma} of {launches} flash_attention "
                             "launches took the TMA path")
    _, device = profile_rows(prof, path)
    busy_ms = sum(r[0] for r in device) / 1e3
    flash_ms = sum(r[0] for r in device if "flash_attention" in r[1]) / 1e3
    require(flash_ms > 0.0, "profile shows no flash_attention device time")
    return dict(tokens=4096, latency_ms=lat[True], plain_latency_ms=lat[False],
                flash_attention_launches=launches, device_busy_ms=busy_ms,
                flash_attention_device_ms=flash_ms, flash_attention_share=flash_ms / busy_ms,
                device_idle_share=max(0.0, 1.0 - busy_ms / lat[True]),
                top_device=[[k[:60], d / 1e3, c] for d, k, c, _ in device[:6]])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run it from the root of a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.executor import BiathlonConfig
    from repro_torch.core.executor_fused import guarantee_prob
    from repro_torch.data.synthetic import make_pipeline
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    build_s = build.build_all()["total"]
    print(f"build: {build_s:.2f} s for {len(build.SOURCES)} kernels (nvcc, sm_90a)", flush=True)

    # degenerate sigma: a float32-subnormal bias is not within delta = 0
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    require(float(guarantee_prob(f(0.0), f(1e-38), f(0.0), f(0.0))) == 0.0,
            "guarantee_prob: subnormal bias accepted at delta = 0")

    t0 = time.perf_counter()
    full = make_pipeline("turbofan", device=dev)
    print(f"turbofan bundle: {full.table_rows} rows, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cfg = BiathlonConfig()
    rec = check_kernels(dev, full, cfg.alpha)
    rec["flash_attention"] = flash_record(dev)
    print("kernels vs plain: ok", flush=True)

    results = {}
    runs = {
        "auto": dict(afc_backend="auto", use_kernel=True),
        "ref": dict(afc_backend="ref", use_kernel=True),
        "plain": dict(afc_backend="auto", use_kernel=False),
    }
    for name, kw in runs.items():
        results[name] = serve_run(full, cfg, dev, n_req=N_SERVE, **kw)
    # a tighter error bound makes full-width requests enter the planner loop
    tight = BiathlonConfig(delta=full.pipeline.delta_default * 0.3)
    for name in ("auto", "plain"):
        results[f"{name}_tight"] = serve_run(full, tight, dev, n_req=N_SERVE, **runs[name])
    compare_runs("tight auto vs plain", results["plain_tight"][0],
                 results["auto_tight"][0], tight)
    caps = sorted({o["cap"] for o in results["auto"][0]})
    require(min(caps) > 1024, f"full-width caps {caps} do not take the incremental path")
    expect_launched("auto", results["auto"][2],
                    ["prefix_power_sums", "ensemble_sum", "sobol_points"], ["sampled_moments"])
    expect_launched("ref", results["ref"][2],
                    ["sampled_moments", "ensemble_sum", "sobol_points"], ["prefix_power_sums"])
    require(not results["plain"][2], f"plain run launched kernels {results['plain'][2]}")
    expect_launched("auto tight", results["auto_tight"][2],
                    ["prefix_power_sums", "ensemble_sum", "sobol_points"], ["sampled_moments"])
    compare_runs("auto vs plain", results["plain"][0], results["auto"][0], cfg)
    compare_runs("ref vs plain", results["plain"][0], results["ref"][0], cfg)
    for name, (outs, p50, launches, _) in results.items():
        print(f"serve {name}: p50 {p50 * 1e3:.3f} ms over {len(outs)} requests, "
              f"iters {[o['iters'] for o in outs]}, caps {sorted({o['cap'] for o in outs})}, "
              f"launches {launches} [{card}]", flush=True)

    outs = results["auto_tight"][0]
    busiest = max(range(N_SERVE), key=lambda i: outs[i]["iters"])
    prof = profile_request(full, tight, dev, full.requests[busiest],
                           ROOT / "build" / "chip_smoke_profile.txt")
    prof["latency_ms"] = outs[busiest]["latency"] * 1e3
    print(f"profile of tight request {busiest}: {json.dumps(prof)} [{card}]", flush=True)

    small = make_pipeline("turbofan", rows_per_group=500, device=dev)
    sm = {name: serve_run(small, cfg, dev, n_req=4, **kw)
          for name, kw in (("auto", runs["auto"]), ("plain", runs["plain"]))}
    require(max(o["cap"] for o in sm["auto"][0]) <= 1024, "reduced-depth caps exceed 1024")
    expect_launched("reduced auto", sm["auto"][2],
                    ["sampled_moments", "ensemble_sum", "sobol_points"], ["prefix_power_sums"])
    compare_runs("reduced auto vs plain", sm["plain"][0], sm["auto"][0], cfg)
    for name, (outs, p50, launches, _) in sm.items():
        print(f"serve reduced {name}: p50 {p50 * 1e3:.3f} ms over {len(outs)} requests, "
              f"iters {[o['iters'] for o in outs]}, launches {launches} [{card}]", flush=True)

    # sensor_health: the holistic path
    t0 = time.perf_counter()
    health = make_pipeline("sensor_health", device=dev)
    print(f"sensor_health bundle: {health.table_rows} rows, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rec["masked_select_ranks"] = select_record(health, dev, cfg)
    rec["prefix_power_sums"]["sensor_health"] = request_tables_record(health, dev)
    rec["masked_select_ranks"]["sweep"] = select_sweep(dev)
    rec["masked_select_ranks"]["max_abs_err"] = max(
        [rec["masked_select_ranks"]["max_abs_err"]]
        + [r["max_abs_err"] for r in rec["masked_select_ranks"]["sweep"]])
    hs = {name: serve_run(health, cfg, dev, n_req=N_SERVE, **kw) for name, kw in runs.items()}
    h_tight = BiathlonConfig(delta=health.pipeline.delta_default * 0.3)
    for name in ("auto", "plain"):
        hs[f"{name}_tight"] = serve_run(health, h_tight, dev, n_req=N_SERVE, **runs[name])
    caps = sorted({o["cap"] for o in hs["auto"][0]})
    require(min(caps) > 1024, f"sensor_health caps {caps} do not take the incremental path")
    expect_launched("sensor_health ref", hs["ref"][2],
                    ["masked_select_ranks", "sampled_moments", "ensemble_sum"],
                    ["prefix_power_sums"])
    for name in ("auto", "auto_tight"):
        expect_launched(f"sensor_health {name}", hs[name][2],
                        ["prefix_power_sums", "ensemble_sum"],
                        ["masked_select_ranks", "sampled_moments"])
    for name in ("plain", "plain_tight"):
        require(not hs[name][2], f"sensor_health {name} launched kernels {hs[name][2]}")
    compare_runs("sensor_health auto vs plain", hs["plain"][0], hs["auto"][0], cfg)
    compare_runs("sensor_health ref vs plain", hs["plain"][0], hs["ref"][0], cfg)
    compare_runs("sensor_health tight auto vs plain", hs["plain_tight"][0],
                 hs["auto_tight"][0], h_tight)
    for name, (outs, p50, launches, _) in hs.items():
        print(f"serve sensor_health {name}: p50 {p50 * 1e3:.3f} ms over {len(outs)} requests, "
              f"iters {[o['iters'] for o in outs]}, caps {sorted({o['cap'] for o in outs})}, "
              f"launches {launches} [{card}]", flush=True)
    outs = hs["auto_tight"][0]
    busiest = max(range(N_SERVE), key=lambda i: outs[i]["iters"])
    h_prof = profile_request(health, h_tight, dev, health.requests[busiest],
                             ROOT / "build" / "chip_smoke_profile_sensor_health.txt")
    h_prof["latency_ms"] = outs[busiest]["latency"] * 1e3
    print(f"profile of sensor_health tight request {busiest}: {json.dumps(h_prof)} [{card}]",
          flush=True)

    h_small = make_pipeline("sensor_health", rows_per_group=500, device=dev)
    hsm = {name: serve_run(h_small, cfg, dev, n_req=4, **kw)
           for name, kw in (("auto", runs["auto"]), ("plain", runs["plain"]))}
    require(max(o["cap"] for o in hsm["auto"][0]) <= 1024,
            "sensor_health reduced-depth caps exceed 1024")
    expect_launched("sensor_health reduced auto", hsm["auto"][2],
                    ["masked_select_ranks", "sampled_moments", "ensemble_sum"],
                    ["prefix_power_sums"])
    require(not hsm["plain"][2], f"sensor_health reduced plain launched {hsm['plain'][2]}")
    compare_runs("sensor_health reduced auto vs plain", hsm["plain"][0], hsm["auto"][0], cfg)
    for name, (outs, p50, launches, _) in hsm.items():
        print(f"serve sensor_health reduced {name}: p50 {p50 * 1e3:.3f} ms over {len(outs)} "
              f"requests, iters {[o['iters'] for o in outs]}, launches {launches} [{card}]",
              flush=True)

    paper = paper_pipelines_phase(dev, cfg, card, np.random.default_rng(1))
    rec["ensemble_sum"].update(paper["trees"])
    rec["ensemble_sum"]["max_abs_err"] = max(
        [rec["ensemble_sum"]["max_abs_err"]] + [r["max_abs_err"] for r in paper["trees"].values()])

    crossover = afc_crossover(dev, cfg)
    for r in crossover:
        print(f"afc crossover {r['pipeline']} cap {r['cap']}: set-up {r['setup_ms']:.4f} ms, "
              f"an evaluation incremental {r['incremental_eval_ms']:.4f} ms, rescan "
              f"{r['rescan_eval_ms']:.4f} ms, crossover {r['crossover_evals']} evaluations "
              f"[{card}]", flush=True)

    lm_head, lm_scenario = lm_head_phase(dev, card)
    backbone = backbone_profile(lm_scenario, dev,
                                ROOT / "build" / "chip_smoke_profile_backbone4096.txt")
    print(f"backbone 1x4096 forward: {json.dumps(backbone)} [{card}]", flush=True)

    def per_request(run, kname, n_req):
        """Launches of a run's requests (warm-up included), apart from its build."""
        _, _, launches, at_build = run
        return (launches.get(kname, 0) - at_build.get(kname, 0)) / (n_req + 1)

    path_run = {"prefix_power_sums": "auto", "sampled_moments": "ref",
                "ensemble_sum": "auto", "sobol_points": "auto", "masked_select_ranks": "ref"}
    # the rescan as "auto" serves it at reduced depth: its own inputs and counts
    rec["sampled_moments"]["reduced_depth"] = dict(
        moments_record(small, dev, cfg.alpha),
        launches=sm["auto"][2].get("sampled_moments", 0),
        launches_per_request=per_request(sm["auto"], "sampled_moments", 4))
    rec["masked_select_ranks"]["reduced_depth"] = dict(
        select_record(h_small, dev, cfg),
        launches=hsm["auto"][2].get("masked_select_ranks", 0),
        launches_per_request=per_request(hsm["auto"], "masked_select_ranks", 4))
    rec["masked_select_ranks"]["phases"] = [
        "request_0_z0_bitwise", "bitwise_stable", "rank_path_bitwise", "sort_gather_bitwise",
        "sweep_4096_16384_32768_65536_bitwise", "reduced_depth_request_0_z0_bitwise"]
    sources = {
        "prefix_power_sums": ("prefix_stats.cu", "src/repro/kernels/sampled_agg/prefix_stats.py:124"),
        "sampled_moments": ("sampled_agg.cu", "src/repro/kernels/sampled_agg/sampled_agg.py:74"),
        "ensemble_sum": ("tree_qmc.cu", "src/repro/kernels/tree_qmc/tree_qmc.py:62"),
        "sobol_points": ("sobol.cu", "src/repro/kernels/sobol/sobol.py:38"),
        "masked_select_ranks": ("quantile_select.cu",
                                "src/repro/kernels/sampled_agg/quantile_select.py:81"),
    }
    kernels = []
    for kname, (src, replaces) in sources.items():
        r = rec[kname]
        # the turbofan runs, or for masked_select_ranks the sensor_health runs
        runs_k = hs if kname == "masked_select_ranks" else results
        path = runs_k[path_run[kname]]
        kernels.append(dict(
            name=kname, route="cuda", source=f"src/repro_torch/kernels/csrc/{src}",
            replaces=replaces,
            launches=runs_k["auto"][2].get(kname, 0) + runs_k["ref"][2].get(kname, 0),
            launches_per_request=per_request(path, kname, N_SERVE),
            launches_per_executor_build=path[3].get(kname, 0),
            max_abs_err=r["max_abs_err"], ms=r["ms"], eager_ms=r["eager_ms"],
            plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r.get("library_ms"),
            shape=r["shape"], phases=r["phases"],
            **{key: r[key] for key in ("z", "reduced_depth", "sort_gather_ms", "sweep",
                                       "earlier_ms", "depth", "node_visits", "plan", "chunk",
                                       "blocks", "gbm", "lm_head", "sensor_health", "run",
                                       "grids", "student_qa", "fraud_detection")
               if key in r},
            launches_paper_pipelines=sum(
                v.get("launches", {}).get(kname, 0) for pipe in paper["serve"].values()
                for v in pipe.values() if isinstance(v, dict)),
        ))
        if kname in SERVED_PATHS:
            kernels[-1]["paths"] = {
                n: runs_k["auto"][2].get(n, 0) + runs_k["ref"][2].get(n, 0)
                for n in set(runs_k["auto"][2]) | set(runs_k["ref"][2])
                if n.startswith(kname + ".")}
    fa = rec["flash_attention"]
    kernels.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:74",
        launches=lm_head["launches"].get("flash_attention", 0),
        launches_per_request=(lm_head["launches"].get("flash_attention", 0)
                              - lm_head["launches_at_build"].get("flash_attention", 0))
        / N_LM_REQ,
        launches_per_executor_build=lm_head["launches_at_build"].get("flash_attention", 0),
        paths=lm_head["flash_attention_paths"],
        **{key: fa[key] for key in ("max_abs_err", "ms", "eager_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "library_max_abs_err", "shape",
                                    "dtype", "causal", "phases", "errors", "lm_head_shape",
                                    "prefill_d128", "ratio_to_library",
                                    "bound_share", "instances")},
        backbone_4096_launches=backbone["flash_attention_launches"],
    ))
    serve = {name: dict(p50_ms=p50 * 1e3, iters=[o["iters"] for o in outs])
             for name, (outs, p50, *_) in results.items()}
    serve.update({f"reduced_{name}": dict(p50_ms=p50 * 1e3, iters=[o["iters"] for o in outs])
                  for name, (outs, p50, *_) in sm.items()})
    for prefix, group in (("sensor_health_", hs), ("sensor_health_reduced_", hsm)):
        serve.update({f"{prefix}{name}": dict(p50_ms=p50 * 1e3, iters=[o["iters"] for o in outs],
                                              launches=launches)
                      for name, (outs, p50, launches, _) in group.items()})
    serve["lm_head"] = {key: val for key, val in lm_head.items()
                        if key not in ("launches", "launches_at_build")}
    serve["paper_pipelines"] = paper["serve"]
    seconds = time.perf_counter() - t_start
    print(json.dumps({"card": card, "build_s": build_s, "serve": serve, "profile": prof,
                      "afc_crossover": crossover,
                      "profile_sensor_health": h_prof,
                      "profile_classification": paper["profile_classification"],
                      "backbone_4096": backbone, "seconds": seconds}), flush=True)
    print(f"chip_smoke: {seconds:.1f} s in all, build included [{card}]", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SmokeFailure, AssertionError) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
