"""The fused Biathlon feedback loop for a batch of requests, in PyTorch.

Port of ``repro/core/executor_fused.py`` (``_executor_core`` +
``build_fused_executor``) together with the ``vmap`` that
``serving/batched.py`` puts over it: the requests of a batch are *lanes*,
a leading axis of every tensor, and each lane runs the reference's per-lane
state machine.  One request is the one-lane case of the same code.

* ``precompute``: buffers clamp ``n`` to the cap; exact-only features start
  at ``z = n``, the others at ``z⁰ = ceil(α·n)``.  The incremental AFC path
  builds the ``prefix_power_sums`` tables once per batch, and for holistic
  (MEDIAN/QUANTILE) features a rank index over the ladder of
  ``max_iters + 1`` plans the planner can reach; the rescan path runs
  ``sampled_moments`` and, for holistic features, ``masked_select_ranks``
  at every evaluation.  Each is ONE launch over the ``(L·k, cap)`` rows.
* ``init_eval``: the z⁰ evaluation is AMI-only (``m + 1`` model rows a
  lane).
* The Saltelli block at z⁰ (``(k+2)·m_sobol`` rows a lane) runs when some
  lane will iterate, and its indices are kept for those lanes only (the
  reference's ``lax.cond``, which ``vmap`` turns into a select).
* ``want_more = active & (prob < tau) & (it < iter_cap) & any(z < n)``, per
  lane; ``iter_cap`` is clamped to ``max_iters``.
* ``step_plan``: a fixed-shape step on device tensors.  Each lane that
  wants more steps ``z`` along its previous evaluation's Sobol direction
  and evaluates the new plan; the batch makes ONE model call on a
  megabatch of ``L·(m + 1 + (k+2)·m_sobol)`` rows.  Lanes that are done or
  inactive are frozen by ``torch.where`` and their ``it`` does not advance,
  as ``vmap``'s ``while_loop`` freezes them.
* Holistic features carry a sorted ``(h, B)`` bootstrap-replicate table
  instead of a σ: the replicate ranks come from JAX's threefry bits
  (``core/threefry.py``) under ``fold_in(PRNGKey(boot_seed), it)``, with
  ``it`` = 0 at z⁰ and the lane's iteration index after that.  Every key
  the loop can reach is derived once per executor on the host and kept on
  the card (``ops.boot_key_table``); a lane gathers its row by its ``it``.

The programs work on a *slot*: the fixed-shape device tensors of one
(lanes, cap bucket), inputs (a batch's data is copied in) and the loop's
state (z, it, ŷ, prob, indices, want).  On the CPU, and with
``capture=False``, the three programs run eagerly and the predicate is
read back after each step.  On the card (``capture=True``, the default
there) each program is captured once per slot as a ``torch.cuda.CUDAGraph``,
the three sharing one memory pool and the slot's buffers; a run copies its
data in, replays the z⁰ graph, reads back once whether any lane iterates
(most requests stop at z⁰ and pay no Saltelli block), then replays the
Saltelli graph and the step graph until every lane is done, reading the
lanes' done flags back after each step.  A failed capture raises; nothing
falls back to the eager loop.

**Prebuilt tables** (``build_fused_executor(..., prebuilt=True)``): the
hot-group feature cache (``serving/feature_cache.py``) keeps each request's
buffers and AFC tables on the device (:class:`PrebuiltTables`, made by
:func:`build_afc_precompute`'s ``cold`` and kept fresh by its ``refresh``).
The z⁰ program of such an executor builds no table: it reads them from
buffers of its slot (``ptab``, ``shift`` and, for holistic features, the
rank index), into which each run copies the lanes' entries, device to
device, as it copies ``vals``.  A cache hit therefore builds no slot and
launches no ``prefix_power_sums``; under ``"ref"`` the tables are ignored
and the rescan kernels run.

**Lanes over shards** (:func:`shard_lanes_executor`,
:func:`shard_lanes_state_executor`): a serving mesh's lanes split into
blocks, one a shard, each shard an executor of its own (model and constants
on its device) with its own slot, graphs and stream.  Every live shard's
replays are issued before any shard's flags are read, so the shards' loops
overlap; a shard whose lanes are done stops.  No program reads another
shard's tensors.

The QMC grid is fixed per executor, so its normal quantiles and the
holistic replicate-table indices are computed once at build time: the AMI
(m, k) and Saltelli (m_sobol, 2k) grids are views of one grid, one
``sobol_points`` launch on the card.  Classification pipelines read the
AMI rows' class frequencies (a comparison-sum over ``n_classes``, never a
``bincount``, which reads its maximum back to the host) at ŷ's class as
the guarantee probability, and take the main-effect indices of the
indicator ``f == ŷ``, as the reference does.
"""
from __future__ import annotations

import contextlib
import gc
from types import SimpleNamespace
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.analysis.contracts import ExecutableContract, register_contract
from repro_torch.core import threefry
from repro_torch.core.guarantee import guarantee_prob
from repro_torch.core.planner import direction, gamma_abs, initial_plan, next_plan
from repro_torch.core.propagation import output_moments, qmc_grid
from repro_torch.core.qmc import uniform_to_normal
from repro_torch.core.sobol_indices import indices_from_outputs
from repro_torch.core.uncertainty import replicate_indices, sample_features_fused
from repro_torch.data.aggregates import AGG_IDS_FULL, HOLISTIC_AGGS, estimates_from_power_sums
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.sampled_agg.ops import (
    boot_key_table,
    bootstrap_rank_targets,
    finish_quantile_estimates,
    masked_estimates,
    masked_quantile_estimates,
    prefix_power_sums,
    resolve_afc_plan,
)
from repro_torch.kernels.sampled_agg.prefix_stats import (
    BLOCK_S,
    N_POWERS,
    HolisticRankIndex,
    append_power_sums,
    build_rank_index,
    empty_rank_index,
    merge_sorted_prefix,
    prefix_moments_at,
    rank_index_from_sorted,
    select_ranks_indexed,
)

__all__ = [
    "CHUNK_CARRY_LEAVES",
    "ChunkedExecutor",
    "FusedExecutor",
    "FusedResult",
    "LaneState",
    "PrebuiltChunkedExecutor",
    "PrebuiltFusedExecutor",
    "PrebuiltTables",
    "ShardedChunkedExecutor",
    "ShardedFusedExecutor",
    "ShardedLaneState",
    "build_afc_precompute",
    "build_chunked_executor",
    "build_fused_executor",
    "fused_rows_per_iteration",
    "pipeline_executor_kwargs",
    "shard_lanes_executor",
    "shard_lanes_state_executor",
]

f32 = torch.float32


class FusedResult(NamedTuple):
    """A run's result: one entry a lane, ``(L,)`` and ``(L, k)``; a run
    given one request's ``(k, cap)`` buffers gets its lane alone, ``()``
    and ``(k,)``, with ``iters`` a Python int."""

    y_hat: torch.Tensor         # f32
    prob: torch.Tensor          # f32 Eq. 1 guarantee probability
    iters: torch.Tensor | int   # planner iterations run
    z: torch.Tensor             # int32 final plan
    samples_used: torch.Tensor  # int64; 0 on an inactive lane


class PrebuiltTables(NamedTuple):
    """A request's incremental-AFC tables, made once and kept on the device.

    ``ptab (k, cap, 4)`` prefix power sums, ``shift (k,)`` their origin
    (``vals[:, 0]``) and the holistic rank index (rows ``(h, ...)``;
    zero-size without holistic features), each with the leading dimensions
    of the buffers they were built from.  Built by
    :func:`build_afc_precompute`; a ``prebuilt=True`` executor reads them.
    """

    ptab: torch.Tensor
    shift: torch.Tensor
    rindex: HolisticRankIndex


def plan_ladder(z0: torch.Tensor, step: torch.Tensor, n: torch.Tensor, n_z: int) -> torch.Tensor:
    """Every plan the planner can reach, ``min(z⁰ + i·step, n)`` for i < n_z:
    ``(..., k, n_z)`` from ``(..., k)`` plans and sizes and ``(...,)`` steps."""
    ladder = torch.arange(n_z, dtype=torch.int32, device=z0.device)
    return torch.minimum(z0[..., None] + ladder * step[..., None, None], n[..., None])


def fused_rows_per_iteration(k: int, m: int, m_sobol: int) -> int:
    """Model rows evaluated per planner iteration (the single megabatch)."""
    return m + 1 + (k + 2) * m_sobol


def pipeline_executor_kwargs(agg_features, device) -> dict:
    """Executor kwargs from a pipeline's ``agg_features``.

    Returns the ``holistic`` / ``quantiles`` (0.5 for a median) /
    ``approximate`` build arguments and the runtime ``agg_ids`` row (int32
    on ``device``).  Raises on operators outside AGG_IDS_FULL.
    """
    unsupported = sorted({f.agg for f in agg_features if f.agg not in AGG_IDS_FULL})
    if unsupported:
        raise ValueError(f"unsupported aggregates {unsupported}")
    holistic = tuple(j for j, f in enumerate(agg_features) if f.agg in HOLISTIC_AGGS)
    return dict(
        holistic=holistic,
        quantiles=tuple(
            0.5 if agg_features[j].agg == "median" else agg_features[j].quantile
            for j in holistic
        ),
        approximate=tuple(f.approximate for f in agg_features),
        agg_ids=torch.tensor(
            [AGG_IDS_FULL[f.agg] for f in agg_features], dtype=torch.int32, device=device
        ),
    )


class FusedExecutor:
    """``run(vals, n, agg_ids, delta, exact, active=None, tau=None, iter_cap=None)``.

    Built by :func:`build_fused_executor`, which documents the arguments.
    ``vals`` is ``(L, k, cap)`` (or one request's ``(k, cap)``), ``n`` and
    ``agg_ids`` ``(L, k)`` (``agg_ids`` may be one ``(k,)`` row), ``exact``
    ``(L, e)``; ``delta``, ``tau`` (default: the build's), ``iter_cap``
    (default and ceiling: ``max_iters``) and ``active`` (default: every
    lane) are one a lane or one for all.  An inactive lane never iterates:
    ``iters == 0``, ``samples_used == 0``, its ŷ and prob those of its z⁰
    evaluation.  :attr:`slots_built` counts the (lanes, cap) slots made:
    on the card, each is one capture of the three programs.
    """

    prebuilt = False

    def __init__(self, model_fn, *, k, task, n_classes, m, m_sobol, alpha, gamma, tau,
                 max_iters, afc_backend, holistic, quantiles, n_boot, boot_seed, approximate,
                 device, use_kernel, capture):
        resolve_afc_plan(afc_backend)  # validate the string at build time
        if task not in ("regression", "classification"):
            raise ValueError(f"task must be 'regression' or 'classification', got {task!r}")
        dev = resolve_device(device)
        if capture is None:
            capture = dev.type == "cuda"
        if capture and dev.type != "cuda":
            raise ValueError("capture=True needs a CUDA device")
        self.model_fn, self.k, self.task, self.m, self.m_sobol = model_fn, k, task, m, m_sobol
        self.classify = task == "classification"
        self.n_classes, self.alpha, self.gamma = n_classes, alpha, gamma
        self.tau, self.max_iters, self.afc_backend = float(tau), int(max_iters), afc_backend
        self.n_boot, self.device, self.use_kernel, self.capture = n_boot, dev, use_kernel, capture
        self.approx = torch.tensor(
            [True] * k if approximate is None else list(approximate), dtype=torch.bool, device=dev
        )
        hol = tuple(int(j) for j in holistic)
        self.n_hol = len(hol)
        qs_list = [0.5] * self.n_hol if quantiles is None else [float(q) for q in quantiles]
        if len(qs_list) != self.n_hol:
            raise ValueError("quantiles must align with holistic indices")
        self.hol_idx = torch.tensor(hol, dtype=torch.int64, device=dev)
        self.qs = torch.tensor(qs_list, dtype=f32, device=dev)
        if self.n_hol:
            # every key the loop can reach, derived on the host, gathered on the card
            table = boot_key_table(threefry.PRNGKey(boot_seed), self.max_iters)
            self.key_table = torch.from_numpy(table.astype("int64")).to(dev)
        # the fixed QMC grid, its normal quantiles and replicate indices, once per executor
        u_ami, u_sob = qmc_grid(m, m_sobol, k, device=dev, use_kernel=use_kernel)
        g_ami, g_sob = uniform_to_normal(u_ami), uniform_to_normal(u_sob)
        self.grids = {
            "ami": (g_ami, replicate_indices(u_ami, self.hol_idx, n_boot)),
            "a": (g_sob[:, :k], replicate_indices(u_sob[:, :k], self.hol_idx, n_boot)),
            "b": (g_sob[:, k:], replicate_indices(u_sob[:, k:], self.hol_idx, n_boot)),
        }
        self.eye = torch.eye(k, dtype=torch.bool, device=dev)
        self.classes = torch.arange(n_classes, device=dev)
        self._slots: dict[tuple[int, int, int], SimpleNamespace] = {}
        self.slots_built = 0

    # ------------------------------------------------------------ evaluation
    def _sample(self, grid, value, sigma, reps):
        normals, rep_idx = self.grids[grid]
        return sample_features_fused(value, sigma, normals, reps, rep_idx, self.hol_idx)

    def _sobol_rows(self, value, sigma, reps):
        """Saltelli A/B/AB block: (L, (k+2)·m_sobol, k)."""
        xa = self._sample("a", value, sigma, reps)
        xb = self._sample("b", value, sigma, reps)
        xab = torch.where(self.eye[:, None, :], xb[:, None], xa[:, None])
        return torch.cat([xa, xb, xab.reshape(xa.shape[0], -1, self.k)], dim=1)

    def _model(self, s, rows):
        """ONE model call on the (L·r, k) rows, each with its lane's exact
        features: (L, r) outputs.  Each lane's row starts at a multiple of 4
        values (the outputs are padded to a row stride of ``4·ceil(r/4)``):
        the card's vectorised reductions over a lane's outputs split a row
        by its 16-byte alignment, so with every row aligned alike (and ``m``
        and ``m_sobol`` multiples of 4, as the defaults are) a request's
        bits do not depend on the lane that serves it."""
        lanes, r, _ = rows.shape
        exact = s.exact[:, None, :].expand(lanes, r, s.exact.shape[1]).reshape(lanes * r, -1)
        y = self.model_fn(rows.reshape(lanes * r, self.k), exact).to(f32).reshape(lanes, r)
        return torch.nn.functional.pad(y, (0, -r % 4))[:, :r]

    def _ami_prob(self, y, y_hat, delta):
        """Eq. 1 guarantee probability from the (L, m) AMI outputs; for
        classification the AMI rows' frequency of ŷ's class."""
        if self.classify:
            counts = (y.to(torch.int64)[..., None] == self.classes).sum(-2)      # (L, C)
            cls = torch.clamp(y_hat.to(torch.int64), 0, self.n_classes - 1)
            return (counts.to(f32) / self.m).gather(-1, cls[:, None])[:, 0]
        return guarantee_prob(y_hat, *output_moments(y), delta)

    def _indices(self, f_all, y_hat):
        return indices_from_outputs(f_all, self.m_sobol, self.k, task=self.task, y_hat=y_hat)[0]

    def _afc(self, s, z, it):
        """(value (L, k), sigma (L, k), replicates (L, h, B)) at plans z;
        ``it`` (L,) keys each lane's replicate ranks."""
        lanes, k = z.shape
        if s.incremental:
            ptab, shift, rindex = s.tables
            rows = ptab.reshape(lanes * k, -1, N_POWERS)
            value, sigma = estimates_from_power_sums(
                prefix_moments_at(rows, z.reshape(-1)), z.reshape(-1), s.n.reshape(-1),
                s.agg.reshape(-1), shift.reshape(-1))
            value, sigma = value.reshape(lanes, k), sigma.reshape(lanes, k)
        else:
            value, sigma = masked_estimates(s.vals, z, s.n, s.agg, use_kernel=self.use_kernel)
        if not self.n_hol:
            return value, sigma, None
        keys = self.key_table.index_select(0, it.to(torch.int64))
        z_h, n_h = z[:, self.hol_idx], s.n[:, self.hol_idx]
        if s.incremental:
            targets = bootstrap_rank_targets(z_h, self.qs, keys, self.n_boot)
            sel = select_ranks_indexed(rindex, z_h.reshape(-1),
                                       targets.reshape(lanes * self.n_hol, -1))
            q_val, reps = finish_quantile_estimates(sel.reshape(targets.shape), z_h, n_h)
        else:
            q_val, reps = masked_quantile_estimates(s.vals_h, z_h, n_h, self.qs, keys,
                                                    self.n_boot, use_kernel=self.use_kernel)
        value = value.index_copy(1, self.hol_idx, q_val)
        sigma = sigma.index_fill(1, self.hol_idx, 0.0)
        return value, sigma, reps

    def _want_more(self, s, z, it, prob):
        """The Eq. 1 loop predicate, one a lane."""
        return s.active & (prob < s.tau) & (it < s.cap_eff) & (z < s.n).any(-1)

    # ------------------------------------------------------------- programs
    def _init(self, s):
        """precompute + init_eval: the carry at z⁰ and whether each lane iterates."""
        lanes, k, cap = s.vals.shape
        s.n = n = torch.clamp(s.n_in, max=cap)
        # exact-only operators (Fig. 10 ablation) consume their full groups from z⁰ on
        z0 = torch.where(self.approx, initial_plan(n, self.alpha), n)
        s.step = gamma_abs(n, self.gamma)
        s.cap_eff = torch.clamp(s.iter_cap, max=self.max_iters)
        if self.n_hol:
            s.vals_h = s.vals[:, self.hol_idx]
        if s.incremental and not self.prebuilt:
            shift = s.vals[..., 0].contiguous()
            ptab = prefix_power_sums(s.vals, shift, use_kernel=self.use_kernel)
            rindex = None
            if self.n_hol:
                zcand = plan_ladder(z0, s.step, n, self.max_iters + 1)[:, self.hol_idx]
                rindex = build_rank_index(s.vals_h.reshape(lanes * self.n_hol, cap),
                                          n[:, self.hol_idx].reshape(-1),
                                          zcand.reshape(lanes * self.n_hol, -1))
            s.tables = ptab, shift, rindex
        it0 = torch.zeros_like(s.it)
        value, sigma, reps = self._afc(s, z0, it0)
        y0 = self._model(s, torch.cat([self._sample("ami", value, sigma, reps),
                                       value[:, None, :]], dim=1))
        y_hat = y0[:, self.m]
        prob = self._ami_prob(y0[:, : self.m], y_hat, s.delta)
        s.value0, s.sigma0, s.reps0 = value, sigma, reps
        s.z.copy_(z0)
        s.it.zero_()
        s.y_hat.copy_(y_hat)
        s.prob.copy_(prob)
        s.idx.zero_()
        s.want.copy_(self._want_more(s, z0, it0, prob))

    def _sobol0(self, s):
        """The Saltelli block at z⁰; its indices kept for the lanes that iterate."""
        f_all = self._model(s, self._sobol_rows(s.value0, s.sigma0, s.reps0))
        idx = self._indices(f_all, s.y_hat)
        s.idx.copy_(torch.where(s.want[:, None], idx, torch.zeros_like(idx)))

    def _step(self, s):
        """step_plan: the lanes that want more step z along their Sobol
        direction and evaluate the new plan; the others stay as they are."""
        w = s.want
        z = torch.where(w[:, None], next_plan(s.z, direction(s.idx, s.z, s.n), s.step, s.n),
                        s.z)
        it = s.it + w.to(s.it.dtype)
        value, sigma, reps = self._afc(s, z, it)
        y_all = self._model(s, torch.cat(
            [self._sample("ami", value, sigma, reps), value[:, None, :],
             self._sobol_rows(value, sigma, reps)], dim=1))
        y_hat = y_all[:, self.m]
        prob = self._ami_prob(y_all[:, : self.m], y_hat, s.delta)
        idx = self._indices(y_all[:, self.m + 1:], y_hat)
        prob = torch.where(w, prob, s.prob)
        s.y_hat.copy_(torch.where(w, y_hat, s.y_hat))
        s.idx.copy_(torch.where(w[:, None], idx, s.idx))
        s.want.copy_(w & self._want_more(s, z, it, prob))
        s.prob.copy_(prob)
        s.z.copy_(z)
        s.it.copy_(it)

    # ------------------------------------------------------------ the driver
    def _slot(self, lanes: int, cap: int, e: int) -> SimpleNamespace:
        """The fixed-shape tensors of one (lanes, cap) bucket, made once."""
        key = (lanes, cap, e)
        s = self._slots.get(key)
        if s is not None:
            return s
        dev, k = self.device, self.k
        z32 = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)  # noqa: E731
        zf = lambda *shape: torch.zeros(shape, dtype=f32, device=dev)  # noqa: E731
        s = SimpleNamespace(
            incremental=resolve_afc_plan(self.afc_backend, cap, cached=self.prebuilt),
            graphs=None, programs=self._programs(),
            # inputs: a run copies its batch in
            vals=zf(lanes, k, cap), n_in=z32(lanes, k), agg=z32(lanes, k), delta=zf(lanes),
            exact=zf(lanes, e), active=torch.zeros(lanes, dtype=torch.bool, device=dev),
            tau=zf(lanes), iter_cap=z32(lanes),
            # the loop's state
            z=z32(lanes, k), it=z32(lanes), y_hat=zf(lanes), prob=zf(lanes), idx=zf(lanes, k),
            want=torch.zeros(lanes, dtype=torch.bool, device=dev),
        )
        if self.prebuilt and s.incremental:
            # the tables a run copies in from the lanes' cache entries
            s.tables = self._table_buffers(lanes, cap)
        self._slots[key] = s
        self.slots_built += 1
        return s

    def _table_buffers(self, lanes: int, cap: int) -> tuple:
        """Fixed ``(ptab (lanes, k, cap, 4), shift (lanes, k), rank index or
        None)`` buffers for the incremental AFC tables of ``lanes`` lanes:
        the rank index has ``lanes · h`` rows, lane after lane, in the
        layout :func:`build_rank_index` gives them."""
        dev = self.device
        rindex = None
        if self.n_hol:
            rows, n_z = lanes * self.n_hol, self.max_iters + 1
            block = min(BLOCK_S, cap)
            capp = -(-cap // block) * block
            i32 = dict(dtype=torch.int32, device=dev)
            rindex = HolisticRankIndex(
                torch.zeros((rows, capp), dtype=f32, device=dev), torch.zeros((rows, capp), **i32),
                torch.zeros((rows, n_z, capp // block + 1), **i32), torch.zeros((rows, n_z), **i32))
        return (torch.zeros((lanes, self.k, cap, N_POWERS), dtype=f32, device=dev),
                torch.zeros((lanes, self.k), dtype=f32, device=dev), rindex)

    def _programs(self):
        """init_eval (z⁰), the Saltelli block at z⁰, one planner step."""
        return self._init, self._sobol0, self._step

    def _capture(self, s) -> None:
        """The slot's programs (``s.programs``: for a run's slot the three
        above) as CUDA graphs on one memory pool, after one eager pass on a
        side stream (which loads the kernel libraries and makes every
        lazily built handle).

        Garbage is collected first and the collector is off while the
        graphs are captured: a collection inside a capture may destroy an
        unreachable graph of another slot or executor, and CUDA refuses
        that while a stream captures (the capture is invalidated).  The
        capture stream is the side stream, on the executor's device: the
        default capture stream is made once, on whichever device was current
        then, and a shard on another card cannot capture on it.
        """
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for program in s.programs:
                program(s)
        cur.wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        graphs = []
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            for program in s.programs:
                graph = torch.cuda.CUDAGraph()
                with build.captured_launches() as recorded, torch.cuda.graph(
                        graph, pool=pool, stream=side):
                    program(s)
                graphs.append((graph, recorded))
        finally:
            if collecting:
                gc.enable()
        s.graphs = graphs

    def _launch(self, s, i: int) -> None:
        """Program ``i`` of slot ``s`` (a run's slot: 0 z⁰, 1 Saltelli at z⁰,
        2 a step), replayed if the slot was captured."""
        if s.graphs is None:
            s.programs[i](s)
            return
        graph, recorded = s.graphs[i]
        graph.replay()
        build.count_replay(recorded)

    def _drive(self, s) -> None:
        self._launch(s, 0)
        if not bool(s.want.any()):          # every lane stops at z⁰
            return
        self._launch(s, 1)
        # a lane that wants more advances its it, and it stops at max_iters
        for _ in range(self.max_iters):
            self._launch(s, 2)
            if not bool(s.want.any()):
                return
        raise RuntimeError("fused executor: a lane iterated past max_iters")

    def __call__(self, vals, n, agg_ids, delta, exact, active=None, tau=None,
                 iter_cap=None) -> FusedResult:
        vals, n, exact = _as(vals, f32), _as(n, torch.int32), _as(exact, f32)
        single = vals.dim() == 2
        if single:
            vals, n, exact = vals[None], n[None], exact[None]
        lanes, k, cap = vals.shape
        if k != self.k:
            raise ValueError(f"fused executor built for k = {self.k}, "
                             f"got buffers {tuple(vals.shape)}")
        s = self._slot(lanes, cap, exact.shape[-1])
        # a pinned host buffer is copied asynchronously, in stream order
        s.vals.copy_(vals, non_blocking=True)
        s.n_in.copy_(n)
        return self._run(s, agg_ids, delta, exact, active, tau, iter_cap, single)

    def _set_knobs(self, s, agg_ids, delta, exact, active, tau, iter_cap) -> None:
        """Copy a run's per-lane inputs into slot ``s`` (``None``: the build's)."""
        s.agg.copy_(_as(agg_ids, torch.int32))
        s.delta.copy_(_as(delta, f32))
        s.exact.copy_(_as(exact, f32))
        s.active.copy_(_as(True if active is None else active, torch.bool))
        s.tau.copy_(_as(self.tau if tau is None else tau, f32))
        s.iter_cap.copy_(_as(self.max_iters if iter_cap is None else iter_cap, torch.int32))

    def _run(self, s, agg_ids, delta, exact, active, tau, iter_cap, single) -> FusedResult:
        """Copy the knobs in, capture a new slot, drive the programs, read out."""
        self._set_knobs(s, agg_ids, delta, exact, active, tau, iter_cap)
        if self.capture and s.graphs is None:
            self._capture(s)
        self._drive(s)
        return self._result(s, single)

    def _result(self, s, single: bool) -> FusedResult:
        """Copies of slot ``s``'s lanes' results (the one lane's if ``single``)."""
        used = torch.where(s.active, torch.minimum(s.z, s.n).sum(-1), 0)
        res = FusedResult(y_hat=s.y_hat.clone(), prob=s.prob.clone(), iters=s.it.clone(),
                          z=s.z.clone(), samples_used=used)
        if single:
            return FusedResult(y_hat=res.y_hat[0], prob=res.prob[0], iters=int(res.iters[0]),
                               z=res.z[0], samples_used=res.samples_used[0])
        return res


def _as(x, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(x).to(dtype)


class PrebuiltFusedExecutor(FusedExecutor):
    """``run(vals, n, agg_ids, delta, exact, tables, active=None, tau=None,
    iter_cap=None)``: the cache-fed twin of :class:`FusedExecutor`.

    ``tables`` is one request's :class:`PrebuiltTables` (with ``vals``
    ``(k, cap)`` and ``n`` ``(k,)``), or a sequence of one a lane (with
    sequences of the lanes' ``vals`` and ``n``), all on the executor's
    device, as :class:`~repro_torch.serving.feature_cache.FeatureCache`
    keeps them.  They are copied into the slot, device to device, one
    launch a buffer; the z⁰ program reads them and builds none.
    """

    prebuilt = True

    def __call__(self, vals, n, agg_ids, delta, exact, tables, active=None, tau=None,
                 iter_cap=None) -> FusedResult:
        exact = _as(exact, f32)
        single = isinstance(tables, PrebuiltTables)
        if single:
            vals, n, tables, exact = [vals], [n], [tables], exact[None]
        cap = vals[0].shape[-1]
        want = (self.k, cap)
        for v, t in zip(vals, tables, strict=True):
            if tuple(v.shape) != want or tuple(t.ptab.shape[:2]) != want:
                raise ValueError(f"prebuilt executor: lanes must share buffers {want}, got "
                                 f"{tuple(v.shape)} and tables {tuple(t.ptab.shape)}")
        s = self._slot(len(tables), cap, exact.shape[-1])
        self._load(s, vals, n, tables)
        return self._run(s, agg_ids, delta, exact, active, tau, iter_cap, single)

    def _load(self, s, vals, n, tables) -> None:
        """Copy the lanes' entries into slot ``s``: one launch a buffer."""
        torch.stack(list(vals), out=s.vals)
        torch.stack([x.to(torch.int32) for x in n], out=s.n_in)
        if s.incremental:
            ptab, shift, rindex = s.tables
            torch.stack([t.ptab for t in tables], out=ptab)
            torch.stack([t.shift for t in tables], out=shift)
            if self.n_hol:
                for f, buf in enumerate(rindex):
                    torch.cat([t.rindex[f] for t in tables], out=buf)


def build_fused_executor(
    model_fn,
    *,
    k: int,
    task: str,
    n_classes: int = 2,
    m: int = 512,
    m_sobol: int = 128,
    alpha: float = 0.05,
    gamma: float = 0.01,
    tau: float = 0.95,
    max_iters: int = 32,
    afc_backend: str = "auto",
    holistic: Sequence[int] = (),
    quantiles: Sequence[float] | None = None,
    n_boot: int = 256,
    boot_seed: int = 0,
    approximate: Sequence[bool] | None = None,
    device=None,
    use_kernel: bool = True,
    capture: bool | None = None,
    prebuilt: bool = False,
) -> FusedExecutor:
    """Returns ``run(vals, n, agg_ids, delta, exact, active=None, tau=None,
    iter_cap=None) -> FusedResult`` (see :class:`FusedExecutor`), or with
    ``prebuilt=True`` its cache-fed twin ``run(vals, n, agg_ids, delta,
    exact, tables, ...)`` (:class:`PrebuiltFusedExecutor`), whose AFC
    strategy resolves with ``cached=True`` (incremental at every cap under
    "auto").

    ``model_fn``: ``(rows (N, k), exact (N, e)) -> (N,)`` predictions
    (regression values, or class ids ``0 .. n_classes − 1`` for
    ``task="classification"``), each row with its request's exact
    features; called exactly once per planner iteration, on the megabatch
    of all lanes (``N = L·(m + 1 + (k+2)·m_sobol)``, lane after lane).
    ``afc_backend`` picks the AFC strategy per cap bucket
    (``ops.resolve_afc_plan``); the implementation follows the device.
    ``holistic`` lists the MEDIAN/QUANTILE feature indices, ``quantiles``
    their q's (median = 0.5), ``n_boot`` the replicate count B and
    ``boot_seed`` the seed of the replicate ranks' key.
    ``use_kernel=False`` runs the plain versions on the card (for
    comparison only).  ``capture`` (default: on a CUDA device) runs the
    programs as CUDA graphs; ``capture=False`` on the card runs them
    eagerly, for comparison only.  Tensors may be passed on any device;
    they are copied into the bucket's buffers on ``device``.
    """
    cls = PrebuiltFusedExecutor if prebuilt else FusedExecutor
    return cls(
        model_fn, k=k, task=task, n_classes=n_classes, m=m, m_sobol=m_sobol, alpha=alpha,
        gamma=gamma, tau=tau, max_iters=max_iters, afc_backend=afc_backend, holistic=holistic,
        quantiles=quantiles, n_boot=n_boot, boot_seed=boot_seed, approximate=approximate,
        device=device, use_kernel=use_kernel, capture=capture)


#: The fixed-lane batch program: one slot a cap bucket, whatever the fill or
#: the knobs (they are copied into the slot's tensors, which keep their
#: addresses), no RNG operator inside a program.
FUSED_CONTRACT = register_contract(ExecutableContract(
    name="fused",
    builder="repro_torch.core.executor_fused.build_fused_executor",
    executables_per_bucket=1,
    collectives=0,
    donated=("the (lanes, cap) slot: vals, n, knobs and the loop state",),
    while_body_flat=True,
    description=(
        "fixed-lane batch program (BatchedFusedServer, BiathlonServer): one slot a cap "
        "bucket, captured once as the z0, Saltelli and step graphs on the card; "
        "counter-based bootstrap keys gathered by each lane's it"
    ),
))

#: The cache-fed twin: the same programs, reading the entries' tables copied
#: into the slot instead of building them.
FUSED_PREBUILT_CONTRACT = register_contract(ExecutableContract(
    name="fused_prebuilt",
    builder="repro_torch.core.executor_fused.build_fused_executor (prebuilt=True)",
    executables_per_bucket=1,
    collectives=0,
    donated=("the (lanes, cap) slot: vals, n, knobs, tables and the loop state",),
    while_body_flat=True,
    description=(
        "cache-fed fused programs: PrebuiltTables copied into the slot replace the "
        "precompute; one slot a cap bucket shared by cache hits and misses"
    ),
))


#: The :class:`LaneState` leaves a chunk changes: a chunk-boundary checkpoint
#: is host copies of these, and a rollback copies them back in place.  The
#: reference's ``CHUNK_CARRY_LEAVES`` with ``want`` for its ``done`` (``done
#: = ~want``) and without ``reps``: the port carries no holistic replicate
#: table between steps, ``_afc`` draws it again from the lane's ``it``.
CHUNK_CARRY_LEAVES = ("z", "it", "y_hat", "prob", "idx", "want")


class LaneState(SimpleNamespace):
    """The lane table of continuous batching: every lane's state as fixed
    device tensors with a leading lanes axis, the reference's ``LaneState``
    (``executor_fused.py:174``) over its lanes.

    request inputs
      ``n (L, k)`` group sizes clamped to the cap, ``agg (L, k)`` operator
      ids, ``delta``, ``tau`` ``(L,)`` knobs, ``exact (L, e)``, ``active
      (L,)`` (False: an empty lane, never iterates), ``cap_eff (L,)`` the
      iteration ceiling, ``step (L,)`` γ; under the rescan also ``vals (L,
      k, cap)`` and, with holistic features, ``vals_h (L, h, cap)``
    planner carry (:data:`CHUNK_CARRY_LEAVES`)
      ``z (L, k)``, ``it (L,)`` (also the bootstrap keys' index, so a
      request's random stream follows it into any lane), ``y_hat``, ``prob``
      ``(L,)``, ``idx (L, k)`` Sobol indices, ``want (L,)`` (``done`` is
      ``~want``)
    incremental AFC tables (``tables``)
      ``ptab (L, k, cap, 4)``, ``shift (L, k)`` and the holistic rank index
      (``L · h`` rows), present on the incremental path only

    A table is one slot of its executor (one per (lanes, cap bucket)): the
    captured step and lane-write graphs read these addresses, so every
    write to it is in place (``copy_``, ``index_copy_``, ``index_fill_``);
    a rebound attribute would leave the graphs reading stale memory.
    """

    def reset(self) -> None:
        """Every lane empty (zeros, ``active = False``), in place: every
        device tensor of the table, the AFC tables' included."""
        tensors = [v for v in vars(self).values() if isinstance(v, torch.Tensor)]
        if self.tables is not None:
            ptab, shift, rindex = self.tables
            tensors += [ptab, shift] + ([] if rindex is None else list(rindex))
        for t in tensors:
            t.zero_()

    def readback(self) -> dict:
        """Host copies of the small per-lane leaves a scheduler reads
        (``done``, ``active``, ``it``, ``z``, ``n``, ``y_hat``, ``prob``):
        stacked on the device as int32 bits and copied to the host once, the
        read-back (and synchronisation) each chunk ends on."""
        k = self.z.shape[1]
        i32 = torch.int32
        packed = torch.cat([self.want.to(i32)[:, None], self.active.to(i32)[:, None],
                            self.it[:, None], self.y_hat.view(i32)[:, None],
                            self.prob.view(i32)[:, None], self.z, self.n], dim=1).cpu().numpy()
        return dict(done=packed[:, 0] == 0, active=packed[:, 1] != 0,
                    it=packed[:, 2].astype(np.int64), z=packed[:, 5:5 + k].copy(),
                    n=packed[:, 5 + k:].copy(), y_hat=packed[:, 3].copy().view(np.float32),
                    prob=packed[:, 4].copy().view(np.float32))

    def snapshot(self) -> dict[str, np.ndarray]:
        """Checkpoint of the chunk carry: host copies of exactly the
        :data:`CHUNK_CARRY_LEAVES`, stacked and copied to the host once.
        Every other leaf is unchanged by a chunk."""
        k = self.z.shape[1]
        i32 = torch.int32
        packed = torch.cat([self.z, self.it[:, None], self.y_hat.view(i32)[:, None],
                            self.prob.view(i32)[:, None], self.idx.view(i32),
                            self.want.to(i32)[:, None]], dim=1).cpu().numpy()
        return dict(z=packed[:, :k].copy(), it=packed[:, k].copy(),
                    y_hat=packed[:, k + 1].copy().view(np.float32),
                    prob=packed[:, k + 2].copy().view(np.float32),
                    idx=packed[:, k + 3:2 * k + 3].copy().view(np.float32),
                    want=packed[:, -1] != 0)

    def restore(self, ckpt: dict[str, np.ndarray]) -> None:
        """Copy a :meth:`snapshot` back into the carry, in place.  A replay
        after it is bitwise the fault-free run: the bootstrap keys follow
        the restored ``it``."""
        for name in CHUNK_CARRY_LEAVES:
            getattr(self, name).copy_(torch.from_numpy(np.ascontiguousarray(ckpt[name])))

    def clear_lanes(self, lanes) -> None:
        """Evict lanes (quarantine, failure): ``active = want = False``, in
        place, so no step moves them again.  Their carry is reset too (``z =
        it = 0``, zero ŷ, prob and indices), because every step reads every
        lane: a wrecked ``it`` or ``z`` would index the key table and the
        prefix tables out of range on the card, a fault that poisons the
        whole CUDA context (JAX clamps such an index; CUDA asserts).  The
        buffers stay until the next refill of the lane."""
        idx = torch.as_tensor(list(lanes), dtype=torch.int64).to(self.z.device)
        if idx.numel() == 0:
            return
        for name, fill in (("active", False), ("want", False), ("z", 0), ("it", 0),
                           ("y_hat", 0.0), ("prob", 0.0), ("idx", 0.0)):
            getattr(self, name).index_fill_(0, idx, fill)


class ChunkedExecutor(FusedExecutor):
    """The fused executor over a lane table, for continuous batching.

    Port of the reference's ``build_chunked_executor`` (``init``, ``chunk``)
    with its refill scatter (``serving/continuous.py``).  Built by
    :func:`build_chunked_executor`.

    ``new_table(lanes, cap, e) -> LaneState``
        the (lanes, cap) table, every lane empty.  One table per (lanes,
        cap): a second call resets the same tensors.  Making a table makes
        its refill slot too, the ``(1, cap)`` slot of a one-lane run, and on
        the card captures both: the refill slot's z⁰ and Saltelli programs,
        and the table's step and lane-write programs.
    ``refill(table, lane, vals, n, agg_ids, delta, exact, tau, iter_cap)``
        admits one request into ``lane``: its inputs are copied into the
        refill slot, the z⁰ program and the Saltelli block (masked by
        ``want``, so no flag is read back) run on that one lane, and the
        lane-write program copies the slot's lane into row ``lane`` of every
        table leaf (``index_copy_`` at a device index set before the
        replay: one captured graph serves every lane) and sets its ``it`` to
        0.  A prebuilt (cached) executor takes a trailing ``tables``
        (:class:`PrebuiltTables`), copied into the refill slot instead of
        built.
    ``chunk(table) -> table``
        at most ``chunk_iters`` replays of the table's step program: the
        lanes' ``want`` flags are read before each, and the chunk ends when
        no lane wants more (a done or empty lane is frozen by the step, as
        the reference's ``while_loop`` leaves it).  Back-to-back chunks
        replay exactly the monolithic run's steps.

    :attr:`slots_built` (the refill slots) and :attr:`tables_built` count
    the slots (on the card, captures): one of each per cap bucket, whatever
    the fill, the knobs or the lanes admitted.
    """

    def __init__(self, model_fn, *, chunk_iters: int, **kw):
        chunk_iters = int(chunk_iters)
        if chunk_iters < 1:
            raise ValueError(f"chunk_iters must be >= 1, got {chunk_iters}")
        super().__init__(model_fn, **kw)
        self.chunk_iters = chunk_iters
        self._tables: dict[tuple[int, int, int], LaneState] = {}

    @property
    def tables_built(self) -> int:
        return len(self._tables)

    def new_table(self, lanes: int, cap: int, e: int) -> LaneState:
        key = (lanes, cap, e)
        t = self._tables.get(key)
        if t is None:
            src = self._slot(1, cap, e)
            t = self._alloc_table(lanes, cap, e, src)
            if self.capture:
                if src.graphs is None:
                    src.programs = (self._init, self._sobol0)
                    self._capture(src)
                self._capture(t)
            self._tables[key] = t
        t.reset()
        return t

    def _alloc_table(self, lanes: int, cap: int, e: int, src) -> LaneState:
        dev, k = self.device, self.k
        z32 = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)  # noqa: E731
        zf = lambda *shape: torch.zeros(shape, dtype=f32, device=dev)  # noqa: E731
        zb = lambda *shape: torch.zeros(shape, dtype=torch.bool, device=dev)  # noqa: E731
        t = LaneState(
            incremental=src.incremental, graphs=None, programs=(self._step, self._write_lane),
            src=src, lane=torch.zeros(1, dtype=torch.int64, device=dev),
            n=z32(lanes, k), agg=z32(lanes, k), delta=zf(lanes), exact=zf(lanes, e),
            active=zb(lanes), tau=zf(lanes), cap_eff=z32(lanes), step=z32(lanes),
            z=z32(lanes, k), it=z32(lanes), y_hat=zf(lanes), prob=zf(lanes), idx=zf(lanes, k),
            want=zb(lanes), tables=None,
        )
        # the leaves the lane write copies from the refill slot's one lane
        t.copied = ["n", "agg", "delta", "exact", "active", "tau", "cap_eff", "step",
                    "z", "y_hat", "prob", "idx", "want"]
        if t.incremental:
            t.tables = self._table_buffers(lanes, cap)
        else:
            t.vals = zf(lanes, k, cap)
            t.copied.append("vals")
            if self.n_hol:
                t.vals_h = zf(lanes, self.n_hol, cap)
                t.copied.append("vals_h")
        return t

    def _write_lane(self, t) -> None:
        """Row ``t.lane`` of every table leaf from the refill slot's lane;
        the lane's ``it`` to 0 (its bootstrap keys start afresh)."""
        src, lane = t.src, t.lane
        for name in t.copied:
            getattr(t, name).index_copy_(0, lane, getattr(src, name))
        t.it.index_fill_(0, lane, 0)
        if t.incremental:
            for dst, new in zip(t.tables[:2], src.tables[:2]):
                dst.index_copy_(0, lane, new)
            if self.n_hol:
                h = self.n_hol
                for dst, new in zip(t.tables[2], src.tables[2]):
                    dst.view(-1, h, *dst.shape[1:]).index_copy_(
                        0, lane, new.reshape(1, h, *new.shape[1:]))

    def refill(self, t: LaneState, lane: int, vals, n, agg_ids, delta, exact, tau, iter_cap,
               tables: PrebuiltTables | None = None) -> None:
        src = t.src
        k, cap = src.vals.shape[1:]
        if self.prebuilt:
            if tables is None:
                raise ValueError("a prebuilt executor's refill takes the entry's tables")
            self._load(src, [vals], [n], [tables])
        else:
            src.vals.copy_(_as(vals, f32).reshape(1, k, cap), non_blocking=True)
            src.n_in.copy_(_as(n, torch.int32).reshape(1, k))
        self._set_knobs(src, agg_ids, delta, exact, True, tau, iter_cap)
        self._launch(src, 0)      # z⁰
        self._launch(src, 1)      # the Saltelli block, kept only if the lane iterates
        t.lane.fill_(int(lane))
        self._launch(t, 1)        # the lane write

    def chunk(self, t: LaneState) -> LaneState:
        for _ in range(self.chunk_iters):
            if not bool(t.want.any()):
                break
            self._launch(t, 0)
        return t


class PrebuiltChunkedExecutor(ChunkedExecutor):
    """The cache-fed :class:`ChunkedExecutor`: ``refill(..., tables)`` copies
    a cache entry's buffers and tables into the refill slot (as
    :class:`PrebuiltFusedExecutor` does into a run's slot) and builds none;
    the AFC strategy resolves with ``cached=True``."""

    prebuilt = True
    _load = PrebuiltFusedExecutor._load


def build_chunked_executor(
    model_fn,
    *,
    chunk_iters: int,
    k: int,
    task: str,
    n_classes: int = 2,
    m: int = 512,
    m_sobol: int = 128,
    alpha: float = 0.05,
    gamma: float = 0.01,
    tau: float = 0.95,
    max_iters: int = 32,
    afc_backend: str = "auto",
    holistic: Sequence[int] = (),
    quantiles: Sequence[float] | None = None,
    n_boot: int = 256,
    boot_seed: int = 0,
    approximate: Sequence[bool] | None = None,
    device=None,
    use_kernel: bool = True,
    capture: bool | None = None,
    prebuilt: bool = False,
) -> ChunkedExecutor:
    """The lane-table executor of continuous batching: :class:`ChunkedExecutor`,
    or with ``prebuilt=True`` :class:`PrebuiltChunkedExecutor`.

    ``chunk_iters`` (≥ 1) is the most planner iterations one ``chunk``
    advances a lane; every other argument is :func:`build_fused_executor`'s.
    """
    cls = PrebuiltChunkedExecutor if prebuilt else ChunkedExecutor
    return cls(
        model_fn, chunk_iters=chunk_iters, k=k, task=task, n_classes=n_classes, m=m,
        m_sobol=m_sobol, alpha=alpha, gamma=gamma, tau=tau, max_iters=max_iters,
        afc_backend=afc_backend, holistic=holistic, quantiles=quantiles, n_boot=n_boot,
        boot_seed=boot_seed, approximate=approximate, device=device, use_kernel=use_kernel,
        capture=capture)


#: The continuous table's one-lane refill slot: admitting a request into
#: any lane replays its graphs; the knobs are data.
REFILL_CONTRACT = register_contract(ExecutableContract(
    name="refill",
    builder="repro_torch.core.executor_fused.build_chunked_executor (refill)",
    executables_per_bucket=1,
    collectives=0,
    donated=("table (LaneState, written in place at a device lane index)",),
    description=(
        "one-lane z0 and Saltelli programs and the lane write into the table at a device "
        "index: admitting a request builds nothing"
    ),
))

#: The continuous table's step slot: a chunk replays it at most chunk_iters
#: times over every lane, in place.
CHUNK_CONTRACT = register_contract(ExecutableContract(
    name="chunk",
    builder="repro_torch.core.executor_fused.build_chunked_executor (chunk)",
    executables_per_bucket=1,
    collectives=0,
    donated=("table (LaneState, written in place at a device lane index)",),
    while_body_flat=True,
    description=(
        "the table's step program, replayed at most chunk_iters times a chunk over every "
        "occupied lane; flat on the incremental AFC path"
    ),
))


def build_afc_precompute(
    *,
    k: int,
    alpha: float = 0.05,
    gamma: float = 0.01,
    max_iters: int = 32,
    holistic: Sequence[int] = (),
    quantiles: Sequence[float] | None = None,
    approximate: Sequence[bool] | None = None,
    device=None,
    use_kernel: bool = True,
) -> SimpleNamespace:
    """The incremental-AFC precompute of a cached executor and its append refresh.

    Returns ``SimpleNamespace(cold, refresh)``:

    ``cold(vals (..., k, cap), n (..., k)) -> PrebuiltTables``
        the tables the executor's z⁰ program would build (shift basis
        ``vals[..., 0]``, the ladder ``min(z⁰ + i·γ, n)``), with the
        buffers' leading dimensions: ONE ``prefix_power_sums`` launch over
        all rows, so the misses of a batch share it.  It runs on the
        current stream, as the kernel's launch state requires.

    ``refresh(vals (k, cap), n (k,), tables, j, x, aff) -> (vals', n', tables')``
        applies one logged insertion of ``x (k,)`` at prefix position ``j``
        (an int) into the rows flagged by ``aff (k,)``: the buffer shifts
        right from j, the tables take :func:`append_power_sums`, the rank
        index :func:`merge_sorted_prefix` and counts over the new ladder.
        Callers route ``j == 0`` to ``cold`` (it replaces the shift basis).
    """
    dev = resolve_device(device)
    hol = tuple(int(j) for j in holistic)
    n_hol = len(hol)
    if quantiles is not None and len(quantiles) != n_hol:
        raise ValueError("quantiles must align with holistic indices")
    hol_idx = torch.tensor(hol, dtype=torch.int64, device=dev)
    approx = torch.tensor([True] * k if approximate is None else list(approximate),
                          dtype=torch.bool, device=dev)
    n_z = max_iters + 1

    def zcand_of(n):
        z0 = torch.where(approx, initial_plan(n, alpha), n)
        return plan_ladder(z0, gamma_abs(n, gamma), n, n_z)

    def cold(vals, n) -> PrebuiltTables:
        vals = _as(vals, f32)
        lead, cap = tuple(vals.shape[:-2]), vals.shape[-1]
        n = torch.clamp(_as(n, torch.int32), max=cap)
        shift = vals[..., 0].contiguous()
        ptab = prefix_power_sums(vals, shift, use_kernel=use_kernel)
        if not n_hol:
            return PrebuiltTables(ptab, shift, empty_rank_index(lead, vals.device))
        zc = zcand_of(n)[..., hol_idx, :]
        ri = build_rank_index(vals[..., hol_idx, :].reshape(-1, cap),
                              n[..., hol_idx].reshape(-1), zc.reshape(-1, n_z))
        return PrebuiltTables(ptab, shift, HolisticRankIndex(
            *(t.reshape(lead + (n_hol,) + tuple(t.shape[1:])) for t in ri)))

    def refresh(vals, n, tables: PrebuiltTables, j: int, x, aff):
        cap = vals.shape[-1]
        n = torch.clamp(_as(n, torch.int32), max=cap)
        x = torch.as_tensor(x, dtype=f32, device=vals.device)
        aff = torch.as_tensor(aff, dtype=torch.bool, device=vals.device)
        c = torch.arange(cap, device=vals.device)
        prev = torch.cat([vals[:, :1], vals[:, :-1]], dim=1)
        inserted = torch.where(c[None, :] < j, vals,
                               torch.where(c[None, :] == j, x[:, None], prev))
        vals2 = torch.where(aff[:, None] & (j < cap), inserted, vals)
        ptab2 = append_power_sums(tables.ptab, tables.shift, j, x, aff)
        n2 = torch.clamp(n + aff.to(torch.int32), max=cap)
        rindex = tables.rindex
        if n_hol:
            msv, msi, _ = merge_sorted_prefix(rindex.sorted_vals, rindex.sorted_idx, n[hol_idx],
                                              cap, j, x[hol_idx], aff[hol_idx])
            block = rindex.sorted_vals.shape[1] // (rindex.blk_cnt.shape[-1] - 1)
            rindex = rank_index_from_sorted(msv, msi, zcand_of(n2)[hol_idx], block=block)
        return vals2, n2, PrebuiltTables(ptab2, tables.shift, rindex)

    return SimpleNamespace(cold=cold, refresh=refresh)


#: The cache's cold precompute runs eagerly and builds no slot (the
#: reference compiles it once a bucket): 0 slots a bucket.
AFC_PRECOMPUTE_CONTRACT = register_contract(ExecutableContract(
    name="afc_precompute",
    builder="repro_torch.core.executor_fused.build_afc_precompute",
    executables_per_bucket=0,
    collectives=0,
    description=(
        "once-a-miss precompute (prefix power sums and the holistic rank index) run "
        "eagerly: its PrebuiltTables stay on the device in the feature cache"
    ),
))


# ------------------------------------------------------------ lanes over shards
class _Shard:
    """One shard of a serving mesh: its executor and, on a card, its own
    stream and a pinned flag that its lanes' ``want`` is copied into behind
    an event, so every shard's replays are issued before any flag is read."""

    def __init__(self, exe: FusedExecutor):
        self.exe = exe
        self.cuda = exe.device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(device=exe.device)
            self._flag = torch.zeros(1, dtype=torch.bool, pin_memory=True)
            self._event = torch.cuda.Event()

    def ctx(self):
        """Issue work on the shard's stream (and device)."""
        return torch.cuda.stream(self.stream) if self.cuda else contextlib.nullcontext()

    def post(self, s) -> None:
        """Inside :meth:`ctx`, after a replay: queue the copy of ``any(want)``."""
        if self.cuda:
            self._flag.copy_(s.want.any().view(1), non_blocking=True)
            self._event.record(self.stream)

    def wants(self, s) -> bool:
        """Whether a lane of ``s`` wants another step, as of the last :meth:`post`."""
        if not self.cuda:
            return bool(s.want.any())
        self._event.synchronize()
        return bool(self._flag[0])


class _Sharded:
    """What the two sharded executors share: the shards, and the fork and
    join of their streams around a call.  Every call forks (each shard's
    stream waits for the current stream of its device) and joins (those
    current streams, and the first shard's device's, wait for the shards'
    work), so work queued before or after a call on the current stream is
    ordered with it: an event recorded there after a call covers the copies
    a shard made from host memory (``HostStaging.release``)."""

    def __init__(self, executors):
        self.shards = [_Shard(e) for e in executors]
        if not self.shards:
            raise ValueError("a serving mesh needs at least one shard")
        self._home = self.shards[0].exe.device
        self._buckets: set[tuple[int, int, int]] = set()

    def _fork(self, shards) -> None:
        for sh in shards:
            if sh.cuda:
                sh.stream.wait_stream(torch.cuda.current_stream(sh.exe.device))

    def _join(self, shards) -> None:
        for sh in shards:
            if sh.cuda:
                for d in {sh.exe.device, self._home}:
                    torch.cuda.current_stream(d).wait_stream(sh.stream)

    def _lanes_per_shard(self, lanes: int) -> int:
        if lanes % len(self.shards):
            raise ValueError(f"{lanes} lanes do not split over {len(self.shards)} shards")
        return lanes // len(self.shards)

    @property
    def slots_built(self) -> int:
        """Slot builds a bucket, counted once over the mesh."""
        return len(self._buckets)


def _block(x, b: slice, dims: int):
    """Lanes ``b`` of a per-lane argument of ``dims`` dimensions a lane
    stack has; an argument given once for every lane passes whole."""
    if x is None:
        return None
    t = torch.as_tensor(x)
    return t[b] if t.dim() == dims else t


class ShardedFusedExecutor(_Sharded):
    """``run(vals (L, k, cap), n, agg_ids, delta, exact, active=None, tau=None,
    iter_cap=None) -> FusedResult``: :class:`FusedExecutor`'s run with the
    lanes split over the shards of a mesh, shard i taking lanes
    ``[i·L/D, (i+1)·L/D)``.  Built by :func:`shard_lanes_executor`.

    A run copies each shard's block of lanes into the shard's own slot
    (captured once a bucket on a card, on the shard's stream and graph pool),
    issues every shard's z⁰ replay, reads the ``want`` flags, then replays
    the Saltelli block and a step on each shard whose lanes still want more
    and reads their flags again, until no shard does.  A shard whose lanes
    are done stops: its lanes wait for their own shard only.  Each lane runs
    the iterations it runs unsharded; the results, on the CPU, are in lane
    order.  :attr:`slots_built` counts a bucket's build once over the mesh;
    :attr:`shard_slots_built` each shard's own slots.
    """

    @property
    def shard_slots_built(self) -> list[int]:
        return [sh.exe.slots_built for sh in self.shards]

    def __call__(self, vals, n, agg_ids, delta, exact, active=None, tau=None,
                 iter_cap=None) -> FusedResult:
        vals, n, exact = _as(vals, f32), _as(n, torch.int32), _as(exact, f32)
        lanes, _k, cap = vals.shape
        per = self._lanes_per_shard(lanes)
        key = (per, cap, exact.shape[-1])
        self._fork(self.shards)
        slots = []
        for i, sh in enumerate(self.shards):
            b = slice(i * per, (i + 1) * per)
            exe = sh.exe
            with sh.ctx():
                s = exe._slot(*key)
                s.vals.copy_(vals[b], non_blocking=True)
                s.n_in.copy_(n[b])
                exe._set_knobs(s, _block(agg_ids, b, 2), _block(delta, b, 1), exact[b],
                               _block(active, b, 1), _block(tau, b, 1), _block(iter_cap, b, 1))
                if exe.capture and s.graphs is None:
                    exe._capture(s)
            slots.append(s)
        self._buckets.add(key)
        self._drive(slots)
        parts = []
        for sh, s in zip(self.shards, slots):
            with sh.ctx():
                parts.append([t.cpu() for t in sh.exe._result(s, False)])
        self._join(self.shards)
        return FusedResult(*(torch.cat(col) for col in zip(*parts)))

    def _drive(self, slots) -> None:
        """Every shard's z⁰; then, on the shards whose lanes want more, the
        Saltelli block with the first step, then steps, every live shard's
        replays issued before any flag is read."""
        pairs = list(zip(self.shards, slots))
        for sh, s in pairs:
            with sh.ctx():
                sh.exe._launch(s, 0)
                sh.post(s)
        live = [(sh, s) for sh, s in pairs if sh.wants(s)]
        first = True
        for _ in range(self.shards[0].exe.max_iters):
            if not live:
                return
            for sh, s in live:
                with sh.ctx():
                    if first:
                        sh.exe._launch(s, 1)
                    sh.exe._launch(s, 2)
                    sh.post(s)
            first = False
            live = [(sh, s) for sh, s in live if sh.wants(s)]
        if live:
            raise RuntimeError("sharded fused executor: a lane iterated past max_iters")


def shard_lanes_executor(build, mesh) -> ShardedFusedExecutor:
    """Data-parallel lanes over a serving mesh (``launch/mesh.py``).

    ``build(device) -> FusedExecutor`` makes one shard's executor, with the
    model and every constant on that device (the caller replicates them);
    it is called once a shard, in mesh order.  Every lane is an independent
    loop over its own slot, so no program reads another shard's tensors and
    nothing crosses between devices on the hot path.  The lane count of a
    run must split evenly over the shards.
    """
    return ShardedFusedExecutor([build(d) for d in mesh.devices])


class ShardedLaneState:
    """A continuous lane table split over the shards of a mesh: ``shards[i]``
    is shard i's :class:`LaneState` of ``L/D`` lanes, global lanes
    ``[i·L/D, (i+1)·L/D)``.  ``readback``, ``snapshot``, ``restore`` and
    ``clear_lanes`` split and join by global lane, each shard's part in
    place."""

    def __init__(self, shards: Sequence[LaneState]):
        self.shards = list(shards)
        self.per = int(self.shards[0].z.shape[0])

    @property
    def lanes(self) -> int:
        return self.per * len(self.shards)

    def locate(self, lane: int) -> tuple[int, int]:
        """``(shard, row)``: the shard whose table holds global ``lane``, and
        the lane's row in it."""
        i, row = divmod(int(lane), self.per)
        if not 0 <= i < len(self.shards):
            raise ValueError(f"lane {lane} outside 0..{self.lanes - 1}")
        return i, row

    def _joined(self, parts: list[dict]) -> dict:
        return {key: np.concatenate([p[key] for p in parts]) for key in parts[0]}

    def readback(self) -> dict:
        return self._joined([t.readback() for t in self.shards])

    def snapshot(self) -> dict[str, np.ndarray]:
        return self._joined([t.snapshot() for t in self.shards])

    def restore(self, ckpt: dict[str, np.ndarray]) -> None:
        for i, t in enumerate(self.shards):
            b = slice(i * self.per, (i + 1) * self.per)
            t.restore({key: v[b] for key, v in ckpt.items()})

    def clear_lanes(self, lanes) -> None:
        rows: dict[int, list[int]] = {}
        for lane in lanes:
            i, row = self.locate(lane)
            rows.setdefault(i, []).append(row)
        for i, r in rows.items():
            self.shards[i].clear_lanes(r)


class ShardedChunkedExecutor(_Sharded):
    """:class:`ChunkedExecutor` over the shards of a mesh, for
    ``ContinuousBatchedServer(mesh=)``.  Built by
    :func:`shard_lanes_state_executor`.

    ``new_table(lanes, cap, e) -> ShardedLaneState``: one ``(lanes/D, cap)``
    table a shard, each with its own one-lane refill slot (captured on the
    shard's stream).  ``refill(table, lane, ...)`` runs only on the shard that
    owns ``lane``: the reference runs the one-lane init on every device and
    masks the write to the owner's rows, which gives the same table with D
    times the work.  ``chunk(table)`` reads each shard's flags and replays
    the step of every shard whose lanes want more, at most ``chunk_iters``
    times, all live shards' replays issued before any flag is read.
    :attr:`slots_built` and :attr:`tables_built` count a bucket's refill slot
    and table once over the mesh; :attr:`shard_slots_built` counts both on
    each shard.
    """

    def __init__(self, executors):
        super().__init__(executors)
        self.chunk_iters = self.shards[0].exe.chunk_iters
        self._tables: dict[tuple[int, int, int], ShardedLaneState] = {}

    @property
    def tables_built(self) -> int:
        return len(self._tables)

    @property
    def shard_slots_built(self) -> list[int]:
        return [sh.exe.slots_built + sh.exe.tables_built for sh in self.shards]

    def new_table(self, lanes: int, cap: int, e: int) -> ShardedLaneState:
        per = self._lanes_per_shard(lanes)
        key = (lanes, cap, e)
        t = self._tables.get(key)
        self._fork(self.shards)
        if t is None:
            parts = []
            for sh in self.shards:
                with sh.ctx():
                    parts.append(sh.exe.new_table(per, cap, e))
            t = self._tables[key] = ShardedLaneState(parts)
            self._buckets.add((1, cap, e))
        else:
            for sh in self.shards:
                with sh.ctx():
                    sh.exe.new_table(per, cap, e)   # resets the shard's table in place
        self._join(self.shards)
        return t

    def refill(self, t: ShardedLaneState, lane: int, vals, n, agg_ids, delta, exact, tau,
               iter_cap) -> None:
        i, row = t.locate(lane)
        sh = self.shards[i]
        self._fork([sh])
        with sh.ctx():
            sh.exe.refill(t.shards[i], row, vals, n, agg_ids, delta, exact, tau, iter_cap)
        self._join([sh])

    def chunk(self, t: ShardedLaneState) -> ShardedLaneState:
        pairs = list(zip(self.shards, t.shards))
        self._fork(self.shards)
        for sh, part in pairs:
            with sh.ctx():
                sh.post(part)
        live = [(sh, part) for sh, part in pairs if sh.wants(part)]
        for _ in range(self.chunk_iters):
            if not live:
                break
            for sh, part in live:
                with sh.ctx():
                    sh.exe._launch(part, 0)
                    sh.post(part)
            live = [(sh, part) for sh, part in live if sh.wants(part)]
        self._join(self.shards)
        return t


def shard_lanes_state_executor(build, mesh) -> ShardedChunkedExecutor:
    """Lane sharding of the continuous table: ``build(device) ->
    ChunkedExecutor`` makes one shard's executor (model and constants on
    that device), called once a shard in mesh order.  As with
    :func:`shard_lanes_executor`, no program reads another shard's tensors:
    admitting into a lane touches its owner's table only."""
    return ShardedChunkedExecutor([build(d) for d in mesh.devices])


#: Lanes over a mesh: each shard's programs read only that shard's tensors,
#: and a bucket is one slot on every shard, whatever the shard count.
SHARDED_LANES_CONTRACT = register_contract(ExecutableContract(
    name="sharded_lanes",
    builder="repro_torch.core.executor_fused.shard_lanes_executor",
    executables_per_bucket=1,
    collectives=0,
    donated=("each shard's (lanes/D, cap) slot: vals, n, knobs and the loop state",),
    while_body_flat=True,
    description=(
        "fixed-lane batch programs over a 1-D ('lanes',) mesh: one executor, slot and "
        "stream a shard, no tensor read across shards; one slot a bucket on every shard"
    ),
))
