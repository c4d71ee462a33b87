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

import gc
from types import SimpleNamespace
from typing import NamedTuple, Sequence

import torch

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
    N_POWERS,
    build_rank_index,
    prefix_moments_at,
    select_ranks_indexed,
)

__all__ = [
    "FusedExecutor",
    "FusedResult",
    "build_fused_executor",
    "fused_rows_per_iteration",
    "pipeline_executor_kwargs",
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
        features: (L, r) outputs."""
        lanes, r, _ = rows.shape
        exact = s.exact[:, None, :].expand(lanes, r, s.exact.shape[1]).reshape(lanes * r, -1)
        return self.model_fn(rows.reshape(lanes * r, self.k), exact).to(f32).reshape(lanes, r)

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
        if s.incremental:
            shift = s.vals[..., 0].contiguous()
            ptab = prefix_power_sums(s.vals, shift, use_kernel=self.use_kernel)
            rindex = None
            if self.n_hol:
                # every plan the planner can reach: min(z⁰ + i·γ, n), i = 0..max_iters
                ladder = torch.arange(self.max_iters + 1, dtype=torch.int32, device=self.device)
                zcand = torch.minimum(z0[..., None] + ladder * s.step[:, None, None],
                                      n[..., None])[:, self.hol_idx]
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
            incremental=resolve_afc_plan(self.afc_backend, cap), graphs=None,
            # inputs: a run copies its batch in
            vals=zf(lanes, k, cap), n_in=z32(lanes, k), agg=z32(lanes, k), delta=zf(lanes),
            exact=zf(lanes, e), active=torch.zeros(lanes, dtype=torch.bool, device=dev),
            tau=zf(lanes), iter_cap=z32(lanes),
            # the loop's state
            z=z32(lanes, k), it=z32(lanes), y_hat=zf(lanes), prob=zf(lanes), idx=zf(lanes, k),
            want=torch.zeros(lanes, dtype=torch.bool, device=dev),
        )
        self._slots[key] = s
        self.slots_built += 1
        return s

    def _programs(self):
        """init_eval (z⁰), the Saltelli block at z⁰, one planner step."""
        return self._init, self._sobol0, self._step

    def _capture(self, s) -> None:
        """The three programs as CUDA graphs on one memory pool, after one
        eager pass on a side stream (which loads the kernel libraries and
        makes every lazily built handle).

        Garbage is collected first and the collector is off while the
        graphs are captured: a collection inside a capture may destroy an
        unreachable graph of another slot or executor, and CUDA refuses
        that while a stream captures (the capture is invalidated).
        """
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for program in self._programs():
                program(s)
        cur.wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        graphs = []
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            for program in self._programs():
                graph = torch.cuda.CUDAGraph()
                with build.captured_launches() as recorded, torch.cuda.graph(graph, pool=pool):
                    program(s)
                graphs.append((graph, recorded))
        finally:
            if collecting:
                gc.enable()
        s.graphs = graphs

    def _launch(self, s, i: int) -> None:
        """Program ``i`` (0: z⁰, 1: Saltelli at z⁰, 2: a step) on slot ``s``."""
        if s.graphs is None:
            self._programs()[i](s)
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
        as_t = lambda x, dtype: torch.as_tensor(x).to(dtype)  # noqa: E731
        vals, n, exact = as_t(vals, f32), as_t(n, torch.int32), as_t(exact, f32)
        single = vals.dim() == 2
        if single:
            vals, n, exact = vals[None], n[None], exact[None]
        lanes, k, cap = vals.shape
        if k != self.k:
            raise ValueError(f"fused executor built for k = {self.k}, "
                             f"got buffers {tuple(vals.shape)}")
        s = self._slot(lanes, cap, exact.shape[-1])
        s.vals.copy_(vals)
        s.n_in.copy_(n)
        s.agg.copy_(as_t(agg_ids, torch.int32))
        s.delta.copy_(as_t(delta, f32))
        s.exact.copy_(exact)
        s.active.copy_(as_t(True if active is None else active, torch.bool))
        s.tau.copy_(as_t(self.tau if tau is None else tau, f32))
        s.iter_cap.copy_(as_t(self.max_iters if iter_cap is None else iter_cap, torch.int32))
        if self.capture and s.graphs is None:
            self._capture(s)
        self._drive(s)
        used = torch.where(s.active, torch.minimum(s.z, s.n).sum(-1), 0)
        res = FusedResult(y_hat=s.y_hat.clone(), prob=s.prob.clone(), iters=s.it.clone(),
                          z=s.z.clone(), samples_used=used)
        if single:
            return FusedResult(y_hat=res.y_hat[0], prob=res.prob[0], iters=int(res.iters[0]),
                               z=res.z[0], samples_used=res.samples_used[0])
        return res


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
) -> FusedExecutor:
    """Returns ``run(vals, n, agg_ids, delta, exact, active=None, tau=None,
    iter_cap=None) -> FusedResult`` (see :class:`FusedExecutor`).

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
    return FusedExecutor(
        model_fn, k=k, task=task, n_classes=n_classes, m=m, m_sobol=m_sobol, alpha=alpha,
        gamma=gamma, tau=tau, max_iters=max_iters, afc_backend=afc_backend, holistic=holistic,
        quantiles=quantiles, n_boot=n_boot, boot_seed=boot_seed, approximate=approximate,
        device=device, use_kernel=use_kernel, capture=capture)
