"""A deployment of a pipeline, made from the seed: rows, their sample order, the fitted forest.

A frozen copy of the port's synthetic generator (``data/synthetic.py``)
and of its random-forest fit (``models/tabular/trees.py``), driven by a
configuration file (``configs/<name>.json``) instead of code: the column
specs, the aggregates, the label's formula and the model's sizes are data.
The draws are made in the generator's order from ``default_rng(seed)``
(the sample order from ``default_rng(seed + 1)``), so a deployment holds
the same rows, group sizes and tree arrays as ``make_pipeline(name,
seed)`` for the same arguments.

The benchmark hands the same deployment to the port (through its public
constructors) and to the plain reference (``reference.py``); neither side
derives it from the other.
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

__all__ = ["Deployment", "fit_random_forest", "forest_predict", "make_deployment"]

_FNS = {"id": lambda a: a, "tanh": np.tanh, "abs": np.abs, "sign": np.sign}


@dataclass
class Deployment:
    """One pipeline's serving data and model, in host memory.

    ``columns[c]`` holds every serving row of column ``c``, group after
    group; ``perm`` the sample order (a group's first z entries of
    ``perm[ptr[g]:ptr[g + 1]]`` are its simple random sample of size z);
    ``forest`` the stacked tree arrays (``feature``, ``threshold``,
    ``left``, ``right``, ``value``: (T, M)), ``base`` its offset, ``depth``
    its traversal rounds.  ``delta`` is the model's held-out MAE on the
    serving groups (0 for a classifier).
    """

    config: dict
    columns: dict
    group_ptr: np.ndarray
    perm: np.ndarray
    sizes: np.ndarray            # (G,) rows of each serving group
    aggs: list                   # [(op, column)] in feature order
    forest: dict
    base: float
    depth: int
    scaler_mean: np.ndarray
    scaler_scale: np.ndarray
    delta: float

    @property
    def k(self) -> int:
        return len(self.aggs)

    @property
    def n_groups(self) -> int:
        return len(self.sizes)

    @property
    def task(self) -> str:
        return self.config["task"]

    def prefix(self, column: str, g: int, z: int) -> np.ndarray:
        """The first ``z`` rows of group ``g``'s sample order, float32."""
        s = int(self.group_ptr[g])
        return self.columns[column][self.perm[s : s + z]]


def _agg_latent(op, mean, std, n, row_noise, q=0.5):
    if op in ("avg", "median"):
        return mean
    if op == "quantile":
        return mean + std * row_noise * NormalDist().inv_cdf(q)
    if op in ("sum", "count"):
        return mean * n
    if op == "std":
        return std * row_noise
    if op == "var":
        return (std * row_noise) ** 2
    raise ValueError(f"unknown aggregate {op!r}")


def _label(spec: dict, agg: np.ndarray, rng) -> np.ndarray:
    """The label formula of a configuration, evaluated in its written order:
    each term is ``[sign, factor, ...]``, a factor a number or ``[fn,
    aggregate index]``, multiplied left to right and added to the running
    sum; then the noise, or the noisy score against its noiseless median."""
    acc = None
    for sign, *factors in spec["terms"]:
        prod = None
        for f in factors:
            v = f if isinstance(f, (int, float)) else _FNS[f[0]](agg[:, f[1]])
            prod = v if prod is None else prod * v
        if acc is None:
            acc = prod if sign == "+" else -prod
        else:
            acc = acc + prod if sign == "+" else acc - prod
    if spec.get("above_median"):
        thr = np.median(acc)
        return (acc + rng.normal(0, spec["noise"], len(acc)) > thr).astype(np.float64)
    return acc + rng.normal(0, spec["noise"], len(acc))


# ------------------------------------------------------------------ forest
def _quantile_bins(X: np.ndarray, n_bins: int) -> np.ndarray:
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    return np.quantile(X, qs, axis=0).T.astype(np.float32)


def _apply_bins(X: np.ndarray, edges: np.ndarray) -> np.ndarray:
    out = np.empty(X.shape, np.int32)
    for f in range(X.shape[1]):
        out[:, f] = np.searchsorted(edges[f], X[:, f], side="right")
    return out


def _fit_tree(Xb, edges, grad, hess, max_depth, feature_frac, rng, min_child_weight=1.0,
              reg_lambda=1.0) -> dict:
    """One CART tree grown breadth-first on binned features, as complete
    node arrays (leaves point at themselves)."""
    n, F = Xb.shape
    n_bins = int(edges.shape[1]) + 1
    max_nodes = 2 ** (max_depth + 1) - 1
    feature = np.zeros(max_nodes, np.int32)
    threshold = np.zeros(max_nodes, np.float32)
    left = np.arange(max_nodes, dtype=np.int32)
    right = np.arange(max_nodes, dtype=np.int32)
    value = np.zeros(max_nodes, np.float32)
    next_free = 1
    frontier = [(0, np.arange(n), 0)]
    while frontier:
        node, rows, depth = frontier.pop()
        g, h = grad[rows], hess[rows]
        G, H = g.sum(), h.sum()
        value[node] = -G / (H + reg_lambda)
        if depth >= max_depth or rows.size < 2 or H < 2 * min_child_weight:
            continue
        feats = (rng.choice(F, max(1, int(F * feature_frac)), replace=False)
                 if feature_frac < 1.0 else np.arange(F))
        best = (0.0, -1, -1)
        xb = Xb[rows]
        base = 0.5 * G * G / (H + reg_lambda)
        for f in feats:
            hg = np.bincount(xb[:, f], weights=g, minlength=n_bins)
            hh = np.bincount(xb[:, f], weights=h, minlength=n_bins)
            GL, HL = np.cumsum(hg)[:-1], np.cumsum(hh)[:-1]
            GR, HR = G - GL, H - HL
            ok = (HL >= min_child_weight) & (HR >= min_child_weight)
            gain = np.where(ok, 0.5 * (GL**2 / (HL + reg_lambda) + GR**2 / (HR + reg_lambda))
                            - base, -np.inf)
            b = int(np.argmax(gain))
            if gain[b] > best[0]:
                best = (float(gain[b]), int(f), b)
        gain, f, b = best
        if f < 0 or gain <= 1e-12 or next_free + 1 >= max_nodes:
            continue
        lo, hi = next_free, next_free + 1
        next_free += 2
        feature[node] = f
        # left iff bin <= b iff x < edges[f, b]: ``x <= nextafter(edge, -inf)``
        threshold[node] = np.nextafter(edges[f, b], -np.inf)
        left[node], right[node] = lo, hi
        go_left = Xb[rows, f] <= b
        frontier.append((lo, rows[go_left], depth + 1))
        frontier.append((hi, rows[~go_left], depth + 1))
    return dict(feature=feature, threshold=threshold, left=left, right=right, value=value)


def fit_random_forest(X, y, *, n_trees: int, max_depth: int, n_bins: int,
                      feature_frac: float, seed: int) -> tuple[dict, float]:
    """Bagged CART forest: ``(stacked arrays, base)``; a prediction is
    ``base + Σ leaves / n_trees``."""
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.float32)
    rng = np.random.default_rng(seed)
    edges = _quantile_bins(X, n_bins)
    Xb = _apply_bins(X, edges)
    base = float(y.mean())
    trees = []
    for _ in range(n_trees):
        rows = rng.integers(0, len(y), len(y))
        g = (base - y[rows]).astype(np.float64)
        trees.append(_fit_tree(Xb[rows], edges, g, np.ones_like(g), max_depth, feature_frac,
                               rng))
    return {k: np.stack([t[k] for t in trees]) for k in trees[0]}, base


def forest_predict(forest: dict, base: float, depth: int, X: np.ndarray) -> np.ndarray:
    """float32 forest output on rows ``X (n, F)``, leaves summed in tree order."""
    X = np.asarray(X, np.float32)
    T = forest["feature"].shape[0]
    rows = np.arange(X.shape[0])
    acc = np.zeros(X.shape[0], np.float32)
    for t in range(T):
        idx = np.zeros(X.shape[0], np.int64)
        for _ in range(depth):
            go_left = X[rows, forest["feature"][t][idx]] <= forest["threshold"][t][idx]
            idx = np.where(go_left, forest["left"][t][idx], forest["right"][t][idx])
        acc = acc + forest["value"][t][idx]
    return np.float32(base) + acc / np.float32(T)


# --------------------------------------------------------------- deployment
def make_deployment(config: dict, seed: int, *, rows_seed: int | None = None,
                    rows_per_group: int | None = None,
                    n_serve_groups: int | None = None) -> Deployment:
    """The deployment of ``config`` for ``seed``; with ``rows_seed`` the
    serving rows and their sample order are drawn from it instead (the
    group parameters, sizes, labels and forest stay ``seed``'s).
    ``rows_per_group`` and ``n_serve_groups`` override the configuration's
    (the CPU tests' small sizes)."""
    rpg = int(rows_per_group or config["rows_per_group"])
    n_serve = int(n_serve_groups or config["n_serve_groups"])
    n_train = int(config["n_train_groups"])
    rng = np.random.default_rng(seed)
    G = n_train + n_serve
    cols = config["columns"]
    aggs = [(a[0], a[1]) for a in config["aggs"]]
    E = len(config["exact_fields"])
    if E:
        raise ValueError("request fields are not generated by this benchmark yet")
    kinds = {c["name"]: c for c in cols}

    mean, std = {}, {}
    for c in cols:
        if c["kind"] == "indicator":
            mean[c["name"]] = rng.uniform(0.05, 0.6, G)
            std[c["name"]] = np.sqrt(mean[c["name"]] * (1 - mean[c["name"]]))
        else:
            mean[c["name"]] = rng.normal(0.0, 2.0, G)
            std[c["name"]] = rng.uniform(0.5, 3.0, G)
    sizes = rng.integers(max(int(rpg * 0.75), 8), int(rpg * 1.25) + 1, G)
    agg_pop = np.stack([
        _agg_latent(op, mean[c], std[c], sizes,
                    1.0 if kinds[c]["kind"] == "indicator" else kinds[c]["row_noise"])
        for op, c in aggs], axis=1)
    labels = _label(config["label"], agg_pop, rng)

    if rows_seed is not None:
        rng = np.random.default_rng(rows_seed)
    serve = slice(n_train, G)
    serve_sizes = sizes[serve]
    total = int(serve_sizes.sum())
    gid_rows = np.repeat(np.arange(n_serve), serve_sizes)
    columns = {}
    for c in cols:
        mu, sd = mean[c["name"]][serve][gid_rows], std[c["name"]][serve][gid_rows]
        if c["kind"] == "indicator":
            columns[c["name"]] = (rng.random(total) < mu).astype(np.float32)
        else:
            columns[c["name"]] = (mu + rng.normal(0, 1, total) * sd * c["row_noise"]
                                  ).astype(np.float32)
    ptr = np.zeros(n_serve + 1, np.int64)
    np.cumsum(serve_sizes, out=ptr[1:])
    prng = np.random.default_rng((seed if rows_seed is None else rows_seed) + 1)
    perm = np.arange(total)
    for g in range(n_serve):
        perm[ptr[g]:ptr[g + 1]] = prng.permutation(perm[ptr[g]:ptr[g + 1]])

    exact_aggs = np.zeros((n_serve, len(aggs)), np.float32)
    for j, (op, c) in enumerate(aggs):
        for g in range(n_serve):
            v = columns[c][perm[ptr[g]:ptr[g + 1]]]
            exact_aggs[g, j] = {"avg": v.mean, "sum": v.sum, "count": v.sum,
                                "std": lambda: v.std(ddof=1),
                                "var": lambda: v.var(ddof=1)}[op]()

    X_train = agg_pop[:n_train].astype(np.float32)
    y_train = labels[:n_train].astype(np.float32)
    s_mean = X_train.mean(0)
    s_scale = np.maximum(X_train.std(0), 1e-6)
    mdl = config["model"]
    if mdl["kind"] != "random_forest":
        raise ValueError(f"model kind {mdl['kind']!r} is not generated by this benchmark yet")
    forest, base = fit_random_forest(
        (X_train - s_mean) / s_scale, y_train, n_trees=mdl["n_trees"],
        max_depth=mdl["max_depth"], n_bins=mdl["n_bins"], feature_frac=mdl["feature_frac"],
        seed=seed)
    delta = 0.0
    if config["task"] == "regression":
        # the generator scales the serving aggregates in float64
        pred = forest_predict(forest, base, mdl["max_depth"],
                              ((exact_aggs.astype(np.float64) - s_mean) / s_scale
                               ).astype(np.float32))
        delta = float(np.mean(np.abs(pred.astype(np.float64) - labels[serve])))
    return Deployment(config=config, columns=columns, group_ptr=ptr, perm=perm,
                      sizes=serve_sizes.astype(np.int64), aggs=aggs, forest=forest, base=base,
                      depth=int(mdl["max_depth"]), scaler_mean=s_mean.astype(np.float32),
                      scaler_scale=s_scale.astype(np.float32), delta=delta)
