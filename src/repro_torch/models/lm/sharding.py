"""Sharding rules: logical axes -> mesh axes, param/activation/cache specs.

Port of ``repro/models/lm/sharding.py``.  Strategy (classic 2D/3D: DP x TP,
optional pod axis composing with DP):

* batch            -> ('pod', 'data')      (gradient all-reduce hierarchy)
* attention heads  -> 'model'              (Megatron TP; the config pads
                                            uneven head counts like 40 or 14)
* kv heads         -> 'model' iff divisible, else replicated (GQA small-kv)
* ffn hidden / moe expert axis / vocab -> 'model'
* decode KV-cache sequence -> 'model'      (split-K / FlashDecoding reduce)
* ssm state heads (or head_dim when heads < tp) -> 'model'

The rules and specs are the reference's, leaf for leaf.  A spec is a
:class:`PSpec`, a tuple of the mesh axis name (or tuple of names) or None a
dim, as a JAX ``PartitionSpec`` holds them.

The reference hands the specs to GSPMD.  The port has no partitioner: one
process drives every shard of an ``LMMesh``, and the placement is explicit.
:func:`shard_params` cuts each leaf into its distinct blocks (a
:class:`Sharded` leaf; a block that several shards share is stored once, on
the first of them, and copied to the others inside the forward pass, so its
gradient sums over them by itself), :func:`gather_params` puts them back
together.  Activations are lists with one tensor a shard (``split_batch``);
the collectives between them are in ``collectives.py``.  The model runs over
a mesh under :func:`use_rules` (``model.py``: all six families).  With no
rules active the same forward runs as one shard: a plain tensor is a
one-shard leaf (:func:`locals_of`, :func:`own_of`, :func:`split_dim_of`,
:func:`offsets_of`) and ``split_batch(None, x)`` is ``[x]``.

The serving cache is placed leaf for leaf by :func:`cache_pspecs`
(:func:`shard_cache`, :func:`empty_cache`; :func:`gather_cache` puts it back
together): each shard holds its own block (``Sharded.own``), the rows of its
data shard and its block of the cached sequence.  A dimension split over an
axis whose size does not divide it raises, as the reference's ``jit``
refuses such an input.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import re
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import collectives

__all__ = [
    "PSpec",
    "Sharded",
    "ShardingRules",
    "use_rules",
    "active_rules",
    "constrain",
    "param_pspecs",
    "batch_pspec",
    "cache_pspecs",
    "empty_cache",
    "gather_cache",
    "gather_params",
    "locals_of",
    "offsets_of",
    "own_of",
    "shard_cache",
    "shard_params",
    "split_batch",
    "split_dim_of",
]

_ACTIVE: list["ShardingRules"] = []


class PSpec(tuple):
    """A partition spec: ``PSpec(None, "model", None)``, one entry a dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PSpec{tuple.__repr__(self)}"


P = PSpec


@dataclass(frozen=True)
class ShardingRules:
    mesh: object                            # launch.mesh.LMMesh (or anything with .shape)
    cfg: ModelConfig
    dp_axes: tuple[str, ...] = ("data",)   # ('pod','data') on the multi-pod mesh
    tp_axis: str = "model"
    # FSDP / ZeRO-3: additionally shard every large param's biggest free dim
    # over 'data' (gathered over 'data' before its block runs).
    fsdp: bool = False
    fsdp_min_elems: int = 1 << 20

    @property
    def tp(self) -> int:
        return self.mesh.shape[self.tp_axis]

    def dp(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.dp_axes)

    # logical resolution -----------------------------------------------------
    def axis(self, logical: str | None):
        if logical is None:
            return None
        if logical == "batch":
            if not self.dp_axes:
                return None
            return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]
        if logical == "model":
            return self.tp_axis
        if logical == "kv_heads":
            return self.tp_axis if self.cfg.n_kv_heads % self.tp == 0 else None
        raise KeyError(logical)

    def pspec(self, *logical) -> PSpec:
        return P(*[self.axis(l) for l in logical])


@contextlib.contextmanager
def use_rules(rules: ShardingRules):
    _ACTIVE.append(rules)
    try:
        yield rules
    finally:
        _ACTIVE.pop()


def active_rules() -> ShardingRules | None:
    return _ACTIVE[-1] if _ACTIVE else None


def constrain(x, *logical):
    """The reference's ``with_sharding_constraint``, which pins the residual
    stream to ``("batch", None, None)`` under rules.  It returns ``x`` with or
    without rules: under rules the port's residual stream is a list of one
    tensor a shard, each holding the rows of its data shard, which is that
    placement by construction."""
    return x


# --------------------------------------------------------------------------
# Parameter specs by path pattern
# --------------------------------------------------------------------------
# (regex over the '/'-joined path, spec of the trailing dims)
_PARAM_RULES: list[tuple[str, tuple]] = [
    # (V, D) vocab-sharded.  re.search matches 'unembed' here too, so the (D, V)
    # unembedding is split over its rows and the rule below never fires, as in
    # the reference; the loss re-splits it over the vocabulary (model.py).
    (r"embed$", ("model", None)),
    (r"unembed$", (None, "model")),                # (D, V)
    (r"frontend_adapter$", (None, None)),
    (r"(wq|wk|wv)$", (None, "model", None)),       # (D, H, hd) head-sharded
    (r"wo$", ("model", None, None)),               # (H, hd, D)
    (r"(bq|bk|bv)$", ("model", None)),             # (H, hd)
    (r"wq_a$", (None, None)),                      # MLA low-rank: small, replicated
    (r"wq_b$", (None, "model", None)),
    (r"wkv_a$", (None, None)),
    (r"wkv_b$", (None, "model", None)),
    (r"(w_gate|w_up)$", (None, "model")),          # dense FFN (D, F)
    (r"w_down$", ("model", None)),                 # (F, D)
    (r"router$", (None, None)),
    # never reached, as in the reference: the two dense-FFN patterns above match
    # the expert leaves first, which split d_ff_expert, not E (moe.py)
    (r"experts?/(w_gate|w_up)$", ("model", None, None)),  # (E, D, F) EP
    (r"experts?/w_down$", ("model", None, None)),
    (r"in_proj$", (None, "model")),                # mamba (D, d_in)
    (r"out_proj$", ("model", None)),               # (di, D)
    (r"(w_q|w_k|w_v)$", (None, "model")),          # mlstm (D, di)
    (r"^.*conv_[wb]$", None),                      # replicate small tensors
    (r"(a_log|d_skip|dt_bias|b_i|b_f|w_i|w_f)$", None),
    (r"slstm.*/w$", (None, "model")),
    (r"slstm.*/r$", None),
    (r"up$", (None, "model")),
    (r"down$", ("model", None)),
]


def _match_spec(path: str, shape: tuple, rules: ShardingRules) -> PSpec:
    ndim = len(shape)
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path):
            if spec is None:
                return P()
            # leading stacked-layer axes are never sharded: left-pad with None
            pad = ndim - len(spec)
            if pad < 0:
                return P()
            logical = (None,) * pad + tuple(spec)
            resolved = [rules.axis(l) for l in logical]
            # divisibility guard: every block must be the same size
            # (e.g. granite's 8 KV heads on a 16-way model axis -> replicate)
            for i, ax in enumerate(resolved):
                if ax is None:
                    continue
                size = rules.mesh.shape[ax] if isinstance(ax, str) else math.prod(
                    rules.mesh.shape[a] for a in ax)
                if shape[i] % size != 0:
                    resolved[i] = None
            if rules.fsdp and math.prod(shape) >= rules.fsdp_min_elems:
                dp = rules.axis("batch")
                dp_size = (
                    0 if dp is None else
                    rules.mesh.shape[dp] if isinstance(dp, str) else
                    math.prod(rules.mesh.shape[a] for a in dp)
                )
                if dp_size > 1:
                    # biggest still-unsharded, divisible dim gets 'data'
                    free = [
                        (shape[i], i) for i, ax in enumerate(resolved)
                        if ax is None and shape[i] % dp_size == 0
                    ]
                    if free:
                        _, i = max(free)
                        resolved[i] = dp
            return P(*resolved)
    return P()  # default: replicate (norm scales, biases, gates)


def param_pspecs(rules: ShardingRules, params_tree) -> dict:
    """Tree of :class:`PSpec` mirroring ``params_tree`` (tensors, or anything
    with a ``shape``)."""

    def walk(subtree, path):
        if isinstance(subtree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in subtree.items()}
        if isinstance(subtree, (list, tuple)):
            return type(subtree)(walk(v, f"{path}/{i}") for i, v in enumerate(subtree))
        # moe expert tensors live under 'moe/' with 3D leaves (E, D, F)
        p = path
        if re.search(r"moe/(w_gate|w_up|w_down)$", path):
            p = path.replace("moe/", "moe/experts/")
        return _match_spec(p, tuple(subtree.shape), rules)

    return walk(params_tree, "")


def batch_pspec(rules: ShardingRules, kind: str, global_batch: int) -> dict:
    """Input specs: tokens/labels batch-sharded when divisible, else replicated."""
    b_axis = "batch" if global_batch % rules.dp() == 0 else None
    spec = {
        "tokens": rules.pspec(b_axis, None),
    }
    if rules.cfg.frontend:
        spec["frontend"] = rules.pspec(b_axis, None, None)
    return spec


def cache_pspecs(rules: ShardingRules, cache_tree, global_batch: int | None = None) -> dict:
    """Decode-cache specs: batch on DP, cache sequence on TP (split-K).  The
    port's ``pos`` is a Python int, replicated as the reference's scalar."""
    if global_batch is not None and global_batch % rules.dp() != 0:
        # e.g. long_500k single-stream decode: batch cannot data-parallelize
        rules = ShardingRules(rules.mesh, rules.cfg, dp_axes=(), tp_axis=rules.tp_axis)

    def leaf_spec(path: str, ndim: int) -> PSpec:
        if path.endswith("pos"):
            return P()
        if re.search(r"(ckv|kpe)", path):       # MLA latent: (L?, B, S, r)
            pad = ndim - 3
            return rules.pspec(*(None,) * pad, "batch", "model", None)
        if re.search(r"/(k|v)$", path):          # (L?, B, S, H, hd)
            pad = ndim - 4
            return rules.pspec(*(None,) * pad, "batch", "model", None, None)
        if re.search(r"conv$", path):            # (.., B, K-1, C)
            pad = ndim - 3
            return rules.pspec(*(None,) * pad, "batch", None, "model")
        if re.search(r"ssm$", path):             # (.., B, H, N, P)
            pad = ndim - 4
            return rules.pspec(*(None,) * pad, "batch", "model", None, None)
        if re.search(r"mC$", path):              # (.., B, H, P, P)
            pad = ndim - 4
            return rules.pspec(*(None,) * pad, "batch", None, "model", None)
        if re.search(r"mn$", path):              # (.., B, H, P)
            pad = ndim - 3
            return rules.pspec(*(None,) * pad, "batch", None, "model")
        if re.search(r"mm$", path):              # (.., B, H)
            pad = ndim - 2
            return rules.pspec(*(None,) * pad, "batch", None)
        if re.search(r"s[cnmh]$", path):         # slstm scalar states (.., B, D)
            pad = ndim - 2
            return rules.pspec(*(None,) * pad, "batch", "model")
        if re.search(r"enc_out$", path):         # (B, S_enc, D)
            return rules.pspec("batch", None, None)
        return P()

    def walk(subtree, path):
        if isinstance(subtree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in subtree.items()}
        if not hasattr(subtree, "shape"):
            return P()
        return leaf_spec(path, len(subtree.shape))

    return walk(cache_tree, "")


# --------------------------------------------------------------------------
# Placement: leaves cut into blocks, batches cut into rows
# --------------------------------------------------------------------------
class Sharded:
    """A leaf on a mesh: its global ``shape``, its ``spec`` (one entry a dim)
    and its distinct ``blocks``, row-major over ``grid`` (the number of blocks
    along each dim).  Each block lives on the first shard that holds it.

    Gradients and Adam moments of a sharded tree are trees of ``Sharded``
    leaves too (``like``); ``optim.adamw.tree_map`` maps over the blocks, so
    every element is stored, updated and counted in the global norm once.
    ``leaf[i]`` is layer ``i`` of a leaf stacked over layers."""

    __slots__ = ("blocks", "spec", "shape", "mesh", "tp_axis", "grid")

    def __init__(self, blocks, spec, shape, mesh, tp_axis: str = "model"):
        self.blocks = tuple(blocks)
        self.shape = torch.Size(shape)
        self.spec = tuple(spec) + (None,) * (len(self.shape) - len(spec))
        self.mesh = mesh
        self.tp_axis = tp_axis
        self.grid = tuple(mesh.axis_size(a) for a in self.spec)

    def like(self, blocks) -> "Sharded":
        """The same placement with other blocks (gradients, moments)."""
        return Sharded(blocks, self.spec, self.shape, self.mesh, self.tp_axis)

    def __repr__(self):
        return (f"Sharded(shape={tuple(self.shape)}, spec={self.spec}, "
                f"{len(self.blocks)} blocks of {tuple(self.blocks[0].shape)})")

    def split_over(self, axes) -> bool:
        """Whether a dim is split over any of the mesh axes ``axes``."""
        for entry in self.spec:
            names = () if entry is None else (entry,) if isinstance(entry, str) else entry
            if any(a in axes for a in names):
                return True
        return False

    def _flat(self, idx) -> int:
        flat = 0
        for i, g in zip(idx, self.grid):
            flat = flat * g + i
        return flat

    def split_dim(self) -> int | None:
        """The dim split over the model axis, if one is."""
        return self.spec.index(self.tp_axis) if self.tp_axis in self.spec else None

    def offsets(self, dim: int) -> list:
        """Each shard's first index along ``dim`` of its block, in the mesh's
        order (all 0 where ``dim`` is not split over the model axis)."""
        dim %= len(self.shape)
        if self.split_dim() != dim:
            return [0] * self.mesh.size
        size = self.shape[dim] // self.grid[dim]
        return [self.mesh.axis_index(c, self.tp_axis) * size for c in self.mesh.coords]

    def locals(self) -> list:
        """Every shard's tensor, in the mesh's order, on its device: its block
        along the model axis, the dims split over the data axes (FSDP)
        gathered over them (``collectives.all_gather``)."""
        mesh = self.mesh
        xs = [self.blocks[self._flat([mesh.axis_index(coord, e) for e in self.spec])].to(dev)
              for coord, dev in zip(mesh.coords, mesh.devices)]
        for d, e in enumerate(self.spec):
            if e is not None and e != self.tp_axis and self.grid[d] > 1:
                xs = collectives.all_gather(xs, mesh, e, dim=d)
        return xs

    def own(self) -> list:
        """Every shard's own block, in the mesh's order, on its device, with
        nothing gathered: the cache's layout, whose dims split over the data
        axes hold the shard's rows.  A block that several shards share is
        the same tensor where they share its device (else a copy)."""
        mesh = self.mesh
        return [self.blocks[self._flat([mesh.axis_index(coord, e) for e in self.spec])].to(dev)
                for coord, dev in zip(mesh.coords, mesh.devices)]

    def homes(self) -> list:
        """Whether each shard, in the mesh's order, is the first that holds
        its block (the one whose device stores it)."""
        mesh, seen, out = self.mesh, set(), []
        for coord in mesh.coords:
            idx = tuple(mesh.axis_index(coord, e) for e in self.spec)
            out.append(idx not in seen)
            seen.add(idx)
        return out

    def __getitem__(self, i: int) -> "Sharded":
        """Layer ``i`` of a leaf stacked over its leading dim."""
        per = self.shape[0] // self.grid[0]
        j, r = divmod(i, per)
        rest = len(self.blocks) // self.grid[0]
        blocks = [b[r] for b in self.blocks[j * rest:(j + 1) * rest]]
        return Sharded(blocks, self.spec[1:], self.shape[1:], self.mesh, self.tp_axis)

    def full(self) -> torch.Tensor:
        """The whole leaf, on the first block's device."""
        dev = self.blocks[0].device

        def build(d, idx):
            if d == len(self.grid):
                return self.blocks[self._flat(idx)].to(dev)
            return torch.cat([build(d + 1, idx + [i]) for i in range(self.grid[d])], dim=d)

        return build(0, [])


def _layout(shape, spec, mesh) -> tuple:
    """(spec padded to the dims, blocks along each dim, each block's home
    device).  Raises ``ValueError`` where a dim split over an axis does not
    divide by its size: the blocks must be equal, as the reference's ``jit``
    requires of a sharded input."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    grid = [mesh.axis_size(a) for a in spec]
    for d, (n, g) in enumerate(zip(shape, grid)):
        if n % g:
            raise ValueError(
                f"a leaf of shape {tuple(shape)} cannot be placed by the spec {spec}: its dim "
                f"{d} ({n}) does not divide over {spec[d]!r} ({g} shards)")
    homes: dict = {}
    for n, coord in enumerate(mesh.coords):
        homes.setdefault(tuple(mesh.axis_index(coord, e) for e in spec), mesh.devices[n])
    return spec, grid, homes


def _cut(t: torch.Tensor, spec, mesh, tp_axis: str) -> Sharded:
    spec, grid, homes = _layout(t.shape, spec, mesh)
    blocks = []
    for idx in itertools.product(*(range(g) for g in grid)):
        b = t
        for d, (i, g) in enumerate(zip(idx, grid)):
            if g > 1:
                size = t.shape[d] // g
                b = b.narrow(d, i * size, size)
        blocks.append(torch.empty(b.shape, dtype=b.dtype, device=homes[idx]).copy_(b))
    return Sharded(blocks, spec, t.shape, mesh, tp_axis)


def _filled(shape, dtype, fill, spec, mesh, tp_axis: str) -> Sharded:
    """A leaf of ``shape`` placed by ``spec``, every element ``fill``, each
    block allocated on its home device."""
    spec, grid, homes = _layout(shape, spec, mesh)
    local = [n // g for n, g in zip(shape, grid)]
    blocks = [torch.full(local, fill, dtype=dtype, device=homes[idx])
              for idx in itertools.product(*(range(g) for g in grid))]
    return Sharded(blocks, spec, shape, mesh, tp_axis)


def shard_params(rules: ShardingRules, params):
    """``params`` with every leaf cut into its blocks on ``rules.mesh`` by
    :func:`param_pspecs`: a tree of :class:`Sharded`."""
    specs = param_pspecs(rules, params)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, s) for v, s in zip(tree, spec))
        return _cut(tree, spec, rules.mesh, rules.tp_axis)

    return walk(params, specs)


def gather_params(sharded):
    """The inverse of :func:`shard_params`: whole tensors, each on its first
    block's device."""
    if isinstance(sharded, dict):
        return {k: gather_params(v) for k, v in sharded.items()}
    if isinstance(sharded, (list, tuple)):
        return type(sharded)(gather_params(v) for v in sharded)
    return sharded.full()


def _cache_batch(rules: ShardingRules, cache) -> int | None:
    """The global batch of a cache tree: the size of the dim that
    :func:`cache_pspecs` puts on the data axes, in the first leaf that has
    one (None without data axes)."""
    axis = rules.axis("batch")
    specs = cache_pspecs(rules, cache)
    for name, spec in specs.items():
        if axis is not None and axis in spec:
            return cache[name].shape[spec.index(axis)]
    return None


def shard_cache(rules: ShardingRules, cache: dict) -> dict:
    """A whole serving cache (``LM.init_cache`` or the unsharded
    ``LM.prefill``'s: tensors and the Python int ``pos``) placed on
    ``rules.mesh`` leaf for leaf by :func:`cache_pspecs`: ``Sharded`` leaves
    and ``pos``.  The batch goes on the data axes where it divides by their
    size, else on none."""
    specs = cache_pspecs(rules, cache, _cache_batch(rules, cache))
    return {name: _cut(t, specs[name], rules.mesh, rules.tp_axis) if hasattr(t, "shape") else t
            for name, t in cache.items()}


def empty_cache(rules: ShardingRules, leaves: dict, global_batch: int) -> dict:
    """An empty cache placed by :func:`cache_pspecs`: ``leaves`` maps a leaf's
    name to its global (shape, type, fill); each block is allocated on its
    home shard's device (no whole tensor is made)."""
    shapes = {name: torch.empty(shape, dtype=dtype, device="meta")
              for name, (shape, dtype, _) in leaves.items()}
    specs = cache_pspecs(rules, shapes, global_batch)
    return {name: _filled(shape, dtype, fill, specs[name], rules.mesh, rules.tp_axis)
            for name, (shape, dtype, fill) in leaves.items()}


def gather_cache(cache: dict) -> dict:
    """The inverse of :func:`shard_cache`: whole tensors in the reference's
    layout, each on its first block's device, and ``pos``."""
    return {name: leaf.full() if isinstance(leaf, Sharded) else leaf
            for name, leaf in cache.items()}


def split_batch(rules: ShardingRules | None, x: torch.Tensor) -> list:
    """A global batch tensor as one tensor a shard, on the shard's device:
    the rows of its data shard when the batch divides by the data-parallel
    size (``batch_pspec``), else every row; ``[x]`` with no rules."""
    if rules is None:
        return [x]
    mesh, dp = rules.mesh, rules.dp()
    axis = rules.axis("batch")
    rows = x.shape[0] // dp if x.shape[0] % dp == 0 else None
    out = []
    for coord, dev in zip(mesh.coords, mesh.devices):
        part = x if rows is None else x.narrow(0, mesh.axis_index(coord, axis) * rows, rows)
        out.append(part.to(dev))
    return out


# --------------------------------------------------------------------------
# A leaf of either forward: a ``Sharded`` leaf, or a tensor (one shard)
# --------------------------------------------------------------------------
def locals_of(leaf) -> list:
    """Every shard's tensor of a leaf (:meth:`Sharded.locals`); ``[leaf]``
    for a tensor, the one shard of the forward with no rules active."""
    return leaf.locals() if isinstance(leaf, Sharded) else [leaf]


def own_of(leaf) -> list:
    """Every shard's own block (:meth:`Sharded.own`); ``[leaf]`` for a tensor."""
    return leaf.own() if isinstance(leaf, Sharded) else [leaf]


def split_dim_of(leaf) -> int | None:
    """The dim split over the model axis (:meth:`Sharded.split_dim`); None
    for a tensor."""
    return leaf.split_dim() if isinstance(leaf, Sharded) else None


def offsets_of(leaf, dim: int) -> list:
    """Each shard's first index along ``dim`` (:meth:`Sharded.offsets`);
    ``[0]`` for a tensor."""
    return leaf.offsets(dim) if isinstance(leaf, Sharded) else [0]
