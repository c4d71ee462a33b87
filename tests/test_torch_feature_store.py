"""The port's online feature store and hot-group cache against the JAX reference.

Port of ``tests/test_feature_store.py`` (the continuous server's test is
left out: that server is not ported) and of the store and cache tests of
``tests/test_recovery.py``.  The same seeded inputs go through both
packages, the reference's store bridged to the port with its generator's
state, so both draw the same append positions:

* ``Table.append`` / ``recover``: ``perm``, ``group_ptr``, versions, log
  and journal equal;
* ``append_power_sums``: bitwise on integer data (and bitwise a rebuild),
  within 1e-3 on floats; ``merge_sorted_prefix``: bitwise (and bitwise a
  re-sort);
* ``build_afc_precompute``: ``cold``'s tables within the tables' tolerance
  (the port's compensated scan orders its float32 additions apart from
  XLA's: 3e-5 relative plus 1e-3 absolute), shift and rank index
  bitwise; a refresh sequence the same way;
* ``entry_checksum`` within 1e-12 relative of the reference's (both float64,
  summed in different orders);
* the cached ``BiathlonServer`` and ``BatchedFusedServer``: plans bitwise,
  iterations equal, ŷ within 1e-4·max(1, |y|) of the reference's cached
  server; after the same appends on both stores plans equal and ŷ within
  1e-3·max(1, |y|); a hit bitwise a miss, with no slot built.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from serving_fixtures import SMALL_CFG, make_small_bundle
from test_torch_bridge import bundle_to_numpy

from repro.core.executor_fused import build_afc_precompute as ref_build_afc_precompute
from repro.data.store import build_table as ref_build_table
from repro.kernels.sampled_agg.prefix_stats import append_power_sums as ref_append_power_sums
from repro.kernels.sampled_agg.prefix_stats import merge_sorted_prefix as ref_merge_sorted_prefix
from repro.serving import BatchedFusedServer as RefBatched
from repro.serving import BiathlonServer as RefServer
from repro.serving.feature_cache import entry_checksum as ref_entry_checksum
from repro_torch.bridge import bundle_from_numpy
from repro_torch.core.executor import BiathlonConfig
from repro_torch.core.executor_fused import build_afc_precompute
from repro_torch.data.store import MAX_APPEND_LOG, build_table
from repro_torch.kernels.sampled_agg.ops import resolve_afc_plan
from repro_torch.kernels.sampled_agg.prefix_stats import (
    append_power_sums,
    merge_sorted_prefix,
    prefix_power_sums_ref,
)
from repro_torch.serving import BatchedFusedServer, BiathlonServer
from repro_torch.serving.feature_cache import FeatureCache, entry_checksum

CFG = BiathlonConfig(m=SMALL_CFG.m, m_sobol=SMALL_CFG.m_sobol)
PTAB_TOL = dict(rtol=3e-5, atol=1e-3)   # the tables' tolerance, as chip_smoke.py holds them


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the port's many small CPU operators beside other
    test workers (see ``torch_pipeline_parity.one_torch_thread``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_tables(seed=0, sizes=(5, 3, 4)):
    """The same toy table built by the reference and by the port."""
    gid = np.concatenate([np.full(s, g) for g, s in enumerate(sizes)])
    rng = np.random.default_rng(seed + 100)
    cols = {"v": rng.normal(size=len(gid)), "a": rng.normal(size=len(gid))}
    ref = ref_build_table({c: v.copy() for c, v in cols.items()}, gid, seed=seed)
    port = build_table(cols, gid, seed=seed)
    ref.name = port.name = "toy"
    return ref, port


def _assert_same_index(ref, port):
    np.testing.assert_array_equal(port.perm, ref.perm)
    np.testing.assert_array_equal(port.group_ptr, ref.group_ptr)
    assert port.group_ids == ref.group_ids
    assert port.versions == ref.versions
    assert port._log == ref._log
    assert port._journal == ref._journal and port.seq == ref.seq
    for c in ref.columns:
        np.testing.assert_array_equal(port.columns[c], ref.columns[c])


def _bundles():
    """The reference's small linear bundle and the port's bridge of it."""
    ref = make_small_bundle()
    return ref, bundle_from_numpy(bundle_to_numpy(ref))


def _specs(g):
    return [("t", "v", g), ("t", "a", g)]


# ------------------------------------------------------- streaming append
def test_append_keeps_perm_a_valid_group_partition_as_the_reference():
    ref, t = _toy_tables()
    rows, keys = {"v": np.arange(4.0), "a": np.arange(4.0)}, np.array([0, 2, 2, 7])
    for table in (ref, t):
        table.append(rows, group_key=keys)  # 7 = a new group
    _assert_same_index(ref, t)
    assert t.n_rows == 12 + 4
    assert sorted(t.perm.tolist()) == list(range(t.n_rows))
    all_gid = np.concatenate([np.full(s, g) for g, s in enumerate((5, 3, 4))] + [keys])
    for key, g in t.group_ids.items():
        s, e = int(t.group_ptr[g]), int(t.group_ptr[g + 1])
        assert (all_gid[t.perm[s:e]] == key).all()
    assert t.group_size(7) == 1 and t.group_size(2) == 6


def test_append_is_deterministic_and_draws_the_reference_positions():
    rows = {"v": np.arange(6.0), "a": -np.arange(6.0)}
    keys = np.array([0, 1, 0, 2, 2, 0])
    (ra, a), (_, b) = _toy_tables(seed=3), _toy_tables(seed=3)
    for table in (ra, a, b):
        table.append(rows, keys)
    _assert_same_index(ra, a)
    np.testing.assert_array_equal(a.perm, b.perm)
    np.testing.assert_array_equal(a.group_ptr, b.group_ptr)


def test_append_insertion_positions_span_uniform_range():
    """j ~ Uniform{0..m}: over many appends into one group every prefix
    position (both ends included) is hit, the same ones as the reference's."""
    ref, t = _toy_tables(seed=5)
    js = set()
    for i in range(64):
        before = t.perm[int(t.group_ptr[0]) : int(t.group_ptr[1])].copy()
        for table in (ref, t):
            table.append({"v": [float(i)], "a": [0.0]}, group_key=[0])
        after = t.perm[int(t.group_ptr[0]) : int(t.group_ptr[1])]
        (j,) = np.where(after == t.n_rows - 1)[0]
        js.add(int(j))
        np.testing.assert_array_equal(np.delete(after, j), before)
    _assert_same_index(ref, t)
    assert 0 in js and max(js) >= 60


def test_append_bumps_versions_and_events_since():
    ref, t = _toy_tables()
    assert t.version(1) == 0 and t.events_since(1, 0) == []
    for table in (ref, t):
        table.append({"v": [1.0, 2.0], "a": [0.0, 0.0]}, group_key=[1, 1])
    assert t.version(1) == 2
    ev = t.events_since(1, 0)
    assert ev == ref.events_since(1, 0) and len(ev) == 2
    for j, row_id in ev:
        assert 0 <= j <= t.group_size(1) and row_id in (12, 13)
    assert t.events_since(1, 1) == ev[1:] == ref.events_since(1, 1)
    assert t.events_since(1, 2) == []


def test_events_since_ages_out_past_log_bound():
    ref, t = _toy_tables()
    n = MAX_APPEND_LOG + 2
    for table in (ref, t):
        table.append({"v": np.zeros(n), "a": np.zeros(n)}, group_key=np.zeros(n, int))
    assert t.events_since(0, 0) is None
    assert t.events_since(0, 2) == ref.events_since(0, 2)
    assert len(t.events_since(0, 2)) == MAX_APPEND_LOG
    assert t.events_since(0, n) == []


def test_append_validates_columns_and_lengths():
    _, t = _toy_tables()
    with pytest.raises(ValueError, match="missing \\['a'\\]"):
        t.append({"v": [1.0]}, group_key=[0])
    with pytest.raises(ValueError, match="unexpected \\['b'\\]"):
        t.append({"v": [1.0], "a": [1.0], "b": [1.0]}, group_key=[0])
    with pytest.raises(ValueError, match="column 'a' has 2 rows"):
        t.append({"v": [1.0], "a": [1.0, 2.0]}, group_key=[0])


def test_empty_group_reads_neutral_not_neighbor():
    _, t = _toy_tables()
    t.add_group(50)
    t.add_group(51)
    t.append({"v": [9.0], "a": [9.0]}, group_key=[51])
    assert t.group_size(50) == 0 and t.version(50) == 0
    assert t.lookup("v", 50) == 0.0
    np.testing.assert_array_equal(t.sample_prefix("v", 50, 8), np.zeros(8))
    assert t.lookup("v", 51) == 9.0
    t.add_group(60)
    assert t.lookup("v", 60) == 0.0
    np.testing.assert_array_equal(t.sample_prefix("a", 60, 4), np.zeros(4))
    assert t.add_group(51) == t.group_ids[51]
    out = np.full(8, 7.0, np.float32)  # a reused row is overwritten, its tail zeroed
    assert t.sample_prefix("v", 51, 8, out=out) is out
    np.testing.assert_array_equal(out, [9.0] + [0.0] * 7)


def test_unknown_group_key_raises_named_valueerror():
    _, t = _toy_tables()
    for op in (lambda: t.lookup("v", 99), lambda: t.group_size(99),
               lambda: t.sample_prefix("v", 99, 8), lambda: t.version(99),
               lambda: t.events_since(99, 0)):
        with pytest.raises(ValueError, match="table 'toy'.*unknown group key 99"):
            op()


# ------------------------------------------------ delta-update kernel math
def _ptab_fixture(rng, k=3, cap=32, ints=False):
    if ints:
        vals = rng.integers(-8, 8, size=(k, cap)).astype(np.float32)
        x = rng.integers(-8, 8, size=(k,)).astype(np.float32)
    else:
        vals = rng.normal(size=(k, cap)).astype(np.float32)
        x = rng.normal(size=(k,)).astype(np.float32)
    return vals, vals[:, 0].copy(), x


def _rebuild_after_insert(vals, shift, j, x):
    """The post-insertion buffer's tables, rebuilt from scratch."""
    k, cap = vals.shape
    new = np.stack([np.insert(vals[r], j, x[r])[:cap] for r in range(k)])
    return prefix_power_sums_ref(torch.from_numpy(new), torch.from_numpy(shift)).numpy()


def _appended(vals, shift, j, x, aff=None):
    """(port, reference) tables after one insertion."""
    ptab = prefix_power_sums_ref(torch.from_numpy(vals), torch.from_numpy(shift))
    port = append_power_sums(ptab, torch.from_numpy(shift), j, torch.from_numpy(x),
                             None if aff is None else torch.tensor(aff)).numpy()
    ref = np.asarray(ref_append_power_sums(
        jnp.asarray(ptab.numpy()), jnp.asarray(shift), jnp.asarray(j, jnp.int32), jnp.asarray(x),
        None if aff is None else jnp.asarray(aff)))
    return port, ref, ptab.numpy()


@pytest.mark.parametrize("j", [1, 7, 31])
def test_append_power_sums_bitwise_on_ints(j):
    """On integer data in [-8, 8) float32 arithmetic is exact: the two-sum
    update is bitwise the reference's and bitwise a rebuild."""
    vals, shift, x = _ptab_fixture(np.random.default_rng(j), ints=True)
    port, ref, _ = _appended(vals, shift, j, x)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, _rebuild_after_insert(vals, shift, j, x))


def test_append_power_sums_close_on_floats_masks_aff_and_ignores_past_cap():
    vals, shift, x = _ptab_fixture(np.random.default_rng(0))
    port, ref, ptab = _appended(vals, shift, 5, x, aff=[True, False, True])
    np.testing.assert_allclose(port, ref, **PTAB_TOL)
    want = _rebuild_after_insert(vals, shift, 5, x)
    np.testing.assert_allclose(port[[0, 2]], want[[0, 2]], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(port[1], ptab[1])  # masked row
    port, ref, ptab = _appended(vals, shift, vals.shape[1], x)
    np.testing.assert_array_equal(port, ptab)
    np.testing.assert_array_equal(ref, ptab)


def _sorted_runs(vals, n, cap):
    """The build_rank_index convention: +inf tail, positions in order,
    stable (value, position) order."""
    pos = np.arange(cap)
    masked = np.where(pos[None, :] < n[:, None], vals, np.inf)
    sidx = np.argsort(masked, axis=1, kind="stable").astype(np.int32)
    return np.take_along_axis(masked, sidx, axis=1).astype(np.float32), sidx


def _merged(svals, sidx, n, cap, j, x, aff=None):
    port = merge_sorted_prefix(torch.from_numpy(svals), torch.from_numpy(sidx),
                               torch.from_numpy(n), cap, j, torch.from_numpy(x),
                               None if aff is None else torch.tensor(aff))
    ref = ref_merge_sorted_prefix(jnp.asarray(svals), jnp.asarray(sidx), jnp.asarray(n), cap,
                                  jnp.asarray(j, jnp.int32), jnp.asarray(x),
                                  None if aff is None else jnp.asarray(aff))
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return [a.numpy() for a in port]


@pytest.mark.parametrize("j,full", [(0, False), (4, False), (9, False), (3, True)])
def test_merge_sorted_prefix_bitwise_the_reference_and_a_resort(j, full):
    """Head, middle and tail of a partial prefix, and a FULL buffer (the
    element pushed past cap drops)."""
    rng = np.random.default_rng(j + 10 * full)
    h, cap = 3, 12
    vals = rng.normal(size=(h, cap)).astype(np.float32)
    n = np.full(h, cap if full else 9, np.int32)
    svals, sidx = _sorted_runs(vals, n, cap)
    x = rng.normal(size=(h,)).astype(np.float32)
    msv, msi, mn = _merged(svals, sidx, n, cap, j, x)
    new = np.stack([np.insert(vals[r, : n[r]], j, x[r])[:cap] for r in range(h)])
    n2 = np.minimum(n + 1, cap)
    padded = np.zeros((h, cap), np.float32)
    for r in range(h):
        padded[r, : n2[r]] = new[r]
    wsv, wsi = _sorted_runs(padded, n2, cap)
    np.testing.assert_array_equal(mn, n2)
    np.testing.assert_array_equal(msv, wsv)
    np.testing.assert_array_equal(msi, wsi)


def test_merge_sorted_prefix_aff_and_past_cap_are_noops():
    rng = np.random.default_rng(2)
    h, cap = 2, 8
    vals = rng.normal(size=(h, cap)).astype(np.float32)
    n = np.full(h, 6, np.int32)
    svals, sidx = _sorted_runs(vals, n, cap)
    x = rng.normal(size=(h,)).astype(np.float32)
    msv, _, mn = _merged(svals, sidx, n, cap, 2, x, aff=[False, True])
    np.testing.assert_array_equal(msv[0], svals[0])
    np.testing.assert_array_equal(mn, [6, 7])
    msv, msi, mn = _merged(svals, sidx, n, cap, cap, x)
    np.testing.assert_array_equal(msv, svals)
    np.testing.assert_array_equal(msi, sidx)
    np.testing.assert_array_equal(mn, n)


# ---------------------------------------- cache-aware strategy resolution
def test_resolve_afc_plan_cached_is_incremental_at_every_cap_under_auto():
    assert resolve_afc_plan("auto", 256) is False
    assert resolve_afc_plan("auto", 1024) is False
    assert resolve_afc_plan("auto", 2048) is True
    for cap in (256, 1024, None):
        assert resolve_afc_plan("auto", cap, cached=True) is True
    assert resolve_afc_plan("ref", 8192, cached=True) is False
    assert resolve_afc_plan("incremental", 256, cached=True) is True


# ------------------------------------- the precompute against the reference
def _precompute_inputs(seed, k=4, cap=256, lanes=()):
    """Zero-padded buffers: row 0 full (a refresh drops its last element),
    the others with 200 values or more."""
    rng = np.random.default_rng(seed)
    n = rng.integers(200, cap + 1, size=lanes + (k,)).astype(np.int32)
    n[..., 0] = cap
    vals = rng.normal(0.0, 1.0, size=lanes + (k, cap)).astype(np.float32)
    vals[np.arange(cap) >= n[..., None]] = 0.0
    return vals, n


def _assert_same_tables(port, ref, holistic):
    np.testing.assert_allclose(port.ptab.numpy(), np.asarray(ref.ptab), **PTAB_TOL)
    np.testing.assert_array_equal(port.shift.numpy(), np.asarray(ref.shift))
    if holistic:
        for a, b in zip(port.rindex, ref.rindex):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    else:
        assert port.rindex.sorted_vals.numel() == 0


@pytest.mark.parametrize("holistic", [(), (0, 2)])
def test_cold_and_a_refresh_sequence_match_the_reference(holistic):
    kw = dict(k=4, alpha=0.05, gamma=0.01, max_iters=8, holistic=holistic)
    port, ref = build_afc_precompute(device="cpu", **kw), ref_build_afc_precompute(**kw)
    vals, n = _precompute_inputs(1)
    pt, rt = port.cold(torch.from_numpy(vals), torch.from_numpy(n)), ref.cold(
        jnp.asarray(vals), jnp.asarray(n))
    _assert_same_tables(pt, rt, holistic)
    # one launch over many requests: each request's tables as if alone
    many, n_many = _precompute_inputs(2, lanes=(3,))
    pm = port.cold(torch.from_numpy(many), torch.from_numpy(n_many))
    for i in range(3):
        one = port.cold(torch.from_numpy(many[i]), torch.from_numpy(n_many[i]))
        np.testing.assert_array_equal(pm.ptab[i].numpy(), one.ptab.numpy())
        for a, b in zip(pm.rindex, one.rindex):
            np.testing.assert_array_equal(a[i].numpy(), b.numpy())
    # a refresh sequence: events at the head, middle and end of the prefixes,
    # and past the cap of the full row
    rng = np.random.default_rng(3)
    pv, pn, rv, rn = torch.from_numpy(vals), torch.from_numpy(n), jnp.asarray(vals), jnp.asarray(n)
    events = ((1, [1, 1, 1, 0]), (100, [1, 0, 1, 1]), (199, [1, 1, 0, 0]), (256, [1, 0, 0, 0]),
              (17, [1, 1, 1, 1]))
    for j, aff in events:
        x = rng.normal(0.0, 1.0, size=4).astype(np.float32)
        aff = np.array(aff, bool)
        pv, pn, pt = port.refresh(pv, pn, pt, j, x, aff)
        rv, rn, rt = ref.refresh(rv, rn, rt, jnp.asarray(j, jnp.int32), jnp.asarray(x),
                                 jnp.asarray(aff))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(pn.numpy(), np.asarray(rn))
        _assert_same_tables(pt, rt, holistic)
    # and the refreshed tables are a cold build of the refreshed buffers
    _assert_same_tables(pt, ref.cold(rv, rn), holistic)


# ----------------------------------------------------- FeatureCache unit
def _small_cache(maxsize=8):
    ref, b = _bundles()
    pre = build_afc_precompute(k=2, device="cpu")
    return b, FeatureCache(b.store, pre.cold, pre.refresh, maxsize=maxsize, device="cpu")


def test_cache_hit_returns_same_entry_and_its_checksum_is_the_references():
    b, cache = _small_cache()
    e1 = cache.get(_specs(0), 128)
    e2 = cache.get(_specs(0), 128)
    assert e2 is e1
    assert cache.stats == dict(hits=1, misses=1, refreshes=0, corruptions=0, entries=1)
    want = ref_entry_checksum(e1.vals.numpy(), e1.n.numpy())
    got = entry_checksum(e1.vals, e1.n)
    assert got == e1.checksum and got[2] == want[2]
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-12)
    vals, sizes = b.store.request_buffers(_specs(0), 128, "cpu")
    assert torch.equal(e1.vals, vals) and torch.equal(e1.n, sizes)


def test_get_many_builds_a_batch_of_misses_at_once():
    b, cache = _small_cache()
    calls = []
    cold = cache.cold
    cache.cold = lambda v, n: calls.append(tuple(v.shape)) or cold(v, n)
    entries = cache.get_many([_specs(0), _specs(1), _specs(0), _specs(2)], 128)
    assert calls == [(3, 2, 128)] and entries[0] is entries[2]
    assert cache.stats == dict(hits=1, misses=3, refreshes=0, corruptions=0, entries=3)
    for g, e in zip((0, 1, 0, 2), entries):
        alone = cold(*b.store.request_buffers(_specs(g), 128, "cpu"))
        assert torch.equal(e.tables.ptab, alone.ptab)
        assert e.checksum == entry_checksum(e.vals, e.n)
    # each entry owns its storage: evicting one frees its share of the batch
    distinct = [entries[0], entries[1], entries[3]]
    ptrs = [t.untyped_storage().data_ptr() for e in distinct
            for t in (e.vals, e.n, e.tables.ptab, e.tables.shift)]
    assert len(set(ptrs)) == len(ptrs)


def test_cache_append_triggers_delta_refresh_matching_rebuild():
    b, cache = _small_cache()
    table = b.store["t"]
    cache.get(_specs(0), 128)
    table.append({"v": [4.5, -1.0], "a": [0.25, 2.0]}, group_key=[0, 0])
    entry = cache.get(_specs(0), 128)
    assert cache.refreshes == 1 and cache.misses == 1
    assert entry.versions == b.store.spec_versions(_specs(0))
    want_vals, want_n = b.store.request_buffers(_specs(0), 128, "cpu")
    assert torch.equal(entry.vals, want_vals) and torch.equal(entry.n, want_n)
    rebuilt = cache.cold(want_vals, want_n)
    assert torch.equal(entry.tables.shift, rebuilt.shift)
    np.testing.assert_allclose(entry.tables.ptab.numpy(), rebuilt.ptab.numpy(), **PTAB_TOL)


def test_cache_shift_basis_event_falls_back_to_rebuild():
    """An append into an EMPTY group draws j = 0 (Uniform{0..0}), which
    replaces the shift basis: the cache rebuilds."""
    b, cache = _small_cache()
    table = b.store["t"]
    table.add_group(77)
    cache.get(_specs(77), 128)
    table.append({"v": [3.0], "a": [1.5]}, group_key=[77])
    assert table.events_since(77, 0) == [(0, table.n_rows - 1)]
    entry = cache.get(_specs(77), 128)
    assert cache.misses == 2 and cache.refreshes == 0
    assert entry.n.tolist() == [1, 1] and float(entry.vals[0, 0]) == 3.0


def test_cache_aged_log_falls_back_to_rebuild():
    b, cache = _small_cache()
    cache.get(_specs(1), 128)
    n = MAX_APPEND_LOG + 1
    b.store["t"].append({"v": np.zeros(n), "a": np.zeros(n)}, group_key=np.ones(n, int))
    cache.get(_specs(1), 128)
    assert cache.misses == 2 and cache.refreshes == 0


def test_cache_lru_evicts_oldest():
    _, cache = _small_cache(maxsize=2)
    for g in (0, 1, 2, 1, 0):  # 2 evicts 0; 1 still resident; 0 misses again
        cache.get(_specs(g), 128)
    assert len(cache) == 2
    assert cache.stats["hits"] == 1 and cache.stats["misses"] == 4


# -------------------------------------------- served parity + slots built
def _assert_close(got, want, tol):
    np.testing.assert_array_equal(got["z"], want["z"])
    assert got["iters"] == want["iters"]
    assert abs(got["y_hat"] - want["y_hat"]) <= tol * max(abs(want["y_hat"]), 1.0)


def test_cached_server_matches_the_reference_hits_and_appends():
    """Miss, hit and the refresh after appends, each against the reference's
    cached server on the same store; a hit is bitwise the miss and builds
    no slot."""
    ref, port = _bundles()
    rsrv = RefServer(ref, SMALL_CFG, mode="fused", cache_size=8)
    srv = BiathlonServer(port, CFG, cache_size=8, device="cpu")
    reqs = [{"g": g} for g in (0, 1, 2, 8)]
    miss = [srv.serve(r) for r in reqs]
    slots = srv.compile_count
    assert slots == len(srv.compiled_buckets) == 2
    hit = [srv.serve(r) for r in reqs]
    assert srv.compile_count == slots, "a hit built a slot"
    assert srv.cache.stats["hits"] == len(reqs)
    for r, a, h in zip(reqs, miss, hit):
        _assert_close(a, rsrv.serve(r), 1e-4)
        np.testing.assert_array_equal(a["z"], h["z"])
        assert a["y_hat"] == h["y_hat"] and a["prob"] == h["prob"]
    rows = {"v": [2.0, -3.0, 0.5], "a": [1.0, 1.0, 0.0]}
    for b in (ref, port):
        b.store["t"].append(rows, group_key=[0, 0, 8])
    _assert_same_index(ref.store["t"], port.store["t"])
    for r in reqs:
        _assert_close(srv.serve(r), rsrv.serve(r), 1e-3)
    assert srv.cache.stats["refreshes"] == 2 == rsrv.cache.stats["refreshes"]
    assert srv.compile_count == slots


def test_batched_cached_server_matches_the_reference_and_a_hit_builds_nothing():
    ref, port = _bundles()
    reqs = [{"g": g} for g in range(3)]
    rsrv = RefBatched(ref, SMALL_CFG, batch_size=4, cache_size=8)
    srv = BatchedFusedServer(port, CFG, batch_size=4, cache_size=8, device="cpu")
    plain = BatchedFusedServer(copy.deepcopy(port), CFG, batch_size=4, device="cpu")
    want, got = rsrv.serve_batch(reqs), srv.serve_batch(reqs)
    slots = srv.compile_count
    np.testing.assert_array_equal(got.z, np.asarray(want.z))
    np.testing.assert_array_equal(got.iters, np.asarray(want.iters))
    assert (np.abs(got.y_hat - want.y_hat) <= 1e-4 * np.maximum(1.0, np.abs(want.y_hat))).all()
    np.testing.assert_array_equal(got.z, plain.serve_batch(reqs).z)
    again = srv.serve_batch(reqs)
    assert srv.compile_count == slots and srv.cache.stats["hits"] == 3
    np.testing.assert_array_equal(again.z, got.z)
    np.testing.assert_array_equal(again.y_hat, got.y_hat)
    for b in (ref, port):
        b.store["t"].append({"v": [1.0, 4.0], "a": [0.5, -0.5]}, group_key=[1, 2])
    want, got = rsrv.serve_batch(reqs), srv.serve_batch(reqs)
    np.testing.assert_array_equal(got.z, np.asarray(want.z))
    assert (np.abs(got.y_hat - want.y_hat) <= 1e-3 * np.maximum(1.0, np.abs(want.y_hat))).all()
    assert srv.cache.stats["refreshes"] == 2 and srv.compile_count == slots


# --------------------------------------------------- store crash recovery
def test_store_recover_matches_never_crashed_table():
    ref, port = _bundles()
    for t in (ref.store["t"], port.store["t"]):
        t.append({"v": [1.5, 2.5], "a": [0.5, 0.25]}, group_key=[0, 3])
        t.append({"v": [-1.0], "a": [0.125]}, group_key=[11])  # a new group
    t = port.store["t"]
    _assert_same_index(ref.store["t"], t)
    want = (t.perm.copy(), t.group_ptr.copy(), dict(t.group_ids), list(t.versions))
    t.perm = np.random.default_rng(0).permutation(t.perm)
    t.group_ptr = t.group_ptr + 3
    t.versions = []
    t._log = {}
    info = t.recover()
    assert info == dict(replayed=4, groups=11, cache_entries_dropped=0)
    np.testing.assert_array_equal(t.perm, want[0])
    np.testing.assert_array_equal(t.group_ptr, want[1])
    assert t.group_ids == want[2] and t.versions == want[3]
    _assert_same_index(ref.store["t"], t)
    assert t.group_size(11) == 1 and t.lookup("v", 11) == -1.0


def test_store_recover_detects_journal_gap():
    _, port = _bundles()
    t = port.store["t"]
    for v in (1.0, 2.0, 3.0):
        t.append({"v": [v], "a": [0.0]}, group_key=[0])
    del t._journal[1]
    with pytest.raises(ValueError, match="gap-free"):
        t.recover()


def test_store_recover_revalidates_caches():
    _, port = _bundles()
    srv = BiathlonServer(port, CFG, cache_size=4, device="cpu")
    srv.serve({"g": 0})
    port.store["t"].append({"v": [9.0], "a": [1.0]}, group_key=[0])  # the entry goes stale
    assert port.store["t"].recover(caches=(srv.cache,))["cache_entries_dropped"] == 1
    assert len(srv.cache) == 0


# ------------------------------------------------------- cache integrity
def _flip_one_value(entry):
    """Flip one buffer value of a cached entry, as bit rot would."""
    entry.vals[0, 3] = entry.vals[0, 3] + 1.0


def test_cache_detects_flipped_value_and_rebuilds():
    _, port = _bundles()
    srv = BiathlonServer(port, CFG, cache_size=4, device="cpu")
    want = srv.serve({"g": 0})
    srv.cache.verify_hits = True
    _flip_one_value(srv.cache.get(_specs(0), 128))
    got = srv.serve({"g": 0})  # detect -> drop -> cold rebuild
    assert srv.cache.corruptions == 1
    np.testing.assert_array_equal(want["z"], got["z"])
    assert want["y_hat"] == got["y_hat"]


def test_revalidate_drops_corrupt_entries_and_an_empty_cache_drops_none():
    _, port = _bundles()
    srv = BiathlonServer(port, CFG, cache_size=4, device="cpu")
    assert srv.cache.revalidate() == 0 and srv.cache.stats["entries"] == 0
    srv.serve({"g": 0})
    srv.serve({"g": 1})
    _flip_one_value(srv.cache.get(_specs(1), 128))
    assert srv.cache.revalidate() == 1 and srv.cache.corruptions == 1
    assert len(srv.cache) == 1


# ----------------------------------------------------- input sanitization
def test_append_rejects_nonfinite_loudly():
    _, port = _bundles()
    t = port.store["t"]
    with pytest.raises(ValueError) as ei:
        t.append({"v": [1.0, np.nan], "a": [0.0, 0.0]}, group_key=[0, 0])
    msg = str(ei.value)
    assert "'t'" in msg and "'v'" in msg and "row 1" in msg
    assert not t._journal
    with pytest.raises(ValueError, match="unknown sanitize policy"):
        t.append({"v": [1.0], "a": [0.0]}, group_key=[0], sanitize="bogus")


def test_append_clamp_coerces_to_observed_range():
    ref, port = _bundles()
    rows = {"v": [np.nan, np.inf, -np.inf], "a": [0.0, 0.0, 0.0]}
    for b in (ref, port):
        b.store["t"].append(rows, group_key=[0, 0, 0], sanitize="clamp")
    t = port.store["t"]
    got = t.columns["v"][-3:]
    hi, lo = float(t.columns["v"][:-3].max()), float(t.columns["v"][:-3].min())
    assert got[0] == 0.0 and got[1] == hi and got[2] == lo
    _assert_same_index(ref.store["t"], t)


def test_serve_batch_rejects_corrupted_store_values():
    _, port = _bundles()
    t = port.store["t"]
    t.columns["v"][int(t.perm[int(t.group_ptr[0])])] = np.nan  # past the append gate
    srv = BatchedFusedServer(port, CFG, batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="serve_batch lane 0"):
        srv.serve_batch([{"g": 0}])
    clamping = BatchedFusedServer(port, CFG, batch_size=2, sanitize="clamp", device="cpu")
    assert np.isfinite(clamping.serve_batch([{"g": 0}]).y_hat[0])


def test_holistic_cached_batches_match_the_reference_before_and_after_appends():
    """sensor_health (three MEDIAN/QUANTILE features: the rank index is
    cached, merged and recounted on a refresh) at a 512 cap, where only a
    cached server takes the incremental path under "auto"."""
    from repro.data.synthetic import make_pipeline as ref_make_pipeline

    ref = ref_make_pipeline("sensor_health", rows_per_group=300, n_train_groups=60,
                            n_serve_groups=3, n_requests=3)
    port = bundle_from_numpy(bundle_to_numpy(ref))
    reqs = ref.requests[:3]
    rsrv = RefBatched(ref, SMALL_CFG, batch_size=4, cache_size=8)
    srv = BatchedFusedServer(port, CFG, batch_size=4, cache_size=8, device="cpu")
    tight = [type("Knobs", (), dict(delta=0.3 * ref.pipeline.delta_default, tau=0.95,
                                    iter_cap=SMALL_CFG.max_iters))()] * len(reqs)
    for _ in range(2):  # a miss, then a hit
        want, got = rsrv.serve_batch(reqs, knobs=tight), srv.serve_batch(reqs, knobs=tight)
        np.testing.assert_array_equal(got.z, np.asarray(want.z))
        np.testing.assert_array_equal(got.iters, np.asarray(want.iters))
        assert (np.abs(got.y_hat - want.y_hat) <= 1e-4 * np.maximum(1.0, np.abs(want.y_hat))).all()
    assert got.cap == 512 and srv.cache.stats == rsrv.cache.stats
    name, rt = next(iter(ref.store.tables.items()))
    pt = port.store[name]
    p = ref.pipeline
    gid = reqs[0][p.agg_features[0].group_field]
    start = int(rt.group_ptr[rt.group_ids[gid]])
    rows = {c: v[rt.perm[start : start + 3]] * (1.25 if v.dtype.kind == "f" else 1)
            for c, v in rt.columns.items()}
    for t in (rt, pt):
        t.append(rows, group_key=[gid] * 3)
    _assert_same_index(rt, pt)
    want, got = rsrv.serve_batch(reqs, knobs=tight), srv.serve_batch(reqs, knobs=tight)
    np.testing.assert_array_equal(got.z, np.asarray(want.z))
    np.testing.assert_array_equal(got.iters, np.asarray(want.iters))
    assert (np.abs(got.y_hat - want.y_hat) <= 1e-3 * np.maximum(1.0, np.abs(want.y_hat))).all()
    assert srv.cache.stats == rsrv.cache.stats and srv.cache.refreshes >= 1
