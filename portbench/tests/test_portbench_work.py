"""The work counts behind the rooflines and step_mfu, against a hand count."""
import pytest

from portbench import work

CONFIG = {"biathlon": {"m": 10, "m_sobol": 4}, "model": {"n_trees": 3, "max_depth": 2},
          "aggs": [["avg", "a"], ["sum", "b"]]}


def test_counts_at_one_shape_by_hand():
    counts = {"refills": 5, "iterating": 2, "lane_steps": 3, "table_rows": 100}
    # rows: 5 z0 evaluations of m + 1 = 11, 2 Saltelli blocks of (k + 2)·m_sobol = 16,
    # 3 lane-steps of 11 + 16 = 27
    assert work.tree_rows(counts, 2, 10, 4) == 55 + 32 + 81 == 168
    w = work.counted_work(counts, CONFIG)
    # forest: 2 features read and 1 output written a row; 3 trees of 2 levels: 2·2 + 1 a tree
    assert w["tree"] == (168 * 12, 168 * 3 * 5)
    # tables over 100 rows of 2 features: a value read, four sums written, 8 ops a value
    assert w["prefix"] == (200 * 4 + 200 * 16, 200 * 8)
    assert w["sampling"] == (168 * 2 * 4, 168 * 2 * 2)


def test_bound_takes_the_longer_term():
    assert work.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 67e12) == pytest.approx(1.0)
    assert work.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)
