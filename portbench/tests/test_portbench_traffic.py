"""The seeded traffic repeats, and every seed offers the same requests."""
import numpy as np
import pytest

from portbench import traffic


@pytest.mark.parametrize("seed", [0, 3, 2**33 + 1])
def test_seeded_streams_repeat(seed):
    s1 = traffic.backlog_segment(24, 96, traffic.rng_for(seed, "backlog"))
    s2 = traffic.backlog_segment(24, 96, traffic.rng_for(seed, "backlog"))
    assert s1 == s2 and all(t == 0.0 for t, _r in s1)
    w1 = traffic.backlog_segment(24, 64, traffic.rng_for(seed, "warm"))
    assert [r for _t, r in w1] != [r for _t, r in s1[:64]]


def test_every_seed_offers_the_same_requests():
    a = traffic.backlog_segment(24, 960, traffic.rng_for(1, "backlog"))
    b = traffic.backlog_segment(24, 960, traffic.rng_for(2, "backlog"))
    ga, gb = [r["gid"] for _t, r in a], [r["gid"] for _t, r in b]
    assert ga != gb and sorted(ga) == sorted(gb)
    assert np.bincount(ga).tolist() == [40] * 24


def test_each_request_is_its_own_object():
    seg = traffic.backlog_segment(3, 9, traffic.rng_for(0, "backlog"))
    assert len({id(r) for _t, r in seg}) == 9
