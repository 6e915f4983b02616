"""Percentiles over all requests, rates over the whole window, spreads,
and the interval arithmetic of the idle share, against hand counts."""

import statistics

import pytest

from port_bench import stats


def test_percentile_nearest_rank():
    xs = [15, 20, 35, 40, 50]
    assert stats.percentile(xs, 30) == 20
    assert stats.percentile(xs, 40) == 20
    assert stats.percentile(xs, 50) == 35
    assert stats.percentile(xs, 100) == 50
    assert stats.percentile(list(range(1, 101)), 95) == 95
    assert stats.percentile(list(range(1, 101)), 90) == 90
    assert stats.percentile([], 50) is None
    with pytest.raises(ValueError):
        stats.percentile(xs, 0)


def test_percentile_takes_every_sample_in_any_order():
    xs = [3.0] * 19 + [100.0]
    assert stats.percentile(xs, 95) == 3.0
    assert stats.percentile(list(reversed(xs)), 96) == 100.0
    assert stats.beyond(list(range(1, 201)), 95) == 10


def test_rate_is_the_whole_window():
    events = [(0.5, 10), (1.0, 5), (2.999, 1), (3.0, 100), (-0.1, 100)]
    assert stats.rate(events, 0.0, 3.0) == pytest.approx(16 / 3)
    with pytest.raises(ValueError):
        stats.rate(events, 1.0, 1.0)


def test_spread_is_python_quartiles_over_median():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 100.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)
    assert stats.spread([5.0] * 6) == 0.0


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.union_seconds(iv) == pytest.approx(3.0)
    assert stats.gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    assert stats.gaps([], 0.0, 1.0) == [(0.0, 1.0)]
    assert stats.union_seconds([]) == 0.0
