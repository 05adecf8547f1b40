import statistics

import pytest

from portbench import stats


def test_union_merges_overlapping_and_touching_intervals():
    assert stats.union([(3, 4), (0, 1), (0.5, 2), (2, 2.5), (5, 6)]) == [(0, 2.5), (3, 4), (5, 6)]
    assert stats.length(stats.union([(0, 1), (0.5, 2)])) == 2


def test_overlap_and_gaps():
    a = stats.union([(0, 2), (4, 6)])
    b = stats.union([(1, 5)])
    assert stats.overlap(a, b) == pytest.approx(2.0)
    assert stats.gaps(a, 0, 8) == [(2, 4), (6, 8)]
    assert stats.gaps(a, -1, 5) == [(-1, 0), (2, 4)]


def test_percentile_is_linear_between_order_statistics():
    xs = list(range(1, 11))
    assert stats.percentile(xs, 90) == pytest.approx(9.1)
    assert stats.percentile(xs, 0) == 1 and stats.percentile(xs, 100) == 10
    assert stats.percentile([3.0], 90) == 3.0


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, median, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / median)
