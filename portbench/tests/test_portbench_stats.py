"""The arithmetic of a run's numbers: every step in a percentile, every
frame in a rate, spreads as the bounds are set from them."""

import statistics

import pytest
import torch

from portbench import stats


def test_percentile_takes_every_value():
    steps = [1.0] * 27 + [2.0, 2.5, 3.0]       # 30 steps, three boundary stalls
    assert stats.percentile(steps, 90) == pytest.approx(1.1)     # xs[26] + 0.1 (xs[27] - xs[26])
    assert stats.percentile(steps, 95) == pytest.approx(2.275)
    assert stats.percentile(steps, 50) == 1.0
    assert stats.percentile([4.0], 90) == 4.0
    assert stats.percentile([], 90) is None
    # order does not matter, every value counts
    assert stats.percentile(list(reversed(steps)), 90) == stats.percentile(steps, 90)


@pytest.mark.parametrize("values,q", [([3.0, 1.0, 2.0, 4.0], 25), ([5.0, 1.0], 90),
                                      (list(range(11)), 70)])
def test_percentile_interpolates_linearly(values, q):
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100
    lo = int(pos)
    want = xs[lo] + (xs[min(lo + 1, len(xs) - 1)] - xs[lo]) * (pos - lo)
    assert stats.percentile(values, q) == pytest.approx(want)


def test_rate_is_all_frames_over_the_whole_window():
    deliveries = [(0.4, 1), (1.3, 8), (2.2, 8), (3.1, 8)]
    frames = sum(n for _, n in deliveries)
    assert stats.rate(frames, deliveries[-1][0]) == pytest.approx(25 / 3.1)
    assert stats.rate(0, 3.0) is None
    assert stats.rate(5, 0.0) is None


def test_spread_is_the_quartile_distance_over_the_median():
    values = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, _, q3 = statistics.quantiles(values, n=4)
    assert stats.spread(values) == pytest.approx((q3 - q1) / statistics.median(values))


def test_union_and_merge_of_kernel_intervals():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 5.8), (7, 7)]
    assert stats.union_length(spans) == 4.0
    assert stats.merged(spans) == [[0, 3], [5, 6], [7, 7]]


def test_rel_l2():
    want = torch.tensor([3.0, 4.0])
    assert stats.rel_l2(want, want) == 0.0
    assert stats.rel_l2(torch.tensor([3.0, 4.5]), want) == pytest.approx(0.1)
