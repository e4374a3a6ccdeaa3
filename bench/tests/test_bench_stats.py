"""The benchmark's own percentile, spread and window arithmetic, on
synthetic timestamps."""

import math
import statistics

import numpy as np
import pytest

import bench_tiny  # noqa: F401
from vsrbench import stats


@pytest.mark.parametrize("p", [0, 10, 50, 90, 95, 100])
def test_bench_percentile_is_numpys_linear(p):
    xs = list(np.random.default_rng(3).exponential(size=37))
    assert math.isclose(stats.percentile(xs, p), float(np.percentile(xs, p)),
                        rel_tol=1e-12)


def test_bench_percentile_counts_failures_as_infinite():
    xs = [1.0] * 8 + [math.inf] * 2          # 10 requests, 2 failed
    assert stats.percentile(xs, 50) == 1.0
    assert stats.percentile(xs, 70) == 1.0
    assert math.isinf(stats.percentile(xs, 90))
    assert stats.percentile([5.0], 90) == 5.0


def test_bench_spread_is_quartiles_over_median():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == (q3 - q1) / q2


def test_bench_whole_batch_window():
    # batches of 10 s back to back, the first dispatched at t = 3
    b = [(3.0 + 10 * i, 13.0 + 10 * i) for i in range(6)]
    assert stats.whole_batches(b, 0.0, 45.0) == (0, 3)   # ends 13..43
    assert stats.whole_batches(b, 0.0, 40.0) == (0, 3)
    assert stats.whole_batches(b, 0.0, 39.9) == (0, 2)
    assert stats.whole_batches(b, 4.0, 45.0) == (1, 4)
    assert stats.whole_batches(b, 0.0, 5.0) is None
    assert stats.whole_batches(b, 100.0, 5.0) is None


def test_bench_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.union_seconds(iv) == 3.0
    assert stats.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert stats.gaps([], 1.0, 2.0) == [(1.0, 2.0)]
    assert stats.mean([]) is None and stats.mean([1.0, 3.0]) == 2.0
