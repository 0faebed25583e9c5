"""The end-to-end arithmetic on synthetic frame times."""

import statistics

import pytest

from benchmark import stats


def test_rate_counts_the_whole_window():
    times = [0.016] * 99 + [0.5]              # one stalled frame
    window = sum(times)
    ms = stats.rate_ms(window, len(times))
    assert ms == pytest.approx(1000 * window / 100)
    # a median of chunks would not see the stall; the rate does
    assert ms > 1.3 * 1000 * statistics.median(times)


def test_p95_is_nearest_rank_over_every_frame():
    times = list(range(1, 101))               # 1 .. 100
    assert stats.percentile(times, 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    stalled = [1.0] * 94 + [50.0] * 6
    assert stats.percentile(stalled, 95) == 50.0
    calm = [1.0] * 95 + [50.0] * 5
    assert stats.percentile(calm, 95) == 1.0


def test_per_second_and_empty_windows():
    assert stats.per_second(1_100_000 * 300, 2.0) == 1.65e8
    with pytest.raises(ValueError):
        stats.rate_ms(1.0, 0)
    with pytest.raises(ValueError):
        stats.percentile([], 95)
    with pytest.raises(ValueError):
        stats.per_second(1.0, 0.0)
