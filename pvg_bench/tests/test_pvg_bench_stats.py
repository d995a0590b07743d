"""The rate and tail arithmetic over every sample of a window."""
import numpy as np
import pytest

from pvg_bench import stats


def test_p95_over_all_samples_with_a_stall():
    # 90 fast frames and a stall of 10 slow ones: the tail is the stall's.
    latencies = [1.0] * 90 + [100.0] * 10
    assert stats.percentile(latencies, 95) == pytest.approx(np.percentile(latencies, 95))
    assert stats.percentile(latencies, 95) == 100.0
    # One stall among 100 frames is beyond the 95th percentile's reach ...
    one = [1.0] * 99 + [500.0]
    assert stats.percentile(one, 95) == 1.0
    # ... but every sample counts in the rate: 100 frames in 0.599 s.
    assert stats.rate(len(one), sum(one) / 1e3) == pytest.approx(100 / 0.599)


@pytest.mark.parametrize("q", [50, 90, 95, 99])
def test_percentile_is_numpys(q):
    values = list(np.random.default_rng(3).exponential(2.0, 1001))
    assert stats.percentile(values, q) == pytest.approx(np.percentile(values, q))


def test_rate_refuses_an_empty_window():
    with pytest.raises(ValueError):
        stats.rate(10, 0.0)
