"""The rate and tail arithmetic over a window of whole jobs."""

import statistics

import pytest

from benchmark import stats


def test_rate_is_all_the_work_over_the_window():
    w = stats.Window(seconds=2.0, durations=[0.5, 0.5, 0.6, 0.4], work=[500, 500, 500, 500])
    assert w.rate() == pytest.approx(1000.0)
    assert w.attempted == 4


def test_a_failed_job_is_attempted_and_does_no_work():
    w = stats.Window(seconds=1.0, durations=[0.5, 0.5], work=[500, 0], failed=1)
    assert w.attempted == 2 and w.failed == 1
    assert w.rate() == pytest.approx(500.0)


def test_p95_over_every_job():
    durs = [0.1 + 0.001 * i for i in range(200)]
    w = stats.Window(seconds=sum(durs), durations=durs, work=[1] * 200)
    # linear interpolation between order statistics: rank 0.95 * 199 = 189.05
    assert w.percentile_ms(95) == pytest.approx(1e3 * (0.1 + 0.001 * 189.05))
    assert w.percentile_ms(50) == pytest.approx(1e3 * statistics.median(durs))


def test_a_tail_needs_two_jobs_and_a_rate_one():
    assert stats.Window(seconds=1.0, durations=[0.3], work=[5]).percentile_ms(95) is None
    assert stats.Window().rate() is None

