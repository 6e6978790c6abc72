"""The tail and rate arithmetic runs over every request of the window."""
import numpy as np
import pytest

import bench_tiny  # noqa: F401  (puts bench/ and src/ on the path)
from benchlib import stats
from benchlib.serve import Rec, Window
from benchlib.traffic import Planned


def rec(due, times, max_new=None):
    p = Planned(index=0, prompt=np.zeros(4, np.int32),
                max_new=len(times) if max_new is None else max_new, tier="8/8")
    return Rec(p, due, due, list(times), [1] * len(times))


def test_percentile_is_numpy_linear():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 50, 101):
        v = rng.exponential(size=n).tolist()
        for q in (50, 90, 95):
            assert stats.percentile(v, q) == pytest.approx(
                float(np.percentile(v, q)))


def test_rate_counts_every_token_of_the_window():
    win = Window(10.0, 20.0, 20.0, {}, {})
    recs = [rec(0.0, [9.0, 10.5, 11.0]), rec(5.0, [19.0, 20.0, 20.5]),
            rec(12.0, [13.0] * 10)]
    # 2 + 2 + 10 tokens inside (10, 20], over 10 s.
    assert stats.rate(recs, win) == pytest.approx(1.4)


def test_open_loop_tails_over_all_requests_due():
    win = Window(100.0, 110.0, 130.0, {}, {})
    due = [rec(100.0 + i, [100.0 + i + 0.1 * (i + 1), 100.0 + i + 2.0])
           for i in range(10)]
    outside = [rec(99.0, [150.0]), rec(110.0, [150.0])]
    never = rec(105.5, [], max_new=3)
    out, attempted, failed = stats.open_loop(due + outside + [never], win,
                                             10.0)
    assert attempted == 11 and failed == 1
    ttft = [0.1 * (i + 1) for i in range(10)] + [130.0 - 105.5]
    for q in (50, 75, 90):
        assert out[f"ttft_p{q}_ms"] == pytest.approx(
            1e3 * float(np.percentile(ttft, q)))
    tpot = [2.0 - 0.1 * (i + 1) for i in range(10)]
    assert out["tpot_p75_ms"] == pytest.approx(
        1e3 * float(np.percentile(tpot, 75)))


def test_a_late_first_token_counts_from_due_time():
    win = Window(0.0, 10.0, 10.0, {}, {})
    out, _, _ = stats.open_loop([rec(1.0, [4.0, 5.0])], win, 10.0)
    assert out["ttft_p75_ms"] == pytest.approx(3000.0)
