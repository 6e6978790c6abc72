"""The traffic generator: deterministic in the seed, the same sizes for
every seed in another order, and the mix files' shares and clips."""
import json

import numpy as np
import pytest

import bench_tiny as T
from benchlib import traffic as tr

MIXES = sorted((T.BENCH / "traffic").glob("*.json"))


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_same_seed_same_requests(path):
    mix = json.loads(path.read_text())
    a = tr.Traffic(mix, 2**31 + 5, 1000)
    b = tr.Traffic(mix, 2**31 + 5, 1000)
    for i in (0, 1, mix["block"] - 1, mix["block"], 3 * mix["block"] + 2):
        ra, rb = a.request(i), b.request(i)
        assert np.array_equal(ra.prompt, rb.prompt)
        assert (ra.max_new, ra.tier) == (rb.max_new, rb.tier)
    if mix["loop"] == "open":
        assert a.arrivals(60.0) == b.arrivals(60.0)


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_other_seed_same_sizes_other_order(path):
    mix = json.loads(path.read_text())
    n = mix["block"]
    a = tr.Traffic(mix, 1, 1000)
    b = tr.Traffic(mix, 2**33 + 1, 1000)
    for blk in (0, 1):
        ra = [a.request(blk * n + i) for i in range(n)]
        rb = [b.request(blk * n + i) for i in range(n)]
        assert sorted(len(r.prompt) for r in ra) == \
            sorted(len(r.prompt) for r in rb)
        assert sorted(r.max_new for r in ra) == sorted(r.max_new for r in rb)
        assert sorted(r.tier for r in ra) == sorted(r.tier for r in rb)
        assert [len(r.prompt) for r in ra] != [len(r.prompt) for r in rb]
    if mix["loop"] == "open":
        da, db = a.arrivals(200.0), b.arrivals(200.0)
        assert np.allclose(sorted(np.diff([0.0] + da)[:n]),
                           sorted(np.diff([0.0] + db)[:n]))
        assert da != db


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_lengths_clipped_and_fit_the_slots(path):
    mix = json.loads(path.read_text())
    t = tr.Traffic(mix, 3, 1000)
    reqs = [t.request(i) for i in range(3 * mix["block"])]
    p, o = mix["prompt"], mix["output"]
    assert all(p["min"] <= len(r.prompt) <= p["max"] for r in reqs)
    assert all(1 <= r.max_new <= o["max"] for r in reqs)
    assert p["max"] + o["max"] <= mix["engine"]["max_len"]
    assert all(0 <= int(r.prompt.min()) and int(r.prompt.max()) < 1000
               for r in reqs)


def test_tiers_in_thirds_and_residual_budgets():
    t = tr.Traffic(T.CLOSED, 9, 500)
    first = [t.request(i) for i in range(6)]
    later = [t.request(6 + i) for i in range(6)]
    assert sorted(r.tier for r in first) == ["2/2"] * 2 + ["4/4"] * 2 + \
        ["8/8"] * 2
    full = tr.lognormal_lengths(T.CLOSED["output"], 6)
    assert sorted(r.max_new for r in later) == sorted(full.tolist())
    assert all(r.max_new <= T.CLOSED["output"]["max"] for r in first)
    assert sum(r.max_new for r in first) < sum(full)


def test_arrivals_rate_and_strata():
    mix = dict(T.OPEN, rate_per_s=2.0, block=50)
    dues = tr.Traffic(mix, 4, 500).arrivals(1000.0)
    assert all(b > a for a, b in zip(dues, dues[1:]))
    assert abs(len(dues) / 1000.0 - 2.0) < 0.1
    gaps = np.diff([0.0] + dues[:50])
    expect = -np.log1p(-tr.strata(50)) / 2.0
    assert np.allclose(sorted(gaps), sorted(expect))


def test_sample_has_each_tiers_longest():
    groups = {"a": [1, 2, 3, 4], "b": [5, 6]}
    longest = {"a": 3, "b": 6}
    got = tr.sample_indices(7, groups, 2, longest)
    assert 3 in got and 6 in got and len(got) == 4
    assert got == tr.sample_indices(7, groups, 2, longest)


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_every_block_sends_the_warmed_prompt_lengths(path):
    """The set-up warms the prompt shapes of ``prompt_lengths()``: every
    block sends exactly those lengths, whatever the seed."""
    mix = json.loads(path.read_text())
    t = tr.Traffic(mix, 2**31 + 5, 1000)
    want = sorted(t.prompt_lengths().tolist())
    for b in range(3):
        got = sorted(len(t.request(b * t.block + i).prompt)
                     for i in range(t.block))
        assert got == want
