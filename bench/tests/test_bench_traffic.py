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
        pa, pb = a.open_plan(45.0, 60.0), b.open_plan(45.0, 60.0)
        assert [d for d, _ in pa] == [d for d, _ in pb]
        assert all(np.array_equal(ra.prompt, rb.prompt)
                   and (ra.max_new, ra.tier) == (rb.max_new, rb.tier)
                   for (_, ra), (_, rb) in zip(pa, pb))


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_other_seed_same_sizes_other_order(path):
    mix = json.loads(path.read_text())
    n = mix["block"]
    a = tr.Traffic(mix, 1, 1000)
    b = tr.Traffic(mix, 2**33 + 1, 1000)
    if mix["loop"] == "open":
        return _same_stretches_other_order(mix, a, b)
    for blk in (0, 1):
        ra = [a.request(blk * n + i) for i in range(n)]
        rb = [b.request(blk * n + i) for i in range(n)]
        assert sorted(len(r.prompt) for r in ra) == \
            sorted(len(r.prompt) for r in rb)
        assert sorted(r.max_new for r in ra) == sorted(r.max_new for r in rb)
        assert sorted(r.tier for r in ra) == sorted(r.tier for r in rb)
        assert [len(r.prompt) for r in ra] != [len(r.prompt) for r in rb]


def _stretches(mix, plan, seconds):
    """The plan's requests by stretch: the warm-up, the window and each
    window-long stretch after it."""
    warm = mix["warmup_s"]
    out = {}
    for d, r in plan:
        k = 0 if d < warm else 1 + int((d - warm) // seconds)
        out.setdefault(k, []).append((d, r))
    return out


def _same_stretches_other_order(mix, a, b, seconds=45.0):
    """Open loop: each stretch (the window whole) holds the same sizes,
    tiers and gaps for every seed, in another order."""
    sa = _stretches(mix, a.open_plan(seconds, 60.0), seconds)
    sb = _stretches(mix, b.open_plan(seconds, 60.0), seconds)
    assert sorted(sa) == sorted(sb) and len(sa) >= 3
    for k in sa:
        ra, rb = [r for _, r in sa[k]], [r for _, r in sb[k]]
        assert sorted(len(r.prompt) for r in ra) == \
            sorted(len(r.prompt) for r in rb)
        assert sorted(r.max_new for r in ra) == sorted(r.max_new for r in rb)
        assert sorted(r.tier for r in ra) == sorted(r.tier for r in rb)
        lo = 0.0 if k == 0 else mix["warmup_s"] + (k - 1) * seconds
        hi = mix["warmup_s"] + k * seconds
        da, db = [d for d, _ in sa[k]], [d for d, _ in sb[k]]
        assert np.allclose(sorted(np.diff([lo] + da + [hi])),
                           sorted(np.diff([lo] + db + [hi])))
        assert da != db
    assert [len(r.prompt) for _, r in sa[1]] != \
        [len(r.prompt) for _, r in sb[1]]


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
    """Each stretch holds round(rate x its length) arrivals, its n + 1 gaps
    the stratified exponential quantiles scaled to its length; the window
    holds exactly its own stretch."""
    mix = dict(T.OPEN, rate_per_s=2.0, warmup_s=10.0)
    seconds = 25.0
    plan = tr.Traffic(mix, 4, 500).open_plan(seconds, 60.0)
    dues = [d for d, _ in plan]
    assert all(b > a for a, b in zip(dues, dues[1:]))
    assert [r.index for _, r in plan] == list(range(len(plan)))
    st = _stretches(mix, plan, seconds)
    assert [len(st[k]) for k in sorted(st)] == [20] + [50] * (len(st) - 1)
    assert 10.0 + seconds * (len(st) - 1) >= 10.0 + seconds + 60.0
    window = [d for d in dues if 10.0 <= d < 10.0 + seconds]
    assert window == [d for d, _ in st[1]]
    gaps = np.diff([10.0] + window + [10.0 + seconds])
    expect = -np.log1p(-tr.strata(51))
    assert np.allclose(sorted(gaps), sorted(expect * seconds / expect.sum()))


def test_sample_has_each_tiers_longest():
    groups = {"a": [1, 2, 3, 4], "b": [5, 6]}
    longest = {"a": 3, "b": 6}
    got = tr.sample_indices(7, groups, 2, longest)
    assert 3 in got and 6 in got and len(got) == 4
    assert got == tr.sample_indices(7, groups, 2, longest)


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_every_block_sends_the_warmed_prompt_lengths(path):
    """The set-up warms the prompt shapes of ``prompt_lengths()`` (a
    closed loop) or of the plan (an open loop): every block sends exactly
    those lengths, whatever the seed; an open loop's window-long stretches
    all send the window's."""
    mix = json.loads(path.read_text())
    t = tr.Traffic(mix, 2**31 + 5, 1000)
    if mix["loop"] == "open":
        st = _stretches(mix, t.open_plan(45.0, 60.0), 45.0)
        want = sorted(len(r.prompt) for _, r in st[1])
        for k in range(2, len(st)):
            assert sorted(len(r.prompt) for _, r in st[k]) == want
        return
    want = sorted(t.prompt_lengths().tolist())
    for b in range(3):
        got = sorted(len(t.request(b * t.block + i).prompt)
                     for i in range(t.block))
        assert got == want
