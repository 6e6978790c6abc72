"""Tail and rate arithmetic over every request of the window (never over
medians of chunks or steps)."""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

from benchlib.serve import Rec, Window


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0..100) with linear interpolation between
    the order statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    h = (len(v) - 1) * q / 100.0
    lo = math.floor(h)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (h - lo) * (v[hi] - v[lo])


def tokens_in(recs: Sequence[Rec], t0: float, t1: float) -> int:
    """Tokens whose streaming time lies in (t0, t1]."""
    return sum(1 for r in recs for t in r.times if t0 < t <= t1)


def rate(recs: Sequence[Rec], win: Window) -> float:
    """All output tokens emitted in the window over its seconds."""
    return tokens_in(recs, win.t_open, win.t_end) / (win.t_end - win.t_open)


# The tails an open-loop cell may name (``ttft_p<q>_ms``, ``tpot_p<q>_ms``).
QUANTILES = (50, 75, 90)


def open_loop(recs: Sequence[Rec], win: Window, seconds: float
              ) -> Tuple[Dict[str, float], int, int]:
    """TTFT and TPOT quantiles over every request due in [open, open +
    seconds):
    TTFT from the request's due time (a request with no first token counts
    its wait until the driver stopped, and as failed; one still streaming
    when the driver stopped is not failed); TPOT over requests
    with two tokens or more, (last - first) / (tokens - 1).  Returns
    (metrics in ms, attempted, failed)."""
    due = [r for r in recs if win.t_open <= r.due < win.t_open + seconds]
    ttft, tpot, failed = [], [], 0
    for r in due:
        if r.times:
            ttft.append(r.times[0] - r.due)
        else:
            ttft.append(win.t_stop - r.due)
            failed += 1
        if len(r.times) >= 2:
            tpot.append((r.times[-1] - r.times[0]) / (len(r.times) - 1))
    out = {}
    for q in QUANTILES:
        if ttft:
            out[f"ttft_p{q}_ms"] = 1e3 * percentile(ttft, q)
        if tpot:
            out[f"tpot_p{q}_ms"] = 1e3 * percentile(tpot, q)
    return out, len(due), failed


def ttft_halves(recs: Sequence[Rec], win: Window, seconds: float
                ) -> Tuple[float, float]:
    """Median TTFT (s) of the requests due in the first and in the second
    half of the window: a queue that grows shows as a later half slower."""
    out = []
    for a, b in ((0.0, 0.5), (0.5, 1.0)):
        lo, hi = win.t_open + a * seconds, win.t_open + b * seconds
        v = [(r.times[0] if r.times else win.t_stop) - r.due
             for r in recs if lo <= r.due < hi]
        out.append(percentile(v, 50) if v else float("nan"))
    return out[0], out[1]
