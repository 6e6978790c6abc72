"""The rag-prefill cell's 75th percentile of time per output token over
every request due in the window with two tokens or more, as
``benchlib.stats.open_loop`` takes it.  Its runs spread with the host's
speed and the order of arrivals, so it is read per layer (in a traced
run, whose profiled stretch runs a little slower)."""
from benchlib import stats


def read(ctx):
    tails, _, _ = stats.open_loop(ctx.recs, ctx.window, ctx.seconds)
    return tails.get("tpot_p75_ms")
