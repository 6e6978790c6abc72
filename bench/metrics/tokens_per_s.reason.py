"""The reason-decode cell's tokens per second, as ``tokens_per_s`` is
taken end to end in other cells: every token streamed in the window over
its seconds.  The cell's decode step is set by the host, whose speed
swings from run to run, so here it is read per layer (in a traced run,
whose profiled stretch of three steps runs a little slower)."""
from benchlib import stats


def read(ctx):
    return stats.rate(ctx.recs, ctx.window)
