"""The decode steps' share of the card's int8 peak: the model's operations
for every token a decode step emitted in the window (projections, head,
attention at the token's context, or the SSM recurrence), over the
engine's decode seconds."""
from benchlib import counts, peaks


def read(ctx):
    secs = ctx.delta("decode_seconds")
    contexts = ctx.decode_contexts()
    if secs <= 0 or not contexts:
        return None
    ops = sum(counts.token_ops(ctx.cfg, c) for c in contexts)
    return 100.0 * ops / secs / peaks.PEAK_OPS_INT8
