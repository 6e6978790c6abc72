"""The decode steps' share of the card's int8 peak: the model's operations
for every token a decode step emitted in the window (projections, head,
the MoE's router and routed and shared experts, attention at the token's
context, the SSM recurrence; the configuration's ``token_ops``,
``benchlib.parts``), over the engine's decode seconds."""
from benchlib import parts, peaks


def read(ctx):
    secs = ctx.delta("decode_seconds")
    contexts = ctx.decode_contexts()
    if secs <= 0 or not contexts:
        return None
    token_ops = parts.of(ctx.cfg).token_ops
    ops = sum(token_ops(ctx.cfg, c) for c in contexts)
    return 100.0 * ops / secs / peaks.PEAK_OPS_INT8
