"""The prefills' share of the card's int8 peak: the model's operations for
every prompt prefilled in the window (each position's projections and
causal attention, the head once), over the engine's prefill seconds."""
from benchlib import counts, peaks


def read(ctx):
    secs = ctx.delta("prefill_seconds")
    prompts = ctx.window_prompts()
    if secs <= 0 or not prompts:
        return None
    ops = sum(counts.prompt_ops(ctx.cfg, n) for n in prompts)
    return 100.0 * ops / secs / peaks.PEAK_OPS_INT8
