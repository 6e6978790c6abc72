"""The prefills' share of the card's int8 peak: the model's operations for
every prompt prefilled in the window (each position's projections and
causal attention, the head once; the configuration's ``prompt_ops``,
``benchlib.parts``), over the engine's prefill seconds."""
from benchlib import parts, peaks


def read(ctx):
    secs = ctx.delta("prefill_seconds")
    prompts = ctx.window_prompts()
    if secs <= 0 or not prompts:
        return None
    prompt_ops = parts.of(ctx.cfg).prompt_ops
    ops = sum(prompt_ops(ctx.cfg, n) for n in prompts)
    return 100.0 * ops / secs / peaks.PEAK_OPS_INT8
