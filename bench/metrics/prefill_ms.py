"""Mean prefill over the window: the engine's own host seconds around each
per-slot prefill (each ends in a copy of its first token to the host)."""


def read(ctx):
    n = ctx.delta("prefills")
    return 1e3 * ctx.delta("prefill_seconds") / n if n else None
