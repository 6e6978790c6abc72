"""Mean decode step over the window: the engine's own host seconds around
its decode chunks (each ends in a copy to the host) over its steps."""


def read(ctx):
    steps = ctx.delta("decode_steps")
    return 1e3 * ctx.delta("decode_seconds") / steps if steps else None
