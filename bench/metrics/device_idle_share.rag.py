"""The share of the traced stretch in which no operation ran on the card:
1 - the union of the device operations' intervals over its length."""
from benchlib import trace


def read(ctx):
    if ctx.traced is None or not ctx.ops():
        return None
    dt = ctx.traced["trace"]
    busy = trace.busy_us([(o.start, o.end) for o in dt.ops])
    return 100.0 * (1.0 - busy / dt.window_us)
