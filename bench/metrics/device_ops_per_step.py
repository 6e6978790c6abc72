"""Device operations per decode step in the traced stretch: operations that
start inside a decode chunk (from its first step's launch to the next
engine phase) over the decode steps traced."""
from benchlib import trace


def read(ctx):
    if ctx.traced is None:
        return None
    steps = len(ctx.spans("decode_step"))
    if not steps:
        return None
    dt = ctx.traced["trace"]
    chunks = [(a, b) for a, b, lab in
              trace.phases(ctx.traced["spans"], dt.t_start, dt.t_stop)
              if lab == "decode"]
    n = sum(1 for o in dt.ops for a, b in chunks if a <= o.start < b)
    return n / steps
