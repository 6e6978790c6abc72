"""Of the card's idle time in the traced stretch, the share in gaps that
began while the host's innermost program span was a model block (a span
under a ``decode_step`` or a ``prefill``, its ``sync`` excepted): idle the
host's dispatch of the model caused, as against the engine around it."""
from benchlib import program


def read(ctx):
    spans = program.program_spans(ctx)
    if not spans or not ctx.ops():
        return None
    blocks, idle = program.idle_in_blocks_us(ctx.traced["trace"], spans)
    return 100.0 * blocks / idle if idle > 0 else None
