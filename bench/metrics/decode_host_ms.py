"""The host's time to enqueue one decode step: over the traced decode
chunks, each program ``decode_chunk`` span less its ``sync`` child (the
copy of the chunk's tokens to the host), summed, over the traced
``decode_step`` spans."""
from benchlib import program


def read(ctx):
    return program.decode_host_ms(ctx)
