"""The host's time to enqueue one decode step in the open loop: the same
reading as ``decode_host_ms``, which moves ``tpot_p75_ms`` here."""
from benchlib import program


def read(ctx):
    return program.decode_host_ms(ctx)
