"""The host's time in one prefill: over the traced program ``prefill``
spans (one per request), each less its ``sync`` child (the wait for the
first token), averaged."""
from benchlib import program


def read(ctx):
    host, n = program.host_less_sync_us(program.program_spans(ctx),
                                        "prefill")
    return host / n / 1e3 if n else None
