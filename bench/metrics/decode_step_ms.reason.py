"""``decode_step_ms`` for the reason-decode cell, read as ``decode_step_ms.py``
reads it.  That cell's wall-clock throughput swings with the host's speed
and is read per layer (``tokens_per_s.reason``); the end-to-end metric
this one moves there is ``device_ms_per_token``, hence an entry of its
own."""
from benchlib.cell import load_reader

read = load_reader("decode_step_ms")
