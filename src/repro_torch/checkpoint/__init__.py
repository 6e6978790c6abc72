"""Atomic checkpoints of nested dicts and lists of arrays (port of
``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer, gc_old,
                                               latest_step, list_steps,
                                               remove, restore, save)

__all__ = ["AsyncCheckpointer", "gc_old", "latest_step", "list_steps",
           "remove", "restore", "save"]
