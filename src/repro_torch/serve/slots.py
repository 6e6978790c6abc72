"""Fixed-slot cache arena for continuous batching (port of
``repro.serve.slots``).

The arena is the model's cache list (``LM.init_cache``): one
``{"pos<j>": KVCache}`` dict per layer, slot axis first in every tensor.
``slot_view`` cuts one slot out as a batch-1 cache whose tensors are VIEWS
of the arena, so a prefill through the view writes the arena in place;
``slot_write`` copies a batch-1 cache into a slot and ``slot_reset`` zeroes
one slot's state, lengths included.  The host-side ``SlotArena.tiers``
vector records which precision tier holds each slot.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from repro_torch.models.layers import KVCache

Caches = List[Dict[str, KVCache]]


def _tensors(c: KVCache):
    return [getattr(c, f.name) for f in dataclasses.fields(c)
            if getattr(c, f.name) is not None]


def slot_view(caches: Caches, slot: int) -> Caches:
    """Slot ``slot`` as a batch-1 cache list sharing storage with the arena."""
    return [{pos: c.slot(slot) for pos, c in layer.items()}
            for layer in caches]


def slot_write(caches: Caches, sub: Caches, slot: int) -> Caches:
    """Copy a batch-1 cache list into slot ``slot`` of the arena."""
    for layer, sub_layer in zip(caches, sub):
        for pos, c in layer.items():
            for dst, src in zip(_tensors(c.slot(slot)), _tensors(sub_layer[pos])):
                dst.copy_(src)
    return caches


def slot_reset(caches: Caches, slot: int) -> Caches:
    """Zero one slot's cache state (lengths included), in place."""
    for layer in caches:
        for c in layer.values():
            for t in _tensors(c.slot(slot)):
                t.zero_()
    return caches


class SlotArena:
    """Owns the arena cache: ``max_slots`` persistent decode slots sharing
    one pre-allocated KV cache, each with its own fill point.  ``tiers`` is
    the host-side slot -> tier-name vector (None = slot free)."""

    def __init__(self, model: Any, max_slots: int, max_len: int,
                 kv_bits: Optional[int] = None, device: Any = None) -> None:
        self.max_slots = max_slots
        self.max_len = max_len
        self.kv_bits = kv_bits
        self.caches: Caches = model.init_cache(max_slots, max_len,
                                               kv_bits=kv_bits, device=device)
        self.tiers: List[Optional[str]] = [None] * max_slots
