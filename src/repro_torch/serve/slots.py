"""Fixed-slot cache arena for continuous batching (port of
``repro.serve.slots``).

The arena is the model's cache list (``LM.init_cache``): one
``{"pos<j>": KVCache}`` dict per layer, slot axis first in every tensor.
``slot_view`` cuts one slot out as a batch-1 cache whose tensors are VIEWS
of the arena, so a prefill through the view writes the arena in place;
``slot_write`` copies a batch-1 cache into a slot and ``slot_reset`` zeroes
one slot's state, lengths included.  In the mixed per-slot KV arena
``fill_kv_tier`` sets an admitted slot's tier code and ``migrate_kv_tier``
requantizes a live slot at a new one.  The host-side ``SlotArena.tiers``
vector records which precision tier holds each slot.

Speculative rollback.  The reference merges the whole pre-draft arena back
into the speculative slots (``merge_slots``).  Here the arena is written in
place and no copy of it is made: :func:`kv_lengths` keeps the lengths
before the draft phase and :func:`merge_slots` restores them for the
speculative slots only.  The draft's K/V writes at ``[len, len+k)`` stay
behind, but the verify window rewrites every position of ``[len, len+k]``
the draft wrote, so after the verify the arena equals the reference's,
lanes past each length included.  :func:`truncate_kv_lengths` then rewinds
the rejected positions.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.models.layers import KVCache

Caches = List[Dict[str, KVCache]]


def slot_view(caches: Caches, slot: int) -> Caches:
    """Slot ``slot`` as a batch-1 cache list sharing storage with the arena."""
    return [{pos: c.slot(slot) for pos, c in layer.items()}
            for layer in caches]


def slot_write(caches: Caches, sub: Caches, slot: int) -> Caches:
    """Copy a batch-1 cache list into slot ``slot`` of the arena."""
    for layer, sub_layer in zip(caches, sub):
        for pos, c in layer.items():
            for dst, src in zip(c.slot(slot).tensors(), sub_layer[pos].tensors()):
                dst.copy_(src)
    return caches


def slot_reset(caches: Caches, slot: int) -> Caches:
    """Zero one slot's cache state (lengths and, in the mixed arena, its
    tier code included), in place.  A zero code is no tier: the engine
    sets the slot's code (:func:`fill_kv_tier`) before the prefill writes."""
    for layer in caches:
        for c in layer.values():
            for t in c.slot(slot).tensors():
                t.zero_()
    return caches


def kv_lengths(caches: Caches) -> List[torch.Tensor]:
    """A copy of every cache's per-slot lengths (the state
    :func:`merge_slots` restores)."""
    return [c.length.clone() for layer in caches for c in layer.values()]


def merge_slots(caches: Caches, original_lengths: List[torch.Tensor],
                keep_original: torch.Tensor) -> Caches:
    """Draft discard, in place: slots where ``keep_original[b]`` get back
    the lengths of ``original_lengths`` (from :func:`kv_lengths`); the
    other slots keep their progress."""
    cs = [c for layer in caches for c in layer.values()]
    for c, orig in zip(cs, original_lengths, strict=True):
        c.length.copy_(torch.where(keep_original, orig, c.length))
    return caches


def truncate_kv_lengths(caches: Caches, rollback: torch.Tensor,
                        mask: torch.Tensor) -> Caches:
    """Shorten slot ``b``'s fill point by ``rollback[b]`` where ``mask[b]``
    (never below 0), in place.  The K/V rows stay: entries past a length
    are invisible to ``decode_attention`` and overwritten by the next
    appends, so a length rewind IS the rollback of rejected positions."""
    for layer in caches:
        for c in layer.values():
            delta = torch.where(mask, rollback, 0).to(c.length.dtype)
            c.length.copy_(torch.clamp_min(c.length - delta, 0))
    return caches


def select_verify_step(caches: Caches, step_index: torch.Tensor) -> Caches:
    """Collapse per-window-step cache snapshots to one step per slot: the
    identity on KV caches (their rollback is the length truncation).  SSM
    caches, which keep one snapshot per window step, are not ported."""
    del step_index
    for layer in caches:
        for c in layer.values():
            if not isinstance(c, KVCache):
                raise NotImplementedError(
                    "SSM cache rollback arrives with the SSM layers, ROADMAP "
                    "Queue 1 item 8")
    return caches


def fill_kv_tier(caches: Caches, code: int) -> Caches:
    """Set every mixed-mode cache's per-slot tier code(s) to ``code`` (16 =
    bf16, 8, 4), in place.  Applied to a slot view right after the slot
    reset, so the admitted request's K/V rows are encoded at ITS code from
    the first prefill write on.  No-op for homogeneous caches."""
    for layer in caches:
        for c in layer.values():
            if c.mixed:
                c.kv_bits.fill_(code)
    return caches


def migrate_kv_tier(caches: Caches, slot: int, code: int) -> Caches:
    """Requantize ONE slot's live KV lanes at a new tier code, in place
    (the KV half of a mid-stream tier migration): the slot's lanes are read
    at their current code and re-encoded at ``code``
    (``KVCache.requantize``).  Lengths and every other slot are untouched.
    No-op for homogeneous caches."""
    for layer in slot_view(caches, slot):
        for c in layer.values():
            if c.mixed:
                c.requantize(code)
    return caches


class SlotArena:
    """Owns the arena cache: ``max_slots`` persistent decode slots sharing
    one pre-allocated KV cache, each with its own fill point.  ``kv_bits``
    follows ``KVCache.create``: None / 8 / 4, or a tuple of tier codes for
    the mixed per-slot arena.  ``tiers`` is the host-side slot -> tier-name
    vector (None = slot free)."""

    def __init__(self, model: Any, max_slots: int, max_len: int,
                 kv_bits: Any = None, device: Any = None) -> None:
        self.max_slots = max_slots
        self.max_len = max_len
        self.kv_bits = kv_bits
        self.caches: Caches = model.init_cache(max_slots, max_len,
                                               kv_bits=kv_bits, device=device)
        self.tiers: List[Optional[str]] = [None] * max_slots
