"""Fixed-slot cache arena for continuous batching (port of
``repro.serve.slots``).

The arena is the model's cache list (``LM.init_cache``): one
``{"pos<j>": KVCache or SSMCache}`` dict per period, slot axis first in
every tensor.  Both cache types name their tensors in ``FIELDS`` and give
``tensors()`` and a batch-1 ``slot()`` view, so the slot operations here
take KV lanes and SSM rows alike.  ``slot_view`` cuts one slot out as a
batch-1 cache whose tensors are VIEWS of the arena, so a prefill through
the view writes the arena in place; ``slot_write`` copies a batch-1 cache
into a slot and ``slot_reset`` zeroes one slot's state, lengths included.
``slot_snapshot`` copies one slot's state to the host (the preemption
snapshot: a COPY, since a view would change when the slot is reused) and
``slot_restore`` writes it into any slot; ``spill_tree`` gives a snapshot
the reference's on-disk layout.  On a tensor-parallel engine the arena
holds this rank's KV heads: ``slot_snapshot(gather=)`` gathers each field
whole before the host copy and ``slot_restore(scatter=)`` keeps this
rank's slice, each naming a field by its arena path (``0.pos0.k``).
In the mixed per-slot KV arena ``fill_kv_tier`` sets an admitted slot's
tier code and ``migrate_kv_tier`` requantizes a live slot at a new one;
both, like ``truncate_kv_lengths``, skip SSM caches.  The host-side
``SlotArena.tiers`` vector records which precision tier holds each slot.

Speculative rollback.  The reference merges the whole pre-draft arena back
into the speculative slots (``merge_slots``).  Here the arena is written in
place and no copy of its KV lanes is made: :func:`pre_draft_state` keeps
the KV lengths before the draft phase and :func:`merge_slots` restores
them for the speculative slots only.  The draft's K/V writes at
``[len, len+k)`` stay behind, but the verify window rewrites every
position of ``[len, len+k]`` the draft wrote, so after the verify the
arena equals the reference's, lanes past each length included.
:func:`truncate_kv_lengths` then rewinds the rejected positions.  SSM rows
have no length to rewind: :func:`pre_draft_state` keeps a device copy of
the speculative slots' conv windows and states, :func:`merge_slots` gives
it back to them (the plain slots keep their draft-phase progress), the
verify starts from it and returns its states per step, and
:func:`select_verify_step` writes each slot's last accepted step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import torch

from repro_torch.checkpoint.checkpoint import Fields
from repro_torch.models.layers import KVCache
from repro_torch.models.ssm import SSMCache

Cache = Union[KVCache, SSMCache]
Caches = List[Dict[str, Cache]]
# One slot's state: per period, per position, the cache tensors by name.
Snapshot = List[Dict[str, Dict[str, torch.Tensor]]]
# (arena path of a field, e.g. "0.pos0.k"; one slot's tensor) -> tensor
FieldMap = Callable[[str, torch.Tensor], torch.Tensor]

# The slot axis of the reference's period-stacked cache leaves
# [n_periods, B, ...], the layout of a spilled snapshot (spill_tree).  The
# arena here keeps one cache per period, so there the slot axis is the
# first of every tensor.
SLOT_AXIS = 1


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


def _slot_fields(cache: Cache, slot: int) -> Dict[str, torch.Tensor]:
    """Every tensor of one slot of ``cache`` (views), by field name."""
    view = cache.slot(slot)
    return {f: getattr(view, f) for f in cache.FIELDS
            if getattr(view, f) is not None}


def slot_template(caches: Caches) -> Snapshot:
    """The tree of a snapshot (views of slot 0): what a spilled snapshot
    is restored into."""
    return [{pos: _slot_fields(c, 0) for pos, c in layer.items()}
            for layer in caches]


def slot_snapshot(caches: Caches, slot: int,
                  gather: Optional[FieldMap] = None) -> Snapshot:
    """A host copy of one slot's whole state: K/V lanes, scale rows, the
    length and (mixed arena) the tier code of every attention layer, the
    conv window and SSD state of every Mamba layer.  The copies are
    complete when this returns.  ``gather`` (a mesh engine's) turns this
    rank's part of a field into the whole field first."""
    def copy(path: str, t: torch.Tensor) -> torch.Tensor:
        if gather is not None:
            t = gather(path, t)
        return t.to("cpu", copy=True)
    return [{pos: {f: copy(f"{i}.{pos}.{f}", t)
                   for f, t in _slot_fields(c, slot).items()}
             for pos, c in layer.items()} for i, layer in enumerate(caches)]


def snapshot_nbytes(snap: Snapshot) -> int:
    return sum(t.numel() * t.element_size()
               for layer in snap for fields in layer.values()
               for t in fields.values())


def slot_restore(caches: Caches, snap: Snapshot, slot: int,
                 scatter: Optional[FieldMap] = None) -> Caches:
    """Write a snapshot into slot ``slot`` (any slot), in place;
    ``scatter`` (a mesh engine's) cuts each whole field to this rank's
    part first."""
    for i, (layer, sub) in enumerate(zip(caches, snap, strict=True)):
        for pos, c in layer.items():
            for f, dst in _slot_fields(c, slot).items():
                src = sub[pos][f]
                if scatter is not None:
                    src = scatter(f"{i}.{pos}.{f}", src)
                dst.copy_(src)
    return caches


def spill_tree(snap: Snapshot) -> Dict[str, Fields]:
    """A snapshot in the reference's layout, the tree its ``slot_view``
    gives: per position, each field stacked over the periods
    ([n_periods, 1, ...]) and named as an attribute of the registered
    cache dataclass (``['pos0'].k``, ``['pos1'].conv``), so a spill file
    restores in either package."""
    return {pos: Fields((f, torch.stack([layer[pos][f] for layer in snap],
                                        dim=SLOT_AXIS - 1))
                        for f in fields)
            for pos, fields in snap[0].items()}


def unspill_tree(tree: Dict[str, Fields]) -> Snapshot:
    """Inverse of :func:`spill_tree`."""
    n = len(next(iter(next(iter(tree.values())).values())))
    return [{pos: {f: t[i] for f, t in fields.items()}
             for pos, fields in tree.items()} for i in range(n)]


def spill_template(caches: Caches) -> Dict[str, Fields]:
    """The shapes and dtypes of a spilled snapshot of ``caches`` (meta
    tensors), what ``checkpoint.restore`` reads one into."""
    n = len(caches)
    return {pos: Fields((f, torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                                        device="meta"))
                        for f, t in fields.items())
            for pos, fields in slot_template(caches)[0].items()}


def pre_draft_state(caches: Caches, keep: torch.Tensor) -> List[Any]:
    """What :func:`merge_slots` restores, per cache: a copy of a KV
    cache's per-slot lengths; for an SSM cache, the indices of the slots
    in ``keep`` and a device copy of their rows of the conv window and
    state (the other slots' rows are never restored, so never copied)."""
    rows = None
    saved: List[Any] = []
    for layer in caches:
        for c in layer.values():
            if isinstance(c, KVCache):
                saved.append(c.length.clone())
                continue
            if rows is None:
                rows = torch.nonzero(keep).flatten()
            saved.append((rows, [t.index_select(0, rows)
                                 for t in c.tensors()]))
    return saved


def merge_slots(caches: Caches, saved: List[Any],
                keep_original: torch.Tensor) -> Caches:
    """Draft discard, in place: slots where ``keep_original[b]`` get back
    the state ``saved`` (from :func:`pre_draft_state` with the same mask):
    KV lengths, SSM conv windows and states; the other slots keep their
    progress."""
    cs = [c for layer in caches for c in layer.values()]
    for c, orig in zip(cs, saved, strict=True):
        if isinstance(c, KVCache):
            c.length.copy_(torch.where(keep_original, orig, c.length))
            continue
        rows, kept = orig
        for t, o in zip(c.tensors(), kept, strict=True):
            t.index_copy_(0, rows, o)
    return caches


def truncate_kv_lengths(caches: Caches, rollback: torch.Tensor,
                        mask: torch.Tensor) -> Caches:
    """Shorten slot ``b``'s fill point by ``rollback[b]`` where ``mask[b]``
    (never below 0), in place.  The K/V rows stay: entries past a length
    are invisible to ``decode_attention`` and overwritten by the next
    appends, so a length rewind IS the rollback of rejected positions.
    SSM caches are skipped (:func:`select_verify_step` rolls them back)."""
    for layer in caches:
        for c in layer.values():
            if isinstance(c, KVCache):
                delta = torch.where(mask, rollback, 0).to(c.length.dtype)
                c.length.copy_(torch.clamp_min(c.length - delta, 0))
    return caches


def select_verify_step(caches: Caches, verified: Caches,
                       step_index: torch.Tensor) -> Caches:
    """Write into ``caches`` step ``step_index[b]`` of each slot's stacked
    verify states (``verified``: what ``LM.verify_step`` returned, SSM
    leaves [W, B, ...]), in place.  KV caches are skipped: their rollback
    is the length truncation.  A slot inactive in the verify holds its
    pre-verify state at every step, so any index keeps it."""
    for layer, vlayer in zip(caches, verified, strict=True):
        for pos, c in layer.items():
            if isinstance(c, KVCache):
                continue
            v = vlayer[pos]
            idx = step_index.to(torch.int64)
            rows = torch.arange(idx.shape[0], device=idx.device)
            for t, stacked in zip(c.tensors(), v.tensors(), strict=True):
                t.copy_(stacked[idx, rows])
    return caches


def fill_kv_tier(caches: Caches, code: int) -> Caches:
    """Set every mixed-mode cache's per-slot tier code(s) to ``code`` (16 =
    bf16, 8, 4), in place.  Applied to a slot view right after the slot
    reset, so the admitted request's K/V rows are encoded at ITS code from
    the first prefill write on.  No-op for homogeneous and SSM caches."""
    for layer in caches:
        for c in layer.values():
            if isinstance(c, KVCache) and c.mixed:
                c.kv_bits.fill_(code)
    return caches


def migrate_kv_tier(caches: Caches, slot: int, code: int) -> Caches:
    """Requantize ONE slot's live KV lanes at a new tier code, in place
    (the KV half of a mid-stream tier migration): the slot's lanes are read
    at their current code and re-encoded at ``code``
    (``KVCache.requantize``).  Lengths and every other slot are untouched.
    No-op for homogeneous and SSM caches."""
    for layer in slot_view(caches, slot):
        for c in layer.values():
            if isinstance(c, KVCache) and c.mixed:
                c.requantize(code)
    return caches


class SlotArena:
    """Owns the arena cache: ``max_slots`` persistent decode slots sharing
    one pre-allocated KV/SSM cache, each with its own fill point.  ``kv_bits``
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
