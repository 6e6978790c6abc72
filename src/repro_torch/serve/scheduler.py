"""Host-side admission scheduling for slot-based continuous batching
(port of ``repro.serve.scheduler``: ``SlotState``, ``FIFOPolicy`` and
``Scheduler`` as the mixed-tier engine uses them; ``SLOPolicy`` and the
tier-serialized admission filter are ROADMAP Queue 1 items 4 and 7).

Pure bookkeeping: a waiting queue plus per-slot state (which request holds
the slot, tokens emitted so far, decode budget remaining).  All clocks are
in the engine's scheduler-clock units (decode steps executed).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Mapping, Optional, Protocol, Sequence, Tuple

from repro_torch.serve.request import Request


@dataclasses.dataclass
class SlotState:
    """One occupied decode slot: the request, its emitted tokens, and the
    decode budget still owed."""

    request: Request
    tokens: List[int] = dataclasses.field(default_factory=list)
    remaining: int = 0

    @property
    def uid(self) -> int:
        return self.request.uid

    def emit(self, token: int) -> None:
        self.tokens.append(token)
        self.remaining -= 1

    @property
    def done(self) -> bool:
        return self.remaining <= 0


class SchedulerPolicy(Protocol):
    """Admission policy: pick which waiting request takes a freed slot.
    ``candidates`` are in queue order; return an index (None iff empty)."""

    def select(self, candidates: Sequence[Request],
               submitted_at: Mapping[int, float],
               now: float) -> Optional[int]: ...


class FIFOPolicy:
    """Strict first-in-first-out admission: the oldest request wins."""

    def select(self, candidates: Sequence[Request],
               submitted_at: Mapping[int, float],
               now: float) -> Optional[int]:
        return 0 if candidates else None


class Scheduler:
    """Policy-driven admission over a fixed number of slots."""

    def __init__(self, num_slots: int,
                 policy: Optional[SchedulerPolicy] = None) -> None:
        self.num_slots = num_slots
        self.policy: SchedulerPolicy = policy if policy is not None \
            else FIFOPolicy()
        self.waiting: Deque[Request] = deque()
        self.submitted_at: Dict[int, float] = {}
        self.slots: List[Optional[SlotState]] = [None] * num_slots
        self.finished: Dict[int, List[int]] = {}

    def submit(self, request: Request, now: float = 0.0) -> None:
        """Append to the waiting queue, stamping the submission clock."""
        self.waiting.append(request)
        self.submitted_at[request.uid] = now

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def admit(self, slot: int, now: float = 0.0) -> Optional[Request]:
        """Pop the policy's choice of waiting request into ``slot``; None if
        nothing waits."""
        occupant = self.slots[slot]
        if occupant is not None:
            raise ValueError(f"slot {slot} is occupied (uid {occupant.uid})")
        waiting = list(self.waiting)
        idx = self.policy.select(waiting, self.submitted_at, now)
        if idx is None:
            return None
        req = waiting[idx]
        del self.waiting[idx]
        self.submitted_at.pop(req.uid, None)
        self.slots[slot] = SlotState(request=req,
                                     remaining=req.max_new_tokens)
        return req

    def occupied(self) -> List[Tuple[int, SlotState]]:
        return [(i, s) for i, s in enumerate(self.slots) if s is not None]

    def release(self, slot: int) -> SlotState:
        """Free a finished slot, recording its output tokens."""
        state = self.slots[slot]
        if state is None:
            raise ValueError(f"slot {slot} is already free")
        self.slots[slot] = None
        self.finished[state.uid] = state.tokens
        return state

    def release_done(self) -> List[int]:
        """Release every slot whose budget is exhausted; returns slot ids."""
        freed = []
        for i, s in self.occupied():
            if s.done:
                self.release(i)
                freed.append(i)
        return freed

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)
