"""Host-side admission scheduling for slot-based continuous batching
(port of ``repro.serve.scheduler``: ``SlotState``, ``FIFOPolicy``,
``SLOPolicy`` and ``Scheduler`` with its tier filter).

Pure bookkeeping: a waiting queue plus per-slot state (which request holds
the slot, tokens emitted so far, decode budget remaining).

* Admission *policy* — which waiting request takes a freed slot — is a
  :class:`SchedulerPolicy`: :class:`FIFOPolicy` (the oldest wins) or
  :class:`SLOPolicy` (tightest deadline slack first, the service time
  priced by the tier's modeled array cycles; optional deadline-driven
  tier auto-selection).  The same policy carries the overload control the
  engine consults: displacement of a RUNNING slot for an urgent request
  (``preempt``), refusal at submit (``shed``), tenant weights and time
  slices for best-effort requests.
* Tier *constraints* are orthogonal to policy: the mixed-tier engine
  admits any tier into any slot (``admit(slot)``), the tier-serialized
  mode only the tier its decode batch runs at (``admit(slot, tier=...)``);
  requests of other tiers keep their queue position.

All clocks (``now``, ``submitted_at``, deadlines) are in the engine's
scheduler-clock units (decode steps executed).
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import (Deque, Dict, List, Mapping, Optional, Protocol, Sequence,
                    Tuple, Union)

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


class _AnyTier:
    """Sentinel type for ``admit(tier=ANY_TIER)`` (no tier constraint)."""

    def __repr__(self) -> str:
        return "ANY_TIER"


ANY_TIER = _AnyTier()   # admit()/peek() sentinel: no tier constraint
TierFilter = Union[str, None, _AnyTier]

# One RUNNING slot as the overload-control hooks see it:
# (slot index, request, decode tokens still owed, submission tick).
RunningEntry = Tuple[int, Request, int, float]


class SchedulerPolicy(Protocol):
    """Admission policy: pick which waiting request takes a freed slot.
    ``candidates`` are the tier-compatible waiting requests in queue order;
    return an index (None iff empty)."""

    def select(self, candidates: Sequence[Request],
               submitted_at: Mapping[int, float],
               now: float) -> Optional[int]: ...


class FIFOPolicy:
    """Strict first-in-first-out admission: the oldest request wins."""

    def select(self, candidates: Sequence[Request],
               submitted_at: Mapping[int, float],
               now: float) -> Optional[int]:
        return 0 if candidates else None


class SLOPolicy:
    """Deadline-aware admission: the tightest slack first, where

        slack = (submitted_at + deadline) - now - max_new_tokens * cost(tier)

    and ``cost(tier)`` is the tier's per-token service cost relative to
    the cheapest tier (``hwmodel.energy.relative_tier_costs``: modeled
    array cycles per MAC, MAC-weighted per layer when ``mac_counts`` is
    given).  A high-precision request occupies the array longer per token,
    so its deadline bites earlier.  Ties break FIFO; requests without a
    deadline have infinite slack and keep FIFO order among themselves.

    Without a schedule, or for a tier it does not price, a token costs
    1.0.  ``auto_tier=True`` lets the engine retag a deadlined request at
    admission (:meth:`select_tier`) to the best tier whose priced service
    still fits its deadline.

    Overload control, all opt-in and consumed by ``ServeEngine``:

    * ``preempt=True``: :meth:`preempt_victim` names a RUNNING request to
      displace when a queued deadlined request's weighted slack is at or
      below ``preempt_slack`` and no slot frees in time; the victim must
      hold strictly more slack (equal urgency never thrashes).
    * ``shed=True``: :meth:`admission_decision` refuses at submit a
      deadlined request whose projected completion misses (with
      ``auto_tier``, names a faster tier that fits instead).
    * ``time_slice=N`` (ticks, >= 1): the engine preempts a best-effort
      RUNNING slot whose slice has run N ticks while requests wait.
    * ``tenant_weights`` (name -> weight >= 1.0): a weighted tenant's
      queue age counts ``weight`` times (:meth:`weighted_slack`).

    ``remaining_tokens`` (uid -> tokens still owed) is kept by the engine
    for SUSPENDED requests, so their slack prices only the remainder."""

    def __init__(self, schedule: Optional[object] = None, *,
                 auto_tier: bool = False,
                 mac_counts: Optional[Mapping[str, float]] = None,
                 preempt: bool = False,
                 preempt_slack: float = 0.0,
                 shed: bool = False,
                 tenant_weights: Optional[Mapping[str, float]] = None,
                 time_slice: Optional[int] = None) -> None:
        self.tier_costs: Dict[str, float] = {}
        if schedule is not None:
            from repro_torch.hwmodel.energy import relative_tier_costs
            self.tier_costs = relative_tier_costs(schedule,
                                                  mac_counts=mac_counts)
        self.auto_tier = bool(auto_tier)
        self.preempt = bool(preempt)
        self.preempt_slack = float(preempt_slack)
        self.shed = bool(shed)
        self.tenant_weights: Dict[str, float] = dict(tenant_weights or {})
        for tenant, w in self.tenant_weights.items():
            if w < 1.0:
                raise ValueError(f"tenant {tenant!r}: weight {w} < 1.0 "
                                 "(weights only ever ACCELERATE aging)")
        if time_slice is not None and int(time_slice) < 1:
            raise ValueError(f"time_slice must be >= 1 scheduler tick, got "
                             f"{time_slice}")
        self.time_slice: Optional[int] = \
            None if time_slice is None else int(time_slice)
        self.remaining_tokens: Dict[int, int] = {}

    def cost(self, tier: Optional[str]) -> float:
        """Relative per-token service cost of a tier (cheapest == 1.0)."""
        return 1.0 if tier is None else self.tier_costs.get(tier, 1.0)

    def weight(self, tenant: Optional[str]) -> float:
        """Fairness weight of a tenant (1.0 unless listed)."""
        return 1.0 if tenant is None else self.tenant_weights.get(tenant, 1.0)

    def est_service(self, request: Request) -> float:
        """Estimated REMAINING service time in scheduler-clock ticks (a
        suspended request prices only the tokens still owed)."""
        owed = self.remaining_tokens.get(request.uid,
                                         request.max_new_tokens)
        return owed * self.cost(request.tier)

    def slack(self, request: Request, submitted_at: Mapping[int, float],
              now: float) -> float:
        """Ticks to spare before the request's deadline (infinite for a
        request without one)."""
        if request.deadline is None:
            return math.inf
        due = submitted_at.get(request.uid, now) + request.deadline
        return due - now - self.est_service(request)

    def weighted_slack(self, request: Request,
                       submitted_at: Mapping[int, float],
                       now: float) -> float:
        """Tenant-fair slack: a weighted tenant's queue age counts
        ``weight`` times.  Equal to :meth:`slack` at weight 1.0 and for a
        request without a deadline (infinite)."""
        s = self.slack(request, submitted_at, now)
        if not math.isfinite(s):
            return s
        age = now - submitted_at.get(request.uid, now)
        return s - (self.weight(request.tenant) - 1.0) * age

    def select(self, candidates: Sequence[Request],
               submitted_at: Mapping[int, float],
               now: float) -> Optional[int]:
        if not candidates:
            return None

        def key(i: int) -> Tuple[float, float, int]:
            r = candidates[i]
            age = now - submitted_at.get(r.uid, now)
            # Ties: the weighted age (submission order without weights),
            # then the queue position.
            return (self.weighted_slack(r, submitted_at, now),
                    -self.weight(r.tenant) * age, i)

        return min(range(len(candidates)), key=key)

    def preempt_victim(self, waiting: Sequence[Request],
                       running: Sequence[RunningEntry],
                       submitted_at: Mapping[int, float],
                       now: float) -> Optional[int]:
        """Uid of the RUNNING request to displace, or None.

        Fires only when (a) some queued deadlined request's weighted slack
        is at or below ``preempt_slack``, (b) no running slot frees within
        that slack on its own, and (c) some RUNNING request holds strictly
        more slack than the urgent one: a best-effort stream (infinite
        slack) first, then the lightest tenant and the longest remaining
        stream."""
        if not self.preempt or not running:
            return None
        urgent_slack = math.inf
        for r in waiting:
            if r.deadline is not None:
                urgent_slack = min(urgent_slack,
                                   self.weighted_slack(r, submitted_at, now))
        if urgent_slack > self.preempt_slack:
            return None
        free_in = min(rem for _, _, rem, _ in running)
        if free_in <= max(urgent_slack, 0.0):
            return None            # a slot frees in time on its own

        def victim_key(entry: RunningEntry) -> Tuple[float, float, int, int]:
            slot, req, rem, tick = entry
            if req.deadline is None:
                s = math.inf
            else:
                s = (tick + req.deadline) - now - rem * self.cost(req.tier)
            return (s, -self.weight(req.tenant), rem, -slot)

        victim = max(running, key=victim_key)
        if victim_key(victim)[0] <= urgent_slack:
            return None            # nobody is strictly lower priority
        return victim[1].uid

    def admission_decision(self, request: Request,
                           waiting: Sequence[Request],
                           running: Sequence[RunningEntry],
                           num_slots: int,
                           submitted_at: Mapping[int, float],
                           now: float) -> str:
        """Admission control at submit: ``"admit"``, ``"shed"``, or a tier
        name to downtier to (``auto_tier`` only).

        The work that outranks the request (queued requests with tighter
        or equal weighted slack, and running work that cannot be displaced:
        deadlined streams with tighter slack, or everything running when
        ``preempt`` is off) is served first, spread over the slots; the
        request fits a tier when that wait plus its priced service meets
        its deadline.  A request without a deadline is always admitted."""
        if not self.shed or request.deadline is None:
            return "admit"
        budget = float(request.deadline)     # submitted at ``now``
        s_req = budget - self.est_service(request)
        ahead = 0.0
        for r in waiting:
            if self.weighted_slack(r, submitted_at, now) <= s_req:
                ahead += self.est_service(r)
        for _, req, rem, tick in running:
            service = rem * self.cost(req.tier)
            if req.deadline is None:
                if not self.preempt:
                    ahead += service
                continue               # a displaceable best-effort stream
            run_slack = (tick + req.deadline) - now - service
            if run_slack <= s_req or not self.preempt:
                ahead += service
        wait = ahead / max(num_slots, 1)

        def feasible(cost: float) -> bool:
            return wait + request.max_new_tokens * cost <= budget

        if feasible(self.cost(request.tier)):
            return "admit"
        if self.auto_tier and self.tier_costs:
            fits = [t for t in self.tier_costs if feasible(self.tier_costs[t])]
            if fits:
                return max(fits, key=lambda t: (self.tier_costs[t], t))
        return "shed"

    def select_tier(self, request: Request, submitted_at_tick: float,
                    now: float) -> Optional[str]:
        """Deadline-aware tier choice at admission (``auto_tier``): the
        request's own tier while ``max_new_tokens * cost`` fits the budget
        left (``submitted_at + deadline - now``), else the most expensive
        (highest-quality) tier that fits, else the cheapest.  Never above
        the requested tier's cost once it does not fit; None (keep the
        tier) without a deadline or a price list.  Ties break on the tier
        name."""
        if request.deadline is None or not self.tier_costs:
            return None
        budget = submitted_at_tick + request.deadline - now

        def fits(tier: str) -> bool:
            return request.max_new_tokens * self.tier_costs[tier] <= budget

        cur = request.tier
        if cur is not None and cur in self.tier_costs and fits(cur):
            return cur
        feasible = [t for t in self.tier_costs if fits(t)]
        if feasible:
            return max(feasible, key=lambda t: (self.tier_costs[t], t))
        return min(self.tier_costs, key=lambda t: (self.tier_costs[t], t))


class Scheduler:
    """Policy-driven admission over a fixed number of slots; ``admit(slot,
    tier=...)`` restricts the candidates to one tier (the serialized
    mode), and the policy chooses among the compatible ones."""

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

    def _pick(self, tier: TierFilter, now: float) -> Optional[int]:
        """Queue index of the policy's choice among the requests the tier
        filter admits."""
        idxs = list(range(len(self.waiting))) if isinstance(tier, _AnyTier) \
            else [i for i, r in enumerate(self.waiting) if r.tier == tier]
        if not idxs:
            return None
        chosen = self.policy.select([self.waiting[i] for i in idxs],
                                    self.submitted_at, now)
        return None if chosen is None else idxs[chosen]

    def peek(self, tier: TierFilter = ANY_TIER,
             now: float = 0.0) -> Optional[Request]:
        """The request the policy WOULD admit next (no state change): what
        an idle tier-serialized engine chooses its next tier by."""
        idx = self._pick(tier, now)
        return None if idx is None else self.waiting[idx]

    def admit(self, slot: int, tier: TierFilter = ANY_TIER,
              now: float = 0.0) -> Optional[Request]:
        """Pop the policy's choice of compatible waiting request into
        ``slot`` (``tier`` a name: that tier's requests only); None if none
        waits."""
        occupant = self.slots[slot]
        if occupant is not None:
            raise ValueError(f"slot {slot} is occupied (uid {occupant.uid})")
        idx = self._pick(tier, now)
        if idx is None:
            return None
        req = self.waiting[idx]
        del self.waiting[idx]
        self.submitted_at.pop(req.uid, None)
        self.slots[slot] = SlotState(request=req,
                                     remaining=req.max_new_tokens)
        return req

    def cancel(self, uid: int) -> None:
        """Drop a WAITING request (if queued) and its submission-clock
        entry."""
        self.waiting = deque(r for r in self.waiting if r.uid != uid)
        self.submitted_at.pop(uid, None)

    def occupied(self) -> List[Tuple[int, SlotState]]:
        return [(i, s) for i, s in enumerate(self.slots) if s is not None]

    def evict(self, slot: int) -> SlotState:
        """Free an occupied slot WITHOUT recording it finished (the
        preemption half of :meth:`release`); returns its state for the
        engine's ``SuspendedState``."""
        state = self.slots[slot]
        if state is None:
            raise ValueError(f"slot {slot} is already free")
        self.slots[slot] = None
        return state

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
