"""Request handles: the streaming half of the serving API (port of
``repro.serve.handle``; pure host bookkeeping).  The engines drive
``QUEUED -> RUNNING -> FINISHED``, ``RUNNING -> SUSPENDED -> RUNNING``
(``ServeEngine.preempt`` and the prefill-free resume) and ``QUEUED`` or
``SUSPENDED -> SHED`` (admission control and ``cancel``).

``Engine.submit`` returns a :class:`RequestHandle` — the caller's view of
one in-flight request.  The handle exposes

* **streamed tokens** — ``handle.tokens`` (everything emitted so far), an
  iterator (``for tok in handle`` drives ``engine.step()`` until the next
  token arrives), and a callback hook (``handle.on_token(fn)``);
* **terminal status** — ``handle.status`` walks ``QUEUED -> RUNNING ->
  FINISHED`` (with ``SUSPENDED`` excursions under preemption and ``SHED``
  as the overload-control terminal); ``handle.result()`` drives the engine
  to completion and returns the full token list;
* **mid-stream tier migration** — ``handle.set_tier(name)`` re-prices a
  QUEUED request or migrates a RUNNING slot (weight plane-prefix switch at
  the next group-layout derivation + an in-place requantization of the
  slot's live KV lane).

Everything here is host-side bookkeeping: handles never touch traced
state directly — they delegate to the engine that minted them.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Iterator, List, Optional, Protocol

from repro_torch.serve.request import Request


class RequestStatus(enum.Enum):
    """Lifecycle of a submitted request (host-side).

    ``QUEUED -> RUNNING -> FINISHED`` is the happy path.  Under overload
    control two more states appear: ``SUSPENDED`` (the request was
    preempted — its slot state lives in a host-side ``SuspendedState`` and
    it waits in the queue for prefill-free re-admission; it may bounce
    ``RUNNING -> SUSPENDED -> RUNNING`` any number of times) and ``SHED``
    (terminal: admission control refused the request, or the caller
    cancelled it before it finished — its token stream is whatever was
    emitted before the cut)."""

    QUEUED = "queued"        # waiting for a slot
    RUNNING = "running"      # occupies a slot (prefilled, decoding)
    SUSPENDED = "suspended"  # preempted; snapshot held, waiting to resume
    FINISHED = "finished"    # budget exhausted; tokens complete
    SHED = "shed"            # terminal: shed by admission control/cancelled


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One emitted token, as returned by ``Engine.step()``.

    ``index`` is the token's 0-based position in the request's output
    stream; ``final`` marks the request's last token (its handle flips to
    FINISHED the moment this event is pushed).  ``tier`` is the precision
    tier the token was decoded at (None on untiered engines) — under
    mid-stream migration, successive events of one request may carry
    different tiers.  ``sampled`` is True when the token came from the
    request's temperature/top-k sampler rather than greedy argmax;
    ``speculative`` marks tokens emitted by a speculative round (accepted
    drafts and correction tokens — all verified at ``tier``, never the
    draft tier)."""

    uid: int
    token: int
    index: int
    tier: Optional[str]
    final: bool
    sampled: bool = False
    speculative: bool = False


class _HandleEngine(Protocol):
    """What a handle needs from the engine that minted it."""

    @property
    def has_work(self) -> bool: ...

    def step(self) -> List[TokenEvent]: ...

    def _set_tier(self, handle: "RequestHandle", tier: str) -> None: ...


class RequestHandle:
    """Caller-facing view of one submitted request (see module docstring).

    Handles are minted by ``Engine.submit`` — never construct one directly
    outside tests.  All clocks (``submitted_at`` / ``admitted_at`` /
    ``finished_at``) are in the engine's scheduler-clock units (decode
    steps), the same units ``Request.deadline`` is priced in."""

    def __init__(self, request: Request, engine: _HandleEngine, *,
                 submitted_at: float = 0.0) -> None:
        self.request = request
        self._engine = engine
        self.status = RequestStatus.QUEUED
        self.tokens: List[int] = []
        self.events: List[TokenEvent] = []
        self.submitted_at = submitted_at
        self.admitted_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.slot: Optional[int] = None
        self._callbacks: List[Callable[[TokenEvent], None]] = []

    # ------------------------------------------------------------- identity
    @property
    def uid(self) -> int:
        return self.request.uid

    @property
    def tier(self) -> Optional[str]:
        """The request's CURRENT tier (tracks mid-stream migrations)."""
        return self.request.tier

    @property
    def done(self) -> bool:
        """True once the request reached a terminal state (FINISHED, or
        SHED by admission control / ``Engine.cancel``)."""
        return self.status in (RequestStatus.FINISHED, RequestStatus.SHED)

    @property
    def queue_wait(self) -> Optional[float]:
        """Scheduler-clock ticks from submission to FIRST admission (None
        while QUEUED/SHED-before-admission).  Preempt/resume cycles do not
        move it: it measures the initial time-to-first-token wait."""
        if self.admitted_at is None:
            return None
        return self.admitted_at - self.submitted_at

    @property
    def ttft(self) -> Optional[float]:
        """Scheduler-clock ticks from submission to the FIRST emitted
        token (None until one streams).  With prefill emitting token 1 at
        admission this usually equals ``queue_wait``; the two diverge only
        for resumed streams, whose first token predates any suspension."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    # ------------------------------------------------------------ streaming
    def on_token(self, callback: Callable[[TokenEvent], None]) -> None:
        """Register a per-token callback.

        Already-buffered events are replayed synchronously at registration,
        so a late subscriber sees the identical stream; subsequent events
        fire from inside ``engine.step()`` as they are emitted."""
        self._callbacks.append(callback)
        for ev in self.events:
            callback(ev)

    def __iter__(self) -> Iterator[int]:
        """Yield the request's tokens, driving ``engine.step()`` whenever
        the next token has not been produced yet (pull-based streaming)."""
        i = 0
        while True:
            while i >= len(self.tokens) and not self.done:
                if not self._engine.has_work:
                    raise RuntimeError(
                        f"request {self.uid}: engine idle but request not "
                        f"finished (status {self.status.value})")
                self._engine.step()
            if i < len(self.tokens):
                yield self.tokens[i]
                i += 1
            else:
                return

    def result(self) -> List[int]:
        """Drive the engine until this request FINISHES; return its tokens."""
        while not self.done:
            if not self._engine.has_work:
                raise RuntimeError(
                    f"request {self.uid}: engine idle but request not "
                    f"finished (status {self.status.value})")
            self._engine.step()
        return list(self.tokens)

    # ------------------------------------------------------------ migration
    def set_tier(self, tier: str) -> None:
        """Change this request's precision tier mid-stream.

        QUEUED: the waiting request is re-tagged (and re-priced for SLO
        admission).  RUNNING: the slot's KV lane is requantized in place at
        the new tier's KV precision and the weight plane prefix switches at
        the engine's next group-layout derivation.  FINISHED: error."""
        self._engine._set_tier(self, tier)

    # ------------------------------------------------------------- internal
    def _mark_admitted(self, slot: int, now: float) -> None:
        self.status = RequestStatus.RUNNING
        self.slot = slot
        if self.admitted_at is None:     # resumes keep the FIRST admission
            self.admitted_at = now

    def _mark_suspended(self) -> None:
        self.status = RequestStatus.SUSPENDED
        self.slot = None

    def _mark_shed(self, now: float) -> None:
        self.status = RequestStatus.SHED
        self.slot = None
        self.finished_at = now

    def _push(self, event: TokenEvent, now: float,
              defer: Optional[Callable[[BaseException], None]] = None
              ) -> None:
        """Engine-side: record one emitted token and fire callbacks.

        ALL handle bookkeeping (buffering, the FINISHED transition) happens
        before any callback runs, and ONLY user-callback exceptions are
        routed through ``defer`` (engines re-raise them at the end of the
        scheduling round, once host state is consistent) — an
        engine-internal bookkeeping error still propagates immediately
        rather than being masked by an unrelated callback failure."""
        self.events.append(event)
        self.tokens.append(event.token)
        if self.first_token_at is None:
            self.first_token_at = now
        if event.final:
            self.status = RequestStatus.FINISHED
            self.slot = None
            self.finished_at = now
        for cb in self._callbacks:
            if defer is None:
                cb(event)
            else:
                try:
                    cb(event)
                except Exception as err:
                    defer(err)

    def __repr__(self) -> str:
        return (f"RequestHandle(uid={self.uid}, status={self.status.value}, "
                f"tier={self.tier!r}, tokens={len(self.tokens)})")
