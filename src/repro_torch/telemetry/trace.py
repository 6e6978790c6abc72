"""The port's one span recorder, exported as Chrome trace-event JSON
(loadable in Perfetto / ``chrome://tracing``).

**One clock.**  Every start and end is a raw ``time.perf_counter()``
reading in seconds: the clock a benchmark's device trace is anchored to,
so the program's spans and the card's operations lie on one axis.  The
Chrome export subtracts the tracer's epoch and writes microseconds.  The
deterministic scheduler clock (``ServeEngine.clock``, decode steps
executed) rides along as fields: ``ticks`` / ``ticks_end`` on every
dispatch span and lifecycle phase, ``ticks`` on every instant, so the
reproducible timeline can be rebuilt from a trace alone.

**The current recorder.**  :data:`CURRENT` is the process's one recorder
slot, ``None`` by default.  The serving engine reads it once per step and
the model once per call (``LM.forward``, ``prefill``, ``decode_step``,
``verify_step``); with it ``None`` they run no span code at all: no clock
read, no allocation, no call.  An engine built with a
:class:`~repro_torch.telemetry.Telemetry` fills it with the telemetry's
tracer for each of its own steps; a benchmark fills it for the stretch
it traces.

**Spans.**  Each has an id, its parent's id (the span open when it began;
0 for none), a name, its start and end, for request work the request's
``uid`` (a child inherits its parent's), and fields; a counter is a field
set when the span ends (a projection's kernel ``launches``).  The names:

* engine (``serve/engine.py``): ``step`` (``tokens`` emitted) holds
  ``admit``, which holds one ``prefill`` per request (``tier``,
  ``prompt_len``, ``padded_len``, ``rows``) with its ``sync`` (the wait for
  the first token); then ``decode_chunk`` (``n_steps``, ``rows``,
  ``active_lanes``, ``layout``) holding ``n_steps`` ``decode_step`` spans
  (``rows``, ``groups``) and the closing ``sync``, or one ``spec_round``
  (``k``, ``n_spec``) in its place; then ``emit`` (the token events and
  their callbacks);
* model, under ``prefill``, ``decode_step`` or ``spec_round``: ``embed``;
  per layer (``layer``) ``attn``, holding ``rope``, ``kv_write`` and
  ``attn_core`` (``launches``: the decode-attention kernel's one launch
  in a decode step on the card), or ``ssm``, holding ``ssm_core``; then
  ``mlp`` or ``moe``; ``head``; the engine's ``select``; and around every
  quantized projection a ``linear`` (``name``, ``rows``, ``launches``:
  the hand-written kernels it launched, the ``_build.LAUNCHES`` delta).

**Tracks** (one Chrome *thread* each, all in pid 1):

* track 0, ``engine`` — every program span, nested by time (category
  ``dispatch`` for ``prefill``, ``decode_chunk`` and ``spec_round``,
  ``host`` for the rest), and instant ("i") events ``migrate``,
  ``preempt``, ``resume``, ``shed``;
* track ``uid + 1``, ``req <uid>`` — the request lifecycle as contiguous
  phase spans ``queued`` / ``running`` / ``suspended`` (each transition
  closes one and opens the next), closed by a terminal ``finished`` or
  ``shed`` instant.

Export sorts events by (tid, ts): ``ts`` is monotone per track, which
``tests/test_torch_telemetry.py`` validates against the trace-event schema.
"""
from __future__ import annotations

import itertools
import json
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Tracer", "Span", "CURRENT", "DISPATCHES", "ENGINE_TRACK", "PID"]

PID = 1
ENGINE_TRACK = 0
# The spans that are engine dispatches (Chrome category ``dispatch``).
DISPATCHES = ("prefill", "decode_chunk", "spec_round")

# The process's current recorder (see the module docstring).
CURRENT: Optional["Tracer"] = None


class Span:
    """One program span; ``end`` is None while it is open."""

    __slots__ = ("id", "parent", "name", "start", "end", "uid", "args")

    def __init__(self, id_: int, parent: int, name: str, start: float,
                 uid: Optional[int], args: Dict[str, Any]) -> None:
        self.id = id_
        self.parent = parent
        self.name = name
        self.start = start
        self.end: Optional[float] = None
        self.uid = uid
        self.args = args


class Tracer:
    """The span recorder (see the module docstring).  Host-side appends
    only: no locks, no device interaction."""

    def __init__(self) -> None:
        self._epoch = time.perf_counter()
        # Closed program spans, in the order they closed.
        self.spans: List[Span] = []
        self._open: List[Span] = []
        self._ids = itertools.count(1)
        # Lifecycle phases and instants: (tid, name, ph, cat, start, end,
        # args), times in perf_counter seconds (end None for an instant).
        self._events: List[Tuple[int, str, str, str, float,
                                 Optional[float], Dict[str, Any]]] = []
        self._track_names: Dict[int, str] = {}
        # uid -> (phase name, phase start, phase start ticks)
        self._open_phase: Dict[int, Tuple[str, float, float]] = {}

    # ------------------------------------------------------------- clocks
    @staticmethod
    def now() -> float:
        """The span clock: raw ``time.perf_counter()`` seconds."""
        return time.perf_counter()

    # -------------------------------------------------------------- spans
    def begin(self, name: str, /, *, t: Optional[float] = None,
              uid: Optional[int] = None, **args: Any) -> Span:
        """Open a span under the innermost open one, starting at ``t``
        (default now)."""
        parent = self._open[-1] if self._open else None
        if parent is not None and uid is None:
            uid = parent.uid
        span = Span(next(self._ids), 0 if parent is None else parent.id,
                    name, time.perf_counter() if t is None else t, uid, args)
        self._open.append(span)
        return span

    def end(self, span: Span, /, *, t: Optional[float] = None,
            **args: Any) -> None:
        """Close ``span`` at ``t`` (default now), adding ``args`` to its
        fields.  Spans it still holds open (an exception left them) are
        dropped."""
        span.end = time.perf_counter() if t is None else t
        if args:
            span.args.update(args)
        while self._open and self._open.pop() is not span:
            pass
        self.spans.append(span)

    # ------------------------------------------------------------- tracks
    def _ensure_track(self, tid: int, name: str) -> None:
        if tid not in self._track_names:
            self._track_names[tid] = name

    def _request_track(self, uid: int) -> int:
        tid = uid + 1
        self._ensure_track(tid, f"req {uid}")
        return tid

    def complete(self, tid: int, name: str, start: float, end: float, *,
                 cat: str = "serve", args: Optional[Dict[str, Any]] = None
                 ) -> None:
        """One complete ("X") event on a track, in perf_counter seconds."""
        self._events.append((tid, name, "X", cat, start, end,
                             dict(args or {})))

    def instant(self, tid: int, name: str, *, cat: str = "serve",
                args: Optional[Dict[str, Any]] = None) -> None:
        self._events.append((tid, name, "i", cat, self.now(), None,
                             dict(args or {})))

    def engine_instant(self, name: str, *, ticks: float,
                       args: Optional[Dict[str, Any]] = None) -> None:
        self._ensure_track(ENGINE_TRACK, "engine")
        merged: Dict[str, Any] = {"ticks": ticks}
        merged.update(args or {})
        self.instant(ENGINE_TRACK, name, args=merged)

    # --------------------------------------------------- request lifecycle
    def request_phase(self, uid: int, phase: str, *, ticks: float) -> None:
        """Transition a request's lifecycle track into ``phase``: the open
        phase span (if any) closes at NOW and the new one opens."""
        tid = self._request_track(uid)
        self._close_phase(uid, tid, ticks)
        self._open_phase[uid] = (phase, self.now(), ticks)

    def request_end(self, uid: int, terminal: str, *, ticks: float) -> None:
        """Close the request's open phase and stamp the terminal instant
        (``finished`` or ``shed``)."""
        tid = self._request_track(uid)
        self._close_phase(uid, tid, ticks)
        self.instant(tid, terminal, cat="lifecycle",
                     args={"ticks": ticks})

    def _close_phase(self, uid: int, tid: int, ticks: float) -> None:
        open_ = self._open_phase.pop(uid, None)
        if open_ is not None:
            phase, start, ticks0 = open_
            self.complete(tid, phase, start, self.now(), cat="lifecycle",
                          args={"ticks": ticks0, "ticks_end": ticks})

    # ------------------------------------------------------------- export
    def _us(self, t: float) -> float:
        return (t - self._epoch) * 1e6

    def _span_event(self, s: Span) -> Dict[str, Any]:
        args = dict(s.args)
        args.update(id=s.id, parent=s.parent)
        if s.uid is not None:
            args["uid"] = s.uid
        assert s.end is not None
        return {"name": s.name, "ph": "X", "pid": PID, "tid": ENGINE_TRACK,
                "cat": "dispatch" if s.name in DISPATCHES else "host",
                "ts": self._us(s.start),
                "dur": max((s.end - s.start) * 1e6, 0.0), "args": args}

    def chrome_events(self) -> List[Dict[str, Any]]:
        """The Chrome trace-event list: process/thread metadata first, then
        the recorded events sorted by (tid, ts) — monotone ts per track.
        Open spans and request phases are NOT closed (export is
        non-destructive)."""
        if self.spans:
            self._ensure_track(ENGINE_TRACK, "engine")
        meta: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": PID, "tid": 0,
            "args": {"name": "repro_torch.serve"},
        }]
        for tid in sorted(self._track_names):
            meta.append({"name": "thread_name", "ph": "M", "pid": PID,
                         "tid": tid,
                         "args": {"name": self._track_names[tid]}})
        body = [self._span_event(s) for s in self.spans]
        for tid, name, ph, cat, start, end, args in self._events:
            ev = {"name": name, "ph": ph, "pid": PID, "tid": tid, "cat": cat,
                  "ts": self._us(start), "args": args}
            if end is None:
                ev["s"] = "t"
            else:
                ev["dur"] = max((end - start) * 1e6, 0.0)
            body.append(ev)
        body.sort(key=lambda e: (e["tid"], e["ts"]))
        return meta + body

    def write(self, path: str) -> None:
        """Dump ``{"traceEvents": [...]}`` JSON (the Perfetto-loadable
        container form of the trace-event format)."""
        with open(path, "w") as fh:
            json.dump({"traceEvents": self.chrome_events(),
                       "displayTimeUnit": "ms"}, fh)
            fh.write("\n")
