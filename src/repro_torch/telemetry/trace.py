"""Span tracing on the serving engine's dual clock, exported as Chrome
trace-event JSON (loadable in Perfetto / ``chrome://tracing``).

The engine has TWO clocks and every span carries both:

* the **deterministic scheduler clock** — decode steps executed
  (``ServeEngine.clock``), the units requests' deadlines and queue waits
  are priced in.  It is bit-stable across runs, so span *ordering* and
  tick-denominated durations are reproducible.
* **wall time** — a monotonic ``time.perf_counter`` offset from the
  tracer's epoch.  It drives the Chrome ``ts``/``dur`` microsecond fields
  (Perfetto's timeline axis) and is the only part of a trace that varies
  run to run.

Track taxonomy (one Chrome *thread* per track, all in pid 1):

* track 0, ``engine`` — one complete ("X") span per engine dispatch:
  ``prefill``, ``decode_chunk``, ``spec_round``; instant ("i") events for
  ``migrate``, ``preempt``, ``resume``, ``shed``.
* track ``uid + 1``, ``req <uid>`` — the request lifecycle as contiguous
  phase spans ``queued`` / ``running`` / ``suspended`` (QUEUED -> RUNNING
  -> SUSPENDED/... transitions close one span and open the next), closed
  by a terminal ``finished`` or ``shed`` instant.

Export sorts events by (tid, ts): ``ts`` is monotone per track, which
``tests/test_torch_telemetry.py`` validates against the trace-event schema.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Tracer", "ENGINE_TRACK", "PID"]

PID = 1
ENGINE_TRACK = 0


class Tracer:
    """Dual-clock span recorder (see module docstring).

    All methods are host-side appends — no locks, no device interaction.
    ``now()`` returns wall seconds since the tracer's epoch; span ``args``
    always include the scheduler-clock ticks so the deterministic timeline
    can be reconstructed from the trace alone."""

    def __init__(self) -> None:
        self._epoch = time.perf_counter()
        self._events: List[Dict[str, Any]] = []
        self._track_names: Dict[int, str] = {}
        # uid -> (phase name, phase start wall-us, phase start ticks)
        self._open_phase: Dict[int, Tuple[str, float, float]] = {}

    # ------------------------------------------------------------- clocks
    def now(self) -> float:
        """Wall seconds since the tracer epoch (monotonic)."""
        return time.perf_counter() - self._epoch

    def _us(self, wall_s: float) -> float:
        return wall_s * 1e6

    # ------------------------------------------------------------- tracks
    def _ensure_track(self, tid: int, name: str) -> None:
        if tid not in self._track_names:
            self._track_names[tid] = name

    def _request_track(self, uid: int) -> int:
        tid = uid + 1
        self._ensure_track(tid, f"req {uid}")
        return tid

    # -------------------------------------------------------------- spans
    def complete(self, tid: int, name: str, start_s: float, end_s: float,
                 *, cat: str = "serve", args: Optional[Dict[str, Any]] = None
                 ) -> None:
        """One complete ("X") span on a track, in tracer-epoch seconds."""
        self._events.append({
            "name": name, "ph": "X", "pid": PID, "tid": tid, "cat": cat,
            "ts": self._us(start_s),
            "dur": max(self._us(end_s) - self._us(start_s), 0.0),
            "args": dict(args or {}),
        })

    def instant(self, tid: int, name: str, *, cat: str = "serve",
                args: Optional[Dict[str, Any]] = None) -> None:
        self._events.append({
            "name": name, "ph": "i", "pid": PID, "tid": tid, "cat": cat,
            "ts": self._us(self.now()), "s": "t",
            "args": dict(args or {}),
        })

    def dispatch(self, name: str, start_s: float, *, ticks: float,
                 ticks_end: float,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """One engine-track dispatch span ending NOW, stamped with both
        clocks (``ticks``/``ticks_end`` are scheduler-clock)."""
        self._ensure_track(ENGINE_TRACK, "engine")
        merged: Dict[str, Any] = {"ticks": ticks, "ticks_end": ticks_end}
        merged.update(args or {})
        self.complete(ENGINE_TRACK, name, start_s, self.now(),
                      cat="dispatch", args=merged)

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
            phase, start_s, ticks0 = open_
            self.complete(tid, phase, start_s, self.now(), cat="lifecycle",
                          args={"ticks": ticks0, "ticks_end": ticks})

    # ------------------------------------------------------------- export
    def chrome_events(self) -> List[Dict[str, Any]]:
        """The Chrome trace-event list: process/thread metadata first, then
        the recorded events sorted by (tid, ts) — monotone ts per track.
        Open request phases are NOT closed (export is non-destructive)."""
        meta: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": PID, "tid": 0,
            "args": {"name": "repro_torch.serve"},
        }]
        for tid in sorted(self._track_names):
            meta.append({"name": "thread_name", "ph": "M", "pid": PID,
                         "tid": tid,
                         "args": {"name": self._track_names[tid]}})
        body = sorted(self._events, key=lambda e: (e["tid"], e["ts"]))
        return meta + body

    def write(self, path: str) -> None:
        """Dump ``{"traceEvents": [...]}`` JSON (the Perfetto-loadable
        container form of the trace-event format)."""
        with open(path, "w") as fh:
            json.dump({"traceEvents": self.chrome_events(),
                       "displayTimeUnit": "ms"}, fh)
            fh.write("\n")
